"""Self-contained HTML rollout viewer (counterpart of
``vid2player3d_tpu/vis/render.py``; numpy only).

A single HTML file with the rollout data embedded as JSON and a small canvas
player: court top-down view and side view, volumetric body (per-body geom
radii drawn as width-varying limbs and joint discs), ball with trail, racket
with head disc. No external assets or network access needed; open it in any
browser. For the same rollout it writes the same bytes as the JAX package's
renderer, the page title included.

Pairs with `eval.export_rollout` / `eval.export_imitation_rollout` (the npz
data contract) and `eval.select_best` (env ranking).
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np

from ..core.smpl import MUJOCO_JOINT_NAMES, SMPL_BONE_ORDER_NAMES, SMPL_PARENTS
from ..tennis import court

# mujoco-order parent table derived from the SMPL tree
_MJ_PARENTS = []
for _n in MUJOCO_JOINT_NAMES:
    _si = SMPL_BONE_ORDER_NAMES.index(_n)
    _p = SMPL_PARENTS[_si]
    _MJ_PARENTS.append(
        -1 if _p < 0 else MUJOCO_JOINT_NAMES.index(SMPL_BONE_ORDER_NAMES[_p]))


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>vid2player3d_tpu rollout</title>
<style>
 body {{ background:#111; color:#ddd; font-family:monospace; margin:12px; }}
 canvas {{ background:#1b3d1b; display:block; margin:6px 0; }}
 .bar {{ display:flex; gap:10px; align-items:center; }}
</style></head><body>
<div class="bar">
 <button id="play">&#9654;/&#10074;&#10074;</button>
 <input id="scrub" type="range" min="0" value="0" style="flex:1">
 <span id="frame"></span>
 <select id="env"></select>
</div>
<canvas id="top" width="900" height="420"></canvas>
<canvas id="side" width="900" height="260"></canvas>
<script>
const D = {data};
const PARENTS = {parents};
const RADII = D.body_radius || null;
const WRIST = D.wrist_id === undefined ? -1 : D.wrist_id;
const HW = {half_width}, HL = {half_length}, NET = {net_height};
const T = D.body.length, NENV = D.envs.length;
let env = 0, t = 0, playing = true;
const scrub = document.getElementById('scrub'); scrub.max = T - 1;
const sel = document.getElementById('env');
D.envs.forEach((e, i) => {{
  const o = document.createElement('option');
  o.value = i; o.text = 'env ' + e; sel.add(o);
}});
sel.onchange = () => {{ env = +sel.value; }};
document.getElementById('play').onclick = () => playing = !playing;
scrub.oninput = () => {{ t = +scrub.value; playing = false; draw(); }};

function lines(ctx, pts) {{
  ctx.beginPath();
  pts.forEach((p, i) => i ? ctx.lineTo(p[0], p[1]) : ctx.moveTo(p[0], p[1]));
  ctx.stroke();
}}
function drawCourt(ctx, W, H, proj) {{
  ctx.strokeStyle = '#cfe3cf'; ctx.lineWidth = 1.2;
  const c = [[-HW, -HL], [HW, -HL], [HW, HL], [-HW, HL], [-HW, -HL]];
  lines(ctx, c.map(p => proj(p[0], p[1], 0)));
  lines(ctx, [proj(-HW, 0, 0), proj(HW, 0, 0)]);       // net line
}}
function skel(ctx, J, proj, color, pxPerM) {{
  ctx.strokeStyle = color; ctx.lineCap = 'round';
  for (let j = 1; j < J.length; j++) {{
    const p = PARENTS[j]; if (p < 0) continue;
    ctx.lineWidth = RADII ? Math.max(1.5, RADII[j] * pxPerM * 1.6) : 2;
    lines(ctx, [proj(J[j][0], J[j][1], J[j][2]),
                proj(J[p][0], J[p][1], J[p][2])]);
  }}
  if (RADII) for (let j = 0; j < J.length; j++) {{
    const q = proj(J[j][0], J[j][1], J[j][2]);
    ctx.fillStyle = color + '55';
    ctx.beginPath();
    ctx.arc(q[0], q[1], Math.max(1, RADII[j] * pxPerM), 0, 7); ctx.fill();
  }}
}}
function draw() {{
  const top = document.getElementById('top').getContext('2d');
  const sideC = document.getElementById('side').getContext('2d');
  top.clearRect(0, 0, 900, 420); sideC.clearRect(0, 0, 900, 260);
  const pt = (x, y, z) => [450 + x * 26, 210 - y * 11.5];   // top-down (x,y)
  const ps = (x, y, z) => [450 + y * 26, 240 - z * 55];     // side (y,z)
  drawCourt(top, 900, 420, pt);
  sideC.strokeStyle = '#cfe3cf';
  lines(sideC, [ps(0, -HL, 0), ps(0, HL, 0)]);
  lines(sideC, [ps(0, 0, 0), ps(0, 0, NET)]);
  const COLORS = ['#7fd4ff', '#ffc04d', '#b0ff9e', '#ff9ecf'];
  for (let si = 0; si < D.body[t][env].length; si++) {{
    const J = D.body[t][env][si];
    skel(top, J, pt, COLORS[si % 4], 22); skel(sideC, J, ps, COLORS[si % 4], 40);
  }}
  // ball + trail
  if (D.ball) for (let k = Math.max(0, t - 15); k <= t; k++) {{
    const b = D.ball[k][env];
    const a = (k - t + 15) / 15;
    for (const [ctx2, proj] of [[top, pt], [sideC, ps]]) {{
      ctx2.fillStyle = `rgba(255,230,80,${{a}})`;
      const q = proj(b[0], b[1], b[2]);
      ctx2.beginPath(); ctx2.arc(q[0], q[1], k === t ? 4 : 2, 0, 7); ctx2.fill();
    }}
  }}
  if (D.racket) {{
    const r = D.racket[t][env];
    const J0 = D.body[t][env][0];
    for (const [ctx2, proj, sc] of [[top, pt, 22], [sideC, ps, 40]]) {{
      ctx2.strokeStyle = '#ff8080'; ctx2.lineWidth = 2;
      const q = proj(r[0], r[1], r[2]);
      const WID = Array.isArray(WRIST) ? WRIST[D.envs[env]] : WRIST;
      if (WID >= 0) {{            // handle: wrist -> head center
        const w = proj(J0[WID][0], J0[WID][1], J0[WID][2]);
        lines(ctx2, [w, q]);
      }}
      ctx2.beginPath(); ctx2.arc(q[0], q[1], 0.15 * sc, 0, 7); ctx2.stroke();
    }}
  }}
  document.getElementById('frame').textContent = t + '/' + (T - 1);
  scrub.value = t;
}}
setInterval(() => {{ if (playing) {{ t = (t + 1) % T; draw(); }} }}, 33);
draw();
</script></body></html>
"""


def render_html(rollout, out_path: str,
                env_ids: Optional[Sequence[int]] = None,
                max_frames: int = 600, dual: bool = False) -> str:
    """Write a standalone HTML viewer for a rollout.

    rollout: path to an `export_rollout` npz or a dict with body_pos
      (T, N, 24, 3), optional ref_body_pos (ghost skeleton — e.g. the
      imitation reference target, drawn in a second color like the
      reference's side-by-side vis, `humanoid_smpl_im_vis.py:72-155`),
      optional ball_pos (T, N, 3) / racket_pos (T, N, 3), optional
      body_radius (24,) geom radii for volumetric limbs, optional
      wrist_id (racket-hand wrist joint for the handle line).
    env_ids: which envs to embed (default: first 4; pass `select_best`
      output to record the best performers).
    dual: paired-lane rally mode — each even lane is drawn together with
      its odd partner mirrored through the net into one scene
      (`mvae_controller_vis_dual.py:86-130`).
    """
    if isinstance(rollout, str):
        rollout = dict(np.load(rollout))
    body = np.asarray(rollout["body_pos"])[:max_frames]
    ball = rollout.get("ball_pos")
    racket = rollout.get("racket_pos")
    N = body.shape[1]
    if env_ids is None:
        env_ids = [e for e in range(min(4 * (2 if dual else 1), N))
                   if not dual or e % 2 == 0]
    env_ids = [int(e) for e in env_ids]

    def rnd(a):
        return np.round(np.asarray(a, np.float64), 3).tolist()

    if dual:
        # scene = even lane + mirrored odd partner (x,y -> -x,-y)
        mirror = np.array([-1.0, -1.0, 1.0])
        partner = [e ^ 1 for e in env_ids]
        skel = np.stack([body[:, env_ids],
                         body[:, partner] * mirror], axis=2)
    else:
        skel = body[:, env_ids][:, :, None]          # (T, E, 1, 24, 3)
        if "ref_body_pos" in rollout:
            ref = np.asarray(rollout["ref_body_pos"])[:max_frames]
            skel = np.concatenate([skel, ref[:, env_ids][:, :, None]],
                                  axis=2)

    data = {"envs": env_ids, "body": rnd(skel)}
    if "body_radius" in rollout:
        data["body_radius"] = rnd(np.asarray(rollout["body_radius"]))
    if "wrist_id" in rollout:
        w = np.asarray(rollout["wrist_id"])
        # per-env array (dual rallies mix handedness) or legacy scalar
        data["wrist_id"] = [int(x) for x in np.atleast_1d(w)] \
            if w.ndim else int(w)
    if ball is not None:
        data["ball"] = rnd(np.asarray(ball)[:max_frames][:, env_ids])
    if racket is not None:
        data["racket"] = rnd(np.asarray(racket)[:max_frames][:, env_ids])
    html = _PAGE.format(data=json.dumps(data), parents=json.dumps(_MJ_PARENTS),
                        half_width=court.HALF_WIDTH,
                        half_length=court.HALF_LENGTH,
                        net_height=court.NET_HEIGHT)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
