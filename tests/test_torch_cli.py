"""The port's command line against the JAX package's: every named config
field by field, the parser, `_clamp_minibatch`, every config built (not
trained) on the CPU, a tiny curriculum through `main([...])` (mvae_federer
-> federer_im -> federer_train_stage_1, then `--test --render`) whose files
the JAX package reads, the profiler and checkpoint cadence of the training
loop, and the options that raise. All on the CPU through `--device cpu`.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vid2player3d_tpu.cli import configs as JC
from vid2player3d_tpu.cli import run as JR
from vid2player3d_tpu.learn import FrozenImitator as JFrozen
from vid2player3d_tpu.learn import running_norm as JRN
from vid2player3d_tpu.learn.networks import V2PNet as JV2PNet
from vid2player3d_tpu.utils import checkpoint as JCK
from vid2player3d_torch.cli import configs as C
from vid2player3d_torch.cli import run as R
from vid2player3d_torch.envs import DualTennisEnv, TennisEnv
from vid2player3d_torch.learn import FrozenImitator, ImitationPPO, V2PPPO
from vid2player3d_torch.mvae import MVAEOption, MVAETrainer, make_synthetic_pose_dataset
from vid2player3d_torch.utils import checkpoint as CK

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _plain(v):
    """A config value as plain Python: dataclasses as {field: value},
    recursively (the two packages' classes differ, their fields must not)."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, (tuple, list)):
        return type(v)(_plain(x) for x in v)
    return v


@pytest.mark.parametrize("name", sorted(JC.CONFIGS))
def test_config_equals_jax(name):
    """Each named config of the JAX CLI, field by field, nested configs,
    randomization and transform specs included."""
    assert _plain(C.get_config(name)) == _plain(JC.get_config(name))


def test_config_names_and_unknown_name():
    assert set(C.CONFIGS) == set(JC.CONFIGS)
    with pytest.raises(KeyError):
        C.get_config("federer_train_stage_9")


def test_presets_are_a_view_of_the_configs():
    """`envs/presets.py` reads `cli/configs.py`: the same objects."""
    from vid2player3d_torch.envs.presets import PRESETS, preset

    assert set(PRESETS) == {n for n, c in C.CONFIGS.items() if c.kind != "mvae"}
    env_cfg, learner = preset("federer_train_stage_2", num_envs=6)
    cfg = C.get_config("federer_train_stage_2")
    assert env_cfg == dataclasses.replace(cfg.env_tennis, num_envs=6) and learner is cfg.v2p


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.required)
            for a in parser._actions if a.dest != "help"}


def test_parser_is_jax_plus_device():
    """The option set is JAX's plus `--device` and the port's tracer switch
    `--trace` (off by default), with JAX's defaults, choices, types and
    required flags."""
    got, want = _options(R.build_parser()), _options(JR.build_parser())
    assert set(got) == set(want) | {"device", "trace"}
    for k, v in want.items():
        assert got[k] == v, k
    assert got["device"][1] is None
    assert got["trace"][1] is False


def test_clamp_minibatch_matches_jax():
    cfgs = [C.get_config(n).ppo or C.get_config(n).v2p for n in ("amass_im",
                                                                 "federer_train_stage_1")]
    for cfg in cfgs:
        for horizon in (1, 4, 7, 32, 64):
            for mb in (1, 6, 16, 512, 16384):
                c = dataclasses.replace(cfg, horizon=horizon, minibatch_size=mb)
                for n in (1, 3, 4, 8, 10, 100, 10240):
                    got, want = R._clamp_minibatch(c, n), JR._clamp_minibatch(c, n)
                    assert got.minibatch_size == want.minibatch_size, (horizon, mb, n)
                    assert (got is c) == (want is c)


@pytest.mark.parametrize("name", sorted(JC.CONFIGS))
def test_every_config_builds(name, tmp_path):
    """Every named config's agent (a MotionVAE trainer for `mvae_*`) built on
    the CPU at 4 envs (8 for a dual rally) with nothing trained under
    `--out`: the env config is the config's with `num_envs` replaced, a
    dual rally gets two policies and the two-handed lanes, a left-handed
    nadal, and the PD-only pi_low."""
    cfg = C.get_config(name)
    device = torch.device("cpu")
    if cfg.kind == "mvae":
        opt = MVAEOption.load(cfg.mvae_version)
        tr = MVAETrainer(opt, make_synthetic_pose_dataset(opt), device=device)
        assert tr.model.latent_size == opt.latent_size
        assert tr.model.encoder.fc1.out_features == opt.hidden_size
        return
    n = 8 if cfg.dual else 4
    args = R.build_parser().parse_args(["--cfg", name, "--num_envs", str(n),
                                        "--out", str(tmp_path)] + CPU)
    if cfg.kind == "im":
        agent = R._build_im(cfg, args, device)
        assert isinstance(agent, ImitationPPO)
        assert agent.env.cfg == dataclasses.replace(cfg.env_im, num_envs=n)
        assert agent.cfg.use_context_ik == cfg.ppo.use_context_ik
        return
    agent = R._build_tennis(cfg, args, device)
    assert isinstance(agent, V2PPPO) and agent.device.type == "cpu"
    env = agent.env
    assert env.cfg == dataclasses.replace(cfg.env_tennis, num_envs=n)
    assert agent.cfg.horizon == cfg.v2p.horizon
    assert agent.cfg.minibatch_size == R._clamp_minibatch(cfg.v2p, n).minibatch_size
    if cfg.dual:
        assert isinstance(env, DualTennisEnv) and agent.num_policies == 2
        two = ("djokovic", "nadal")
        assert env._lane_two_hand == (cfg.player in two, cfg.player_b in two)
        assert [s.player for s in env._lane_specs] == [cfg.player, cfg.player_b]
    else:
        assert type(env) is TennisEnv and agent.num_policies == 1
        assert env._lane_two_hand == (cfg.env_tennis.two_hand_backhand,)
    assert [s.righthand for s in env._lane_specs] == \
        [s.player != "nadal" for s in env._lane_specs]
    # the pool honors the config's bounce box: x at each trajectory's first
    # frame below 0.25 m (the 30 Hz frame nearest its bounce) inside it, to
    # 0.5 m
    traj = env.gen.traj_pool
    low = traj[torch.arange(traj.shape[0]), (traj[..., 2] < 0.25).to(torch.int8).argmax(1)]
    assert float(low[:, 0].abs().max()) < cfg.env_tennis.ball_bounce_x_half + 0.5
    assert isinstance(env.pi_low, FrozenImitator)
    assert all(float(p.abs().max()) == 0.0 for p in env.pi_low.net.parameters())


@pytest.fixture(scope="module")
def curriculum(tmp_path_factory):
    """mvae_federer (1 epoch of 2 batches) -> federer_im (8 envs, horizon 4)
    -> federer_train_stage_1 (8 envs, horizon 4), then the stage's eval with
    `--test --render` from its best.npz; returns (out dir, console text of
    each call)."""
    out = str(tmp_path_factory.mktemp("cli"))
    logs = {}

    def run(key, argv):
        from contextlib import redirect_stdout
        from io import StringIO

        buf = StringIO()
        with redirect_stdout(buf):
            assert R.main(argv + CPU) == 0
        logs[key] = buf.getvalue()

    run("mvae", ["--cfg", "mvae_federer", "--epochs", "1", "--mvae_batches", "2",
                 "--out", out])
    run("im", ["--cfg", "federer_im", "--num_envs", "8", "--horizon", "4",
               "--minibatch_size", "16", "--epochs", "1", "--seed", "1",
               "--out", os.path.join(out, "federer_im")])
    run("stage1", ["--cfg", "federer_train_stage_1", "--num_envs", "8", "--horizon", "4",
                   "--minibatch_size", "16", "--epochs", "1", "--seed", "1", "--out", out])
    run("eval", ["--cfg", "federer_train_stage_1", "--num_envs", "4", "--test", "--epochs", "1",
                 "--seed", "1", "--out", out, "--checkpoint", os.path.join(out, "best.npz"),
                 "--render", os.path.join(out, "roll.html")])
    return out, logs


def test_cli_curriculum_finds_each_stage(curriculum):
    """Each stage's files, and the next stage finding them: stage 1 embeds
    federer_im's best.npz and decodes through the trained MotionVAE (its
    `init_frames.npy` present); metrics rows are finite."""
    out, logs = curriculum
    for f in ("mvae_federer/latest.npz", "mvae_federer/init_frames.npy",
              "federer_im/best.npz", "federer_im/latest.npz", "federer_im/metrics.jsonl",
              "best.npz", "latest.npz", "metrics.jsonl"):
        assert os.path.exists(os.path.join(out, f)), f
    assert "finite" in json.loads(logs["mvae"][logs["mvae"].index("{"):])
    assert f"embedding frozen low-level policy from {out}/federer_im/best.npz" in logs["stage1"]
    assert "no trained MVAE" not in logs["stage1"]
    rows = [json.loads(r) for r in open(os.path.join(out, "metrics.jsonl"))]
    assert len(rows) == 2     # the MotionVAE's epoch, then stage 1's
    assert np.isfinite(rows[-1]["reward_mean"]) and rows[-1]["grad_skip"] == 0.0


def test_cli_eval_report_and_render(curriculum):
    """`--test --render`: the report has the JAX eval's keys and finite
    values; the HTML viewer holds the first four envs."""
    out, logs = curriculum
    text = logs["eval"]
    report = json.loads(text[text.index("{"):text.index("}") + 1])
    assert set(report) == {"cycles", "hit_rate", "bounce_in_rate", "bounce_pos_error",
                           "fh_ratio", "reward_mean"}
    assert all(v is None or np.isfinite(v) for v in report.values())
    html = open(os.path.join(out, "roll.html")).read()
    assert '"envs": [0, 1, 2, 3]' in html and "<canvas" in html
    data = np.load(os.path.join(out, "roll.npz"))
    assert data["body_pos"].shape == (150, 4, 24, 3)


def test_cli_files_read_by_jax(curriculum):
    """The JAX package reads what the port's CLI wrote: `FrozenImitator.
    from_checkpoint` of federer_im's best.npz (params and normalizer equal to
    the port's reader), `load_pytree` of stage 1's best.npz against a JAX
    V2PNet template (params and both normalizers equal)."""
    out, _ = curriculum
    path = os.path.join(out, "federer_im", "best.npz")
    jf = JFrozen.from_checkpoint(path)
    tf = FrozenImitator.from_checkpoint(path, device="cpu")
    jp = CK.params_from_jax(JCK._flatten(jf.params))
    for k, v in tf.net.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jp[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(np.asarray(jf.obs_norm.mean), tf.obs_norm.mean.numpy())

    path = os.path.join(out, "best.npz")
    cfg = C.get_config("federer_train_stage_1")
    flat = CK.load_npz(path)
    obs_dim = flat["obs_norm/1"].shape[0]
    net = JV2PNet(num_actions=cfg.env_tennis.num_actions, actor_units=cfg.v2p.actor_units,
                  critic_units=cfg.v2p.critic_units)
    like = {"params": net.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_dim))),
            "obs_norm": JRN.RunningNormState.create(obs_dim),
            "val_norm": JRN.RunningNormState.create(1)}
    got = JCK._flatten(JCK.load_pytree(path, like))
    for k, v in got.items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


def test_train_loop_profile_and_saves(tmp_path):
    """Four amass_im epochs at 4 envs with `--profile` and `--save_every 2`:
    a torch.profiler trace of epochs 2-4, four metrics rows, latest.npz and
    best.npz, and a warm start from latest.npz through `--checkpoint`."""
    out, prof = str(tmp_path / "im"), str(tmp_path / "prof")
    base = ["--cfg", "amass_im", "--num_envs", "4", "--horizon", "2", "--minibatch_size", "8",
            "--out", out] + CPU
    assert R.main(base + ["--epochs", "4", "--save_every", "2", "--profile", prof]) == 0
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    assert len(open(os.path.join(out, "metrics.jsonl")).readlines()) == 4
    flat = CK.load_npz(os.path.join(out, "latest.npz"))
    assert int(flat["epoch"]) == 4
    assert R.main(base + ["--epochs", "1", "--checkpoint", os.path.join(out, "latest.npz")]) == 0
    assert int(CK.load_npz(os.path.join(out, "latest.npz"))["epoch"]) == 5


def test_cli_data_parallel_cpu(tmp_path, monkeypatch):
    """`--n_devices 2 --device cpu` trains amass_im over two gloo ranks for an
    epoch at 4 envs (a 120 s collective timeout): rank 0 alone logs (one
    metrics row) and writes the checkpoints, which the JAX package's
    `load_pytree` reads with the JAX learner's template, every leaf equal to
    the file's."""
    from vid2player3d_tpu.data.synthetic import make_synthetic_motion_lib as j_make_lib
    from vid2player3d_tpu.envs import HumanoidImEnv as JEnv
    from vid2player3d_tpu.learn import ImitationPPO as JPPO
    from vid2player3d_torch.parallel import mesh as PM

    monkeypatch.setattr(PM, "DEFAULT_TIMEOUT_S", 120.0)
    out = str(tmp_path / "dp")
    assert R.main(["--cfg", "amass_im", "--num_envs", "4", "--horizon", "2", "--minibatch_size",
                   "8", "--epochs", "1", "--n_devices", "2", "--out", out] + CPU) == 0
    assert sorted(os.listdir(out)) == ["best.npz", "latest.npz", "metrics.jsonl"]
    assert len(open(os.path.join(out, "metrics.jsonl")).readlines()) == 1
    cfg = JC.get_config("amass_im")
    jenv = JEnv(dataclasses.replace(cfg.env_im, num_envs=4),
                j_make_lib(num_motions=1, T=30, fps=30.0, seed=0), rng=0)
    jinit = JPPO(jenv, dataclasses.replace(cfg.ppo, horizon=2, minibatch_size=8))._init
    like = {"params": jinit.params, "obs_norm": jinit.obs_norm, "val_norm": jinit.val_norm,
            "opt_state": jinit.opt_state, "epoch": jinit.epoch, "lr": jinit.lr}
    path = os.path.join(out, "latest.npz")
    flat = CK.load_npz(path)
    got = JCK._flatten(JCK.load_pytree(path, like))
    assert set(got) == set(flat) and int(flat["epoch"]) == 1
    for k, v in got.items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


def test_cli_trains_on_generated_data(tmp_path):
    """The data tools feed the CLI: `python -m vid2player3d_torch.data.
    tennis_motion` writes a 2-sequence dataset that `--cfg mvae_federer
    --dataset_dir` trains on for an epoch of 2 windows (finite losses, the
    checkpoint and a finite random-walk report), and a `tennis_motion_lib`
    file that `--cfg federer_im --motion_file` trains on at 8 envs (finite
    metrics, best.npz). `--dataset_dir`'s help names the port's generator."""
    from contextlib import redirect_stdout
    from io import StringIO

    from vid2player3d_torch.data.tennis_motion import tennis_motion_lib

    help_ = {a.dest: a.help for a in R.build_parser()._actions}["dataset_dir"]
    assert "python -m vid2player3d_torch.data.tennis_motion" in help_
    ds = str(tmp_path / "ds")
    gen = subprocess.run([sys.executable, "-m", "vid2player3d_torch.data.tennis_motion", ds,
                          "--num_sequences", "2", "--cycles_per_seq", "2"], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
                         timeout=300)
    assert gen.returncode == 0 and "head_speed@contact" in gen.stdout, gen.stderr
    out = str(tmp_path / "out")
    buf = StringIO()
    with redirect_stdout(buf):
        assert R.main(["--cfg", "mvae_federer", "--dataset_dir", ds, "--epochs", "1",
                       "--mvae_batches", "2", "--out", out] + CPU) == 0
    text = buf.getvalue()
    assert f"dataset: {ds} (" in text and json.loads(text[text.index("{"):])["finite"]
    row = json.loads(open(os.path.join(out, "metrics.jsonl")).readline())
    assert all(np.isfinite(row[k]) for k in ("recon", "kl", "recon_phase"))
    assert os.path.exists(os.path.join(out, "mvae_federer", "latest.npz"))

    lib = str(tmp_path / "tennis_lib.npz")
    tennis_motion_lib(num_sequences=2, out_path=lib, device="cpu")
    im = os.path.join(out, "federer_im")
    with redirect_stdout(StringIO()):
        assert R.main(["--cfg", "federer_im", "--motion_file", lib, "--num_envs", "8",
                       "--horizon", "4", "--minibatch_size", "16", "--epochs", "1",
                       "--out", im] + CPU) == 0
    row = json.loads(open(os.path.join(im, "metrics.jsonl")).readline())
    assert all(np.isfinite(v) for v in row.values()) and row["reward_mean"] > 0.0
    assert os.path.exists(os.path.join(im, "best.npz"))


def test_cli_raises(tmp_path):
    """`--n_devices` below 1 raises; with no card and no `--device` the CLI
    raises instead of running on the CPU, `--n_devices` included (its ranks
    run on the CPU only with `--device cpu`)."""
    argv = ["--cfg", "amass_im", "--num_envs", "4", "--out", str(tmp_path)]
    with pytest.raises(ValueError, match="--n_devices 0"):
        R.main(argv + ["--n_devices", "0"] + CPU)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI defaults to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.main(argv + ["--n_devices", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        R.main(["--cfg", "mvae_federer", "--out", str(tmp_path)])


def test_module_entry_points(tmp_path):
    """`python -m vid2player3d_torch` and `python -m vid2player3d_torch.tennis.
    pool` in a fresh interpreter: `--help` exits 0; without a card the
    package's entry point exits non-zero with "no CUDA device"."""
    env = dict(os.environ, PYTHONPATH=REPO)
    for mod in ("vid2player3d_torch", "vid2player3d_torch.tennis.pool"):
        out = subprocess.run([sys.executable, "-m", mod, "--help"], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0 and "--device" in out.stdout, out.stderr
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, "-m", "vid2player3d_torch", "--cfg", "amass_im",
                          "--out", str(tmp_path)], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
