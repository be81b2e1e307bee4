"""K2's share of its roofline in the profiled window, in %: the least
time its launches need over their device time by kernel name
(`moe_linear_kernel` and its prep `moe_split_w_kernel`, torch.profiler).

Each decode is three GEMM launches at B = the envs, one per decoder layer
(the port's `graphs.counters()` count them through the replays), and three
prep launches. A GEMM's least time is the larger of its bytes over the HBM
rate and 3 x its operations over the TF32 peak (the kernel keeps f32-grade
results with three TF32 products per product); the prep's is its bytes over
the HBM rate (``flops.py``, ``peaks.py``)."""

from benchmark import flops, peaks


def _layers(m):
    d_in, inter = m["latent_size"] + m["frame_size"], m["latent_size"] + m["hidden_size"]
    out = m["frame_size"] + (2 if m["predict_phase"] else 0)
    return ((d_in, m["hidden_size"]), (inter, m["hidden_size"]), (inter, out))


def read(ctx):
    gemm = ctx.launches.get("moe_linear", 0)
    by_name = ctx.profile.get("by_name", {}) if ctx.profile else {}
    seconds = sum(v for k, v in by_name.items() if "moe_linear_kernel" in k
                  or "moe_split_w_kernel" in k)
    if gemm == 0 or gemm % 3 or seconds <= 0:
        return None
    m, batch = ctx.cfg["mvae"], ctx.window["envs"]
    least = 0.0
    for i, o in _layers(m):
        f = flops.moe_linear(batch, ((i, o),), m["num_experts"])
        least += max(f["bytes"] / peaks.HBM_BYTES_PER_S,
                     3 * f["ops"] / peaks.FLOPS_PER_S["tf32"])
        least += 4.0 * 3 * m["num_experts"] * (i + 1) * o / peaks.HBM_BYTES_PER_S
    return least * (gemm // 3) / seconds * 100.0
