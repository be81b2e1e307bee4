"""K3's share of its roofline in the profiled training epoch, in %: the least
time its launches need (their bytes over the HBM rate, ``flops.py``) over
their device time by kernel name (`fk_chain_kernel`, torch.profiler). A
stage-1 step runs the FK twice, at N = the envs (the FK targets) and at N =
the reset candidates; any other count of launches reads nothing."""

from benchmark import flops, peaks

JOINTS = 24


def read(ctx):
    launches = ctx.launches.get("fk_chain", 0)
    by_name = ctx.profile.get("by_name", {}) if ctx.profile else {}
    seconds = sum(v for k, v in by_name.items() if "fk_chain_kernel" in k)
    steps = ctx.window["horizon"]
    if launches != 2 * steps or seconds <= 0:
        return None
    env = ctx.cfg["env"]
    nbytes = steps * (flops.fk_chain_bytes(ctx.window["envs"], JOINTS)
                      + flops.fk_chain_bytes(env["reset_candidates"], JOINTS))
    return nbytes / peaks.HBM_BYTES_PER_S / seconds * 100.0
