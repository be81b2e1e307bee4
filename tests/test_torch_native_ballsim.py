"""The port's native ball-flight backend: its ctypes binding of
``native/ballsim.cpp`` against the JAX package's binding (bit for bit) and
against the port's own `simulate_flight` (the JAX test's tolerances), the
pool generator's two backends row by row, the build cache, the build
failure that raises instead of falling back, and the pool CLI's file read
by the JAX package.
"""

import os

import numpy as np
import pytest
import torch

from vid2player3d_tpu.native import simulate_flight_native as j_simulate_native
from vid2player3d_tpu.tennis.ball import TennisBallGenerator as JGen
from vid2player3d_torch.native import ballsim
from vid2player3d_torch.native import build_library, simulate_flight_native
from vid2player3d_torch.tennis import pool
from vid2player3d_torch.tennis.ball import DEFAULT_PARAMS, TennisBallGenerator, simulate_flight

torch.set_num_threads(1)


def _launches(n=64, seed=0):
    """The JAX test's launch states (tests/test_native_ballsim.py)."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-4, 4, n), rng.uniform(11, 13, n),
                    rng.uniform(1.0, 1.6, n)], 1).astype(np.float32)
    speed = rng.uniform(25, 32, n)
    theta = np.deg2rad(rng.uniform(4, 16, n))
    d = -pos[:, :2] / np.linalg.norm(pos[:, :2], axis=1, keepdims=True)
    vel = np.stack([speed * np.cos(theta) * d[:, 0],
                    speed * np.cos(theta) * d[:, 1],
                    speed * np.sin(theta)], 1).astype(np.float32)
    vspin = rng.uniform(3, 10, n).astype(np.float32)
    return pos, vel, vspin


def test_native_is_the_jax_binding_bit_for_bit():
    """64 balls x 80 frames through the port's library and the JAX
    package's (the same source and flags): every output equal."""
    pos, vel, vspin = _launches()
    got = simulate_flight_native(pos, vel, vspin, num_frames=80)
    want = j_simulate_native(pos, vel, vspin, num_frames=80)
    assert got._fields == want._fields
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_native_matches_the_torch_integrator():
    """Against the port's `simulate_flight` on the CPU, at the JAX test's
    tolerances: trajectories within 2e-2 over 80 frames, the same bounces,
    pass-net on 95%, bounce positions within 5e-2 and times within two
    frames."""
    pos, vel, vspin = _launches()
    nat = simulate_flight_native(pos, vel, vspin, num_frames=80)
    ref = simulate_flight(torch.tensor(pos), torch.tensor(vel), torch.tensor(vspin),
                          num_frames=80, p=DEFAULT_PARAMS)
    err = np.abs(nat.traj - ref.traj.numpy()).max()
    assert err < 2e-2, f"max traj deviation {err}"
    assert np.array_equal(nat.has_bounce, ref.has_bounce.numpy())
    assert np.mean(nat.pass_net == ref.pass_net.numpy()) > 0.95
    hb = nat.has_bounce
    assert np.allclose(nat.bounce_pos[hb], ref.bounce_pos.numpy()[hb], atol=5e-2)
    assert np.allclose(nat.bounce_time[hb], ref.bounce_time.numpy()[hb], atol=2.0 / 30.0)


def test_generator_backends_agree_row_by_row():
    """`TennisBallGenerator(backend="native")` and `"torch"` on one seed:
    both draw the same launches, so the pools agree in size within 5% and
    the candidates both keep, matched by launch position, carry identical
    launch states and trajectories within 2e-2. "auto" is the torch
    integrator."""
    nat = TennisBallGenerator(num_candidates=512, seed=3, backend="native", device="cpu")
    tor = TennisBallGenerator(num_candidates=512, seed=3, backend="torch", device="cpu")
    auto = TennisBallGenerator(num_candidates=512, seed=3, device="cpu")
    assert (nat.backend, tor.backend, auto.backend) == ("native", "torch", "torch")
    assert torch.equal(auto.traj_pool, tor.traj_pool)
    assert abs(nat.pool_size - tor.pool_size) <= 0.05 * tor.pool_size
    tl = tor.launch_pos.numpy()
    matched = 0
    for i, lp in enumerate(nat.launch_pos.numpy()):
        j = np.nonzero((tl == lp).all(1))[0]
        if j.size:
            j = int(j[0])
            for f in ("launch_pos", "launch_vel", "launch_vspin"):
                np.testing.assert_array_equal(getattr(nat, f)[i].numpy(),
                                              getattr(tor, f)[j].numpy(), err_msg=f)
            assert float((nat.traj_pool[i] - tor.traj_pool[j]).abs().max()) < 2e-2
            matched += 1
    assert matched >= 0.95 * min(nat.pool_size, tor.pool_size)
    assert nat.traj_pool.dtype == torch.float32 and nat.device.type == "cpu"


def test_native_rejects_malformed_launches():
    """Shapes are checked before the arrays reach the library."""
    pos, vel, vspin = _launches(n=8)
    for bad in ((pos[:, :2], vel, vspin), (pos, vel[:4], vspin), (pos, vel, vspin[:, None])):
        with pytest.raises(ValueError):
            simulate_flight_native(*bad)
    with pytest.raises(ValueError):
        simulate_flight_native(pos, vel, vspin, num_frames=0)


def test_build_is_cached():
    """A second build reuses the library: same path, same mtime."""
    lib1 = build_library()
    mtime = os.path.getmtime(lib1)
    assert build_library() == lib1 and os.path.getmtime(lib1) == mtime
    assert lib1.endswith(os.path.join("build", "native", "libballsim.so"))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile: `backend="native"` raises with the
    compiler's message; nothing falls back to the torch integrator."""
    bad = tmp_path / "ballsim.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(ballsim, "SOURCE", bad)
    monkeypatch.setattr(ballsim, "LIBRARY", tmp_path / "build" / "libballsim.so")
    monkeypatch.setattr(ballsim, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TennisBallGenerator(num_candidates=16, backend="native", device="cpu")
    assert not (tmp_path / "build" / "libballsim.so").exists()


def test_pool_cli_file_read_by_jax(tmp_path, capsys):
    """`python -m vid2player3d_torch.tennis.pool --backend native`: its file
    is the native generator's pool, and the JAX package's `from_npz` reads
    it."""
    out = str(tmp_path / "pool.npz")
    assert pool.main(["--out", out, "--num_candidates", "512", "--seed", "3",
                      "--traj_length", "60", "--backend", "native", "--device", "cpu"]) == 0
    assert "native backend" in capsys.readouterr().out
    gen = TennisBallGenerator({"ball_traj_length": 60}, num_candidates=512, seed=3,
                              backend="native", device="cpu")
    j = JGen.from_npz(out)
    assert j.pool_size == gen.pool_size and j.traj_length == 60
    for f in ("traj_pool", "launch_pos", "launch_vel", "launch_vspin"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)), getattr(gen, f).numpy(),
                                      err_msg=f)
