"""The port's data-parallel helpers (``vid2player3d_torch/parallel``) against
the JAX package's mesh helpers, case for case with `tests/test_parallel.py`:
each rank's block of a sharded tree (the JAX array's shard on that device),
scalars and non-divisible leaves kept whole (replicated), `replicate` equal
to rank 0's values, `cross_shard_mean` (JAX's `pmean` under `shard_map`),
the mesh of a process group; and the port's own rules: `initialize_distributed`
a no-op without torchrun's variables, NCCL refused for ranks sharing a card
or on the CPU, every per-env draw of a sharded env the global draw's block.

Two gloo ranks on the CPU, started once for the module (rendezvous by a file
in a fresh temporary directory, a 120 s collective timeout).
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import torch_dp_workers as W
from vid2player3d_tpu import parallel as JPL
from vid2player3d_torch import parallel as PL
from vid2player3d_torch.data.synthetic import make_synthetic_motion_lib
from vid2player3d_torch.envs import HumanoidImEnv
from vid2player3d_torch.envs.presets import preset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks():
    return PL.spawn(W.mesh_helpers, 2, device="cpu", timeout_s=120.0)


@pytest.fixture(scope="module")
def jmesh():
    return JPL.data_parallel_mesh(2, devices=jax.devices("cpu"))


def _tree(r):
    return {"per_env": np.arange(16.0).reshape(16, 1) + 100 * r, "scalar": 2.0 + r,
            "table": np.arange(12.0).reshape(3, 4)}


def test_mesh_and_placement(ranks, jmesh):
    """Each rank holds its contiguous block of a divisible leaf: the JAX
    array's shard on device r. The scalar and the 3-row table (2 does not
    divide 3) stay whole, as JAX replicates them."""
    jt = JPL.shard_leading_axis({k: np.asarray(v, np.float32) for k, v in _tree(0).items()},
                                jmesh)
    shards = sorted(jt["per_env"].addressable_shards, key=lambda s: s.device.id)
    assert jt["scalar"].sharding.is_fully_replicated
    assert jt["table"].sharding.is_fully_replicated
    for r, out in enumerate(ranks):
        got = out["sharded"]
        np.testing.assert_array_equal(got["per_env"].numpy() - 100 * r,
                                      np.asarray(shards[r].data))
        assert float(got["scalar"]) == 2.0 + r
        np.testing.assert_array_equal(got["table"].numpy(), _tree(r)["table"])


def test_data_parallel_mesh_from_the_group(ranks):
    """Inside the ranks the mesh is the group's: dp 2, rank in order, gloo.
    Without a group only one rank exists, and it needs its device."""
    assert [(o["rank"], o["dp"], o["backend"]) for o in ranks] == [(0, 2, "gloo"),
                                                                   (1, 2, "gloo")]
    # asked for without a device, the group's mesh takes the one each rank pinned
    assert [o["default_device"] for o in ranks] == ["cpu", "cpu"]
    one = PL.data_parallel_mesh(1, device="cpu")
    assert (one.dp, one.rank, one.collective) == (1, 0, False)
    with pytest.raises(RuntimeError, match="needs a process group"):
        PL.data_parallel_mesh(2)
    with pytest.raises(ValueError, match="needs its device"):
        PL.data_parallel_mesh()


def test_replicate_is_rank0(ranks):
    """`replicate` gives every rank rank 0's values, dtypes kept."""
    for out in ranks:
        rep = out["replicated"]
        np.testing.assert_array_equal(rep["per_env"].numpy(), _tree(0)["per_env"])
        assert float(rep["scalar"]) == 2.0 and rep["per_env"].dtype == torch.float32


def test_cross_shard_mean_matches_pmean(ranks, jmesh):
    """The mean over the ranks, as JAX's `cross_shard_mean` (`pmean` inside
    `shard_map`) computes it; a bf16 leaf averages in f32 and stays bf16."""
    f = jax.shard_map(lambda x: JPL.cross_shard_mean(x), mesh=jmesh,
                      in_specs=PartitionSpec("data"), out_specs=PartitionSpec("data"))
    want = np.asarray(f(np.repeat(np.arange(2.0, dtype=np.float32)[:, None], 3, axis=1)))
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["mean"]["x"].numpy(), want[r])
        assert out["mean"]["h"].dtype == torch.bfloat16
        np.testing.assert_array_equal(out["mean"]["h"].float().numpy(), [1.5, 1.5])


def test_gather_and_sum(ranks):
    for out in ranks:
        np.testing.assert_array_equal(out["gathered"].numpy(), [[0.0, 0.0], [1.0, 10.0]])
        np.testing.assert_array_equal(out["summed"].numpy(), [2.0, 1.0])


def test_gloo_mesh_device_from_the_group(tmp_path):
    """A gloo group joined through `init_process_group` gives the mesh the
    device that call pinned; a gloo group joined by other means has no
    device to give, so a mesh without `device` raises instead of assuming
    the CPU."""
    import torch.distributed as dist

    rdv = "file://" + str(tmp_path / "rdv")
    assert PL.init_process_group(0, 1, rdv, device="cpu", timeout_s=60.0).type == "cpu"
    try:
        mesh = PL.data_parallel_mesh()
        assert (mesh.dp, mesh.backend, mesh.device) == (1, "gloo", torch.device("cpu"))
    finally:
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=rdv + "2", rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="pass the rank's device"):
            PL.data_parallel_mesh()
        assert PL.data_parallel_mesh(device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_initialize_distributed_noop_without_torchrun(monkeypatch):
    """Without torchrun's variables `initialize_distributed` joins nothing,
    as JAX's does without a coordinator address."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert PL.initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def test_nccl_refused_for_shared_ranks(tmp_path):
    """NCCL needs a card per rank: more ranks than visible cards raise with
    both counts (here no card at all), NCCL on the CPU raises, and nothing
    switches to gloo on its own."""
    cards = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"{cards + 1} ranks on {cards} visible card"):
        PL.init_process_group(0, cards + 1, "file://" + str(tmp_path / "rdv"), backend="nccl",
                              device="cuda:0")
    with pytest.raises(ValueError, match="only gloo"):
        PL.spawn(W.mesh_helpers, 2, backend="nccl", device="cpu")
    assert not torch.distributed.is_initialized()
    assert not os.path.exists(tmp_path / "rdv")


def test_env_shard_draws_are_global_blocks():
    """A sharded env holds its block of the per-env arrays, and every draw it
    makes is the block of the global draw: the reset times and the context
    corruption (amass_im_corrupt's) from a generator seeded alike equal the
    one-process env's rows, for both ranks."""
    lib = make_synthetic_motion_lib(num_motions=2, T=60, seed=0, device="cpu")
    # amass_im_corrupt's env: the reset also draws the context corruption
    env_cfg, _ = preset("amass_im_corrupt", num_envs=4, substeps=1)
    env = HumanoidImEnv(env_cfg, lib, device="cpu")
    _, _, ctx = env.reset_all(generator=torch.Generator().manual_seed(3))
    times = env.reset_all(generator=torch.Generator().manual_seed(3))[0].motion_times
    for r in range(2):
        mesh = PL.DataParallelMesh(dp=2, rank=r, device=torch.device("cpu"))
        sh = env.shard(mesh)
        assert (sh.cfg.num_envs, sh.shard_info.num_envs) == (2, 4)
        np.testing.assert_array_equal(sh.motion_ids.numpy(), W.rows(env.motion_ids.numpy(), r))
        np.testing.assert_array_equal(sh.model.body_mass.numpy(),
                                      W.rows(env.model.body_mass.numpy(), r))
        state, _, sctx = sh.reset_all(generator=torch.Generator().manual_seed(3))
        np.testing.assert_array_equal(state.motion_times.numpy(), W.rows(times.numpy(), r))
        for k in ("feat", "conf"):
            np.testing.assert_array_equal(sctx[k].numpy(), W.rows(ctx[k].numpy(), r))
        g = PL.draw_rows(sh.shard_info, (2, 3), lambda s: torch.arange(12.0).reshape(s))
        np.testing.assert_array_equal(g.numpy(), W.rows(np.arange(12.0).reshape(4, 3), r))
    with pytest.raises(ValueError, match="do not split"):
        env.shard(PL.DataParallelMesh(dp=3, rank=0, device=torch.device("cpu")))
