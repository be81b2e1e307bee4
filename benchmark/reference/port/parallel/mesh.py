"""Data parallelism over ``torch.distributed`` (counterpart of
``vid2player3d_tpu/parallel/mesh.py``).

One process per rank: each rank owns a contiguous block of the envs, the
params and the optimizer state are replicated, and the collectives JAX's SPMD
partitioner inserts are written out here. A `DataParallelMesh` names the
process group, the world size `dp`, this process's `rank` and its device.

Backends, never switched silently:
- ``nccl`` when every rank has a card of its own;
- ``gloo`` on the CPU;
- ranks that share one card pass ``backend="gloo"``; asking for NCCL there
  raises. Gloo's collectives run on host copies of CUDA tensors.

Every group is created with a finite timeout, so a dead rank fails the run
instead of hanging it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks before the run fails
DEFAULT_TIMEOUT_S = 600.0

# the default group `init_process_group` joined and the device it pinned
_pinned: tuple = (None, None)


@dataclasses.dataclass(frozen=True)
class DataParallelMesh:
    """A 1-D data-parallel mesh: `dp` ranks, this process's `rank` and
    `device`, the process group (None at world size 1 without one) and its
    backend."""
    dp: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None

    @property
    def collective(self) -> bool:
        """Whether the collectives go through a process group (also at world
        size 1, where they are that backend's no-op round trip)."""
        return self.group is not None


def _resolve_backend(backend: Optional[str], device: torch.device, ranks_here: int) -> str:
    """The backend for `ranks_here` ranks of one host on `device`'s kind."""
    if device.type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"backend {backend!r} on the CPU: only gloo runs there")
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"no data-parallel backend for device {device}")
    if backend == "gloo":
        return "gloo"
    if backend not in (None, "nccl"):
        raise ValueError(f"unknown backend {backend!r}")
    cards = torch.cuda.device_count()
    if ranks_here > cards:
        raise RuntimeError(
            f"{ranks_here} ranks on {cards} visible card(s): NCCL needs a card per rank; "
            "ranks that share a card must pass backend='gloo'")
    return "nccl"


def init_process_group(rank: int, world_size: int, init_method: str,
                       backend: Optional[str] = None, device=None,
                       timeout_s: float = DEFAULT_TIMEOUT_S, local_rank: Optional[int] = None,
                       ranks_here: Optional[int] = None) -> torch.device:
    """Join the default process group as `rank` of `world_size` and pin this
    process to its device; returns the device. `device` defaults to card
    `local_rank` (NCCL) and must be given for the CPU or for ranks sharing a
    card (gloo)."""
    local_rank = rank if local_rank is None else local_rank
    ranks_here = world_size if ranks_here is None else ranks_here
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "ranks on the CPU")
        device = torch.device("cuda", local_rank)
    device = torch.device(device)
    backend = _resolve_backend(backend, device, ranks_here)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local_rank if backend == "nccl" else 0)
        if backend == "nccl" and device.index != local_rank:
            raise RuntimeError(f"NCCL rank {rank} on {device}: each rank takes its own card "
                               f"(cuda:{local_rank})")
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    global _pinned
    _pinned = (dist.group.WORLD, device)
    return device


def initialize_distributed(backend: Optional[str] = None, device=None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the group from torchrun's variables (`RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`); returns whether it joined.
    A no-op without them, or when this process has joined already."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    init_process_group(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://",
                       backend=backend, device=device, timeout_s=timeout_s, local_rank=local,
                       ranks_here=int(os.environ.get("LOCAL_WORLD_SIZE",
                                                     os.environ["WORLD_SIZE"])))
    return True


def data_parallel_mesh(n_devices: Optional[int] = None, backend: Optional[str] = None,
                       device=None) -> DataParallelMesh:
    """The mesh over the default process group (all of its ranks). Without a
    group only a world of one exists: `n_devices` None or 1 gives a mesh of
    one rank with no collectives. `backend` and `device`, when given, must be
    the group's and this rank's; `device` defaults to the one
    `init_process_group` pinned, and to the current card under NCCL."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(f"a mesh of {n_devices} ranks needs a process group: start the "
                               "ranks with torchrun or parallel.spawn")
        if device is None:
            raise ValueError("a mesh of one rank without a process group needs its device")
        return DataParallelMesh(dp=1, rank=0, device=torch.device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise RuntimeError(f"asked for {n_devices} ranks, the process group has {world}")
    got = dist.get_backend()
    if backend is not None and backend != got:
        raise RuntimeError(f"asked for backend {backend!r}, the process group runs {got!r}")
    if device is None:
        group, pinned = _pinned
        if group is dist.group.WORLD:
            device = pinned
        elif got == "nccl":
            device = torch.device("cuda", torch.cuda.current_device())
        else:
            raise ValueError(f"a {got} group joined outside init_process_group: pass the "
                             "rank's device")
    return DataParallelMesh(dp=world, rank=rank, device=torch.device(device), backend=got,
                            group=dist.group.WORLD)


# -- trees ---------------------------------------------------------------------

def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply `fn` to every tensor leaf of dicts, lists, tuples and
    dataclasses; other leaves are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, v) for v in tree)
    if hasattr(tree, "_fields"):                      # namedtuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(lambda t: out.append(t) or t, tree)
    return out


# -- placement ---------------------------------------------------------------------

def block(n: int, mesh: DataParallelMesh) -> slice:
    """This rank's contiguous block [r·n/D, (r+1)·n/D) of `n` rows."""
    if n % mesh.dp:
        raise ValueError(f"{n} rows do not split over {mesh.dp} ranks")
    m = n // mesh.dp
    return slice(mesh.rank * m, (mesh.rank + 1) * m)


def shard_leading_axis(tree: Any, mesh: DataParallelMesh) -> Any:
    """This rank's contiguous block of every leaf's leading axis. Scalars and
    leaves whose leading size `dp` does not divide (shared tables) are kept
    whole, as the JAX helper replicates them."""
    def take(x):
        if x.dim() == 0 or x.shape[0] % mesh.dp:
            return x
        return x[block(x.shape[0], mesh)]

    return tree_map(take, tree)


def _collective(t: torch.Tensor, mesh: DataParallelMesh, op: Callable[[torch.Tensor], Any]
                ) -> torch.Tensor:
    """Run the in-place collective `op` on `t`; under gloo a CUDA tensor goes
    through a host copy. Returns the result on `t`'s device."""
    if mesh.backend == "gloo" and t.device.type != "cpu":
        h = t.detach().cpu()
        op(h)
        return h.to(t.device)
    op(t)
    return t


def all_reduce_sum(t: torch.Tensor, mesh: Optional[DataParallelMesh]) -> torch.Tensor:
    """The elementwise sum of `t` over the ranks (a new tensor; `t` itself
    unchanged). Without collectives, `t`."""
    if mesh is None or not mesh.collective:
        return t
    return _collective(t.detach().clone(), mesh,
                       lambda x: dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group))


def all_gather_rows(x: torch.Tensor, mesh: Optional[DataParallelMesh]) -> torch.Tensor:
    """Every rank's `x` stacked along a new leading rank axis, in rank order
    (all ranks pass the same shape). Without collectives, `x[None]`."""
    if mesh is None or not mesh.collective:
        return x[None]
    x = x.detach().contiguous()
    dev = x.device
    if mesh.backend == "gloo" and dev.type != "cpu":
        x = x.cpu()
    out = [torch.empty_like(x) for _ in range(mesh.dp)]
    dist.all_gather(out, x, group=mesh.group)
    return torch.stack(out).to(dev)


def replicate(tree: Any, mesh: Optional[DataParallelMesh]) -> Any:
    """Every tensor leaf set to rank 0's values (a broadcast per leaf; leaves
    keep their dtype, device and requires_grad)."""
    if mesh is None or not mesh.collective:
        return tree

    def bcast(x):
        y = _collective(x.detach().clone(), mesh,
                        lambda h: dist.broadcast(h, src=0, group=mesh.group))
        return y.requires_grad_(x.requires_grad)

    return tree_map(bcast, tree)


def flat_all_reduce(tensors: Sequence[torch.Tensor], mesh: DataParallelMesh,
                    mean: bool = False) -> List[torch.Tensor]:
    """Sum (or mean) over the ranks of a list of tensors in one flat float32
    bucket: one collective whatever the number of tensors. Returns new
    tensors of the inputs' shapes and dtypes."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    flat = all_reduce_sum(flat, mesh)
    if mean:
        flat = flat / mesh.dp
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[o:o + n].reshape(t.shape).to(t.dtype))
        o += n
    return out


def cross_shard_mean(tree: Any, mesh: Optional[DataParallelMesh]) -> Any:
    """The mean of every tensor leaf over the ranks, accumulated in float32
    and cast back to the leaf's dtype (one flat collective for the tree)."""
    if mesh is None or not mesh.collective:
        return tree
    leaves = tree_leaves(tree)
    it = iter(flat_all_reduce(leaves, mesh, mean=True))
    return tree_map(lambda _: next(it), tree)


def barrier(mesh: Optional[DataParallelMesh]) -> None:
    if mesh is not None and mesh.collective:
        if mesh.backend == "nccl":
            dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
        else:
            dist.barrier(group=mesh.group)


# -- env blocks ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EnvShard:
    """A sharded env's place in the global batch: `num_envs` envs in all,
    this rank's block `rows`. Every random draw of the env is made at the
    global size from the generator all ranks seed alike, and the block kept,
    so D ranks step exactly the envs one process would."""
    mesh: DataParallelMesh
    num_envs: int

    def __post_init__(self):
        if self.num_envs % self.mesh.dp:
            raise ValueError(f"{self.num_envs} envs do not split over {self.mesh.dp} ranks")

    @property
    def rows(self) -> slice:
        return block(self.num_envs, self.mesh)

    def take(self, x):
        """This rank's rows of a global (num_envs, ...) draw."""
        return x[self.rows]


def global_rows(shard: Optional[EnvShard], x):
    """This rank's rows of a global per-env draw; `x` itself when unsharded."""
    return x if shard is None else shard.take(x)


def draw_rows(shard: Optional[EnvShard], shape, fn: Callable):
    """`fn(shape)` for a per-env draw of (n, ...) rows: with a shard, drawn
    at the global (num_envs, ...) and this rank's rows kept."""
    if shard is None:
        return fn(tuple(shape))
    return shard.take(fn((shard.num_envs,) + tuple(shape[1:])))


# -- launching ranks ---------------------------------------------------------------

def _rank_entry(rank: int, fn: Callable, world_size: int, init_method: str,
                backend: Optional[str], device, timeout_s: float, out_dir: str,
                args: tuple) -> None:
    dev = init_process_group(rank, world_size, init_method, backend=backend, device=device,
                             timeout_s=timeout_s)
    if dev.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    try:
        result = fn(data_parallel_mesh(world_size, device=dev), *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args: tuple = (), backend: Optional[str] = None,
          device=None, init_method: Optional[str] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run `fn(mesh, *args)` in `nprocs` new processes, one rank each, and
    return their results in rank order (each saved with `torch.save`, read
    back on the CPU). A rank that raises makes this raise. Rendezvous is a
    file in a fresh temporary directory unless `init_method` is given.

    `fn` must be importable by name (a module-level function). `device`:
    None gives rank r card r over NCCL; "cpu" gloo ranks on the CPU; a card
    shared by every rank needs `backend="gloo"`."""
    import torch.multiprocessing as mp

    # refused here, before any process starts
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "ranks on the CPU")
    _resolve_backend(backend, dev, nprocs)
    tmp = tempfile.mkdtemp(prefix="v2p_dp_")
    try:
        init = init_method or "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(_rank_entry, args=(fn, nprocs, init, backend, device, timeout_s, tmp, args),
                 nprocs=nprocs, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
