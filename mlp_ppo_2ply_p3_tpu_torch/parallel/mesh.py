"""Data parallelism over ``torch.distributed``: the game batch split over
ranks, the train state replicated.

Port of ``mlp_ppo_2ply_p3_tpu/parallel/mesh.py``.  JAX runs one program
over a ``Mesh`` and lets GSPMD partition it; here one process runs per
rank, and a ``World`` (rank, size, device, backend) takes the place of
the mesh.  The game batch B splits into ``size`` contiguous shards of
B / size games: rank r holds games ``[r * B / size, (r + 1) * B /
size)``.  A sharded run computes the unsharded run's global
computation:

- every random tensor is drawn at its global shape from the same
  generator on every rank, and each rank keeps its rows
  (``shard_batch``), so the generators stay in lockstep and draw the
  unsharded run's stream;
- per-game work (features, the MLP, movegen with both kernels, the env
  step, GAE) runs on the rank's shard only; movegen's one batch-wide
  rule, the capacity of its doubles and non-doubles sub-batches (which
  binds at a reset, whose first rolls are all non-doubles), is the
  global batch's: two small gathers a call place each game
  (``core.movegen._global_fit``);
- the update gathers the rollout once (``gather_batch``), so each
  statistic over the (T, B) batch is computed on the same tensors as in
  the unsharded run; each rank takes its 1 / size of every global
  minibatch, and the gradients are summed over ranks (``all_reduce_sum``)
  before the clip by global norm and Adam, which then run identically on
  every rank.

Memory: after the gather every rank holds the unsharded run's rollout,
(T, B, 198) float32 observations and, in afterstate mode, (T, B, M, 52)
int8 afterstates (28 GB at T=128, B=16384, M=256).  The afterstates, most
of those bytes, are gathered into one buffer that is allocated once and
kept for the next gather of that shape (``gather_stacked``), every rank's
shard whole in rank order, (size, T, B / size, M, 52), read in place.

Backends are explicit and never chosen after a failure:

- ``nccl`` for ranks on CUDA devices, rank -> ``cuda:(LOCAL_RANK %
  device_count)``.  NCCL refuses two ranks on one device, and so does
  ``initialize_distributed``.
- ``gloo`` on the CPU, and for ranks that share one card.  The
  collectives here hand gloo host tensors only: a CUDA tensor is staged
  through host memory (copied out, reduced or gathered there, copied
  back to its device).
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils.profiling import span

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class World:
    rank: int
    size: int
    device: torch.device
    backend: str

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.size} ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


_world: World | None = None


def check_divisible(num_envs: int, t_horizon: int, num_minibatches: int,
                    size: int) -> None:
    """Raise unless B and the global minibatch split evenly over ``size``
    ranks.  JAX falls back to one device when they do not; processes
    that already share a run cannot, so the port refuses."""
    mb = num_envs * t_horizon // num_minibatches
    if num_envs % size or mb % size:
        raise ValueError(
            f"num_envs={num_envs} (minibatch {mb} = {num_envs} x "
            f"{t_horizon} / {num_minibatches}) must divide by the "
            f"{size} ranks: every rank holds B / {size} games and takes "
            f"1 / {size} of each minibatch")


def _map(fn, tree):
    """``fn`` over every tensor of a tensor or of nested tuples, lists
    and NamedTuples of them; None stays None."""
    if tree is None or isinstance(tree, torch.Tensor):
        return None if tree is None else fn(tree)
    items = [_map(fn, x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(
        items)


def shard_batch(tree, world: World | None, dim: int = 0):
    """This rank's rows (along ``dim``) of every tensor of ``tree``.  The
    identity without a world."""
    if world is None:
        return tree

    def rows(x):
        sl = world.rows(x.shape[dim])
        return x.narrow(dim, sl.start, sl.stop - sl.start)

    return _map(rows, tree)


def _comm_device(world: World) -> torch.device:
    """Where the backend takes tensors: the host for gloo, the rank's
    device for nccl."""
    return torch.device("cpu") if world.backend == "gloo" else world.device


def _to_comm(x: torch.Tensor, world: World) -> torch.Tensor:
    """``x`` contiguous on the backend's device; bool travels as uint8."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    return x.to(_comm_device(world)).contiguous()


def _from_comm(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(device=like.device, dtype=like.dtype)


def gather_batch(tree, world: World | None, dim: int = 0):
    """Every rank's rows of each tensor of ``tree``, concatenated along
    ``dim`` in rank order: the global batch, on every rank.  The inverse
    of ``shard_batch``; the identity without a world."""
    if world is None:
        return tree

    def gather(x):
        src = _to_comm(x, world)
        parts = [torch.empty_like(src) for _ in range(world.size)]
        dist.all_gather(parts, src)
        return _from_comm(torch.cat(parts, dim=dim), x)

    with span("gather_batch"):
        return _map(gather, tree)


def gather_stacked(x: torch.Tensor, world: World) -> torch.Tensor:
    """Every rank's ``x`` stacked along a new first axis in rank order,
    (size, *x.shape), in a buffer that this process allocates at the first
    gather of that shape, dtype and device and reuses at every later one:
    what it returns holds until the next such gather.  Nothing else is
    allocated (gloo: one host buffer too, kept the same way)."""
    with span("gather_batch"):
        src = _to_comm(x, world)
        comm = _kept_buffer("comm", (world.size, *src.shape), src.dtype,
                            src.device)
        dist.all_gather(list(comm.unbind(0)), src)
        if comm.device == x.device and comm.dtype == x.dtype:
            return comm
        out = _kept_buffer("out", comm.shape, x.dtype, x.device)
        return out.copy_(comm)


# gather_stacked's buffers, by (role, shape, dtype, device)
_KEPT: dict = {}


def _kept_buffer(role, shape, dtype, device) -> torch.Tensor:
    key = (role, tuple(shape), dtype, str(device))
    if key not in _KEPT:
        _KEPT[key] = torch.empty(shape, dtype=dtype, device=device)
    return _KEPT[key]


def all_reduce_sum(tensors, world: World | None) -> list:
    """Element-wise sums over the ranks of a list of tensors, each
    returned on its own device.  Tensors of one dtype travel as one flat
    buffer, so a list of gradients is one collective.  The identity
    without a world."""
    tensors = list(tensors)
    if world is None:
        return tensors
    with span("all_reduce_sum"):
        return _all_reduce_sum(tensors, world)


def _all_reduce_sum(tensors, world):
    out = [None] * len(tensors)
    by_dtype: dict = {}
    for i, x in enumerate(tensors):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = _to_comm(torch.cat([tensors[i].reshape(-1) for i in idx]),
                        world)
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = _from_comm(flat[off:off + n].reshape(tensors[i].shape),
                                tensors[i])
            off += n
    return out


def replicate(tensors, world: World | None):
    """Broadcast rank 0's ``tensors`` and check that they equal every
    rank's own: ranks start from one seed (or one checkpoint), so their
    train states must already agree.  Raises ``ValueError`` on every rank
    when one differs."""
    if world is None:
        return
    bad = 0
    for x in tensors:
        mine = _to_comm(x, world)
        theirs = mine.clone()
        dist.broadcast(theirs, src=0)
        bad += int(not torch.equal(mine, theirs))
    (bad,) = all_reduce_sum([torch.tensor([bad], dtype=torch.int64)], world)
    if int(bad):
        raise ValueError(f"{int(bad)} tensors of the train state differ "
                         f"between ranks: every rank must start from the "
                         f"same seed and checkpoint")


def broadcast_object(obj, world: World | None):
    """Rank 0's ``obj`` (picklable), on every rank."""
    if world is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=_comm_device(world))
    return box[0]


def refuse_shared_devices(world: World, group=None) -> None:
    """Raise on every rank when two ranks of ``group`` hold the same CUDA
    device of one host, which NCCL cannot serve."""
    me = (socket.gethostname(), str(world.device))
    peers = [None] * world.size
    dist.all_gather_object(peers, me, group=group)
    shared = sorted({f"{h} {d}" for h, d in peers
                     if peers.count((h, d)) > 1})
    if shared:
        raise ValueError(
            f"ranks share a device ({', '.join(shared)}): NCCL needs one "
            f"device per rank; pass backend='gloo' (--backend gloo) for "
            f"ranks sharing one card")


def _rank_device(dev: torch.device, local_rank: int) -> torch.device:
    if dev.type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def _check_backend(backend: str, dev: torch.device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: choose one of {BACKENDS}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend 'nccl' needs CUDA devices; the CPU runs "
                         "on 'gloo'")


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           device="cuda") -> World | None:
    """Join the process group of a multi-process run and return this
    rank's ``World``; None (a strict no-op) for one process.

    Explicit flags (the driver's ``--coordinator host:port
    --num-processes N --process-id R``) win and become
    ``init_process_group(init_method="tcp://host:port", world_size=N,
    rank=R)``.  With no flags, a launcher's environment is detected:
    ``torchrun`` sets ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and
    ``MASTER_ADDR``/``MASTER_PORT``, and a ``WORLD_SIZE`` above 1 joins
    with ``init_method="env://"``.  ``BG_NO_DIST_AUTODETECT=1`` opts out
    of the detection, as in the JAX package.

    ``backend`` defaults to ``nccl`` on CUDA and ``gloo`` on the CPU;
    ranks sharing one card must ask for ``gloo``.  The rank's device is
    ``cuda:(LOCAL_RANK % device_count)`` (``LOCAL_RANK`` defaults to the
    rank)."""
    global _world
    env = os.environ
    if num_processes is not None and num_processes > 1:
        if coordinator is None or process_id is None:
            raise ValueError("--num-processes > 1 needs --coordinator "
                             "host:port and --process-id")
        init = dict(init_method=f"tcp://{coordinator}",
                    world_size=num_processes, rank=process_id)
    elif env.get("BG_NO_DIST_AUTODETECT"):
        return None
    elif int(env.get("WORLD_SIZE", "1")) > 1:
        init = dict(init_method="env://", world_size=int(env["WORLD_SIZE"]),
                    rank=int(env["RANK"]))
    else:
        return None
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    _check_backend(backend, dev)
    local_rank = int(env.get("LOCAL_RANK", init["rank"]))
    dev = _rank_device(dev, local_rank)
    if backend == "nccl":
        local_size = int(env.get("LOCAL_WORLD_SIZE", "1"))
        if local_size > torch.cuda.device_count():
            raise ValueError(
                f"{local_size} ranks on a host with "
                f"{torch.cuda.device_count()} CUDA devices: NCCL needs one "
                f"device per rank; pass backend='gloo' for ranks sharing "
                f"one card")
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, **init)
    world = World(init["rank"], init["world_size"], dev, backend)
    if backend == "nccl":
        group = dist.new_group(backend="gloo")
        try:
            refuse_shared_devices(world, group)
        except ValueError:
            dist.destroy_process_group()
            raise
        dist.destroy_process_group(group)
    _world = world
    return world


def current_world(device="cuda") -> World | None:
    """This rank's ``World`` in the initialised default process group, or
    None when there is none."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if _world is not None:
        return _world
    rank = dist.get_rank()
    dev = _rank_device(resolve_device(device),
                       int(os.environ.get("LOCAL_RANK", rank)))
    return World(rank, dist.get_world_size(), dev, dist.get_backend())


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    global _world
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _world = None
