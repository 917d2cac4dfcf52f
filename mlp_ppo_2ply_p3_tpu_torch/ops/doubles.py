"""One level of movegen's doubles frontier: expand each frontier row by the
die, keep the expansions whose origin rank does not fall below the row's,
and stable-compact them into the next frontier.

``doubles_level`` ports the JAX package's doubles ``level``
(``mlp_ppo_2ply_p3_tpu/core/movegen.py:406-416``), which XLA fuses and
whose compaction is the Pallas ``compact_rows``
(``mlp_ppo_2ply_p3_tpu/ops/compaction.py:231``) under ``use_pallas``.  Its
kernel (``csrc/doubles.cu``) builds each row's candidates in registers
and shared memory, so the (G, K x 27, 53) candidate grid that the plain
version materialises never reaches device memory; the note at the top of
the source says what bounds it on an H100.

The candidate-grid helpers (``perm_scan``, ``expand_one_die``,
``rank_of``) live here, and ``core.movegen`` takes them from here for its
other paths.

The wrapper dispatches on the tensors' device: CPU tensors take the plain
PyTorch version, CUDA tensors launch the kernel or raise.  Its
``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import board as B
from . import compaction

I8 = torch.int8
I32 = torch.int32

# Candidate-slot grid per die: 24 point origins + bar + farthest
# bear-off + exact bear-off (see board.submoves_one_die).
NSLOT = 27


def _bcast(mask, x):
    """Right-pad a leading-axis mask with singleton dims to x's rank."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def perm_scan(x, mirror):
    """Reorder (G, ..., 27) per-slot arrays into each game's scan order:
    the reference scans point origins in ABSOLUTE ascending order for
    both players, so for player-2 games (``mirror``, (G,) bool) the first
    25 slots (points + bar) are flipped; the two bear-off slots stay
    last."""
    flipped = torch.cat([torch.flip(x[..., :25], dims=(-1,)), x[..., 25:]],
                        dim=-1)
    return torch.where(_bcast(mirror, x), flipped, x)


def expand_one_die(boards, valid, die, mirror):
    """Expand (G, K, 52) frontiers by one die: returns
    (after (G, K*NSLOT, 52), valid (G, K*NSLOT), origin (G, K*NSLOT)) over
    the dense candidate grid, iterated in scan order."""
    g, k = valid.shape
    v, o, d, h = (perm_scan(a, mirror)
                  for a in B.submoves_one_die(boards, die[:, None]))
    after = B.apply_submove(boards[:, :, None, :], o, d, h)  # (G,K,27,52)
    val = valid[:, :, None] & v
    return (after.reshape(g, k * NSLOT, 52), val.reshape(g, k * NSLOT),
            o.reshape(g, k * NSLOT))


def rank_of(origin):
    """Movement-direction rank of an origin (bar first)."""
    return torch.where(origin == B.ORIGIN_BAR, -1, origin)


def doubles_level_plain(boards, ranks, n_in, die, mirror, k_out: int):
    """Plain PyTorch level (any device): the dense candidate grid, the
    rank filter and ``compaction.compact_rows_plain`` over the boards and
    ranks catted into one int8 block, as the JAX ``level`` computes it."""
    g, k, _ = boards.shape
    if n_in is None:     # a root level: every row valid, no rank filter
        valid = torch.ones((g, k), dtype=torch.bool, device=boards.device)
    else:
        valid = (torch.arange(k, device=boards.device)[None, :]
                 < torch.clamp(n_in, max=k)[:, None])
    eb, ev, eo = expand_one_die(boards, valid, die.to(I32),
                                mirror.to(torch.bool))
    erank = rank_of(eo).to(I8)
    if ranks is not None:
        parent = ranks.to(I32).repeat_interleave(NSLOT, dim=1)
        ev = ev & (erank.to(I32) >= parent)
    block = torch.cat([eb, erank[:, :, None]], dim=2)
    out, n = compaction.compact_rows_plain(block, ev, k_out)
    return out[:, :, :52].contiguous(), out[:, :, 52].contiguous(), n


def _check(boards, ranks, n_in, die, mirror, k_out):
    if boards.dtype != I8 or boards.dim() != 3 or boards.shape[2] != 52:
        raise ValueError(f"boards must be (G, K, 52) int8, got "
                         f"{tuple(boards.shape)} {boards.dtype}")
    g, k, _ = boards.shape
    if (ranks is None) != (n_in is None):
        raise ValueError("ranks and n_in are both given, or both None for "
                         "a root level")
    want = {"ranks": (ranks, (g, k), (I8,)),
            "n_in": (n_in, (g,), (I32,)),
            "die": (die, (g,), (I32,)),
            "mirror": (mirror, (g,), (torch.bool, torch.uint8))}
    for name, (x, shape, dtypes) in want.items():
        if x is None and name in ("ranks", "n_in"):
            continue
        if x is None or tuple(x.shape) != shape or x.dtype not in dtypes:
            raise ValueError(
                f"{name} must be {shape} of {dtypes}, got "
                f"{None if x is None else (tuple(x.shape), x.dtype)}")
        if x.device != boards.device:
            raise ValueError(f"{name} is on {x.device}, boards on "
                             f"{boards.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not boards.is_contiguous():
        raise ValueError("boards must be contiguous")
    if k_out < 0:
        raise ValueError(f"k_out must be >= 0, got {k_out}")
    if max(g, k * 52, k_out * 52) >= 2**31:
        raise ValueError(f"shape {tuple(boards.shape)} -> {k_out} too large")
    if boards.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {boards.device}")


_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn():
    from .build import load

    fn = load("doubles").doubles_level_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_P] * 8 + [_I] * 3 + [_P], _I
    return fn


def doubles_level(boards, ranks, n_in, die, mirror, k_out: int):
    """One doubles frontier level for every game.

    Args:
      boards: (G, K, 52) int8 frontier, contiguous.
      ranks:  (G, K) int8 origin rank of each row's last submove.
      n_in:   (G,) int32 valid-row counts (row k is valid iff
              k < min(n_in, K)).  ``ranks`` and ``n_in`` both None: a
              root level, every row valid and no rank filter.
      die:    (G,) int32 die of each game, 0..6 (0 only on all-zero
              padding rows).
      mirror: (G,) bool or uint8: the game's mover is player 2 (scan
              order).
      k_out:  output width.

    Returns (boards_out (G, k_out, 52) int8, ranks_out (G, k_out) int8,
    n (G,) int32): the valid candidates in (row, scan position) order,
    zero past the count; n is unclamped and may exceed k_out.
    """
    _check(boards, ranks, n_in, die, mirror, k_out)
    if boards.device.type == "cpu":
        return doubles_level_plain(boards, ranks, n_in, die, mirror, k_out)
    g, k, _ = boards.shape
    dev = boards.device
    with torch.cuda.device(dev):
        out = torch.empty((g, k_out, 52), dtype=I8, device=dev)
        rout = torch.empty((g, k_out), dtype=I8, device=dev)
        n = torch.empty((g,), dtype=I32, device=dev)
        err = _fn()(
            boards.data_ptr(), None if ranks is None else ranks.data_ptr(),
            None if n_in is None else n_in.data_ptr(), die.data_ptr(),
            mirror.data_ptr(), out.data_ptr(), rout.data_ptr(),
            n.data_ptr(), g, k, k_out,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"doubles_level kernel launch failed: CUDA error "
                           f"{err} at shape {tuple(boards.shape)} -> {k_out}")
    _COUNTERS["doubles_level"].launches += 1
    return out, rout, n


doubles_level.launches = 0
# the function object that owns the count, so that a caller who wraps the
# wrapper (to capture its inputs) still counts on the original
_COUNTERS = {"doubles_level": doubles_level}
