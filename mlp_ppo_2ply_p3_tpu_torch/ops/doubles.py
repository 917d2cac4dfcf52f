"""Movegen's doubles frontier: each level expands every frontier row by
the die, keeps the expansions whose origin rank does not fall below the
row's, and stable-compacts them into the next frontier; the fourth level
also writes the final move list.

``doubles_levels`` ports the JAX package's first three doubles levels
(``first`` and its compaction, and two calls of its ``level``,
``mlp_ppo_2ply_p3_tpu/core/movegen.py:395-419``), which XLA fuses and whose
compactions are the Pallas ``compact_rows``
(``mlp_ppo_2ply_p3_tpu/ops/compaction.py:231``) under ``use_pallas``.  Its
kernel (``csrc/doubles.cu``) runs L1, L2 and L3 of a game in one block,
with L1 and L2 in shared memory as the next level's input, so neither the
(G, K x 27, 53) candidate grids that the plain version materialises nor a
frontier read back between levels touches device memory; the note at the
top of the source says what bounds it on an H100.

``doubles_final`` is the fourth level together with the selection after it
(``mlp_ppo_2ply_p3_tpu/core/movegen.py:420``, ``:422-439``): the deepest
non-empty level is the list.  Its kernel, in the same source, writes the
list, its counts and overflow flags in the launch that expands L3, so no
(G, M, 52) embedding of an earlier level is built.  In place (``out`` and
``dst``), as ``core.movegen.legal_afterstates_batch`` calls it, each slot's
list goes straight to its game's row of the batch's (B, M, 52) output, so
no doubles list of its own is allocated either.

The candidate-grid helpers (``perm_scan``, ``first_die``,
``expand_one_die``, ``rank_of``) and the plain level
(``doubles_level_plain``) live here, and ``core.movegen`` and
``ops.nondoubles`` take them from here.

Each wrapper dispatches on the tensors' device: CPU tensors take the plain
PyTorch version, CUDA tensors launch the kernel or raise.  Their
``launches`` attributes count kernel launches (``doubles_levels`` under
the key ``doubles_level``).
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


def first_die(vecs, die, mirror):
    """One die from (G, 52) boards: (afterstates (G, 27, 52), valid
    (G, 27), origin (G, 27)) in scan order."""
    v, o, d, h = (perm_scan(a, mirror)
                  for a in B.submoves_one_die(vecs, die))
    return B.apply_submove(vecs[:, None, :], o, d, h), v, o


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


def doubles_levels_plain(vecs, die, mirror, k1: int, k2: int, k3: int):
    """Plain PyTorch first three levels (any device): three
    ``doubles_level_plain`` calls, the first on the roots as a one-row
    frontier with no rank filter.  Returns (f1b, n1, f2b, n2, f3b, f3r,
    n3): each level's frontier (zeros past its count) and unclamped
    count, and L3's ranks."""
    d, mi = die.to(I32), mirror.to(torch.bool)
    f1b, f1r, n1 = doubles_level_plain(vecs[:, None, :], None, None, d, mi,
                                       k1)
    f2b, f2r, n2 = doubles_level_plain(f1b, f1r, n1, d, mi, k2)
    f3b, f3r, n3 = doubles_level_plain(f2b, f2r, n2, d, mi, k3)
    return f1b, n1, f2b, n2, f3b, f3r, n3


def embed(boards, n, m):
    """Place (G, K, 52) frontiers into (G, M, 52) buffers (truncating if
    K > M), with the counts clamped to M (JAX ``_embed``)."""
    k = min(boards.shape[1], m)
    out = boards.new_zeros((boards.shape[0], m, 52))
    out[:, :k] = boards[:, :k]
    return out, torch.clamp(n, max=m)


def doubles_final_plain(f1b, n1, f2b, n2, f3b, f3r, n3, die, mirror,
                        m: int, out=None, dst=None):
    """Plain PyTorch fourth level and final list (any device):
    ``doubles_level_plain`` from L3 into M rows, then the JAX selection
    (``_doubles_batch``'s tail): the deepest non-empty level, embedded
    into M rows; its count clamped to M; the five-term overflow flag
    with K2 and K3 the widths of ``f2b`` and ``f3b``.  With ``dst``, slot
    g's list goes to row ``dst[g]`` of ``out`` (none where it is -1, whose
    count and flag are 0), and ``out`` is returned."""
    f4b, _, n4 = doubles_level_plain(f3b, f3r, n3, die, mirror, m)
    k2, k3 = f2b.shape[1], f3b.shape[1]
    has2, has3, has4 = n2 > 0, n3 > 0, n4 > 0
    l1b, l1n = embed(f1b, n1, m)
    l2b, l2n = embed(f2b, n2, m)
    l3b, l3n = embed(f3b, n3, m)
    w4, w3, w2 = (h[:, None, None] for h in (has4, has3, has2))
    lists = torch.where(w4, f4b,
                        torch.where(w3, l3b, torch.where(w2, l2b, l1b)))
    n = torch.where(has4, n4,
                    torch.where(has3, l3n, torch.where(has2, l2n, l1n)))
    not4, not3 = torch.logical_not(has4), torch.logical_not(has3)
    overflow = (
        (has2 & (n2 > k2))
        | (has3 & (n3 > k3))
        | (has4 & (n4 > m))
        | (not4 & has3 & (n3 > m))
        | (not3 & has2 & (n2 > m))
    )
    n = torch.clamp(n, max=m)
    if dst is None:
        return lists, n, overflow
    if dst.numel() and (int(dst.min()) < -1
                        or int(dst.max()) >= out.shape[0]):
        raise IndexError(f"dst holds a row outside [-1, {out.shape[0]})")
    filled = dst >= 0
    out[dst[filled].long()] = lists[filled]
    return out, torch.where(filled, n, 0), overflow & filled


def _check_frontier(boards, ranks, n_in, die, mirror, k_out):
    """A level's inputs: a (G, K, 52) frontier with its ranks and counts."""
    if boards.dtype != I8 or boards.dim() != 3 or boards.shape[2] != 52:
        raise ValueError(f"boards must be (G, K, 52) int8, got "
                         f"{tuple(boards.shape)} {boards.dtype}")
    g, k, _ = boards.shape
    want = {"ranks": (ranks, (g, k), (I8,)),
            "n_in": (n_in, (g,), (I32,)),
            "die": (die, (g,), (I32,)),
            "mirror": (mirror, (g,), (torch.bool, torch.uint8))}
    for name, (x, shape, dtypes) in want.items():
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


def _check_levels(vecs, die, mirror, k1, k2, k3):
    if vecs.dtype != I8 or vecs.dim() != 2 or vecs.shape[1] != B.VEC:
        raise ValueError(f"vecs must be (G, 52) int8, got "
                         f"{tuple(vecs.shape)} {vecs.dtype}")
    g = vecs.shape[0]
    want = {"die": (die, (I32,)),
            "mirror": (mirror, (torch.bool, torch.uint8))}
    for name, (x, dtypes) in want.items():
        if tuple(x.shape) != (g,) or x.dtype not in dtypes:
            raise ValueError(f"{name} must be ({g},) of {dtypes}, got "
                             f"{(tuple(x.shape), x.dtype)}")
        if x.device != vecs.device:
            raise ValueError(f"{name} is on {x.device}, vecs on "
                             f"{vecs.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not vecs.is_contiguous():
        raise ValueError("vecs must be contiguous")
    if min(k1, k2, k3) < 0:
        raise ValueError(f"widths must be >= 0, got {k1}, {k2}, {k3}")
    if max(g, k1 * 52, k2 * 52, k3 * 52) >= 2**31:
        raise ValueError(f"G={g}, widths {k1}, {k2}, {k3}: too large")
    if vecs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vecs.device}")


def _check_final(f1b, n1, f2b, n2, f3b, f3r, n3, die, mirror, m, out,
                 dst):
    _check_frontier(f3b, f3r, n3, die, mirror, m)
    g = f3b.shape[0]
    for name, fb, n in (("f1b", f1b, n1), ("f2b", f2b, n2)):
        if (fb.dtype != I8 or fb.dim() != 3 or fb.shape[0] != g
                or fb.shape[2] != 52):
            raise ValueError(f"{name} must be ({g}, K, 52) int8, got "
                             f"{tuple(fb.shape)} {fb.dtype}")
        if tuple(n.shape) != (g,) or n.dtype != I32:
            raise ValueError(f"the count of {name} must be ({g},) int32, "
                             f"got {(tuple(n.shape), n.dtype)}")
        for x in (fb, n):
            if x.device != f3b.device:
                raise ValueError(f"{name} is on {x.device}, f3b on "
                                 f"{f3b.device}")
            if not x.is_contiguous():
                raise ValueError(f"{name} and its count must be contiguous")
        if fb.shape[1] * 52 >= 2**31:
            raise ValueError(f"{name} {tuple(fb.shape)} too large")
    if (out is None) != (dst is None):
        raise ValueError("the in-place form needs both out and dst")
    if dst is None:
        return
    if tuple(dst.shape) != (g,) or dst.dtype != I32:
        raise ValueError(f"dst must be ({g},) int32, got "
                         f"{(tuple(dst.shape), dst.dtype)}")
    if out.dtype != I8 or out.dim() != 3 or tuple(out.shape[1:]) != (m, 52):
        raise ValueError(f"out must be (B, {m}, 52) int8, got "
                         f"{tuple(out.shape)} {out.dtype}")
    for name, x in (("dst", dst), ("out", out)):
        if x.device != f3b.device:
            raise ValueError(f"{name} is on {x.device}, f3b on "
                             f"{f3b.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out.shape[0] >= 2**31:
        raise ValueError(f"out {tuple(out.shape)} too large")


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "doubles_levels_launch": ([_P] * 10 + [_I] * 4 + [_P], _I),
    "doubles_final_launch": ([_P, _P, _I, _P, _P, _I, _P, _P, _P, _I]
                             + [_P] * 4 + [_I] + [_P] * 2 + [_I] * 2 + [_P],
                             _I),
}


def _fn(name):
    from .build import load

    fn = getattr(load("doubles"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _SIGNATURES[name]
    return fn


def doubles_levels(vecs, die, mirror, k1: int, k2: int, k3: int):
    """The first three doubles frontier levels for every game, in one
    launch.

    Args:
      vecs:   (G, 52) int8 canonical root boards, contiguous.
      die:    (G,) int32 die of each game, 0..6 (0 only on all-zero
              padding rows).
      mirror: (G,) bool or uint8: the game's mover is player 2 (scan
              order).
      k1, k2, k3: the widths of L1, L2 and L3.

    Returns (f1b (G, k1, 52), n1 (G,), f2b (G, k2, 52), n2, f3b (G, k3, 52),
    f3r (G, k3) int8, n3): each level's valid candidates in (row, scan
    position) order, zero past the count; the counts are int32 and
    unclamped (they may exceed the width), L3's origin ranks beside it;
    equal to ``doubles_levels_plain``.
    """
    _check_levels(vecs, die, mirror, k1, k2, k3)
    if vecs.device.type == "cpu":
        return doubles_levels_plain(vecs, die, mirror, k1, k2, k3)
    g = vecs.shape[0]
    dev = vecs.device
    with torch.cuda.device(dev):
        f1b, f2b, f3b = (torch.empty((g, k, 52), dtype=I8, device=dev)
                         for k in (k1, k2, k3))
        f3r = torch.empty((g, k3), dtype=I8, device=dev)
        n1, n2, n3 = (torch.empty((g,), dtype=I32, device=dev)
                      for _ in range(3))
        err = _fn("doubles_levels_launch")(
            vecs.data_ptr(), die.data_ptr(), mirror.data_ptr(),
            f1b.data_ptr(), n1.data_ptr(), f2b.data_ptr(), n2.data_ptr(),
            f3b.data_ptr(), f3r.data_ptr(), n3.data_ptr(), g, k1, k2, k3,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"doubles_levels kernel launch failed: CUDA error {err} at G={g}, "
            f"widths {k1}, {k2}, {k3} (shared memory: 53 bytes x "
            f"(min(k1, 27) + k2) + 4 x max(k1, k2, k3) a block)")
    _COUNTERS["doubles_level"].launches += 1
    return f1b, n1, f2b, n2, f3b, f3r, n3


def doubles_final(f1b, n1, f2b, n2, f3b, f3r, n3, die, mirror, m: int,
                  out=None, dst=None):
    """The fourth doubles level and the final move list, for every game.

    Args:
      f1b, f2b: (G, K1, 52) and (G, K2, 52) int8 L1 and L2 frontiers.
      n1, n2:   (G,) int32 their unclamped counts.
      f3b, f3r, n3: the L3 frontier (G, K3, 52), its ranks (G, K3) int8
              and its unclamped counts (G,) int32, as ``doubles_levels``
              returns them.
      die, mirror: as ``doubles_levels``'s.
      m:        list width (``max_moves``).
      out, dst: None: the lists are a new (G, m, 52) tensor.  Or the
              in-place form: slot g's list goes to row ``dst[g]`` of
              ``out`` ((B, m, 52) int8, contiguous; ``dst`` (G,) int32,
              contiguous, its rows in [0, B) and distinct), none where
              ``dst[g]`` is -1; no other row of ``out`` is written.  A
              row outside [-1, B) raises ``IndexError`` on the CPU and
              fails the launch on the card (a sticky CUDA error, as
              torch's device-side index asserts), writing nothing.

    Returns (lists, n (G,) int32 clamped to m, overflow (G,) bool), equal
    to ``doubles_final_plain``: the deepest non-empty level's first
    min(K, m) rows, then zeros; ``lists`` is ``out`` in the in-place
    form, where an empty slot's count and flag are 0.
    """
    _check_final(f1b, n1, f2b, n2, f3b, f3r, n3, die, mirror, m, out, dst)
    if f3b.device.type == "cpu":
        return doubles_final_plain(f1b, n1, f2b, n2, f3b, f3r, n3, die,
                                   mirror, m, out, dst)
    g = f3b.shape[0]
    dev = f3b.device
    with torch.cuda.device(dev):
        if out is None:
            out = torch.empty((g, m, 52), dtype=I8, device=dev)
        n = torch.empty((g,), dtype=I32, device=dev)
        overflow = torch.empty((g,), dtype=torch.bool, device=dev)
        err = _fn("doubles_final_launch")(
            f1b.data_ptr(), n1.data_ptr(), f1b.shape[1], f2b.data_ptr(),
            n2.data_ptr(), f2b.shape[1], f3b.data_ptr(), f3r.data_ptr(),
            n3.data_ptr(), f3b.shape[1], die.data_ptr(), mirror.data_ptr(),
            None if dst is None else dst.data_ptr(), out.data_ptr(),
            out.shape[0], n.data_ptr(), overflow.data_ptr(), g, m,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"doubles_final kernel launch failed: CUDA error "
                           f"{err} at shape {tuple(f3b.shape)} -> {m}")
    _COUNTERS["doubles_final"].launches += 1
    return out, n, overflow


doubles_levels.launches = 0
doubles_final.launches = 0
# the function objects that own the counts, so that a caller who wraps a
# wrapper (to capture its inputs) still counts on the original
_COUNTERS = {"doubles_level": doubles_levels, "doubles_final": doubles_final}
