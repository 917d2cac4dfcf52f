"""Movegen's non-doubles batch: every legal afterstate of a non-double roll,
in the reference's order, for every game at once.

``nondoubles_batch`` ports the JAX package's ``_nondoubles_candidates`` and
``_nondoubles_batch`` (``mlp_ppo_2ply_p3_tpu/core/movegen.py:301-369``):
both die orders, the emission and max-submove rules, the raw compaction,
the first-occurrence dedup and the compaction into the M-wide list, which
XLA fuses around the Pallas ``compact_rows``
(``mlp_ppo_2ply_p3_tpu/ops/compaction.py:231``) under ``use_pallas``.  Its
kernel (``csrc/nondoubles.cu``) builds one game's candidates in registers
and shared memory, so neither the candidate grids nor the raw block that
the plain version materialises reaches device memory; the note at the top
of the source says what bounds it on an H100.

Given a ``place`` (the in-place form), the same kernel completes a whole
batch's (B, M, 52) list, whose doubles games' rows ``doubles_final`` has
written: each non-double game's list at its own row (the last fitting
non-double's where the game does not fit the non-doubles sub-batch's
capacity), the last fitting doubles game's row copied to each doubles
game past the doubles capacity, and the counts and flags of
``core.movegen.legal_afterstates_batch``.  That takes over the JAX
package's non-doubles split, its gather back and its selection
(``mlp_ppo_2ply_p3_tpu/core/movegen.py:576-614``), so no (B, M, 52) gather
or ``where`` runs around the kernel.

The wrapper dispatches on the tensors' device: CPU tensors take the plain
PyTorch version, CUDA tensors launch the kernel or raise.  Its
``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core import board as B
from . import compaction
from .doubles import NSLOT, expand_one_die, first_die

I8 = torch.int8
I32 = torch.int32


def _arange_lt(k, n):
    """(G, k) prefix mask: slot j < n[g]."""
    return torch.arange(k, device=n.device)[None, :] < n[:, None]


def one_order(vecs, d_first, d_second, k1, mirror):
    """One die order per game: returns (singles (G, k1, 52),
    singles_valid, pair_boards (G, k1*27, 52), pair_valid, has2 (G,))."""
    b1, v1, _ = first_die(vecs, d_first, mirror)
    b1c, n1 = compaction.compact_rows_plain(b1.contiguous(), v1, k1)
    v1c = _arange_lt(k1, n1)
    pair_b, pair_v, _ = expand_one_die(b1c, v1c, d_second, mirror)
    return b1c, v1c, pair_b, pair_v, pair_v.any(dim=1)


def candidates_plain(vecs, d_hi, d_lo, mirror, k1: int):
    """Per-game candidate blocks (G, 2*(k1*27 + k1), 52) in block order
    [A pairs, A singles, B pairs, B singles], and their flags with the
    emission rules and the max-submove filter applied (JAX
    ``_nondoubles_candidates``).  Both die orders run as one stacked (2G)
    batch."""
    g = vecs.shape[0]
    both = one_order(
        torch.cat([vecs, vecs]), torch.cat([d_hi, d_lo]),
        torch.cat([d_lo, d_hi]), k1, torch.cat([mirror, mirror]),
    )
    (a1b, b1b), (a1v, b1v), (a2b, b2b), (a2v, b2v), (has2_a, has2_b) = (
        (x[:g], x[g:]) for x in both
    )

    # skip the reversed order iff pass A yielded exactly one unique
    # single-submove move (distinct origins with one die always give
    # distinct boards, so the unique count is a plain popcount)
    not_a = torch.logical_not(has2_a)
    uniq_singles_a = (a1v & not_a[:, None]).sum(dim=1)
    run_b = torch.logical_not(not_a & (uniq_singles_a == 1))

    cand_boards = torch.cat([a2b, a1b, b2b, b1b], dim=1)
    cand_valid = torch.cat(
        [
            a2v & has2_a[:, None],
            a1v & not_a[:, None],
            b2v & (has2_b & run_b)[:, None],
            b1v & (torch.logical_not(has2_b) & run_b)[:, None],
        ],
        dim=1,
    )
    one = torch.cat([
        torch.full((k1 * NSLOT,), 2, dtype=I32, device=vecs.device),
        torch.full((k1,), 1, dtype=I32, device=vecs.device),
    ])
    seqlen = torch.cat([one, one])
    # max-submove filter before dedup: equal boards always have equal
    # submove counts, so the order of the two does not matter
    max_len = torch.where(cand_valid, seqlen, 0).amax(dim=1)
    keep0 = cand_valid & (seqlen[None, :] == max_len[:, None])
    return cand_boards, keep0


def raw_block_plain(vecs, d_hi, d_lo, mirror, k1: int, kd: int):
    """The first ``kd`` raw candidates of each game (G, kd, 52), their
    flags and the unclamped raw counts: what the dedup sees."""
    cand, keep0 = candidates_plain(vecs, d_hi, d_lo, mirror, k1)
    cb, n_raw = compaction.compact_rows_plain(cand, keep0, kd)
    return cb, _arange_lt(kd, torch.clamp(n_raw, max=kd)), n_raw


def nondoubles_batch_plain(vecs, d_hi, d_lo, mirror, k1: int, kd: int,
                           m: int, dedup: bool, place=None, out=None):
    """Plain PyTorch non-doubles batch (any device): the candidate blocks,
    ``compaction.compact_rows_plain`` and, with ``dedup``,
    ``compaction.dedup_compact_rows_plain``, as the JAX
    ``_nondoubles_batch`` computes it; with a ``place``,
    ``nondoubles_place_plain``."""
    if place is not None:
        return nondoubles_place_plain(vecs, d_hi, d_lo, mirror, k1, kd, m,
                                      dedup, place, out)
    d_hi, d_lo, mirror = d_hi.to(I32), d_lo.to(I32), mirror.to(torch.bool)
    if not dedup:
        cand, keep0 = candidates_plain(vecs, d_hi, d_lo, mirror, k1)
        lists, n = compaction.compact_rows_plain(cand, keep0, m)
        return lists, torch.clamp(n, max=m), n > m
    cb, kv, n_raw = raw_block_plain(vecs, d_hi, d_lo, mirror, k1, kd)
    lists, n = compaction.dedup_compact_rows_plain(cb, kv, m)
    return lists, torch.clamp(n, max=m), (n_raw > kd) | (n > m)


def nondoubles_place_plain(vecs, d_hi, d_lo, mirror, k1: int, kd: int,
                           m: int, dedup: bool, place, out):
    """Plain PyTorch in-place form (any device), into ``out``: each
    non-double game's row of ``nondoubles_batch_plain`` on the games that
    ``src`` names; a doubles game's row as it is (``doubles_final`` wrote
    it), or, past the doubles capacity, the row ``dst`` gives its slot;
    the counts and flags with the sub-batch capacity's and the game-over
    rules (``core.movegen.legal_afterstates_batch``'s gather and
    ``where``s).  Returns ``out`` with them."""
    src, fits, dst, db_n, db_of = place
    nd = src >= 0
    fits = fits.to(torch.bool)
    own = torch.arange(src.shape[0], device=src.device)
    rows = torch.where(nd, src.long(), own)
    lists, n, of = nondoubles_batch_plain(vecs[rows], d_hi[rows],
                                          d_lo[rows], mirror[rows], k1, kd,
                                          m, dedup)
    slot = torch.clamp(-1 - src.long(), min=0)
    from_row = dst.long()[slot]
    copy = ~nd & ~fits & (from_row >= 0)
    fill = out.index_select(0, from_row.clamp(min=0))
    out.copy_(torch.where(nd[:, None, None], lists,
                          torch.where(copy[:, None, None], fill, out)))
    n = torch.where(fits, torch.where(nd, n, db_n[slot]), 0)
    of = torch.where(nd, of, db_of[slot].to(torch.bool)) | ~fits
    return out, torch.where(B.game_over(vecs), 0, n), of


def _check(vecs, d_hi, d_lo, mirror, k1, kd, m):
    if vecs.dtype != I8 or vecs.dim() != 2 or vecs.shape[1] != B.VEC:
        raise ValueError(f"vecs must be (G, 52) int8, got "
                         f"{tuple(vecs.shape)} {vecs.dtype}")
    g = vecs.shape[0]
    want = {"d_hi": (d_hi, (I32,)), "d_lo": (d_lo, (I32,)),
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
    if k1 < 1 or kd < 0 or m < 0:
        raise ValueError(f"need k1 >= 1, kd >= 0, m >= 0; got {k1}, {kd}, "
                         f"{m}")
    if max(kd, m) > 65535 or g >= 2**31:
        raise ValueError(f"G={g}, widths kd {kd}, m {m}: too large")
    if vecs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vecs.device}")


def _check_place(vecs, m, place, out):
    if not isinstance(place, tuple) or len(place) != 5:
        raise ValueError("place must be (src, fits, dst, db_n, db_of)")
    src, fits, dst, db_n, db_of = place
    g = vecs.shape[0]
    if out is None or out.dtype != I8 or tuple(out.shape) != (g, m, B.VEC):
        raise ValueError(f"the in-place form needs out ({g}, {m}, 52) int8, "
                         f"got {None if out is None else tuple(out.shape)}")
    gd = dst.shape[0] if dst.dim() == 1 else -1
    want = {"src": (src, (g,), (I32,)),
            "fits": (fits, (g,), (torch.bool, torch.uint8)),
            "dst": (dst, (gd,), (I32,)),
            "db_n": (db_n, (gd,), (I32,)),
            "db_of": (db_of, (gd,), (torch.bool, torch.uint8))}
    for name, (x, shape, dtypes) in want.items():
        if tuple(x.shape) != shape or x.dtype not in dtypes:
            raise ValueError(f"{name} must be {shape} of {dtypes}, got "
                             f"{(tuple(x.shape), x.dtype)}")
    for name, x in (("src", src), ("fits", fits), ("dst", dst),
                    ("db_n", db_n), ("db_of", db_of), ("out", out)):
        if x.device != vecs.device:
            raise ValueError(f"{name} is on {x.device}, vecs on "
                             f"{vecs.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if gd < 1:
        raise ValueError("dst needs at least one slot")


_P, _I = ctypes.c_void_p, ctypes.c_int


def _fn():
    from .build import load

    fn = load("nondoubles").nondoubles_launch
    if fn.argtypes is None:
        fn.argtypes, fn.restype = [_P] * 12 + [_I] * 5 + [_P], _I
    return fn


def nondoubles_batch(vecs, d_hi, d_lo, mirror, k1: int, kd: int, m: int,
                     dedup: bool, place=None, out=None):
    """Every game's non-double move list.

    Args:
      vecs:   (G, 52) int8 canonical boards, contiguous.
      d_hi:   (G,) int32 die of order A's first submove, 0..6 (0 only on
              all-zero padding rows).
      d_lo:   (G,) int32 the other die.
      mirror: (G,) bool or uint8: the game's mover is player 2 (scan
              order).
      k1:     singles kept per die order (>= 1).
      kd:     raw candidates the dedup sees (``MovegenConfig.dedup_width``).
      m:      list width (``max_moves``).
      dedup:  False: the raw candidates straight into the list (duplicates
              remain).
      place:  None: game g's row is its own list.  Or the in-place form
              over a batch, (src (G,) int32, fits (G,) bool or uint8,
              dst (Gd,) int32, db_n (Gd,) int32, db_of (Gd,) bool or
              uint8), all contiguous: src[g] >= 0 makes game g's row the
              list of game src[g] (its dice and mirror flag too); src[g] <
              0 makes game g the doubles game of slot s = -1 - src[g],
              whose row ``doubles_final`` wrote, with count db_n[s] and
              flag db_of[s]; a game with fits[g] False gets n = 0 and the
              flag, and a doubles one the row dst[s] of ``out`` (the slot
              clamp); one whose mover has borne off 15 checkers n = 0.
              Every src[g] must lie in [-Gd, G).
      out:    the in-place form's (G, m, 52) int8 list, contiguous, which
              ``doubles_final`` has written the doubles games' rows of.

    Returns (out (G, m, 52) int8, n (G,) int32 clamped to m, overflow (G,)
    bool), equal to ``nondoubles_batch_plain``.
    """
    _check(vecs, d_hi, d_lo, mirror, k1, kd, m)
    if place is not None:
        _check_place(vecs, m, place, out)
    elif out is not None:
        raise ValueError("out is the in-place form's: give a place")
    if vecs.device.type == "cpu":
        return nondoubles_batch_plain(vecs, d_hi, d_lo, mirror, k1, kd, m,
                                      dedup, place, out)
    g = vecs.shape[0]
    dev = vecs.device
    ptrs = ((None,) * 5 if place is None
            else tuple(x.data_ptr() for x in place))
    with torch.cuda.device(dev):
        if out is None:
            out = torch.empty((g, m, 52), dtype=I8, device=dev)
        n = torch.empty((g,), dtype=I32, device=dev)
        overflow = torch.empty((g,), dtype=torch.bool, device=dev)
        err = _fn()(
            vecs.data_ptr(), d_hi.data_ptr(), d_lo.data_ptr(),
            mirror.data_ptr(), *ptrs, out.data_ptr(), n.data_ptr(),
            overflow.data_ptr(), g, k1, kd, m, int(dedup),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"nondoubles kernel launch failed: CUDA error "
                           f"{err} at G={g}, k1 {k1}, kd {kd}, m {m}, "
                           f"dedup {dedup} (shared memory: 4 games a block, "
                           f"{8 if dedup else 4} bytes a listed candidate "
                           f"and 56 a kept single a game)")
    _COUNTERS["nondoubles"].launches += 1
    return out, n, overflow


nondoubles_batch.launches = 0
# the function object that owns the count, so that a caller who wraps the
# wrapper (to capture its inputs) still counts on the original
_COUNTERS = {"nondoubles": nondoubles_batch}
