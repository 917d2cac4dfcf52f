"""Fixed-shape legal-move enumerator (the rules hot path), batched torch.

Port of ``mlp_ppo_2ply_p3_tpu/core/movegen.py``.  Every function here is
written over an explicit leading game axis instead of under ``vmap``;
shapes are static (width caps + overflow flags), so the main path needs
no host synchronisation and truncates exactly where the JAX package does.

- A *full move* is represented by its **afterstate board** (canonical
  frame, see ``core.board``).
- Non-doubles: both die orders are expanded as dense ``(k1, 27)``
  candidate grids; singles are emitted only when that order admits no
  two-submove sequence, the reversed order is skipped iff the first pass
  yielded exactly one unique single, duplicates are removed by
  first-occurrence in generation order and the max-submove filter is
  applied.
- Doubles: breadth-first frontier expansion to depth 4 restricted to
  non-decreasing origin order, which makes every level duplicate-free,
  so levels are plain stable compactions.  The final list is the deepest
  non-empty level.

Every stable compaction, including the per-game k1 compaction and the
doubles/non-doubles sub-batch split, goes through
``ops.compaction.compact_rows``: the CUDA kernel on the card, its plain
PyTorch version on the CPU.  Output lists, counts and overflow flags are
bit-identical to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops import compaction
from . import board as B
from .constants import NUM_CHECKERS

I8 = torch.int8
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class MovegenConfig:
    """Static width caps (the JAX package's ``MovegenConfig``; its
    docstring records the measured maxima behind each default)."""

    max_moves: int = 256    # M: final list width (reference env cap: 500)
    k1: int = 16            # first-level frontier (hard bound: 15 origins)
    k2: int = 96            # doubles frontier after 2 submoves
    k3: int = 224           # doubles frontier after 3 submoves
    dedup_width: int = 384  # non-doubles raw-candidate block fed to dedup
    # doubles sub-batch capacity = B // dbl_div + dbl_add for B >= 512
    dbl_div: int = 4
    dbl_add: int = 64
    # reference-order doubles enumeration with levelwise dedup (parity
    # preset); k4 is the pre-dedup width of its final level
    exact_order: bool = False
    k4: int = 1920
    # give the non-doubles sub-batch the full batch width (batches with
    # injected non-uniform dice)
    full_nondoubles: bool = False
    # Kernel selectors kept from the JAX package.  There they pick one of
    # two Pallas TPU formulations or the jnp path (use_pallas=False).
    # All three compute the same stable compaction bit for bit, and the
    # TPU-specific formulations have no meaning on Hopper, so here every
    # value maps to the one ops.compaction.compact_rows (see
    # _compact_batch).
    use_pallas: bool = False
    pallas_kernel: str = "segmented"
    # dedup=False: compact the raw non-doubles block straight into the
    # output (duplicates remain) — only for duplicate-insensitive
    # consumers (the 2-ply reply min), never for the env's action list
    dedup: bool = True

    @classmethod
    def parity(cls, max_moves: int = 500) -> "MovegenConfig":
        """Strict reference-parity preset (exact list order, caps above
        every practical bound, M = the reference env's 500)."""
        return cls(
            max_moves=max_moves, k2=128, k3=512, dedup_width=512,
            exact_order=True, k4=1920,
        )

    @classmethod
    def fast(cls, max_moves: int = 256) -> "MovegenConfig":
        """Throughput preset: width caps at the measured maxima plus
        margin and the doubles sub-batch at mean + 8 sigma."""
        return cls(
            max_moves=max_moves, k2=80, k3=192, dedup_width=288,
            dbl_div=5, dbl_add=56,
        )


# Candidate-slot grid per die: 24 point origins + bar + farthest
# bear-off + exact bear-off (see board.submoves_one_die).
NSLOT = 27


def _bcast(mask, x):
    """Right-pad a leading-axis mask with singleton dims to x's rank."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def _perm_scan(x, mirror):
    """Reorder (G, ..., 27) per-slot arrays into each game's scan order:
    the reference scans point origins in ABSOLUTE ascending order for
    both players, so for player-2 games (``mirror``, (G,) bool) the first
    25 slots (points + bar) are flipped; the two bear-off slots stay
    last."""
    flipped = torch.cat([torch.flip(x[..., :25], dims=(-1,)), x[..., 25:]],
                        dim=-1)
    return torch.where(_bcast(mirror, x), flipped, x)


def _arange_lt(k, n):
    """(G, k) prefix mask: slot j < n[g]."""
    return torch.arange(k, device=n.device)[None, :] < n[:, None]


# --- building blocks --------------------------------------------------------


def _first_die(vecs, die, mirror):
    """One die from (G, 52) boards: (afterstates (G, 27, 52), valid
    (G, 27), origin (G, 27)) in scan order."""
    v, o, d, h = (_perm_scan(a, mirror)
                  for a in B.submoves_one_die(vecs, die))
    return B.apply_submove(vecs[:, None, :], o, d, h), v, o


def _expand_one_die(boards, valid, die, mirror):
    """Expand (G, K, 52) frontiers by one die: returns
    (after (G, K*NSLOT, 52), valid (G, K*NSLOT), origin (G, K*NSLOT)) over
    the dense candidate grid, iterated in scan order."""
    g, k = valid.shape
    v, o, d, h = (_perm_scan(a, mirror)
                  for a in B.submoves_one_die(boards, die[:, None]))
    after = B.apply_submove(boards[:, :, None, :], o, d, h)  # (G,K,27,52)
    val = valid[:, :, None] & v
    return (after.reshape(g, k * NSLOT, 52), val.reshape(g, k * NSLOT),
            o.reshape(g, k * NSLOT))


def _compact_batch(payloads, valid, k_out: int):
    """Batch-level stable compaction over (G, N[, C]) payloads whose
    values fit int8 (board counts <= 15, origin ranks <= 24, dice <= 6).

    The payloads are concatenated along C into one int8 block and
    compacted by ``ops.compaction.compact_rows`` in one launch.  The JAX
    package chooses here between two Pallas kernels
    (``MovegenConfig.pallas_kernel``) and the jnp ``_compact`` path
    (``use_pallas=False``); all three are one function, held bit-identical
    by the JAX package's own tests, so every choice maps to this one call.
    Returns (payloads_out, n (G,))."""
    cols, widths = [], []
    for p in payloads:
        m = p[:, :, None] if p.dim() == 2 else p
        widths.append(m.shape[2])
        cols.append(m.to(I8))
    cat = torch.cat(cols, dim=2) if len(cols) > 1 else cols[0]
    out, n = compaction.compact_rows(cat.contiguous(), valid.contiguous(),
                                     k_out)
    outs, off = [], 0
    for p, w in zip(payloads, widths):
        sel = out[:, :, off:off + w]
        off += w
        sel = sel[:, :, 0] if p.dim() == 2 else sel
        outs.append(sel.to(p.dtype))
    return tuple(outs), n


def _compact_games(payloads, valid, k_out: int):
    """Compact along the GAME axis (the sub-batch split): payloads
    (N[, C]) with valid (N,), as one row of ``_compact_batch``."""
    outs, n = _compact_batch(tuple(p[None] for p in payloads), valid[None],
                             k_out)
    return tuple(o[0] for o in outs), n[0]


def _dedup_pairwise(boards, valid):
    """First-occurrence dedup flags in ORIGINAL (generation) order for
    (G, K, 52) boards: keep[g, i] iff row i is valid and no earlier valid
    row holds the same board.  The (G, K, K) equality is accumulated one
    packed key word at a time, so only one (G, K, K) bool block is live
    (fusing all 7 words would materialise 7 of them)."""
    keys = B.pack_key(boards)  # (G, K, 7)
    eq = keys[:, :, None, 0] == keys[:, None, :, 0]
    for w in range(1, keys.shape[-1]):
        eq &= keys[:, :, None, w] == keys[:, None, :, w]
    k = boards.shape[1]
    earlier = torch.ones((k, k), dtype=torch.bool,
                         device=boards.device).tril_(-1)
    eq &= earlier
    eq &= valid[:, None, :]
    dup = eq.any(dim=2)
    return valid & torch.logical_not(dup)


def _embed(boards, n, m):
    """Place (G, K, 52) frontiers into (G, M, 52) buffers (truncating if
    K > M)."""
    k = min(boards.shape[1], m)
    out = boards.new_zeros((boards.shape[0], m, 52))
    out[:, :k] = boards[:, :k]
    return out, torch.clamp(n, max=m)


# --- non-doubles ------------------------------------------------------------


def _one_order(vecs, d_first, d_second, k1, mirror):
    """One die order per game: returns (singles (G, k1, 52),
    singles_valid, pair_boards (G, k1*27, 52), pair_valid, has2 (G,))."""
    b1, v1, _ = _first_die(vecs, d_first, mirror)
    (b1c,), n1 = _compact_batch((b1,), v1, k1)  # <= 15 valid: never overflows
    v1c = _arange_lt(k1, n1)
    pair_b, pair_v, _ = _expand_one_die(b1c, v1c, d_second, mirror)
    return b1c, v1c, pair_b, pair_v, pair_v.any(dim=1)


def _nondoubles_candidates(vecs, d_hi, d_lo, cfg: MovegenConfig, mirror):
    """Per-game candidate blocks (G, 2*(k1*27 + k1), 52) with reference
    emission semantics and the max-submove filter applied.  Both die
    orders run as one stacked (2G) batch."""
    g, k1 = vecs.shape[0], cfg.k1
    both = _one_order(
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
    one_order = torch.cat([
        torch.full((k1 * NSLOT,), 2, dtype=I32, device=vecs.device),
        torch.full((k1,), 1, dtype=I32, device=vecs.device),
    ])
    seqlen = torch.cat([one_order, one_order])
    # max-submove filter before dedup: equal boards always have equal
    # submove counts, so the order of the two does not matter
    max_len = torch.where(cand_valid, seqlen, 0).amax(dim=1)
    keep0 = cand_valid & (seqlen[None, :] == max_len[:, None])
    return cand_boards, keep0


def _nondoubles_batch(vecs, d_hi, d_lo, cfg: MovegenConfig, mirror):
    """(G,)-batched non-doubles enumeration: candidate blocks, then
    stable compaction -> per-game dedup -> compaction into the M-wide
    output."""
    cand, keep0 = _nondoubles_candidates(vecs, d_hi, d_lo, cfg, mirror)
    if not cfg.dedup:
        (out,), n = _compact_batch((cand,), keep0, cfg.max_moves)
        return out, torch.clamp(n, max=cfg.max_moves), n > cfg.max_moves
    kd = cfg.dedup_width
    (cb,), n_raw = _compact_batch((cand,), keep0, kd)
    kv = _arange_lt(kd, torch.clamp(n_raw, max=kd))
    keep = _dedup_pairwise(cb, kv)
    (out,), n = _compact_batch((cb,), keep, cfg.max_moves)
    overflow = (n_raw > kd) | (n > cfg.max_moves)
    return out, torch.clamp(n, max=cfg.max_moves), overflow


# --- doubles ----------------------------------------------------------------


def _rank_of(origin):
    """Movement-direction rank of an origin (bar first)."""
    return torch.where(origin == B.ORIGIN_BAR, -1, origin)


def _doubles_batch(vecs, die, cfg: MovegenConfig, mirror):
    """(G,)-batched depth-4 frontier expansion with non-decreasing-origin
    canonicalization and no dedup (distinct non-decreasing origin
    sequences give distinct boards), each level a plain stable
    compaction."""
    m = cfg.max_moves
    b1, v1, o1 = _first_die(vecs, die, mirror)
    r1 = _rank_of(o1).to(I8)
    (f1b, f1r), n1 = _compact_batch((b1, r1), v1, cfg.k1)
    f1v = _arange_lt(cfg.k1, n1)

    def level(fb, fr, fv, k_out):
        eb, ev, eo = _expand_one_die(fb, fv, die, mirror)
        erank = _rank_of(eo).to(I8)
        parent = fr.to(I32).repeat_interleave(NSLOT, dim=1)
        ev = ev & (erank.to(I32) >= parent)
        has = ev.any(dim=1)
        (nb, nr), n = _compact_batch((eb, erank), ev, k_out)
        nv = _arange_lt(k_out, torch.clamp(n, max=k_out))
        return nb, nr, nv, n, has

    f2b, f2r, f2v, n2, has2 = level(f1b, f1r, f1v, cfg.k2)
    f3b, f3r, f3v, n3, has3 = level(f2b, f2r, f2v, cfg.k3)
    f4b, _, _, n4, has4 = level(f3b, f3r, f3v, m)

    # deepest non-empty level is the legal move list
    l1b, l1n = _embed(f1b, n1, m)
    l2b, l2n = _embed(f2b, n2, m)
    l3b, l3n = _embed(f3b, n3, m)
    w4, w3, w2 = (h[:, None, None] for h in (has4, has3, has2))
    out = torch.where(w4, f4b, torch.where(w3, l3b, torch.where(w2, l2b, l1b)))
    n = torch.where(has4, n4,
                    torch.where(has3, l3n, torch.where(has2, l2n, l1n)))
    not4, not3 = torch.logical_not(has4), torch.logical_not(has3)
    overflow = (
        (has2 & (n2 > cfg.k2))
        | (has3 & (n3 > cfg.k3))
        | (has4 & (n4 > m))
        | (not4 & has3 & (n3 > m))
        | (not3 & has2 & (n2 > m))
    )
    return out, torch.clamp(n, max=m), overflow


def _doubles_exact(vecs, die, cfg: MovegenConfig, mirror):
    """Reference-ORDER doubles enumeration (exact_order mode), batched:
    replays the reference's permutation scan with a first-occurrence
    board dedup at every level (see the JAX package's docstring for why
    levelwise dedup is exact)."""
    m = cfg.max_moves
    b1, v1, _ = _first_die(vecs, die, mirror)
    # L1 boards are distinct (distinct origins): no L1 dedup
    (f1b,), n1 = _compact_batch((b1,), v1, cfg.k1)
    f1v = _arange_lt(cfg.k1, n1)

    def level(fb, fkeep, k_out):
        eb, ev, _ = _expand_one_die(fb, fkeep, die, mirror)
        has = ev.any(dim=1)
        n_pre = ev.sum(dim=1, dtype=I32)
        (nb,), _ = _compact_batch((eb,), ev, k_out)
        nv = _arange_lt(k_out, torch.clamp(n_pre, max=k_out))
        return nb, _dedup_pairwise(nb, nv), n_pre, has

    f2b, f2k, n2, has2 = level(f1b, f1v, cfg.k2)
    f3b, f3k, n3, has3 = level(f2b, f2k, cfg.k3)
    f4b, f4k, n4, has4 = level(f3b, f3k, cfg.k4)

    c2, c3, c4 = (k.sum(dim=1, dtype=I32) for k in (f2k, f3k, f4k))
    (o4,), _ = _compact_batch((f4b,), f4k, m)
    (o3,), _ = _compact_batch((f3b,), f3k, m)
    (o2,), _ = _compact_batch((f2b,), f2k, m)
    l1b, l1n = _embed(f1b, n1, m)
    w4, w3, w2 = (h[:, None, None] for h in (has4, has3, has2))
    out = torch.where(w4, o4, torch.where(w3, o3, torch.where(w2, o2, l1b)))
    n = torch.where(has4, c4,
                    torch.where(has3, c3, torch.where(has2, c2, l1n)))
    overflow = (
        (has2 & (n2 > cfg.k2))
        | (has3 & (n3 > cfg.k3))
        | (has4 & (n4 > cfg.k4))
        | (n > m)
    )
    return out, torch.clamp(n, max=m), overflow


def _doubles_dispatch_batch(vecs, die, cfg: MovegenConfig, mirror):
    if cfg.exact_order:
        return _doubles_exact(vecs, die, cfg, mirror)
    return _doubles_batch(vecs, die, cfg, mirror)


# --- public entry -----------------------------------------------------------


def doubles_capacity(batch_size: int,
                     cfg: MovegenConfig = MovegenConfig()) -> int:
    """Static width of the doubles sub-batch in
    ``legal_afterstates_batch`` (Binomial(B, 1/6) doubles: the default
    sits > 12 sigma above the mean for B >= 512, ``fast()`` at +8)."""
    if batch_size < 512:
        return batch_size
    return batch_size // cfg.dbl_div + cfg.dbl_add


def nondoubles_capacity(batch_size: int,
                        cfg: MovegenConfig = MovegenConfig()) -> int:
    """Static width of the NON-doubles sub-batch: reserves the +8-sigma
    lower tail of the doubles count.  Batches with injected non-uniform
    dice must set ``cfg.full_nondoubles``."""
    if batch_size < 512 or cfg.full_nondoubles:
        return batch_size
    margin = int(8 * math.sqrt(batch_size * 5 / 36))
    reserve = max(0, batch_size // 6 - margin)
    return batch_size - reserve


def compactions_per_call(cfg: MovegenConfig = MovegenConfig()) -> int:
    """Number of ``compact_rows`` calls one ``legal_afterstates_batch``
    makes: the two sub-batch splits, the stacked k1 compaction and the
    one or two non-doubles levels, and the doubles levels."""
    nondoubles = 1 + (2 if cfg.dedup else 1)
    doubles = 7 if cfg.exact_order else 4
    return 2 + nondoubles + doubles


def _game_over(vecs):
    return vecs[:, B.MY_OFF].to(I32) >= NUM_CHECKERS


def legal_afterstates_batch(vecs, dice, cfg: MovegenConfig = MovegenConfig(),
                            mirror=None):
    """Batched legal-move enumeration with doubles partitioning: doubles
    games are stable-compacted into a ``doubles_capacity(B)`` sub-batch
    (the rest into ``nondoubles_capacity(B)``), expanded there, and
    gathered back.  All shapes static.

    Args:
      vecs:   (B, 52) int8 canonical boards (current player to move).
      dice:   (B, 2) integer dice.
      cfg:    static width configuration.
      mirror: (B,) bool — True for games whose mover is player 2, so the
              list follows the reference's generation order (None = all
              False, canonical order).

    Returns: (boards (B, M, 52) int8, n_moves (B,) int32, overflow (B,)).
    """
    bsz = vecs.shape[0]
    if mirror is None:
        mirror = torch.zeros((bsz,), dtype=torch.bool, device=vecs.device)
    d0 = dice[:, 0].to(I32)
    d1 = dice[:, 1].to(I32)
    is_double = d0 == d1
    not_double = torch.logical_not(is_double)
    d_hi, d_lo = torch.maximum(d0, d1), torch.minimum(d0, d1)
    mir8 = mirror.to(I8)

    bn = nondoubles_capacity(bsz, cfg)
    (nvecs, nhi, nlo, nmir), _ = _compact_games(
        (vecs, d_hi, d_lo, mir8), not_double, bn
    )
    nd_out, nd_n, nd_of = _nondoubles_batch(nvecs, nhi, nlo, cfg, nmir > 0)

    bd = doubles_capacity(bsz, cfg)
    (dvecs, ddie, dmir), _ = _compact_games((vecs, d0, mir8), is_double, bd)
    db_out, db_n, db_of = _doubles_dispatch_batch(dvecs, ddie, cfg, dmir > 0)

    pos_d = torch.cumsum(is_double.to(I32), 0, dtype=I32)  # 1-indexed slots
    slot_d = torch.clamp(pos_d - 1, 0, bd - 1).long()
    fits_d = is_double & (pos_d <= bd)
    pos_n = torch.cumsum(not_double.to(I32), 0, dtype=I32)
    slot_n = torch.clamp(pos_n - 1, 0, bn - 1).long()
    fits_n = not_double & (pos_n <= bn)

    out = torch.where(is_double[:, None, None], db_out[slot_d], nd_out[slot_n])
    n = torch.where(
        is_double,
        torch.where(fits_d, db_n[slot_d], 0),
        torch.where(fits_n, nd_n[slot_n], 0),
    )
    of = torch.where(
        is_double,
        db_of[slot_d] | torch.logical_not(fits_d),
        nd_of[slot_n] | torch.logical_not(fits_n),
    )
    n = torch.where(_game_over(vecs), 0, n)
    return out, n, of


def nondoubles_afterstates_batch(vecs, d_hi, d_lo,
                                 cfg: MovegenConfig = MovegenConfig(),
                                 mirror=None):
    """Non-doubles enumeration WITHOUT the doubles partition: every game
    uses the (d_hi, d_lo) dice directly.  Same output contract as
    ``legal_afterstates_batch``, including the game-over rule."""
    if mirror is None:
        mirror = torch.zeros((vecs.shape[0],), dtype=torch.bool,
                             device=vecs.device)
    out, n, of = _nondoubles_batch(vecs, d_hi.to(I32), d_lo.to(I32), cfg,
                                   mirror)
    return out, torch.where(_game_over(vecs), 0, n), of


def doubles_afterstates_batch(vecs, die, cfg: MovegenConfig = MovegenConfig(),
                              mirror=None):
    """Doubles enumeration without the partition: every game uses
    ``die`` four times."""
    if mirror is None:
        mirror = torch.zeros((vecs.shape[0],), dtype=torch.bool,
                             device=vecs.device)
    out, n, of = _doubles_dispatch_batch(vecs, die.to(I32), cfg, mirror)
    return out, torch.where(_game_over(vecs), 0, n), of


def legal_afterstates(vec, dice, cfg: MovegenConfig = MovegenConfig(),
                      mirror=False):
    """All legal afterstates from one canonical board + dice pair.

    Args:
      vec:    (52,) int8 canonical board (current player to move).
      dice:   (2,) integer dice.
      cfg:    static width configuration.
      mirror: bool — True when the mover is player 2.

    Returns: (boards (M, 52) int8, n_moves () int32, overflow () bool).
    """
    dev = vec.device
    mir = torch.as_tensor(mirror, dtype=torch.bool, device=dev).reshape(1)
    dice = torch.as_tensor(dice, device=dev).to(I32)
    d0, d1 = dice[0:1], dice[1:2]
    d_hi, d_lo = torch.maximum(d0, d1), torch.minimum(d0, d1)
    nd_out, nd_n, nd_of = _nondoubles_batch(vec[None], d_hi, d_lo, cfg, mir)
    db_out, db_n, db_of = _doubles_dispatch_batch(vec[None], d0, cfg, mir)
    is_double = (d0 == d1)[0]
    out = torch.where(is_double, db_out[0], nd_out[0])
    n = torch.where(is_double, db_n[0], nd_n[0])
    of = torch.where(is_double, db_of[0], nd_of[0])
    n = torch.where(_game_over(vec[None])[0], 0, n)
    return out, n, of
