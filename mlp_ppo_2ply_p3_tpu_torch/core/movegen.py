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

``legal_afterstates_batch`` allocates its (B, M, 52) output once and makes
four kernel calls that write it in place: one
``ops.compaction.compact_rows`` that splits off the doubles sub-batch; one
``ops.doubles.doubles_levels`` (its first three frontier levels); one
``ops.doubles.doubles_final`` (the fourth level, which writes the deepest
non-empty level as each fitting doubles game's list, straight into that
game's row of the output); and one ``ops.nondoubles.nondoubles_batch`` in
place over the whole batch, which writes each non-double game's list at
its own row (both die orders, the emission and max-submove rules, the
dedup and the compaction; JAX ``_nondoubles_candidates`` and
``_nondoubles_batch``), copies the last fitting doubles game's row to the
doubles games past the sub-batch's capacity, and sets every count and
flag.  So neither sub-batch's list of the JAX package is ever built, and
no (B, M, 52) gather or ``where`` runs around the kernels; the placement
(which game carries which list, and which row each doubles slot fills)
is a few (B,) integer ops on the device.  Every compaction of the
``exact_order`` doubles path goes through ``compact_rows`` as well.  Each
is a CUDA kernel on the card and its plain PyTorch version on the CPU.
Output lists, counts and overflow flags are bit-identical to the JAX
package's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops import compaction, doubles, nondoubles
from ..parallel import mesh
from ..utils.profiling import span
from . import board as B

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


def _arange_lt(k, n):
    """(G, k) prefix mask: slot j < n[g]."""
    return torch.arange(k, device=n.device)[None, :] < n[:, None]


# --- building blocks --------------------------------------------------------


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
    row holds the same board (``ops.compaction.first_occurrence_plain``).
    Only the ``exact_order`` doubles levels use them; the non-doubles
    kernel dedups on chip."""
    return compaction.first_occurrence_plain(boards, valid)


# --- non-doubles ------------------------------------------------------------


def _nondoubles_batch(vecs, d_hi, d_lo, cfg: MovegenConfig, mirror):
    """(G,)-batched non-doubles enumeration: one
    ``nondoubles.nondoubles_batch`` at the config's widths."""
    return nondoubles.nondoubles_batch(
        vecs.contiguous(), d_hi.contiguous(), d_lo.contiguous(),
        mirror.contiguous(), cfg.k1, cfg.dedup_width, cfg.max_moves,
        cfg.dedup)


# --- doubles ----------------------------------------------------------------


def _doubles_batch(vecs, die, cfg: MovegenConfig, mirror, out=None,
                   dst=None):
    """(G,)-batched depth-4 frontier expansion with non-decreasing-origin
    canonicalization and no dedup (distinct non-decreasing origin
    sequences give distinct boards): one ``doubles.doubles_levels`` call,
    L1 to L3 (each level's expansion, rank filter and compaction); then
    one ``doubles.doubles_final``, the fourth level, which writes the
    deepest non-empty level as the list with its count and overflow:
    into a (G, M, 52) tensor of its own, or, given ``out`` and ``dst``,
    slot g's list at row ``dst[g]`` of ``out``."""
    die, mirror = die.contiguous(), mirror.contiguous()
    levels = doubles.doubles_levels(vecs.contiguous(), die, mirror, cfg.k1,
                                    cfg.k2, cfg.k3)
    return doubles.doubles_final(*levels, die, mirror, cfg.max_moves, out,
                                 dst)


def _doubles_exact(vecs, die, cfg: MovegenConfig, mirror):
    """Reference-ORDER doubles enumeration (exact_order mode), batched:
    replays the reference's permutation scan with a first-occurrence
    board dedup at every level (see the JAX package's docstring for why
    levelwise dedup is exact)."""
    m = cfg.max_moves
    b1, v1, _ = doubles.first_die(vecs, die, mirror)
    # L1 boards are distinct (distinct origins): no L1 dedup
    (f1b,), n1 = _compact_batch((b1,), v1, cfg.k1)
    f1v = _arange_lt(cfg.k1, n1)

    def level(fb, fkeep, k_out):
        eb, ev, _ = doubles.expand_one_die(fb, fkeep, die, mirror)
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
    l1b, l1n = doubles.embed(f1b, n1, m)
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


def _doubles_dispatch_batch(vecs, die, cfg: MovegenConfig, mirror,
                            out=None, dst=None):
    """The doubles sub-batch's lists, counts and flags as
    ``doubles.doubles_final`` gives them, in place given ``out`` and
    ``dst``: the kernels' frontier, or under ``exact_order`` the
    reference-order enumeration."""
    if not cfg.exact_order:
        return _doubles_batch(vecs, die, cfg, mirror, out, dst)
    lists, n, of = _doubles_exact(vecs, die, cfg, mirror)
    if dst is None:
        return lists, n, of
    # one index_copy_ and no host sync: the empty slots' lists all go to
    # the first row that no slot fills, which the caller writes afterwards
    # (an empty slot leaves such a row, as the slots are at most the rows)
    bsz = out.shape[0]
    filled = dst >= 0
    taken = torch.zeros((bsz + 1,), dtype=torch.bool, device=out.device)
    taken.index_fill_(0, torch.where(filled, dst, bsz).long(), True)
    spare = torch.logical_not(taken[:bsz]).to(I32).argmax().to(I32)
    out.index_copy_(0, torch.where(filled, dst, spare).long(), lists)
    return out, torch.where(filled, n, 0), of & filled


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
    makes: the doubles sub-batch split, and under ``exact_order`` the
    seven of the doubles levels."""
    return 1 + (7 if cfg.exact_order else 0)


def nondoubles_per_call(cfg: MovegenConfig = MovegenConfig()) -> int:
    """Number of ``nondoubles_batch`` calls one ``legal_afterstates_batch``
    makes: the whole batch, in place."""
    return 1


def doubles_levels_per_call(cfg: MovegenConfig = MovegenConfig()) -> int:
    """Number of ``doubles_levels`` calls (the launch key
    ``doubles_level``) one ``legal_afterstates_batch`` makes: the first
    three doubles levels in one launch, unless ``exact_order``."""
    return 0 if cfg.exact_order else 1


def doubles_finals_per_call(cfg: MovegenConfig = MovegenConfig()) -> int:
    """Number of ``doubles_final`` calls one ``legal_afterstates_batch``
    makes: the fourth doubles level with the list, unless
    ``exact_order``."""
    return 0 if cfg.exact_order else 1


def _placement(is_double, bd: int, bn: int):
    """Which list each game of the batch carries (``legal_afterstates_batch``
    in place), on the device and without a host sync: the first ``bd``
    doubles games (in batch order) fit the doubles sub-batch and the first
    ``bn`` non-doubles games the non-doubles one; a game that does not fit
    carries the list of its kind's last fitting game, slot capacity - 1
    (the slot clamp).  Returns (src (B,) int32: -1 - the doubles game's
    slot, or the game whose non-double list a non-double game carries;
    fits (B,) bool; pos_d: each game's 1-indexed position among the
    doubles games; ord_n: its 0-indexed one among the non-doubles; dst
    (bd,) int32: the game whose row each doubles slot's list fills, -1 for
    an empty slot).  Each line is one small kernel on the card, so they
    are few."""
    bsz = is_double.shape[0]
    pos_d = torch.cumsum(is_double, 0, dtype=I32)
    own = torch.arange(bsz, dtype=I32, device=is_double.device)
    ord_n = own - pos_d
    fits_n = ord_n < bn
    # the bn-th non-double: ord_n is non-decreasing
    last_n = torch.searchsorted(ord_n, bn - 1, out_int32=True).clamp(
        max=bsz - 1)
    src = torch.where(is_double, torch.clamp(-pos_d, -bd, -1),
                      torch.where(fits_n, own, last_n))
    fits = torch.where(is_double, pos_d <= bd, fits_n)
    # slot s holds the (s + 1)-th doubles game, if there is one
    slots = torch.arange(1, bd + 1, dtype=I32, device=is_double.device)
    dst = torch.searchsorted(pos_d, slots, out_int32=True)
    dst = torch.where(dst < bsz, dst, -1)
    return src, fits, pos_d, ord_n, dst


def _global_fit(world, cfg, pos_d, ord_n, dst, out):
    """The sub-batch capacities of the global batch, for a shard of it
    (data parallelism, ``world`` a ``parallel.mesh.World``): which of the
    shard's doubles and non-doubles games fit their global sub-batch's
    capacity, and the rows the games that do not fit carry.

    Unsharded, the first ``capacity`` games of each kind (in batch order)
    fit, and every other game of the kind gets n = 0, the overflow flag
    and the list of the kind's last fitting game, global slot capacity - 1
    (the slot clamp).  It binds at a reset, whose first rolls are all
    non-doubles.  Here the counts of every shard are gathered, each game
    is placed by its global position, and the last game's list is
    gathered from the shard that holds it: the row of the shard's in-place
    output ``out`` that holds that doubles slot's list (``dst``) or that
    non-double game's.  Returns (fits_d, fits_n, fill_d, fill_n)."""
    gsz = pos_d.shape[0] * world.size
    caps = torch.tensor([doubles_capacity(gsz, cfg),
                         nondoubles_capacity(gsz, cfg)], dtype=I32,
                        device=pos_d.device)
    every = mesh.gather_batch(torch.stack([pos_d[-1], ord_n[-1] + 1])[None],
                              world)                     # (W, 2) counts
    before = torch.cumsum(every, 0, dtype=I32) - every   # earlier shards'
    last = caps - 1 - before          # the last fitting game's local slot
    owner = ((last >= 0) & (last < every)).to(I32).argmax(0)
    mine = last[world.rank]
    # the shard's games at doubles slot mine[0] and non-doubles slot
    # mine[1]; index_select keeps the slots on the device (no host sync)
    slot_d = mine[0].long().clamp(0, dst.shape[0] - 1)
    game_d = dst.index_select(0, slot_d.reshape(1)).clamp(min=0)
    game_n = (ord_n < mine[1]).sum().clamp(max=out.shape[0] - 1)
    cand = out.index_select(0, torch.cat([game_d.long(),
                                          game_n.reshape(1)]))
    cands = mesh.gather_batch(cand[None], world)         # (W, 2, M, 52)
    fill = cands[owner, torch.arange(2, device=owner.device)]
    first = before[world.rank]
    return (pos_d + first[0] <= caps[0], ord_n + first[1] < caps[1],
            fill[0], fill[1])


def legal_afterstates_batch(vecs, dice, cfg: MovegenConfig = MovegenConfig(),
                            mirror=None, world=None):
    """Batched legal-move enumeration with doubles partitioning: doubles
    games are stable-compacted into a ``doubles_capacity(B)`` sub-batch and
    expanded there, and ``doubles_final`` writes each fitting doubles
    game's list straight into its row of the (B, M, 52) output; one
    in-place ``nondoubles_batch`` then lists every non-double game at its
    own row of the same output (the first ``nondoubles_capacity(B)`` of
    them; the rest carry the last fitting one's list, as the JAX package's
    sub-batch and gather give), copies the last fitting doubles game's row
    to the doubles games past the capacity, and sets every count and
    flag.  All shapes static, no host sync.

    Args:
      vecs:   (B, 52) int8 canonical boards (current player to move).
      dice:   (B, 2) integer dice.
      cfg:    static width configuration.
      mirror: (B,) bool — True for games whose mover is player 2, so the
              list follows the reference's generation order (None = all
              False, canonical order).
      world:  a ``parallel.mesh.World`` when the B games are one rank's
              shard of a global batch of B x size games: every rank must
              call this at once (two collectives), and the result is the
              shard's rows of the global batch's, capacities included
              (``_global_fit``).  The shard's non-doubles capacity is
              then all of its B games; its doubles one stays
              ``doubles_capacity(B)``, 12 sigma above the mean count
              (``fast()``: 8), which a shard's doubles exceed with a
              probability below 1e-15 a call.

    Returns: (boards (B, M, 52) int8, n_moves (B,) int32, overflow (B,)).
    """
    with span("movegen"):
        bsz = vecs.shape[0]
        if mirror is None:
            mirror = torch.zeros((bsz,), dtype=torch.bool, device=vecs.device)
        d0 = dice[:, 0].to(I32)
        d1 = dice[:, 1].to(I32)
        is_double = d0 == d1
        d_hi, d_lo = torch.maximum(d0, d1), torch.minimum(d0, d1)

        bd = doubles_capacity(bsz, cfg)
        bn = bsz if world is not None else nondoubles_capacity(bsz, cfg)
        src, fits, pos_d, ord_n, dst = _placement(is_double, bd, bn)
        mir8 = mirror.view(I8) if mirror.dtype == torch.bool else mirror.to(I8)
        (dvecs, ddie, dmir), _ = _compact_games((vecs, d0, mir8), is_double,
                                                bd)
        out = torch.empty((bsz, cfg.max_moves, B.VEC), dtype=I8,
                          device=vecs.device)
        _, db_n, db_of = _doubles_dispatch_batch(dvecs, ddie, cfg, dmir > 0,
                                                 out, dst)
        out, n, of = nondoubles.nondoubles_batch(
            vecs.contiguous(), d_hi, d_lo, mirror.contiguous(), cfg.k1,
            cfg.dedup_width, cfg.max_moves, cfg.dedup,
            (src, fits, dst, db_n, db_of), out)
        if world is not None:
            g_fits_d, g_fits_n, fill_d, fill_n = _global_fit(
                world, cfg, pos_d, ord_n, dst, out)
            keep = torch.where(is_double, (pos_d <= bd) & g_fits_d, g_fits_n)
            fill = torch.where(is_double[:, None, None], fill_d, fill_n)
            out = torch.where(keep[:, None, None], out, fill)
            n = torch.where(keep, n, 0)
            of = of | torch.logical_not(keep)
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
    return out, torch.where(B.game_over(vecs), 0, n), of


def doubles_afterstates_batch(vecs, die, cfg: MovegenConfig = MovegenConfig(),
                              mirror=None):
    """Doubles enumeration without the partition: every game uses
    ``die`` four times."""
    if mirror is None:
        mirror = torch.zeros((vecs.shape[0],), dtype=torch.bool,
                             device=vecs.device)
    out, n, of = _doubles_dispatch_batch(vecs, die.to(I32), cfg, mirror)
    return out, torch.where(B.game_over(vecs), 0, n), of


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
    n = torch.where(B.game_over(vec[None])[0], 0, n)
    return out, n, of
