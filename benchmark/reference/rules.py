"""The rules of backgammon as plain PyTorch: boards, dice, the 198
TD-Gammon features, the fixed-width move generator and the batched
environment.

A frozen copy, made for the benchmark's reference, of the plain
versions in the PyTorch port (``core/board.py``, ``core/dice.py``,
``core/features.py``, ``ops/compaction.py::compact_rows_plain`` and
``first_occurrence_plain``, ``ops/doubles.py``'s plain levels,
``ops/nondoubles.py``'s plain batch, ``core/movegen.py``'s capacities
and ``env/bg_env.py``), which the port's tests hold bit for bit to the
JAX package's rules.  It imports nothing of either package, so a later
change to the program cannot move it.  Two forms are written out anew
rather than copied: the batch's placement (each game's list, count and
flag, and the slot clamp past a sub-batch's capacity) is computed from
the two sub-batches' plain lists instead of in place, and the doubles
sub-batch is gathered with an index instead of a compaction kernel; both
give the port's results.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

I8 = torch.int8
I32 = torch.int32

NUM_POINTS = 24
NUM_CHECKERS = 15
MATCH_LENGTH = 15
REWARD_INVALID_ACTION = -1.0
REWARD_WIN_NORMAL = 1.0
REWARD_WIN_GAMMON = 1.5
REWARD_WIN_BACKGAMMON = 2.0
INITIAL_POINTS_P1 = {0: 2, 11: 5, 16: 3, 18: 5}
INITIAL_POINTS_P2 = {23: 2, 12: 5, 7: 3, 5: 5}

MY = slice(0, 24)
OPP = slice(24, 48)
MY_BAR, OPP_BAR, MY_OFF, OPP_OFF = 48, 49, 50, 51
ORIGIN_BAR = 24
DEST_OFF = 24
NSLOT = 27
_INV_CHECKERS = float(np.float32(1.0 / NUM_CHECKERS))


# --- dice -------------------------------------------------------------------


def _rolls_table():
    rolls, probs = [], []
    for d0 in range(1, 7):
        for d1 in range(d0, 7):
            rolls.append((d0, d1))
            probs.append(1.0 if d0 == d1 else 2.0)
    return np.array(rolls, np.int8), np.array(probs, np.float32) / 36.0


ROLLS_21, ROLL_PROBS_21 = _rolls_table()


def roll(gen, shape):
    return torch.randint(1, 7, tuple(shape) + (2,), generator=gen,
                         device=gen.device, dtype=I8)


def roll_nondouble(gen, shape):
    i = torch.randint(0, 30, tuple(shape), generator=gen, device=gen.device,
                      dtype=I32)
    d0, r = i // 5, i % 5
    d1 = r + (r >= d0).to(I32)
    return torch.stack([d0 + 1, d1 + 1], dim=-1).to(I8)


# --- boards -----------------------------------------------------------------


def _flip(x):
    return torch.flip(x, dims=(-1,))


def to_canonical(points, bar_, off_, player):
    p0 = player.to(I32) == 0
    p0v = p0[..., None]
    my_pts = torch.where(p0v, points[..., 0, :], _flip(points[..., 1, :]))
    opp_pts = torch.where(p0v, points[..., 1, :], _flip(points[..., 0, :]))
    tail = torch.stack([torch.where(p0, bar_[..., 0], bar_[..., 1]),
                        torch.where(p0, bar_[..., 1], bar_[..., 0]),
                        torch.where(p0, off_[..., 0], off_[..., 1]),
                        torch.where(p0, off_[..., 1], off_[..., 0])], dim=-1)
    return torch.cat([my_pts.to(I8), opp_pts.to(I8), tail.to(I8)], dim=-1)


def from_canonical(vec, player):
    p0v = (player.to(I32) == 0)[..., None]
    my_pts, opp_pts = vec[..., MY], vec[..., OPP]
    points = torch.stack([torch.where(p0v, my_pts, _flip(opp_pts)),
                          torch.where(p0v, opp_pts, _flip(my_pts))], dim=-2)
    mine = torch.stack([vec[..., MY_BAR], vec[..., OPP_BAR]], dim=-1)
    theirs = torch.stack([vec[..., OPP_BAR], vec[..., MY_BAR]], dim=-1)
    bar_ = torch.where(p0v, mine, theirs)
    mine = torch.stack([vec[..., MY_OFF], vec[..., OPP_OFF]], dim=-1)
    theirs = torch.stack([vec[..., OPP_OFF], vec[..., MY_OFF]], dim=-1)
    return points, bar_, torch.where(p0v, mine, theirs)


def opponent_view(vec):
    tail = torch.stack([vec[..., OPP_BAR], vec[..., MY_BAR],
                        vec[..., OPP_OFF], vec[..., MY_OFF]], dim=-1)
    return torch.cat([_flip(vec[..., OPP]), _flip(vec[..., MY]), tail],
                     dim=-1)


def game_over(vec):
    return vec[..., MY_OFF].to(I32) >= NUM_CHECKERS


def _take(x, idx):
    return torch.gather(x, -1, idx.clamp(0, 23).long()[..., None])[..., 0]


def submoves_one_die(vec, die):
    """(valid, origin, dest, hit) over 27 candidate slots: 24 point
    origins, the bar entry, the farthest bear-off, the exact bear-off."""
    shape = torch.broadcast_shapes(vec.shape[:-1], die.shape)
    dev = vec.device
    die = die.to(I32).expand(shape)
    my = vec[..., MY].to(I32).expand(shape + (24,))
    opp = vec[..., OPP].to(I32).expand(shape + (24,))
    my_bar = vec[..., MY_BAR].to(I32).expand(shape)
    my_off = vec[..., MY_OFF].to(I32).expand(shape)
    live = torch.logical_not(my_off >= NUM_CHECKERS)
    on_bar = my_bar > 0
    o = torch.arange(24, dtype=I32, device=dev)
    dest_pt = o + die[..., None]
    in_board = dest_pt < NUM_POINTS
    opp_at = torch.where(in_board,
                         torch.gather(opp, -1, dest_pt.clamp(0, 23).long()),
                         0)
    all_home = torch.logical_not(on_bar) & (my[..., :18].sum(-1) == 0)
    home_pts = torch.arange(18, 24, dtype=I32, device=dev)
    farthest = torch.where(my[..., 18:24] > 0, home_pts, 99).amin(-1)
    valid_normal = (torch.logical_not(on_bar)[..., None] & (my > 0)
                    & in_board & (opp_at <= 1) & live[..., None])
    dest_pts = torch.where(in_board, dest_pt, DEST_OFF)
    hit_pts = valid_normal & (opp_at == 1)
    bar_dest = die - 1
    opp_bar_dest = _take(opp, bar_dest)
    valid_bar = on_bar & (opp_bar_dest <= 1) & live
    hit_bar = valid_bar & (opp_bar_dest == 1)
    far_valid = (all_home & (farthest < 99) & (farthest + die >= NUM_POINTS)
                 & live)
    far_origin = farthest.clamp(18, 23)
    ex_origin = NUM_POINTS - die
    ex_valid = (all_home & (_take(my, ex_origin) > 0)
                & (ex_origin != farthest) & live)
    false1 = torch.zeros(shape + (1,), dtype=torch.bool, device=dev)
    off1 = torch.full(shape + (1,), DEST_OFF, dtype=I32, device=dev)
    valid = torch.cat([valid_normal, valid_bar[..., None],
                       far_valid[..., None], ex_valid[..., None]], dim=-1)
    origin = torch.cat([o.expand(shape + (24,)),
                        torch.full(shape + (1,), ORIGIN_BAR, dtype=I32,
                                   device=dev),
                        far_origin[..., None], ex_origin[..., None]], dim=-1)
    dest = torch.cat([dest_pts, bar_dest[..., None], off1, off1], dim=-1)
    hit = torch.cat([hit_pts, hit_bar[..., None], false1, false1], dim=-1)
    return valid, origin, dest, hit


def apply_submove(vec, origin, dest, hit):
    ar = torch.arange(24, dtype=I32, device=vec.device)
    origin, dest, hit8 = origin.to(I32), dest.to(I32), hit.to(I8)
    o_oh = (ar == origin[..., None]).to(I8)
    d_oh = (ar == dest[..., None]).to(I8)
    my = vec[..., MY] - o_oh + d_oh
    opp = vec[..., OPP] - d_oh * hit8[..., None]
    my_bar = vec[..., MY_BAR] - (origin == ORIGIN_BAR).to(I8)
    opp_bar = vec[..., OPP_BAR] + hit8
    my_off = vec[..., MY_OFF] + (dest == DEST_OFF).to(I8)
    opp_off = vec[..., OPP_OFF].expand(my_off.shape)
    tail = torch.stack([my_bar, opp_bar, my_off, opp_off], dim=-1)
    return torch.cat([my, opp.expand(my.shape), tail], dim=-1)


def pack_key(vec):
    v = vec.to(torch.int64) & 0xF
    byte = v[..., MY] | (v[..., OPP] << 4)
    b = byte.reshape(byte.shape[:-1] + (6, 4))
    words = (b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
             | (b[..., 3] << 24))
    words = torch.where(words >= 2**31, words - 2**32, words)
    tail = (v[..., MY_BAR] | (v[..., OPP_BAR] << 8) | (v[..., MY_OFF] << 16)
            | (v[..., OPP_OFF] << 24))
    return torch.cat([words, tail[..., None]], dim=-1).to(I32)


# --- features ---------------------------------------------------------------


def encode(points, bar, off, turn, dtype=torch.float32):
    n = points.to(dtype)
    pts = torch.stack([(n >= 1).to(dtype), (n >= 2).to(dtype),
                       (n >= 3).to(dtype),
                       torch.clamp(n - 3.0, min=0.0) / 2.0], dim=-1)
    pts = pts.reshape(pts.shape[:-3] + (2, 96))
    barf = bar.to(dtype)[..., None] / 2.0
    offf = off.to(dtype)[..., None] * _INV_CHECKERS
    flat = torch.cat([pts, barf, offf], dim=-1)
    flat = flat.reshape(flat.shape[:-2] + (196,))
    t = turn.to(I32)
    cur = torch.stack([(t == 0).to(dtype), (t == 1).to(dtype)], dim=-1)
    return torch.cat([flat, cur.expand(flat.shape[:-1] + (2,))], dim=-1)


def encode_canonical(vecs, player, dtype=torch.float32):
    my, opp = vecs[..., 0:24], vecs[..., 24:48]
    p = player.to(I32)
    is_p0s = (p == 0).expand(vecs.shape[:-1])
    is_p0 = is_p0s[..., None]
    points = torch.stack([torch.where(is_p0, my, _flip(opp)),
                          torch.where(is_p0, opp, _flip(my))], dim=-2)
    bar = torch.stack([torch.where(is_p0s, vecs[..., 48], vecs[..., 49]),
                       torch.where(is_p0s, vecs[..., 49], vecs[..., 48])],
                      dim=-1)
    off = torch.stack([torch.where(is_p0s, vecs[..., 50], vecs[..., 51]),
                       torch.where(is_p0s, vecs[..., 51], vecs[..., 50])],
                      dim=-1)
    return encode(points, bar, off, p.expand(vecs.shape[:-1]), dtype=dtype)


# --- compaction -------------------------------------------------------------


def _arange_lt(k, n):
    return torch.arange(k, device=n.device)[None, :] < n[:, None]


def compact_rows(payload, valid, k_out: int):
    """Stable compaction of each row's valid entries into ``k_out``
    slots, zeros past the count; returns (out, unclamped count)."""
    b, n, c = payload.shape
    pos = torch.cumsum(valid.to(I32), dim=1, dtype=I32)
    count = pos[:, -1].clone() if n else torch.zeros(b, dtype=I32,
                                                     device=payload.device)
    if n == 0 or k_out == 0:
        return payload.new_zeros((b, k_out, c)), count
    targets = torch.arange(1, k_out + 1, dtype=I32,
                           device=payload.device).expand(b, k_out)
    src = torch.searchsorted(pos, targets.contiguous()).clamp_(max=n - 1)
    out = torch.gather(payload, 1, src[:, :, None].expand(b, k_out, c))
    live = targets <= count[:, None]
    return out * live[:, :, None].to(out.dtype), count


def first_occurrence(boards, valid):
    keys = pack_key(boards)
    eq = keys[:, :, None, 0] == keys[:, None, :, 0]
    for w in range(1, keys.shape[-1]):
        eq &= keys[:, :, None, w] == keys[:, None, :, w]
    k = boards.shape[1]
    eq &= torch.ones((k, k), dtype=torch.bool, device=boards.device).tril_(-1)
    eq &= valid[:, None, :].to(torch.bool)
    return valid.to(torch.bool) & torch.logical_not(eq.any(dim=2))


# --- doubles ----------------------------------------------------------------


def _perm_scan(x, mirror):
    flipped = torch.cat([torch.flip(x[..., :25], dims=(-1,)), x[..., 25:]],
                        dim=-1)
    m = mirror.reshape(mirror.shape + (1,) * (x.dim() - mirror.dim()))
    return torch.where(m, flipped, x)


def first_die(vecs, die, mirror):
    v, o, d, h = (_perm_scan(a, mirror) for a in submoves_one_die(vecs, die))
    return apply_submove(vecs[:, None, :], o, d, h), v, o


def expand_one_die(boards, valid, die, mirror):
    g, k = valid.shape
    v, o, d, h = (_perm_scan(a, mirror)
                  for a in submoves_one_die(boards, die[:, None]))
    after = apply_submove(boards[:, :, None, :], o, d, h)
    val = valid[:, :, None] & v
    return (after.reshape(g, k * NSLOT, 52), val.reshape(g, k * NSLOT),
            o.reshape(g, k * NSLOT))


def _doubles_level(boards, ranks, n_in, die, mirror, k_out: int):
    g, k, _ = boards.shape
    if n_in is None:
        valid = torch.ones((g, k), dtype=torch.bool, device=boards.device)
    else:
        valid = _arange_lt(k, torch.clamp(n_in, max=k))
    eb, ev, eo = expand_one_die(boards, valid, die, mirror)
    erank = torch.where(eo == ORIGIN_BAR, -1, eo).to(I8)
    if ranks is not None:
        ev = ev & (erank.to(I32) >= ranks.to(I32).repeat_interleave(NSLOT,
                                                                   dim=1))
    out, n = compact_rows(torch.cat([eb, erank[:, :, None]], dim=2), ev,
                          k_out)
    return out[:, :, :52].contiguous(), out[:, :, 52].contiguous(), n


def _embed(boards, n, m):
    k = min(boards.shape[1], m)
    out = boards.new_zeros((boards.shape[0], m, 52))
    out[:, :k] = boards[:, :k]
    return out, torch.clamp(n, max=m)


def doubles_lists(vecs, die, mirror, k1, k2, k3, m):
    """Depth-4 frontier with non-decreasing origin ranks; the deepest
    non-empty level is the list.  Returns (lists, n, overflow)."""
    die, mirror = die.to(I32), mirror.to(torch.bool)
    f1b, f1r, n1 = _doubles_level(vecs[:, None, :], None, None, die, mirror,
                                  k1)
    f2b, f2r, n2 = _doubles_level(f1b, f1r, n1, die, mirror, k2)
    f3b, f3r, n3 = _doubles_level(f2b, f2r, n2, die, mirror, k3)
    f4b, _, n4 = _doubles_level(f3b, f3r, n3, die, mirror, m)
    has2, has3, has4 = n2 > 0, n3 > 0, n4 > 0
    l1b, l1n = _embed(f1b, n1, m)
    l2b, l2n = _embed(f2b, n2, m)
    l3b, l3n = _embed(f3b, n3, m)
    w4, w3, w2 = (h[:, None, None] for h in (has4, has3, has2))
    lists = torch.where(w4, f4b, torch.where(w3, l3b,
                                             torch.where(w2, l2b, l1b)))
    n = torch.where(has4, n4, torch.where(has3, l3n,
                                          torch.where(has2, l2n, l1n)))
    not4, not3 = torch.logical_not(has4), torch.logical_not(has3)
    overflow = ((has2 & (n2 > k2)) | (has3 & (n3 > k3)) | (has4 & (n4 > m))
                | (not4 & has3 & (n3 > m)) | (not3 & has2 & (n2 > m)))
    return lists, torch.clamp(n, max=m), overflow


# --- non-doubles ------------------------------------------------------------


def _one_order(vecs, d_first, d_second, k1, mirror):
    b1, v1, _ = first_die(vecs, d_first, mirror)
    b1c, n1 = compact_rows(b1.contiguous(), v1, k1)
    v1c = _arange_lt(k1, n1)
    pair_b, pair_v, _ = expand_one_die(b1c, v1c, d_second, mirror)
    return b1c, v1c, pair_b, pair_v, pair_v.any(dim=1)


def _candidates(vecs, d_hi, d_lo, mirror, k1):
    g = vecs.shape[0]
    both = _one_order(torch.cat([vecs, vecs]), torch.cat([d_hi, d_lo]),
                      torch.cat([d_lo, d_hi]), k1,
                      torch.cat([mirror, mirror]))
    (a1b, b1b), (a1v, b1v), (a2b, b2b), (a2v, b2v), (has2_a, has2_b) = (
        (x[:g], x[g:]) for x in both)
    not_a = torch.logical_not(has2_a)
    run_b = torch.logical_not(not_a & ((a1v & not_a[:, None]).sum(1) == 1))
    boards = torch.cat([a2b, a1b, b2b, b1b], dim=1)
    valid = torch.cat([a2v & has2_a[:, None], a1v & not_a[:, None],
                       b2v & (has2_b & run_b)[:, None],
                       b1v & (torch.logical_not(has2_b) & run_b)[:, None]],
                      dim=1)
    one = torch.cat([torch.full((k1 * NSLOT,), 2, dtype=I32,
                                device=vecs.device),
                     torch.full((k1,), 1, dtype=I32, device=vecs.device)])
    seqlen = torch.cat([one, one])
    max_len = torch.where(valid, seqlen, 0).amax(dim=1)
    return boards, valid & (seqlen[None, :] == max_len[:, None])


def nondoubles_lists(vecs, d_hi, d_lo, mirror, k1, kd, m, dedup):
    """Both die orders, the emission and max-submove rules, the dedup of
    the first ``kd`` raw candidates.  Returns (lists, n, overflow)."""
    d_hi, d_lo, mirror = d_hi.to(I32), d_lo.to(I32), mirror.to(torch.bool)
    cand, keep0 = _candidates(vecs, d_hi, d_lo, mirror, k1)
    if not dedup:
        lists, n = compact_rows(cand, keep0, m)
        return lists, torch.clamp(n, max=m), n > m
    cb, n_raw = compact_rows(cand, keep0, kd)
    kv = _arange_lt(kd, torch.clamp(n_raw, max=kd))
    lists, n = compact_rows(cb, first_occurrence(cb, kv), m)
    return lists, torch.clamp(n, max=m), (n_raw > kd) | (n > m)


# --- the batch's move lists -------------------------------------------------


class Movegen(NamedTuple):
    """Width caps: ``core/movegen.py``'s ``MovegenConfig`` fields."""

    max_moves: int
    k1: int
    k2: int
    k3: int
    dedup_width: int
    dbl_div: int
    dbl_add: int
    dedup: bool = True


def doubles_capacity(b, cfg: Movegen):
    return b if b < 512 else b // cfg.dbl_div + cfg.dbl_add


def nondoubles_capacity(b, cfg: Movegen):
    if b < 512:
        return b
    margin = int(8 * math.sqrt(b * 5 / 36))
    return b - max(0, b // 6 - margin)


def legal_afterstates(vecs, dice, cfg: Movegen, mirror):
    """(lists (B, M, 52), n (B,), overflow (B,)) of canonical boards
    ``vecs`` under ``dice``.  The first ``doubles_capacity`` doubles games
    and the first ``nondoubles_capacity`` others, in batch order, get
    their lists; a game past its kind's capacity carries the list of the
    kind's last fitting game, with n = 0 and the overflow flag."""
    b, dev = vecs.shape[0], vecs.device
    m = cfg.max_moves
    d0, d1 = dice[:, 0].to(I32), dice[:, 1].to(I32)
    is_double = d0 == d1
    bd, bn = doubles_capacity(b, cfg), nondoubles_capacity(b, cfg)
    pos_d = torch.cumsum(is_double.to(I32), 0, dtype=I32)
    ord_n = torch.arange(b, dtype=I32, device=dev) - pos_d
    fits_d = is_double & (pos_d <= bd)
    fits_n = torch.logical_not(is_double) & (ord_n < bn)
    out = torch.zeros((b, m, 52), dtype=I8, device=dev)
    n = torch.zeros((b,), dtype=I32, device=dev)
    of = torch.zeros((b,), dtype=torch.bool, device=dev)
    for fits, kind in ((fits_n, "n"), (fits_d, "d")):
        rows = torch.nonzero(fits)[:, 0]
        if rows.numel() == 0:
            continue
        if kind == "n":
            lists, cnt, ovf = nondoubles_lists(
                vecs[rows], torch.maximum(d0, d1)[rows],
                torch.minimum(d0, d1)[rows], mirror[rows], cfg.k1,
                cfg.dedup_width, m, cfg.dedup)
        else:
            lists, cnt, ovf = doubles_lists(vecs[rows], d0[rows],
                                            mirror[rows], cfg.k1, cfg.k2,
                                            cfg.k3, m)
        out[rows], n[rows], of[rows] = lists, cnt, ovf
        same = is_double if kind == "d" else torch.logical_not(is_double)
        past = torch.nonzero(same & torch.logical_not(fits))[:, 0]
        if past.numel():
            out[past] = out[rows[-1]].clone()
            of[past] = True
    return out, torch.where(game_over(vecs), 0, n), of


def reply_lists(vecs, roll_, cfg: Movegen):
    """Every game of ``vecs`` under one roll (no partition, no mirror):
    the 2-ply reply sweep's enumeration."""
    g, dev = vecs.shape[0], vecs.device
    lo, hi = roll_
    mirror = torch.zeros((g,), dtype=torch.bool, device=dev)
    full = lambda d: torch.full((g,), d, dtype=I32, device=dev)  # noqa: E731
    if lo == hi:
        lists, n, of = doubles_lists(vecs, full(lo), mirror, cfg.k1, cfg.k2,
                                     cfg.k3, cfg.max_moves)
    else:
        lists, n, of = nondoubles_lists(vecs, full(hi), full(lo), mirror,
                                        cfg.k1, cfg.dedup_width,
                                        cfg.max_moves, cfg.dedup)
    return lists, torch.where(game_over(vecs), 0, n), of


# --- the environment --------------------------------------------------------


class State(NamedTuple):
    points: torch.Tensor      # (B, 2, 24) int8
    bar: torch.Tensor         # (B, 2) int8
    off: torch.Tensor         # (B, 2) int8
    turn: torch.Tensor        # (B,) int8
    dice: torch.Tensor        # (B, 2) int8
    score: torch.Tensor       # (B, 2) int32
    game_over: torch.Tensor   # (B,) bool
    match_over: torch.Tensor  # (B,) bool
    after: torch.Tensor       # (B, M, 52) int8
    n_moves: torch.Tensor     # (B,) int32
    overflow: torch.Tensor    # (B,) bool


# the fields that say where every game stands (the rest follow from them)
BOARD_FIELDS = ("points", "bar", "off", "turn", "dice", "score",
                "game_over", "match_over")


class Draws(NamedTuple):
    rolled: torch.Tensor
    fresh_turn: torch.Tensor
    fresh_dice: torch.Tensor


def initial_points(device):
    pts = torch.zeros((2, 24), dtype=I8)
    for p, c in INITIAL_POINTS_P1.items():
        pts[0, p] = c
    for p, c in INITIAL_POINTS_P2.items():
        pts[1, p] = c
    return pts.to(device)


def draw_fresh(gen, b):
    starter = roll_nondouble(gen, (b,))
    return (starter[:, 0] < starter[:, 1]).to(I8), roll_nondouble(gen, (b,))


def draw_step(gen, b) -> Draws:
    rolled = roll(gen, (b,))
    turn, dice_ = draw_fresh(gen, b)
    return Draws(rolled, turn, dice_)


def lists_of(points, bar, off, turn, dice_, cfg: Movegen):
    return legal_afterstates(to_canonical(points, bar, off, turn), dice_, cfg,
                             turn == 1)


def make_state(points, bar, off, turn, dice_, cfg: Movegen) -> State:
    b, dev = turn.shape[0], turn.device
    after, n, of = lists_of(points, bar, off, turn, dice_, cfg)
    zb = torch.zeros((b,), dtype=torch.bool, device=dev)
    return State(points.to(I8), bar.to(I8), off.to(I8), turn.to(I8),
                 dice_.to(I8), torch.zeros((b, 2), dtype=I32, device=dev),
                 zb, zb.clone(), after, n, of)


def reset(gen, b, cfg: Movegen) -> State:
    turn, dice_ = draw_fresh(gen, b)
    pts = initial_points(turn.device).expand(b, 2, 24).clone()
    zero2 = torch.zeros((b, 2), dtype=I8, device=turn.device)
    return make_state(pts, zero2, zero2.clone(), turn, dice_, cfg)


def step(s: State, actions, draws: Draws, cfg: Movegen):
    """One half-turn of every game: (state', reward (B,), done (B,))."""
    b, dev = s.turn.shape[0], s.turn.device
    not_ = torch.logical_not
    was_over = s.game_over
    no_moves = not_(was_over) & (s.n_moves == 0)
    action = actions.to(I32)
    live = not_(was_over) & not_(no_moves)
    invalid = live & ((action < 0) | (action >= s.n_moves))
    commit = live & not_(invalid)
    idx = action.clamp(0, cfg.max_moves - 1).long()
    chosen = torch.gather(s.after, 1,
                          idx[:, None, None].expand(b, 1, 52))[:, 0]
    win = commit & (chosen[:, MY_OFF].to(I32) >= NUM_CHECKERS)
    opp_off0 = chosen[:, OPP_OFF].to(I32) == 0
    opp_in_home = chosen[:, 24 + 18:48].to(I32).sum(-1) > 0
    opp_on_bar = chosen[:, OPP_BAR].to(I32) > 0
    is_bg = win & opp_off0 & (opp_in_home | opp_on_bar)
    is_gammon = win & opp_off0 & not_(is_bg)
    game_score = torch.where(win, torch.where(is_bg, 3, torch.where(
        is_gammon, 2, 1)), 0).to(I32)
    win_reward = torch.where(is_bg, REWARD_WIN_BACKGAMMON, torch.where(
        is_gammon, REWARD_WIN_GAMMON, REWARD_WIN_NORMAL))
    reward = (torch.where(invalid, REWARD_INVALID_ACTION, 0.0)
              + torch.where(win, win_reward, 0.0)).to(torch.float32)
    done = was_over | win
    c_pts, c_bar, c_off = from_canonical(chosen, s.turn)
    f_pts = initial_points(dev)
    zero2 = torch.zeros((2,), dtype=I8, device=dev)
    cm, wo = commit[:, None], was_over[:, None]
    n_pts = torch.where(wo[:, :, None], f_pts,
                        torch.where(cm[:, :, None], c_pts, s.points))
    n_bar = torch.where(wo, zero2, torch.where(cm, c_bar, s.bar))
    n_off = torch.where(wo, zero2, torch.where(cm, c_off, s.off))
    flip = no_moves | (commit & not_(win))
    n_turn = torch.where(was_over, draws.fresh_turn,
                         (s.turn + flip.to(I8)) % 2).to(I8)
    n_dice = torch.where(wo, draws.fresh_dice,
                         torch.where(flip[:, None], draws.rolled,
                                     s.dice)).to(I8)
    score = torch.where((was_over & s.match_over)[:, None], 0, s.score)
    is_mover = (torch.arange(2, device=dev)[None, :]
                == s.turn.to(I32)[:, None])
    score = (score + torch.where(win[:, None] & is_mover,
                                 game_score[:, None], 0)).to(I32)
    match_over = torch.where(was_over, False, s.match_over | (
        win & (score.amax(-1) >= MATCH_LENGTH)))
    game_over_ = torch.where(was_over, False, s.game_over | win)
    after, n_mv, ovf = lists_of(n_pts, n_bar, n_off, n_turn, n_dice, cfg)
    n_mv = torch.where(game_over_, 0, n_mv)
    ns = State(n_pts, n_bar, n_off, n_turn, n_dice, score, game_over_,
               match_over, after, n_mv, ovf)
    return ns, reward, done


def observe(s: State):
    return encode(s.points, s.bar, s.off, s.turn)
