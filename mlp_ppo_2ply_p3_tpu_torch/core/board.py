"""Board primitives in the canonical (current-player) frame, batched.

Port of ``mlp_ppo_2ply_p3_tpu/core/board.py``.  A board is a flat
``(..., 52)`` int8 vector
``[my points (24), opp points (24), my_bar, opp_bar, my_off, opp_off]``
where the mover always travels in the +1 direction (0 -> 23), home board
is 18..23, bar entry lands on ``die - 1`` and bear-off exits past 23.

The JAX functions act on one board and are vmapped by their callers;
here every function broadcasts over leading dimensions instead.  Point
reflection (``x[::-1]`` in JAX) is ``torch.flip``; arithmetic on boards
stays explicitly int8.
"""

from __future__ import annotations

import torch

from .constants import NUM_CHECKERS, NUM_POINTS

# slots in the flat canonical vector
MY = slice(0, 24)
OPP = slice(24, 48)
MY_BAR, OPP_BAR, MY_OFF, OPP_OFF = 48, 49, 50, 51
VEC = 52

# submove encoding: origin in 0..24 (24 = bar), dest in 0..24 (24 = off)
ORIGIN_BAR = 24
DEST_OFF = 24

I8 = torch.int8
I32 = torch.int32


def _flip(x):
    return torch.flip(x, dims=(-1,))


def to_canonical(points, bar_, off_, player):
    """Absolute arrays (points (..., 2, 24), bar (..., 2), off (..., 2))
    + player (...,) -> canonical (..., 52) int8 vectors."""
    p0 = player.to(I32) == 0
    p0v = p0[..., None]
    my_pts = torch.where(p0v, points[..., 0, :], _flip(points[..., 1, :]))
    opp_pts = torch.where(p0v, points[..., 1, :], _flip(points[..., 0, :]))
    my_b = torch.where(p0, bar_[..., 0], bar_[..., 1])
    opp_b = torch.where(p0, bar_[..., 1], bar_[..., 0])
    my_o = torch.where(p0, off_[..., 0], off_[..., 1])
    opp_o = torch.where(p0, off_[..., 1], off_[..., 0])
    tail = torch.stack([my_b, opp_b, my_o, opp_o], dim=-1)
    return torch.cat([my_pts.to(I8), opp_pts.to(I8), tail.to(I8)], dim=-1)


def from_canonical(vec, player):
    """Canonical (..., 52) vectors + player (...,) -> absolute
    (points (..., 2, 24), bar (..., 2), off (..., 2))."""
    p0 = player.to(I32) == 0
    p0v = p0[..., None]
    my_pts, opp_pts = vec[..., MY], vec[..., OPP]
    pts0 = torch.where(p0v, my_pts, _flip(opp_pts))
    pts1 = torch.where(p0v, opp_pts, _flip(my_pts))
    points = torch.stack([pts0, pts1], dim=-2)
    mine = torch.stack([vec[..., MY_BAR], vec[..., OPP_BAR]], dim=-1)
    theirs = torch.stack([vec[..., OPP_BAR], vec[..., MY_BAR]], dim=-1)
    bar_ = torch.where(p0v, mine, theirs)
    mine = torch.stack([vec[..., MY_OFF], vec[..., OPP_OFF]], dim=-1)
    theirs = torch.stack([vec[..., OPP_OFF], vec[..., MY_OFF]], dim=-1)
    off_ = torch.where(p0v, mine, theirs)
    return points, bar_, off_


def opponent_view(vec):
    """Canonical-frame involution: re-canonicalize boards for the other
    player (swap my/opp halves and reflect the point order)."""
    tail = torch.stack(
        [vec[..., OPP_BAR], vec[..., MY_BAR], vec[..., OPP_OFF],
         vec[..., MY_OFF]], dim=-1
    )
    return torch.cat([_flip(vec[..., OPP]), _flip(vec[..., MY]), tail], dim=-1)


def _take(x, idx):
    """x (..., 24) at per-board index idx (...,) -> (...,)."""
    return torch.gather(x, -1, idx.clamp(0, 23).long()[..., None])[..., 0]


def submoves_one_die(vec, die):
    """All candidate submoves for one die from canonical boards.

    ``vec`` (..., 52) and ``die`` (...) broadcast together to a batch
    shape S.  Returns (valid S+(27,) bool, origin S+(27,) int32,
    dest S+(27,) int32, hit S+(27,) bool) over 27 candidate slots:

    - 0..23: normal point-to-point moves — dest in-board, not blocked;
    - 24: the bar-entry submove;
    - 25: bear-off from the FARTHEST occupied home point (overshoot or
      exact);
    - 26: exact bear-off from point ``24-die`` when that differs from the
      farthest point.

    The slot order is the reference's emission order (normal in-home
    moves, then the farthest bear-off, then the exact bear-off), which
    exact list-order parity requires.
    """
    shape = torch.broadcast_shapes(vec.shape[:-1], die.shape)
    dev = vec.device
    die = die.to(I32).expand(shape)
    my = vec[..., MY].to(I32).expand(shape + (24,))
    opp = vec[..., OPP].to(I32).expand(shape + (24,))
    my_bar = vec[..., MY_BAR].to(I32).expand(shape)
    my_off = vec[..., MY_OFF].to(I32).expand(shape)

    game_over = my_off >= NUM_CHECKERS
    on_bar = my_bar > 0
    live = torch.logical_not(game_over)

    o = torch.arange(24, dtype=I32, device=dev)
    dest_pt = o + die[..., None]
    in_board = dest_pt < NUM_POINTS
    opp_dest = torch.gather(opp, -1, dest_pt.clamp(0, 23).long())
    opp_at = torch.where(in_board, opp_dest, 0)
    open_dest = opp_at <= 1
    occupied = my > 0

    all_home = torch.logical_not(on_bar) & (my[..., :18].sum(-1) == 0)
    # farthest (lowest-index) occupied home point; sentinel 99 when empty
    home_pts = torch.arange(18, 24, dtype=I32, device=dev)
    farthest = torch.where(my[..., 18:24] > 0, home_pts, 99).amin(-1)

    valid_normal = (
        torch.logical_not(on_bar)[..., None] & occupied & in_board
        & open_dest & live[..., None]
    )
    dest_pts = torch.where(in_board, dest_pt, DEST_OFF)
    hit_pts = valid_normal & (opp_at == 1)

    # die == 0 only occurs on the all-zero padding rows of a sub-batch,
    # where on_bar is False: the clamp in _take never changes a result
    bar_dest = die - 1
    opp_bar_dest = _take(opp, bar_dest)
    valid_bar = on_bar & (opp_bar_dest <= 1) & live
    hit_bar = valid_bar & (opp_bar_dest == 1)

    # farthest-checker bear-off (exact or overshoot)
    far_valid = (
        all_home & (farthest < 99) & (farthest + die >= NUM_POINTS) & live
    )
    far_origin = farthest.clamp(18, 23)
    # exact bear-off from 24-die when distinct from the farthest point
    ex_origin = NUM_POINTS - die
    ex_valid = (
        all_home & (_take(my, ex_origin) > 0) & (ex_origin != farthest) & live
    )

    false1 = torch.zeros(shape + (1,), dtype=torch.bool, device=dev)
    off1 = torch.full(shape + (1,), DEST_OFF, dtype=I32, device=dev)
    valid = torch.cat(
        [valid_normal, valid_bar[..., None], far_valid[..., None],
         ex_valid[..., None]], dim=-1
    )
    origin = torch.cat(
        [o.expand(shape + (24,)),
         torch.full(shape + (1,), ORIGIN_BAR, dtype=I32, device=dev),
         far_origin[..., None], ex_origin[..., None]], dim=-1
    )
    dest = torch.cat([dest_pts, bar_dest[..., None], off1, off1], dim=-1)
    hit = torch.cat([hit_pts, hit_bar[..., None], false1, false1], dim=-1)
    return valid, origin, dest, hit


def game_over(vec):
    """(...,) bool: the mover has borne off all 15 checkers."""
    return vec[..., MY_OFF].to(I32) >= NUM_CHECKERS


def apply_submove(vec, origin, dest, hit):
    """Apply submoves to canonical boards (no validity check).  ``vec``
    (..., 52) broadcasts against ``origin``/``dest``/``hit`` (...), so a
    (K, 1, 52) frontier with (K, 27) submoves gives (K, 27, 52)."""
    ar = torch.arange(24, dtype=I32, device=vec.device)
    origin = origin.to(I32)
    dest = dest.to(I32)
    hit8 = hit.to(I8)
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
    """Pack canonical boards (..., 52) into (..., 7) int32 exact dedup
    keys.  Checker counts fit 4 bits (<= 15): 24 points x (my | opp<<4)
    packed 4 points per word (6 words) + one word of bar/off counters.
    Words are assembled in int64 and wrapped to int32 two's complement,
    the bit pattern the JAX package's int32 shifts give."""
    v = vec.to(torch.int64) & 0xF
    byte = v[..., MY] | (v[..., OPP] << 4)          # (..., 24) 0..255
    b = byte.reshape(byte.shape[:-1] + (6, 4))
    words = (
        b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    )
    words = torch.where(words >= 2**31, words - 2**32, words)
    tail = (
        v[..., MY_BAR] | (v[..., OPP_BAR] << 8) | (v[..., MY_OFF] << 16)
        | (v[..., OPP_OFF] << 24)
    )
    return torch.cat([words, tail[..., None]], dim=-1).to(I32)


def is_race(vec):
    """(..., 52) canonical boards -> (...,) bool: no contact, the mover's
    rearmost checker past every opponent checker, a checker on the bar
    counting as rearmost for its side (the mover's at point -1, the
    opponent's at 24) and a side with no checker left meeting none.  The
    same for the board and its ``opponent_view``, for either mover and for
    the position's features (``core.features.is_race``): the class of the
    position.  It is ``agents/pubeval.py::is_race`` but where the mover has
    borne off every checker with an opponent checker on the bar (pubeval's
    reads contact there)."""
    idx = torch.arange(NUM_POINTS, device=vec.device)
    my_min = torch.where(vec[..., MY] > 0, idx, 99).amin(-1)
    my_min = torch.where(vec[..., MY_BAR] > 0, -1, my_min)
    opp_max = torch.where(vec[..., OPP] > 0, idx, -99).amax(-1)
    opp_max = torch.where(vec[..., OPP_BAR] > 0, NUM_POINTS, opp_max)
    return my_min > opp_max
