"""TD-Gammon 198-dim feature encoding, batched over leading dimensions.

Port of ``mlp_ppo_2ply_p3_tpu/core/features.py``: per player x 24 points
the 4-tuple ``[n>=1, n>=2, n>=3, max(n-3,0)/2]`` (player-major,
point-minor), then per player ``bar/2`` and ``off/15``, then the
current-player one-hot.  Layout:
``[P0 96 | P0 bar | P0 off | P1 96 | P1 bar | P1 off | cur0 | cur1]``.
Every value is a small integer over 1, 2 or 15, computed by the same
float32 operations as the JAX package's compiled path, so the two agree
exactly.  XLA compiles ``off / 15`` into a multiplication by the float32
reciprocal of 15 (one ulp away from a true division for some counts);
the port multiplies by the same constant.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import FEATURE_DIM, NUM_CHECKERS

_INV_CHECKERS = float(np.float32(1.0 / NUM_CHECKERS))


def encode(points, bar, off, turn, dtype=torch.float32):
    """Encode absolute-frame boards.

    Args:
      points: (..., 2, 24) integer per-player point counts.
      bar:    (..., 2) integer bar counts.
      off:    (..., 2) integer borne-off counts.
      turn:   (...,) integer current player (0/1); afterstates are
              encoded with the mover's one-hot.

    Returns: (..., 198) features.
    """
    n = points.to(dtype)
    ge1 = (n >= 1).to(dtype)
    ge2 = (n >= 2).to(dtype)
    ge3 = (n >= 3).to(dtype)
    extra = torch.clamp(n - 3.0, min=0.0) / 2.0
    pts = torch.stack([ge1, ge2, ge3, extra], dim=-1)  # (..., 2, 24, 4)
    pts = pts.reshape(pts.shape[:-3] + (2, 96))
    barf = bar.to(dtype)[..., None] / 2.0               # (..., 2, 1)
    offf = off.to(dtype)[..., None] * _INV_CHECKERS
    per_player = torch.cat([pts, barf, offf], dim=-1)   # (..., 2, 98)
    flat = per_player.reshape(per_player.shape[:-2] + (196,))
    t = turn.to(torch.int32)
    cur = torch.stack([(t == 0).to(dtype), (t == 1).to(dtype)], dim=-1)
    out = torch.cat([flat, cur.expand(flat.shape[:-1] + (2,))], dim=-1)
    assert out.shape[-1] == FEATURE_DIM
    return out


def encode_canonical(vecs, player, dtype=torch.float32):
    """Encode canonical (..., 52) boards for the mover ``player``, which
    broadcasts against ``vecs.shape[:-1]`` (e.g. (B, 1) against
    (B, M, 52)).  Converts back to the absolute frame inline."""
    my = vecs[..., 0:24]
    opp = vecs[..., 24:48]
    p = player.to(torch.int32)
    is_p0s = (p == 0).expand(vecs.shape[:-1])
    is_p0 = is_p0s[..., None]
    p0 = torch.where(is_p0, my, torch.flip(opp, dims=(-1,)))
    p1 = torch.where(is_p0, opp, torch.flip(my, dims=(-1,)))
    points = torch.stack([p0, p1], dim=-2)  # (..., 2, 24)
    bar = torch.stack(
        [torch.where(is_p0s, vecs[..., 48], vecs[..., 49]),
         torch.where(is_p0s, vecs[..., 49], vecs[..., 48])], dim=-1
    )
    off = torch.stack(
        [torch.where(is_p0s, vecs[..., 50], vecs[..., 51]),
         torch.where(is_p0s, vecs[..., 51], vecs[..., 50])], dim=-1
    )
    turn = p.expand(vecs.shape[:-1])
    return encode(points, bar, off, turn, dtype=dtype)


def is_race(x):
    """(..., 198) features -> (...,) bool: the position is a race, no
    checker of either side able to meet one of the other's.  Player 0 moves
    up the points, player 1 down: a race is player 0's rearmost checker
    past player 1's rearmost, a checker on the bar counting as rearmost for
    its side (player 0's at point -1, player 1's at 24) and a side with no
    checker left meeting none (``core.board.is_race`` on canonical boards).
    Columns 4 i and 98 + 4 i are each player's n >= 1 on point i, 96 and
    194 their bars."""
    idx = torch.arange(24, device=x.device)
    p0_min = torch.where(x[..., 0:96:4] > 0, idx, 99).amin(-1)
    p0_min = torch.where(x[..., 96] > 0, -1, p0_min)
    p1_max = torch.where(x[..., 98:194:4] > 0, idx, -99).amax(-1)
    p1_max = torch.where(x[..., 194] > 0, 24, p1_max)
    return p0_min > p1_max
