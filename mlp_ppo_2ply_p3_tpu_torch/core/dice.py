"""Dice distributions and rolling from an explicit ``torch.Generator``.

Port of ``mlp_ppo_2ply_p3_tpu/core/dice.py``:

- normal rolls: uniform ordered pair from 36 outcomes;
- opening rolls: sampled *directly* from the 30 ordered non-double
  outcomes (distributionally identical to re-rolling doubles, but a
  fixed amount of work).

Also exposes the 21 unique sorted rolls + probabilities used by the
2-ply expectimax chance nodes.  Torch generators cannot reproduce JAX's
threefry streams, so the port matches these distributions, not streams.
"""

from __future__ import annotations

import numpy as np
import torch


def _rolls_table():
    rolls, probs = [], []
    for d0 in range(1, 7):
        for d1 in range(d0, 7):
            rolls.append((d0, d1))
            probs.append(1.0 if d0 == d1 else 2.0)
    return (
        np.array(rolls, dtype=np.int8),
        np.array(probs, dtype=np.float32) / 36.0,
    )


ROLLS_21_NP, ROLL_PROBS_21_NP = _rolls_table()
ROLLS_21 = torch.from_numpy(ROLLS_21_NP)             # (21, 2) sorted rolls
ROLL_PROBS_21 = torch.from_numpy(ROLL_PROBS_21_NP)   # (21,)


def roll(gen: torch.Generator, shape=()):
    """Uniform ordered dice pair(s): shape + (2,) int8 in 1..6, on the
    generator's device."""
    return torch.randint(
        1, 7, tuple(shape) + (2,), generator=gen, device=gen.device,
        dtype=torch.int8,
    )


def nondouble_from_index(i):
    """Map a uniform index in [0, 30) to an ordered non-double pair:
    d0 = i // 5, r = i % 5, d1 = r + (r >= d0) (the JAX package's map)."""
    i = i.to(torch.int32)
    d0 = i // 5
    r = i % 5
    d1 = r + (r >= d0).to(torch.int32)
    return torch.stack([d0 + 1, d1 + 1], dim=-1).to(torch.int8)


def roll_nondouble(gen: torch.Generator, shape=()):
    """Uniform ordered NON-double pair(s): shape + (2,) int8, d0 != d1."""
    i = torch.randint(
        0, 30, tuple(shape), generator=gen, device=gen.device,
        dtype=torch.int32,
    )
    return nondouble_from_index(i)
