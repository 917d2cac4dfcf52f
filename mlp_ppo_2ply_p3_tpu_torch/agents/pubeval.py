"""pubeval linear baseline opponent for league evaluation.

Port of ``mlp_ppo_2ply_p3_tpu/agents/pubeval.py``, whose docstring sets
out Tesauro's public ``setx`` encoding (122 inputs over the mover-relative
position, separate weights for race and contact) and why the canonical
weight values are not bundled.  Until they are loaded (``load_weights``,
or the ``PUBEVAL_WEIGHTS`` environment variable), ``heuristic_weights``
provides a deterministic hand-tuned pair over the same 122 layout.

Our canonical frame (core.board: the mover walks 0 -> 23 and bears off
past 23) maps onto pubeval's by point reversal: our point i is pubeval
point 24 - i, so pubeval's block j - 1 reads our point j - 1.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import resolve_device
from ..env import bg_env

WIN_SCORE = 99999999.0  # pubeval's pos[26]==15 short-circuit value
NEG_INF = -1e9
# XLA compiles ``off / 15`` into a multiplication by the float32
# reciprocal (core.features does the same)
_INV_CHECKERS = float(np.float32(1.0 / 15.0))


def encode_pubeval(vec):
    """Canonical (..., 52) board -> (..., 122) exact pubeval x[] encoding
    (the mover of ``vec`` is pubeval's "computer")."""
    my = vec[..., 0:24].to(torch.float32)
    opp = vec[..., 24:48].to(torch.float32)
    n = my - opp  # signed mover-relative count per point (disjoint occupancy)
    x0 = (n == -1).to(torch.float32)
    x1 = (n == 1).to(torch.float32)
    x2 = (n >= 2).to(torch.float32)
    x3 = (n == 3).to(torch.float32)
    x4 = torch.where(n >= 4, (n - 3.0) / 2.0, 0.0)
    pts = torch.stack([x0, x1, x2, x3, x4], dim=-1)  # (..., 24, 5)
    pts = pts.reshape(pts.shape[:-2] + (120,))
    opp_bar = vec[..., 49].to(torch.float32)   # pos[0] = -opp_bar
    my_off = vec[..., 50].to(torch.float32)    # pos[26]
    tail = torch.stack([opp_bar / 2.0, my_off * _INV_CHECKERS], dim=-1)
    return torch.cat([pts, tail], dim=-1)


def is_race(vec):
    """Race (no contact): the mover's rearmost checker has passed every
    opponent checker (a checker on the bar is rearmost for either side)."""
    my = vec[..., 0:24].to(torch.int32)
    opp = vec[..., 24:48].to(torch.int32)
    idx = torch.arange(24, device=vec.device)
    my_min = torch.where(my > 0, idx, 99).amin(-1)
    my_min = torch.where(vec[..., 48] > 0, -1, my_min)
    opp_max = torch.where(opp > 0, idx, -99).amax(-1)
    opp_max = torch.where(vec[..., 49] > 0, 99, opp_max)
    return my_min > opp_max


def heuristic_weights(device="cuda") -> dict:
    """Deterministic hand-tuned weights over the exact setx layout: pip
    progress, borne-off men and made points; blots and deep stacks are
    penalised in contact positions (the JAX package's values)."""
    contact = np.zeros(122, np.float32)
    race = np.zeros(122, np.float32)
    for w, blot_pen, point_bonus, opp_blot_bonus, stack_pen in (
        (contact, -0.30, 0.15, 0.05, -0.04),
        (race, 0.0, 0.0, 0.0, -0.02),
    ):
        for jm1 in range(24):
            progress = (jm1 + 1) / 25.0  # per-checker progress toward off
            w[5 * jm1 + 0] = opp_blot_bonus
            w[5 * jm1 + 1] = progress + blot_pen
            w[5 * jm1 + 2] = 2.0 * progress + point_bonus
            w[5 * jm1 + 3] = progress
            w[5 * jm1 + 4] = 2.0 * progress + stack_pen
        w[120] = 0.5   # opponent men on bar (x[120] is already +opp_bar/2)
        w[121] = 15.0  # mover men off (x[121] = off/15 -> 1.0 per checker)
    return _on_device(contact, race, device)


def _on_device(contact, race, device) -> dict:
    dev = resolve_device(device)
    return {"contact": torch.from_numpy(contact).to(dev),
            "race": torch.from_numpy(race).to(dev)}


def load_weights(path: str, device="cuda") -> dict:
    """True pubeval weights from an .npz with arrays ``contact`` (wc) and
    ``race`` (wr), each (122,) in setx order."""
    data = np.load(path)
    wc = np.asarray(data["contact"], np.float32)
    wr = np.asarray(data["race"], np.float32)
    if wc.shape != (122,) or wr.shape != (122,):
        raise ValueError(f"pubeval weights must be (122,) each, got "
                         f"{wc.shape} and {wr.shape}")
    return _on_device(wc, wr, device)


def default_weights(device="cuda") -> dict:
    path = os.environ.get("PUBEVAL_WEIGHTS", "")
    if path and os.path.exists(path):
        return load_weights(path, device)
    return heuristic_weights(device)


def evaluate(weights: dict, vec):
    """Score canonical afterstate boards (higher = better for the mover),
    as the original pubeval program does: race/contact weights, and the
    huge score once the mover has all 15 off."""
    x = encode_pubeval(vec)
    w = torch.where(is_race(vec)[..., None], weights["race"],
                    weights["contact"])
    score = torch.sum(x * w, dim=-1)
    won = vec[..., 50].to(torch.int32) >= 15
    return torch.where(won, WIN_SCORE, score)


def pubeval_actions(weights: dict, state: bg_env.EnvState, rand=None):
    """League-opponent policy: argmax linear score over legal afterstates
    (draws nothing)."""
    vals = evaluate(weights, state.after)  # (B, M)
    mask = bg_env.action_mask(state)
    return torch.argmax(torch.where(mask, vals, NEG_INF),
                        dim=-1).to(torch.int32)
