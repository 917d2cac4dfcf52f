"""2-ply expectimax move selection, batched.

Port of ``mlp_ppo_2ply_p3_tpu/agents/twoply.py`` (its docstring has the
design and the width guarantees).  For each game the top-k 1-ply
candidates are expanded over the 21-roll chance axis; the opponent's
replies are enumerated by the same fixed-shape movegen as the env, every
reply afterstate is scored by the value net from the mover's
perspective, and

    score(a) = sum_r p_r * min_{reply in legal(a, r)} V(reply board)

with the min over an empty reply set defined as V(a) (the opponent
dances).

- The chance split is static: the 15 non-doubles rolls run
  ``movegen.nondoubles_afterstates_batch`` and the 6 doubles dies run
  ``movegen.doubles_afterstates_batch``.
- Each leg walks the flattened (B * top_k) candidate axis in
  ``SearchConfig.game_chunk`` / ``dbl_game_chunk`` chunks, padded to a
  whole number of chunks so that every launch has a static shape; each
  reply list is reduced to its masked min in ``eval_slot_chunk``-wide
  feature blocks.  ``lax.map`` / ``lax.scan`` become Python loops.
  Chunking cannot change a result: the min and the sums are per
  candidate.
- Non-doubles replies skip dedup (a min ignores duplicates) while the
  reply width is at least 482, the raw maximum; below it dedup is kept.
- Top-k keeps ``lax.top_k``'s order: a stable descending sort, so that
  among equal values (every game with fewer than k moves ties at -1e9)
  the lower index comes first.
"""

from __future__ import annotations

import torch

from ..core import board as Bd
from ..core import dice as D
from ..core import features as F
from ..core import movegen as MG
from ..env import bg_env
from ..models.mlp import MLP
from ..utils.config import SearchConfig
from .basic import afterstate_values

NEG_INF = -1e9
POS_INF = 1e9
I32 = torch.int32

# static chance-node split: indices into dice.ROLLS_21 (sorted (lo, hi)
# pairs; doubles sit where lo == hi)
_DBL_IDX = tuple(i for i in range(21)
                 if D.ROLLS_21_NP[i, 0] == D.ROLLS_21_NP[i, 1])
_ND_IDX = tuple(i for i in range(21) if i not in _DBL_IDX)
assert len(_DBL_IDX) == 6 and len(_ND_IDX) == 15


def _reply_cfg(scfg: SearchConfig) -> MG.MovegenConfig:
    """Reply-enumeration widths: doubles caps above the measured maxima
    (L2 44 / L3 161 / final 459); non-doubles replies compact raw
    candidates straight into the M'-wide list, provably overflow-free at
    M' >= 482; below 482 dedup is kept so that the cap bounds unique
    boards."""
    m = scfg.reply_max_moves
    return MG.MovegenConfig(
        max_moves=m,
        k2=max(80, min(m, 128)),
        k3=max(224, min(m, 256)),
        dedup_width=288,
        dedup=m < 482,
    )


def _masked_min_values(model: MLP, boards, n, us, slot_chunk: int):
    """(C,) min value over each game's valid reply prefix; +POS_INF where
    n == 0.  ``boards`` (C, M, 52) are in the OPPONENT's canonical frame
    (they just replied); flipped back to ours they are encoded with
    mover ``us`` (C,).  The reply axis is walked in ``slot_chunk``-wide
    blocks, so features are never built at (C, M, 198) at once."""
    c, m, _ = boards.shape
    sc = min(slot_chunk, m)
    pad = (-m) % sc
    if pad:
        boards = torch.nn.functional.pad(boards, (0, 0, 0, pad))
    ours = Bd.opponent_view(boards)
    slots = torch.arange(sc, device=boards.device)
    worst = torch.full((c,), POS_INF, dtype=torch.float32,
                       device=boards.device)
    for s0 in range(0, m + pad, sc):
        feats = F.encode_canonical(ours[:, s0:s0 + sc], us[:, None])
        vals = model.value(feats)                              # (C, sc)
        valid = (s0 + slots)[None, :] < n[:, None]
        blk = torch.where(valid, vals, POS_INF).amin(dim=1)
        worst = torch.minimum(worst, blk)
    return worst


def _reply_leg(model: MLP, vecs, us, dance, chunk: int, slot_chunk: int,
               dice_xs, movegen_fn):
    """Sweep one static leg (non-doubles or doubles) of the chance node:
    every roll in ``dice_xs`` against every candidate board in ``vecs``
    (flattened (BK, 52)), chunked over the candidate axis.  Returns
    (worst (R, BK), dance-filled where a roll has no replies;
    overflow (BK,))."""
    bk = vecs.shape[0]
    c = min(chunk, bk)
    pad = (-bk) % c
    if pad:
        vecs = torch.nn.functional.pad(vecs, (0, 0, 0, pad))
        us = torch.nn.functional.pad(us, (0, pad))
        dance = torch.nn.functional.pad(dance, (0, pad))
    worsts, ovfs = [], []
    for c0 in range(0, bk + pad, c):
        cv, cu, cd = vecs[c0:c0 + c], us[c0:c0 + c], dance[c0:c0 + c]
        rows, any_ovf = [], torch.zeros((c,), dtype=torch.bool,
                                        device=vecs.device)
        for d in dice_xs:
            boards, n, ovf = movegen_fn(cv, d)
            worst = _masked_min_values(model, boards, n, cu, slot_chunk)
            rows.append(torch.where(n > 0, worst, cd))
            any_ovf = any_ovf | ovf
        worsts.append(torch.stack(rows))                     # (R, C)
        ovfs.append(any_ovf)
    return torch.cat(worsts, dim=1)[:, :bk], torch.cat(ovfs)[:bk]


def launches_per_decision(batch: int, scfg: SearchConfig = SearchConfig()):
    """(compact_rows, dedup_compact_rows) launches of one decision over
    ``batch`` games: per chunk, each non-doubles roll makes the stacked
    k1 compaction and the raw one (then one dedup below width 482), each
    doubles die its four levels."""
    rcfg = _reply_cfg(scfg)
    bk = batch * scfg.top_k
    nd = -(-bk // min(scfg.game_chunk, bk)) * len(_ND_IDX)
    db = -(-bk // min(scfg.dbl_game_chunk, bk)) * len(_DBL_IDX)
    return 2 * nd + 4 * db, nd * MG.dedups_per_call(rcfg)


@torch.no_grad()
def candidate_scores(model: MLP, state: bg_env.EnvState,
                     scfg: SearchConfig = SearchConfig()):
    """(top_idx (B, k) move indices, score2 (B, k) their 2-ply scores,
    -1e9 where a game has fewer than k moves; overflow (B,))."""
    k = scfg.top_k
    b = state.turn.shape[0]
    dev = state.turn.device
    mask = bg_env.action_mask(state)

    # ---- 1-ply scores and top-k pruning -------------------------------
    v1 = torch.where(mask, afterstate_values(model, state), NEG_INF)
    top_v, top_idx = torch.sort(v1, dim=-1, descending=True, stable=True)
    top_v, top_idx = top_v[:, :k], top_idx[:, :k]
    top_valid = top_v > NEG_INF / 2
    cand = torch.gather(state.after, 1,
                        top_idx[:, :, None].expand(b, k, 52))  # (B, k, 52)
    # our value of a candidate when it is our turn again (opponent dance)
    v_dance = model.value(F.encode_canonical(cand, state.turn[:, None]))

    # ---- opponent chance/reply sweep (static roll split) --------------
    rcfg = _reply_cfg(scfg)
    flat_vecs = Bd.opponent_view(cand).reshape(b * k, 52)
    flat_us = state.turn.repeat_interleave(k)
    flat_dance = v_dance.reshape(b * k)

    def nd_fn(cv, roll):
        lo, hi = roll
        full = lambda d: torch.full((cv.shape[0],), d, dtype=I32, device=dev)
        return MG.nondoubles_afterstates_batch(cv, full(hi), full(lo), rcfg)

    def dbl_fn(cv, die):
        die = torch.full((cv.shape[0],), die, dtype=I32, device=dev)
        return MG.doubles_afterstates_batch(cv, die, rcfg)

    nd_rolls = [tuple(int(x) for x in D.ROLLS_21_NP[i]) for i in _ND_IDX]
    dbl_dies = [int(D.ROLLS_21_NP[i, 0]) for i in _DBL_IDX]
    w_nd, of_nd = _reply_leg(model, flat_vecs, flat_us, flat_dance,
                             scfg.game_chunk, scfg.eval_slot_chunk,
                             nd_rolls, nd_fn)                   # (15, BK)
    w_db, of_db = _reply_leg(model, flat_vecs, flat_us, flat_dance,
                             scfg.dbl_game_chunk, scfg.eval_slot_chunk,
                             dbl_dies, dbl_fn)                  # (6, BK)

    probs = D.ROLL_PROBS_21.to(dev)
    p_nd, p_db = probs[list(_ND_IDX)], probs[list(_DBL_IDX)]
    score2 = (torch.sum(p_nd[:, None] * w_nd, dim=0)
              + torch.sum(p_db[:, None] * w_db, dim=0)).reshape(b, k)
    score2 = torch.where(top_valid, score2, NEG_INF)
    overflow = (of_nd | of_db).reshape(b, k).any(dim=1)
    return top_idx, score2, overflow


def twoply_actions_values(model: MLP, state: bg_env.EnvState,
                          scfg: SearchConfig = SearchConfig()):
    """(action (B,) int32, backup score (B,), overflow (B,)): the
    expert-iteration interface.  The backup score of the chosen move is
    the 2-ply expectimax value of the state for the mover, the value-head
    distillation target."""
    top_idx, score2, overflow = candidate_scores(model, state, scfg)
    best_k = torch.argmax(score2, dim=-1, keepdim=True)       # (B, 1)
    best2 = torch.gather(score2, 1, best_k)[:, 0]
    action = torch.gather(top_idx, 1, best_k)[:, 0]
    return action.to(I32), best2, overflow


def twoply_actions_report(model: MLP, state: bg_env.EnvState,
                          scfg: SearchConfig = SearchConfig()):
    """(B,) actions by 2-ply expectimax over the current legal moves, and
    a (B,) bool report of any reply-movegen overflow."""
    action, _, overflow = twoply_actions_values(model, state, scfg)
    return action, overflow


def twoply_actions(model: MLP, state: bg_env.EnvState,
                   scfg: SearchConfig = SearchConfig()):
    """(B,) actions by 2-ply expectimax (see twoply_actions_report)."""
    return twoply_actions_values(model, state, scfg)[0]
