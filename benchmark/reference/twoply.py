"""2-ply expectimax decisions as plain PyTorch, and the self-play loop
that plays them.

For each game the top-k 1-ply candidates (the mover's value of each
legal afterstate, -V of the board seen by the opponent, a stable
descending sort) are expanded over the 21 rolls; every opponent reply is
listed by the rules and valued for the mover, and

    score(a) = sum_r p_r * min_{reply in legal(a, r)} V(reply)

with the min over no reply taken as V(a) (the opponent dances).  The
decision is the candidate of highest score, and its score is the backup.

``Player`` plays such decisions and env steps from a seed, as the
benchmark's self-play loop does: it is the control that stands in the
program's place, in a lower precision (``precision="tf32"``) or with a
fault planted.
"""

from __future__ import annotations

import torch

from . import model as Mdl
from . import rules

NEG = -1e9
POS = 1e9
FAULTS = ("state_unchanged", "half_batch", "action_altered")


def reply_movegen(reply_max_moves):
    """The reply sweep's widths: the doubles caps above the measured
    maxima and no dedup from 482 replies up (a min ignores duplicates)."""
    m = reply_max_moves
    return rules.Movegen(max_moves=m, k1=16, k2=max(80, min(m, 128)),
                         k3=max(224, min(m, 256)), dedup_width=288,
                         dbl_div=4, dbl_add=64, dedup=m < 482)


def one_ply(params, s: rules.State, precision="float32"):
    """(B, M) the mover's value of each legal afterstate, NEG past n."""
    m = s.after.shape[1]
    y = Mdl.board_head(params, s.after, 1 - s.turn.to(torch.int32), "value",
                       precision, opponent=True)
    valid = torch.arange(m, device=y.device)[None, :] < s.n_moves[:, None]
    return torch.where(valid, -y, NEG)


def scores(params, s: rules.State, moves, top_k, reply_max_moves,
           precision="float32", rolls=range(21)):
    """(B, K) 2-ply scores of the move indices ``moves`` (B, K)."""
    b, k = moves.shape
    cand = torch.gather(s.after, 1, moves[:, :, None].long().expand(b, k, 52))
    turn = s.turn.to(torch.int32)
    dance = Mdl.board_head(params, cand, turn, "value", precision)
    flat = rules.opponent_view(cand).reshape(b * k, 52)
    us = turn.repeat_interleave(k)
    rcfg = reply_movegen(reply_max_moves)
    probs = torch.from_numpy(rules.ROLL_PROBS_21).to(cand.device)
    total = torch.zeros((b * k,), dtype=torch.float32, device=cand.device)
    weight = float(sum(rules.ROLL_PROBS_21[r] for r in rolls))
    for r in rolls:
        lo, hi = (int(x) for x in rules.ROLLS_21[r])
        boards, n, _ = rules.reply_lists(flat, (lo, hi), rcfg)
        vals = Mdl.board_head(params, boards, us, "value", precision,
                              opponent=True)
        slot = torch.arange(boards.shape[1], device=n.device)[None, :]
        worst = torch.where(slot < n[:, None], vals, POS).amin(dim=1)
        total = total + probs[r] * torch.where(n > 0, worst,
                                               dance.reshape(b * k))
    return (total / weight if len(rolls) < 21 else total).reshape(b, k)


def decide(params, s: rules.State, top_k, reply_max_moves,
           precision="float32", rolls=range(21)):
    """(action (B,) int32, backup (B,), top moves (B, k), 1-ply values
    (B, M))."""
    v1 = one_ply(params, s, precision)
    top_v, top = torch.sort(v1, dim=-1, descending=True, stable=True)
    top_v, top = top_v[:, :top_k], top[:, :top_k]
    s2 = scores(params, s, top, top_k, reply_max_moves, precision, rolls)
    s2 = torch.where(top_v > NEG / 2, s2, NEG)
    best = torch.argmax(s2, dim=-1, keepdim=True)
    return (torch.gather(top, 1, best)[:, 0].to(torch.int32),
            torch.gather(s2, 1, best)[:, 0], top, v1)


def judge(params, s: rules.State, actions, backups, top_k, reply_max_moves):
    """The program's decisions on ``s``: (the widest gap of a backup from
    the reference's, the widest gap by which a chosen move's 2-ply score
    lies below the reference's best, or its 1-ply value below the
    reference's k-th where the reference prunes it)."""
    _, best, top, v1 = decide(params, s, top_k, reply_max_moves)
    mine = scores(params, s, actions[:, None].long(), top_k,
                  reply_max_moves)[:, 0]
    has = s.n_moves > 0
    in_top = (top == actions[:, None].long()).any(dim=1)
    v1_a = torch.gather(v1, 1, actions[:, None].long())[:, 0]
    pruned = torch.where(in_top, 0.0, (v1[:, :].sort(dim=-1, descending=True)
                                       .values[:, top_k - 1] - v1_a).clamp(
                                           min=0))
    gap = torch.maximum((best - mine).clamp(min=0), pruned)
    backup_gap = (backups - best).abs()
    zero = torch.zeros((), device=gap.device)
    return (float(torch.where(has, backup_gap, zero).max()),
            float(torch.where(has, gap, zero).max()))


class Player:
    """Self-play by 2-ply decisions from ``seed``: the control."""

    def __init__(self, params, movegen: rules.Movegen, games, seed, device,
                 top_k, reply_max_moves, precision="float32", fault=None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.params, self.mg, self.b = params, movegen, games
        self.top_k, self.rmm = top_k, reply_max_moves
        self.precision, self.fault = precision, fault
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.state = rules.reset(self.gen, games, movegen)

    def ply(self):
        """(state before, action, backup); the state advances."""
        s = self.state
        rolls = range(0, 21, 2) if self.fault == "half_batch" else range(21)
        action, backup, _, _ = decide(self.params, s, self.top_k, self.rmm,
                                      self.precision, rolls)
        if self.fault == "action_altered":
            first = torch.arange(self.b, device=action.device) == 0
            action = torch.where(first, (action + 1) % s.n_moves.clamp(min=1),
                                 action).to(torch.int32)
        draws = rules.draw_step(self.gen, self.b)
        if self.fault != "state_unchanged":
            self.state, _, _ = rules.step(s, action, draws, self.mg)
        return s, action, backup
