"""Batched lockstep backgammon environment over torch tensors.

Port of ``mlp_ppo_2ply_p3_tpu/env/bg_env.py``: ``B`` games advance in
lockstep; state is an immutable ``EnvState`` of tensors on one device.
Reference semantics kept exactly:

- reset: a non-double roll decides the starter (higher first die ->
  player 0), a second non-double roll is the first-move roll;
- step on a finished game auto-resets and returns ``done=True`` with 0
  reward;
- no legal move => auto-pass consuming the step, reward 0;
- invalid action index => reward -1, state unchanged, same player
  retries;
- win detection with gammon (x1.5) / backgammon (x2.0) rewards and
  1/2/3 match scoring to ``match_length``.

Randomness is drawn in one place and applied in another: ``draw_step``
takes every random number a step needs (rolled dice, fresh-game turn and
dice for all B games) from an explicit ``torch.Generator``, and
``step_with_draws`` applies them.  Tests feed the second one draws
replayed from the JAX package's key schedule.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from .. import resolve_device
from ..core import board as B
from ..core import dice as D
from ..core import features as F
from ..core.constants import (
    INITIAL_POINTS_P1,
    INITIAL_POINTS_P2,
    MATCH_LENGTH,
    NUM_CHECKERS,
    REWARD_INVALID_ACTION,
    REWARD_WIN_BACKGAMMON,
    REWARD_WIN_GAMMON,
    REWARD_WIN_NORMAL,
)
from ..core.movegen import MovegenConfig, legal_afterstates_batch
from ..parallel import mesh
from ..utils.profiling import span

I8 = torch.int8
I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    match_length: int = MATCH_LENGTH
    movegen: MovegenConfig = MovegenConfig()

    @property
    def max_moves(self) -> int:
        return self.movegen.max_moves


class EnvState(NamedTuple):
    """All tensors carry a leading batch axis B."""

    points: torch.Tensor      # (B, 2, 24) int8 absolute per-player counts
    bar: torch.Tensor         # (B, 2) int8
    off: torch.Tensor         # (B, 2) int8
    turn: torch.Tensor        # (B,) int8 current player
    dice: torch.Tensor        # (B, 2) int8
    score: torch.Tensor       # (B, 2) int32 match scores
    game_over: torch.Tensor   # (B,) bool
    match_over: torch.Tensor  # (B,) bool
    after: torch.Tensor       # (B, M, 52) int8 canonical afterstates
    n_moves: torch.Tensor     # (B,) int32
    overflow: torch.Tensor    # (B,) bool movegen width-cap saturation


class StepInfo(NamedTuple):
    reward: torch.Tensor      # (B,) float32
    done: torch.Tensor        # (B,) bool
    winner: torch.Tensor      # (B,) int8, -1 if game not won this step
    game_score: torch.Tensor  # (B,) int32, 0/1/2/3
    invalid: torch.Tensor     # (B,) bool
    passed: torch.Tensor      # (B,) bool (auto-pass steps)


class StepDraws(NamedTuple):
    """Every random number one ``step`` consumes, for all B games."""

    rolled: torch.Tensor      # (B, 2) int8 next roll after a half-turn
    fresh_turn: torch.Tensor  # (B,) int8 starter of an auto-reset game
    fresh_dice: torch.Tensor  # (B, 2) int8 its first (non-double) roll


@functools.lru_cache(maxsize=None)
def initial_points(device) -> torch.Tensor:
    """(2, 24) int8 starting position, absolute frame.  Cached per device
    (callers never write to it) so a step makes no host-to-device copy,
    which would wait for the card."""
    pts = torch.zeros((2, 24), dtype=I8)
    for p, n in INITIAL_POINTS_P1.items():
        pts[0, p] = n
    for p, n in INITIAL_POINTS_P2.items():
        pts[1, p] = n
    return pts.to(device)


def draw_fresh(gen: torch.Generator, batch_size: int):
    """Fresh-game draws: the starter is decided by a non-double roll
    (roll[0] < roll[1] -> player 2 starts), then a second non-double roll
    is the first-move roll.  Returns (turn (B,) int8, dice (B, 2) int8)."""
    starter = D.roll_nondouble(gen, (batch_size,))
    turn = (starter[:, 0] < starter[:, 1]).to(I8)
    return turn, D.roll_nondouble(gen, (batch_size,))


def draw_step(gen: torch.Generator, batch_size: int) -> StepDraws:
    rolled = D.roll(gen, (batch_size,))
    fresh_turn, fresh_dice = draw_fresh(gen, batch_size)
    return StepDraws(rolled, fresh_turn, fresh_dice)


def _movegen_batch(points, bar, off, turn, dice_, cfg: EnvConfig,
                   world=None):
    """(B, ...) absolute arrays -> (after, n, overflow); ``mirror`` keeps
    the list in the reference's generation order for both players.  With
    a ``world`` the B games are this rank's shard (every rank calls)."""
    vecs = B.to_canonical(points, bar, off, turn)
    return legal_afterstates_batch(vecs, dice_, cfg.movegen,
                                   mirror=turn == 1, world=world)


def make_state(points, bar, off, turn, dice_, cfg: EnvConfig,
               world=None) -> EnvState:
    """Build an EnvState from (batched) board tensors: computes the
    legal-move cache; scores and flags zeroed."""
    bsz = turn.shape[0]
    dev = turn.device
    after, n, ovf = _movegen_batch(points, bar, off, turn, dice_, cfg, world)
    zb = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    return EnvState(
        points=points.to(I8),
        bar=bar.to(I8),
        off=off.to(I8),
        turn=turn.to(I8),
        dice=dice_.to(I8),
        score=torch.zeros((bsz, 2), dtype=I32, device=dev),
        game_over=zb,
        match_over=zb.clone(),
        after=after,
        n_moves=n,
        overflow=ovf,
    )


def reset_with_draws(turn, dice_, cfg: EnvConfig, world=None) -> EnvState:
    """B fresh games from given starter turns and first rolls."""
    bsz = turn.shape[0]
    pts = initial_points(turn.device).expand(bsz, 2, 24).clone()
    zero2 = torch.zeros((bsz, 2), dtype=I8, device=turn.device)
    return make_state(pts, zero2, zero2.clone(), turn, dice_, cfg, world)


def reset(gen: torch.Generator, cfg: EnvConfig, batch_size: int,
          device="cuda", world=None) -> EnvState:
    """B fresh games on ``device``; ``gen`` must live on that device.
    With a ``world`` (``parallel.mesh.World``) the draws are made for all
    ``batch_size`` games and this rank's shard of them is built; every
    rank must call."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, device is {dev}")
    turn, dc = mesh.shard_batch(draw_fresh(gen, batch_size), world)
    return reset_with_draws(turn, dc, cfg, world)


def step_with_draws(state: EnvState, actions, draws: StepDraws,
                    cfg: EnvConfig, world=None):
    """Advance all B games one half-turn with the given random draws.
    Returns (state', StepInfo).  With a ``world`` the games are this
    rank's shard (and ``draws`` its rows): every rank must call, since
    movegen places the games in the global batch."""
    with span("env_step"):
        s = state
        bsz = s.turn.shape[0]
        dev = s.turn.device
        not_ = torch.logical_not

        was_over = s.game_over
        no_moves = not_(was_over) & (s.n_moves == 0)
        action = actions.to(I32)
        live = not_(was_over) & not_(no_moves)
        invalid = live & ((action < 0) | (action >= s.n_moves))
        commit = live & not_(invalid)

        idx = action.clamp(0, cfg.max_moves - 1).long()
        chosen = torch.gather(
            s.after, 1, idx[:, None, None].expand(bsz, 1, 52))[:, 0]  # (B, 52)
        win = commit & (chosen[:, B.MY_OFF].to(I32) >= NUM_CHECKERS)
        # gammon / backgammon in the canonical frame: loser bore off none;
        # backgammon adds loser checkers in the winner's home (canonical
        # 18..23) or on the bar
        opp_off0 = chosen[:, B.OPP_OFF].to(I32) == 0
        opp_in_home = chosen[:, 24 + 18:48].to(I32).sum(-1) > 0
        opp_on_bar = chosen[:, B.OPP_BAR].to(I32) > 0
        is_backgammon = win & opp_off0 & (opp_in_home | opp_on_bar)
        is_gammon = win & opp_off0 & not_(is_backgammon)
        game_score = torch.where(
            win,
            torch.where(is_backgammon, 3, torch.where(is_gammon, 2, 1)),
            0,
        ).to(I32)
        win_reward = torch.where(
            is_backgammon, REWARD_WIN_BACKGAMMON,
            torch.where(is_gammon, REWARD_WIN_GAMMON, REWARD_WIN_NORMAL),
        )
        reward = (
            torch.where(invalid, REWARD_INVALID_ACTION, 0.0)
            + torch.where(win, win_reward, 0.0)
        ).to(torch.float32)
        done = was_over | win

        # --- next board / turn / dice --------------------------------------
        c_pts, c_bar, c_off = B.from_canonical(chosen, s.turn)
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
        n_dice = torch.where(
            wo, draws.fresh_dice,
            torch.where(flip[:, None], draws.rolled, s.dice),
        ).to(I8)

        # --- scores / flags -------------------------------------------------
        score = torch.where((was_over & s.match_over)[:, None], 0, s.score)
        is_mover = (torch.arange(2, device=dev)[None, :]
                    == s.turn.to(I32)[:, None])
        win_add = torch.where(win[:, None] & is_mover, game_score[:, None], 0)
        score = (score + win_add).to(I32)
        match_over = torch.where(
            was_over, False,
            s.match_over | (win & (score.amax(-1) >= cfg.match_length)),
        )
        game_over = torch.where(was_over, False, s.game_over | win)

        after, n_mv, ovf = _movegen_batch(n_pts, n_bar, n_off, n_turn, n_dice,
                                          cfg, world)
        n_mv = torch.where(game_over, 0, n_mv)
        ns = EnvState(
            points=n_pts, bar=n_bar, off=n_off, turn=n_turn, dice=n_dice,
            score=score, game_over=game_over, match_over=match_over,
            after=after, n_moves=n_mv, overflow=ovf,
        )
        info = StepInfo(
            reward=reward,
            done=done,
            winner=torch.where(win, s.turn, -1).to(I8),
            game_score=game_score,
            invalid=invalid,
            passed=no_moves,
        )
        return ns, info


def step(state: EnvState, actions, gen: torch.Generator, cfg: EnvConfig):
    """Advance all B games one half-turn, drawing from ``gen``."""
    return step_with_draws(state, actions,
                           draw_step(gen, state.turn.shape[0]), cfg)


# --- observations -----------------------------------------------------------


def observe(state: EnvState):
    """Current-state features (B, 198) — the policy input."""
    return F.encode(state.points, state.bar, state.off, state.turn)


def action_mask(state: EnvState):
    """(B, M) prefix mask over the legal-move list."""
    m = state.after.shape[1]
    return (torch.arange(m, device=state.after.device)[None, :]
            < state.n_moves[:, None])


def afterstate_features(state: EnvState):
    """(B, M, 198) features of every legal afterstate, encoded with the
    mover's one-hot."""
    return F.encode_canonical(state.after, state.turn[:, None])
