"""League / arena evaluation: pit two policies against each other over a
batch of lockstep games and measure honest win rates.

Port of ``mlp_ppo_2ply_p3_tpu/agents/arena.py``.  Both policies act on
every game each ply and are selected by side; A plays player 0 in even
games and player 1 in odd games; each game's first completion is
latched and scored; ``plies`` counts the half-turns of unfinished games.

A policy is ``(params, state, rand) -> (B,) int32 actions`` (see
``agents.basic``).  Every random number of a run comes from a
``Sampler``: the reset draws, and per ply the env's ``StepDraws`` and one
uniform source for each side.  Tests substitute one that replays the
JAX package's key schedule.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import resolve_device
from ..env import bg_env
from ..ppo.learner import Rand, uniforms

Policy = Callable[[object, bg_env.EnvState, Rand], torch.Tensor]


class ArenaResult(NamedTuple):
    wins_a: torch.Tensor     # () int32
    wins_b: torch.Tensor     # ()
    finished: torch.Tensor   # () games that reached a result
    points_a: torch.Tensor   # () total match points (gammons count 2, bg 3)
    points_b: torch.Tensor   # ()
    plies: torch.Tensor      # () half-turns played up to each game's first
    #                           completion (unfinished games: max_plies)


class PlyDraws(NamedTuple):
    rand_a: Rand
    rand_b: Rand
    env: bg_env.StepDraws


class Sampler:
    """Every random draw of an arena run, from one generator."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def reset_draws(self, n_games: int):
        """(turn (B,) int8, dice (B, 2) int8) of the fresh games."""
        return bg_env.draw_fresh(self.gen, n_games)

    def ply(self, n_games: int) -> PlyDraws:
        return PlyDraws(uniforms(self.gen), uniforms(self.gen),
                        bg_env.draw_step(self.gen, n_games))


def _start(draws, env_cfg, n_games, device):
    """(sampler, state, a_side, latch carry) of a fresh run."""
    dev = resolve_device(device)
    if isinstance(draws, torch.Generator):
        if draws.device.type != dev.type:
            raise ValueError(f"generator on {draws.device}, device is {dev}")
        draws = Sampler(draws)
    state = bg_env.reset_with_draws(*draws.reset_draws(n_games), env_cfg)
    a_side = (torch.arange(n_games, device=dev) % 2).to(torch.int8)
    carry = (
        torch.zeros((n_games,), dtype=torch.bool, device=dev),
        torch.full((n_games,), -1, dtype=torch.int8, device=dev),
        torch.zeros((n_games,), dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev),
    )
    return draws, state, a_side, carry


def _ply(policy_a, params_a, policy_b, params_b, draws, state, a_side,
         carry, env_cfg):
    """One half-turn of every game, with first-completion latching."""
    done, winner_side, game_score, plies = carry
    d = draws.ply(state.turn.shape[0])
    act_a = policy_a(params_a, state, d.rand_a)
    act_b = policy_b(params_b, state, d.rand_b)
    actions = torch.where(state.turn == a_side, act_a, act_b)
    plies = plies + torch.logical_not(done).sum(dtype=torch.int32)
    state, info = bg_env.step_with_draws(state, actions, d.env, env_cfg)
    won = info.winner >= 0
    won_now = won & torch.logical_not(done)
    winner_side = torch.where(won_now, info.winner, winner_side)
    game_score = torch.where(won_now, info.game_score, game_score)
    return state, (done | won, winner_side, game_score, plies)


def _result(a_side, carry) -> ArenaResult:
    done, winner_side, game_score, plies = carry
    a_won = done & (winner_side == a_side)
    b_won = done & (winner_side == (1 - a_side))
    return ArenaResult(
        wins_a=a_won.sum(dtype=torch.int32),
        wins_b=b_won.sum(dtype=torch.int32),
        finished=done.sum(dtype=torch.int32),
        points_a=torch.where(a_won, game_score, 0).sum(dtype=torch.int32),
        points_b=torch.where(b_won, game_score, 0).sum(dtype=torch.int32),
        plies=plies,
    )


@torch.no_grad()
def play(policy_a: Policy, params_a, policy_b: Policy, params_b, draws,
         env_cfg: bg_env.EnvConfig, n_games: int, max_plies: int = 400,
         device="cuda") -> ArenaResult:
    """Play ``n_games`` lockstep for ``max_plies`` half-turns with no host
    synchronisation.  ``draws`` is a ``torch.Generator`` on ``device``
    or a ``Sampler``."""
    draws, state, a_side, carry = _start(draws, env_cfg, n_games, device)
    for _ in range(max_plies):
        state, carry = _ply(policy_a, params_a, policy_b, params_b, draws,
                            state, a_side, carry, env_cfg)
    return _result(a_side, carry)


@torch.no_grad()
def play_hostloop(policy_a: Policy, params_a, policy_b: Policy, params_b,
                  draws, env_cfg: bg_env.EnvConfig, n_games: int,
                  max_plies: int = 400, device="cuda") -> ArenaResult:
    """``play``, but the host reads the latch after every ply and stops
    once every game is finished (for heavyweight search policies, whose
    plies cost seconds).  Same result as ``play``."""
    draws, state, a_side, carry = _start(draws, env_cfg, n_games, device)
    for _ in range(max_plies):
        state, carry = _ply(policy_a, params_a, policy_b, params_b, draws,
                            state, a_side, carry, env_cfg)
        if bool(carry[0].all()):
            break
    return _result(a_side, carry)


# the JAX package's compiled entry, kept so that callers port line for line
play_jit = play


def win_rate(result: ArenaResult) -> float:
    return float(result.wins_a) / max(1, int(result.finished))
