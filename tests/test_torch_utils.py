"""Shared helpers of the port's parity tests (no tests here).

The port (``mlp_ppo_2ply_p3_tpu_torch``) is held against the JAX package
on the same inputs: inputs are made with numpy from a seed and handed to
both sides as numpy arrays.  Torch generators cannot reproduce JAX's
threefry streams, so where JAX draws random numbers (dice, fresh games)
the helpers here replay its key schedule with the JAX package's own dice
functions and hand the draws to the port.  Torch runs on the CPU with
one thread (the suite runs under several xdist workers)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mlp_ppo_2ply_p3_tpu.core import dice as JD
from mlp_ppo_2ply_p3_tpu.core import oracle
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env as TE

from .test_movegen import abs_to_canonical_np

torch.set_num_threads(1)


def tt(x):
    """numpy / jax array -> CPU torch tensor (same dtype)."""
    return torch.from_numpy(np.array(x))


def _fresh_game_draws(key):
    """JAX ``bg_env._fresh_game``'s draws from one key: (turn, dice)."""
    k1, k2 = jax.random.split(key)
    starter = JD.roll_nondouble(k1)
    return (starter[0] < starter[1]).astype(jnp.int8), JD.roll_nondouble(k2)


@partial(jax.jit, static_argnums=1)
def _reset_draws(key, batch):
    return jax.vmap(_fresh_game_draws)(jax.random.split(key, batch))


@partial(jax.jit, static_argnums=1)
def _step_draws(key, batch):
    def one(k):
        k_fresh, k_roll = jax.random.split(k)
        turn, dice = _fresh_game_draws(k_fresh)
        return JD.roll(k_roll), turn, dice

    return jax.vmap(one)(jax.random.split(key, batch))


def jax_reset_draws(key, batch):
    """(turn, dice) that JAX ``bg_env.reset(key, cfg, batch)`` draws,
    replayed through its key schedule with the JAX package's dice."""
    return tuple(tt(x) for x in _reset_draws(key, batch))


def jax_step_draws(key, batch) -> TE.StepDraws:
    """Every random number JAX ``bg_env.step(state, actions, key, cfg)``
    draws for ``batch`` games: per game ``split(key, B)[i]`` splits into
    (k_fresh, k_roll); k_fresh gives the fresh game's starter and first
    roll, k_roll the next roll."""
    return TE.StepDraws(*(tt(x) for x in _step_draws(key, batch)))


class JaxArenaDraws:
    """An arena ``Sampler`` that replays JAX ``arena.play``'s key schedule
    (``agents/arena.py:49,55,74``): ``key`` splits into (k_reset, k_run),
    k_run into ``max_plies`` ply keys, each of those into (k_a, k_b,
    k_env).  The policies' uniforms are ``jax.random.uniform(k_side,
    shape)``, as ``basic.random_actions`` draws them."""

    def __init__(self, key, max_plies):
        self.k_reset, k_run = jax.random.split(key)
        self.plies = iter(jax.random.split(k_run, max_plies))

    def reset_draws(self, n_games):
        return jax_reset_draws(self.k_reset, n_games)

    def ply(self, n_games):
        from mlp_ppo_2ply_p3_tpu_torch.agents.arena import PlyDraws

        k_a, k_b, k_env = jax.random.split(next(self.plies), 3)
        return PlyDraws(jax_uniforms(k_a), jax_uniforms(k_b),
                        jax_step_draws(k_env, n_games))


def jax_uniforms(key):
    """A policy's draw source that returns ``jax.random.uniform(key,
    shape)``."""
    return lambda shape: tt(jax.random.uniform(key, shape))


def assert_same_tuple(got, want, names):
    """Field-by-field bit equality of two NamedTuples of arrays."""
    for g, w, name in zip(got, want, names):
        np.testing.assert_array_equal(nn_(g), np.asarray(w), err_msg=name)


def nn_(x):
    """torch tensor -> numpy."""
    return x.detach().cpu().numpy()


def random_positions(rng, n, stage):
    """n (absolute board, player) pairs from the oracle's generator."""
    boards, players = [], []
    for _ in range(n):
        boards.append(oracle.random_board(rng, stage=stage))
        players.append(int(rng.integers(0, 2)))
    return np.stack(boards), np.array(players)


def canonical(boards, players):
    return np.stack([abs_to_canonical_np(b, p)
                     for b, p in zip(boards, players)])


def split_abs(boards):
    """(N, 52) absolute boards -> points (N, 2, 24), bar (N, 2), off (N, 2)."""
    points = np.stack([boards[:, 0:24], boards[:, 24:48]], axis=1)
    return points, boards[:, 48:50].copy(), boards[:, 50:52].copy()
