"""Port parity: the batched environment (``env/bg_env.py``).

The port's ``step`` takes its random numbers from ``draw_step`` and
applies them in ``step_with_draws``; here the draws are JAX's own,
replayed from its key schedule, so both packages must produce the same
states and step infos bit for bit (rewards are small exact floats:
tolerance 0).  Covered: reset, random play with invalid actions,
auto-pass, normal win / gammon / backgammon for both players, match end
and auto-reset, and the three observation functions."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mlp_ppo_2ply_p3_tpu.core.movegen import MovegenConfig as JMovegenConfig
from mlp_ppo_2ply_p3_tpu.env import bg_env as JE
from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env as TE

from .test_torch_utils import (
    assert_same_tuple,
    jax_reset_draws,
    jax_step_draws,
    nn_,
    tt,
)

B = 8
# the slice's movegen widths; a short match so that matches end
JCFG = JE.EnvConfig(match_length=3, movegen=JMovegenConfig.fast(256))
TCFG = TE.EnvConfig(match_length=3, movegen=MovegenConfig.fast(256))
STATE_FIELDS = TE.EnvState._fields
INFO_FIELDS = TE.StepInfo._fields


def _step_both(js, ts, actions, key):
    js2, jinfo = JE.step(js, jnp.asarray(actions), key, JCFG)
    ts2, tinfo = TE.step_with_draws(ts, tt(actions), jax_step_draws(key, B),
                                    TCFG)
    assert_same_tuple(ts2, js2, STATE_FIELDS)
    assert_same_tuple(tinfo, jinfo, INFO_FIELDS)
    return js2, ts2, tinfo


def _observations_match(js, ts):
    np.testing.assert_array_equal(nn_(TE.observe(ts)),
                                  np.asarray(JE.observe(js)))
    np.testing.assert_array_equal(nn_(TE.action_mask(ts)),
                                  np.asarray(JE.action_mask(js)))
    np.testing.assert_array_equal(nn_(TE.afterstate_features(ts)),
                                  np.asarray(JE.afterstate_features(js)))


def test_reset_and_random_play_step_for_step():
    key = jax.random.PRNGKey(7)
    js = JE.reset(key, JCFG, B)
    ts = TE.reset_with_draws(*jax_reset_draws(key, B), TCFG)
    assert_same_tuple(ts, js, STATE_FIELDS)
    _observations_match(js, ts)

    rng = np.random.default_rng(7)
    seen = {"done": 0, "invalid": 0, "win": 0}
    for t in range(160):
        n = nn_(ts.n_moves)
        actions = (rng.random(B) * np.maximum(n, 1)).astype(np.int32)
        # now and then an out-of-range index: reward -1, same mover
        bad = rng.random(B) < 0.05
        actions[bad] = np.where(rng.random(B) < 0.5, -1, n)[bad]
        key, k = jax.random.split(key)
        js, ts, info = _step_both(js, ts, actions, k)
        seen["done"] += int(info.done.sum())
        seen["invalid"] += int(info.invalid.sum())
        seen["win"] += int((info.winner >= 0).sum())
        if t % 40 == 0:
            _observations_match(js, ts)
    assert seen["done"] > 0 and seen["invalid"] > 0 and seen["win"] > 0, seen


def _board(p0_points, p1_points, bar=(0, 0), off=(0, 0)):
    pts = np.zeros((2, 24), np.int8)
    for p, pp in enumerate((p0_points, p1_points)):
        for i, c in pp.items():
            pts[p, i] = c
    for p in (0, 1):
        assert pts[p].sum() + bar[p] + off[p] == 15
    return pts, np.array(bar, np.int8), np.array(off, np.int8)


def test_endgames_pass_invalid_and_match_end():
    """Crafted rows, each stepped twice: the mover bears off its last
    checker for a normal win, a gammon and a backgammon (player 0 and
    player 1); a bar checker facing a closed board auto-passes; an index
    past the list is invalid.  The backgammon (3 points) ends the
    3-point match, so the next step resets the score; every winner's
    game auto-resets from the draws."""
    rows = [
        # player 0 wins: normal, gammon, backgammon (loser in 18..23)
        (_board({23: 1}, {0: 14}, off=(14, 1)), 0),
        (_board({23: 1}, {3: 15}, off=(14, 0)), 0),
        (_board({23: 1}, {3: 14, 20: 1}, off=(14, 0)), 0),
        # player 1 wins: normal, gammon, backgammon (loser on the bar)
        (_board({23: 14}, {0: 1}, off=(1, 14)), 1),
        (_board({20: 15}, {0: 1}, off=(0, 14)), 1),
        (_board({20: 14}, {0: 1}, bar=(1, 0), off=(0, 14)), 1),
        # player 0 on the bar, entry points 0..5 all closed: auto-pass
        (_board({10: 14}, {0: 2, 1: 2, 2: 2, 3: 2, 4: 2, 5: 5},
                bar=(1, 0)), 0),
        # opening position, invalid index
        (_board({0: 2, 11: 5, 16: 3, 18: 5}, {23: 2, 12: 5, 7: 3, 5: 5}), 1),
    ]
    points = np.stack([r[0][0] for r in rows])
    bar = np.stack([r[0][1] for r in rows])
    off = np.stack([r[0][2] for r in rows])
    turn = np.array([r[1] for r in rows], np.int8)
    dice = np.tile(np.array([[6, 5]], np.int8), (B, 1))

    js = JE.make_state(*(jnp.asarray(x) for x in (points, bar, off, turn,
                                                    dice)), JCFG)
    ts = TE.make_state(*(tt(x) for x in (points, bar, off, turn, dice)),
                       TCFG)
    assert_same_tuple(ts, js, STATE_FIELDS)
    assert int(ts.n_moves[6]) == 0

    actions = np.zeros(B, np.int32)
    actions[7] = TCFG.max_moves - 1
    js, ts, info = _step_both(js, ts, actions, jax.random.PRNGKey(3))
    np.testing.assert_array_equal(nn_(info.game_score)[:6], [1, 2, 3] * 2)
    np.testing.assert_array_equal(nn_(info.reward)[:6], [1.0, 1.5, 2.0] * 2)
    assert bool(info.passed[6]) and bool(info.invalid[7])
    assert float(info.reward[7]) == -1.0
    np.testing.assert_array_equal(nn_(ts.match_over),
                                  [0, 0, 1, 0, 0, 1, 0, 0])

    js, ts, info = _step_both(js, ts, np.zeros(B, np.int32),
                              jax.random.PRNGKey(4))
    assert nn_(info.done)[:6].all()
    np.testing.assert_array_equal(nn_(ts.score)[[2, 5]], 0)
    assert int(ts.score[1].sum()) == 2
    _observations_match(js, ts)


def test_step_draws_shapes_and_reset_on_device_arg():
    """The port's own draws: shapes, ranges, non-double fresh rolls; and
    ``reset`` on an explicit CPU device."""
    gen = torch.Generator().manual_seed(0)
    d = TE.draw_step(gen, 64)
    assert d.rolled.shape == (64, 2) and d.fresh_dice.shape == (64, 2)
    assert d.rolled.dtype == torch.int8 and d.fresh_turn.dtype == torch.int8
    assert int(d.rolled.min()) >= 1 and int(d.rolled.max()) <= 6
    assert bool((d.fresh_dice[:, 0] != d.fresh_dice[:, 1]).all())
    state = TE.reset(gen, TCFG, 16, device="cpu")
    assert state.after.shape == (16, TCFG.max_moves, 52)
    assert bool((state.n_moves > 0).all())
