"""Port parity: 2-ply distillation (``scripts/run_distill.py`` ->
``mlp_ppo_2ply_p3_tpu_torch/scripts/run_distill.py``) on the committed
frozen_v1 net, at the script's widths (``MovegenConfig.fast(256)``, the
default ``SearchConfig``; the chunks differ, which changes no result).

- ``collect`` and ``collect_outcomes``, 16 games x 4 plies from the
  endgame positions of ``test_torch_learner.py`` (games end and restart
  inside the window), JAX's env draws replayed: actions exact where the
  best 2-ply score leads the second by more than 1e-4 (as
  ``test_torch_twoply.py``; at this seed every game takes JAX's action,
  so the trajectories stay aligned); observations, afterstates, move
  counts and movers exact; backup targets within 1e-5; outcome targets
  and the resolved mask exact.
- One ``make_update`` step on the collected minibatch (64 states) ==
  JAX's ``update`` with ``optax.adam``: loss, CE and MSE within 1e-5;
  Adam's first moment (0.1 x the gradient) within rtol 1e-4 and atol
  1e-8 (2e-6 of its largest entry; measured 2.5e-9); every
  parameter within 1e-6, except where the gradient is at its rounding
  noise (|g| < 1e-6: inputs that are almost never on in 64 states, and
  the score head's bias, whose exact gradient is zero): Adam's first
  step is lr g / (|g| + 1e-8), so there it may take either sign, and
  the bound is lr.
- ``main`` at ``--device cpu`` with tiny flags writes records with the
  JAX script's keys, for both target kinds."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.agents import frozen as JF
from mlp_ppo_2ply_p3_tpu.core.movegen import MovegenConfig as JMovegenConfig
from mlp_ppo_2ply_p3_tpu.env import bg_env as JE
from mlp_ppo_2ply_p3_tpu.utils.config import SearchConfig as JSearchConfig
from mlp_ppo_2ply_p3_tpu_torch.agents import arena, frozen, twoply
from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env as TE
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
from mlp_ppo_2ply_p3_tpu_torch.scripts import run_distill as TD
from mlp_ppo_2ply_p3_tpu_torch.utils import convert
from mlp_ppo_2ply_p3_tpu_torch.utils.config import SearchConfig

from .test_torch_learner import endgame_positions
from .test_torch_utils import jax_step_draws, nn_, tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAMES, PLIES, LR = 16, 4, 3e-4
JENV = JE.EnvConfig(movegen=JMovegenConfig.fast(256))
TENV = TE.EnvConfig(movegen=MovegenConfig.fast(256))


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_run_distill", os.path.join(REPO, "scripts", "run_distill.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Replay:
    """The env draws of the JAX script's key schedule: each ply splits
    ``key`` into (key, k_env) and steps with k_env."""

    def __init__(self, key, plies):
        self.draws = []
        for _ in range(plies):
            key, k_env = jax.random.split(key)
            self.draws.append(jax_step_draws(k_env, GAMES))
        self.draws = iter(self.draws)

    def env_draws(self, batch_size):
        return next(self.draws)


@pytest.fixture(scope="module")
def setup():
    jparams, jcfg = JF.load_frozen()
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    model, cfg = frozen.load_frozen(device="cpu")
    start = endgame_positions(1)
    return dict(jax=jax_script(), jparams=jparams, jcfg=jcfg, model=model,
                m=TENV.max_moves,
                jstate=JE.make_state(*(jnp.asarray(x) for x in start), JENV),
                tstate=TE.make_state(*(tt(x) for x in start), TENV))


@pytest.fixture(scope="module")
def jax_collected(setup):
    """JAX's ``collect`` from the endgame start with key 3."""
    s = setup
    return s["jax"].collect(s["jparams"], s["jstate"], jax.random.PRNGKey(3),
                            JENV, s["jcfg"], JSearchConfig(), PLIES)


@pytest.fixture
def margins(monkeypatch):
    """The lead of the best 2-ply score over the second, per game, of
    every decision the port makes."""
    out, inner = [], twoply.candidate_scores

    def recorded(*a, **kw):
        top_idx, score2, ovf = inner(*a, **kw)
        top2 = torch.topk(score2, 2, dim=1).values
        out.append(nn_(top2[:, 0] - top2[:, 1]))
        return top_idx, score2, ovf

    monkeypatch.setattr(twoply, "candidate_scores", recorded)
    return out


def check_buffers(got, want, margins, backup):
    """``margins`` of every state collected, or None where the buffers
    hold a subset of them (the resolved states)."""
    if margins is not None:
        clear = np.concatenate(margins) > 1e-4
        assert clear.sum() >= len(clear) // 2
        np.testing.assert_array_equal(got["action"][clear],
                                      np.asarray(want["action"])[clear])
    for k in ("action", "obs", "after", "n_moves", "turn"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    if backup:
        np.testing.assert_allclose(got["target_v"], want["target_v"],
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(got["target_v"], want["target_v"])


def test_collect_matches_jax(setup, jax_collected, margins):
    s = setup
    want, jstate, _ = jax_collected
    got, tstate = TD.collect(s["model"], s["tstate"],
                             Replay(jax.random.PRNGKey(3), PLIES), TENV,
                             SearchConfig(), PLIES)
    assert len(margins) == PLIES
    check_buffers(got, want, margins, backup=True)
    assert got["obs"].shape == (PLIES * GAMES, 198)
    for f, g, w in zip(TE.EnvState._fields, tstate, jstate):
        np.testing.assert_array_equal(nn_(g), np.asarray(w), err_msg=f)


def test_collect_outcomes_matches_jax(setup, margins):
    """The same decisions as ``test_collect_matches_jax`` (same start and
    key), held there where the margins are clear."""
    s = setup
    key = jax.random.PRNGKey(3)
    want, jstate, _, j_res, j_tot = s["jax"].collect_outcomes(
        s["jparams"], s["jstate"], key, JENV, s["jcfg"], JSearchConfig(),
        PLIES)
    got, tstate, res, tot = TD.collect_outcomes(
        s["model"], s["tstate"], Replay(key, PLIES), TENV, SearchConfig(),
        PLIES)
    assert (res, tot) == (j_res, j_tot) and tot == PLIES * GAMES
    assert 0 < res < tot     # some games end inside the window, some not
    assert len(margins) == PLIES
    check_buffers(got, want, None, backup=False)
    for f, g, w in zip(TE.EnvState._fields, tstate, jstate):
        np.testing.assert_array_equal(nn_(g), np.asarray(w), err_msg=f)


def test_make_update_matches_optax_adam(setup, jax_collected):
    s = setup
    mb = tuple(np.asarray(jax_collected[0][k]) for k in TD.KEYS)
    opt = optax.adam(LR)
    jupdate = s["jax"].make_update(s["jcfg"], s["m"], opt, 1.0, 1.0)
    jp, jopt, jloss, jce, jvl = jupdate(s["jparams"],
                                        opt.init(s["jparams"]),
                                        tuple(jnp.asarray(x) for x in mb))
    model, _ = frozen.load_frozen(device="cpu")
    update = TD.make_update(model, s["m"], LR, 1.0, 1.0)
    state, loss, ce, vl = update(learner.init_optimizer(model),
                                 tuple(tt(x) for x in mb))
    np.testing.assert_allclose([float(loss), float(ce), float(vl)],
                               [float(jloss), float(jce), float(jvl)],
                               rtol=1e-5, atol=1e-5)
    assert int(state.count) == 1 == int(jopt[0].count)
    got = convert.params_to_numpy(model)
    mu = dict(zip((n for n, _ in model.layers.named_parameters()),
                  state.mu))
    for layer in got:
        for k, name in (("w", f"{layer}.weight"), ("b", f"{layer}.bias")):
            # the first moment is 0.1 x the gradient
            g_mu = nn_(mu[name]).T if k == "w" else nn_(mu[name])
            j_mu = np.asarray(jopt[0].mu[layer][k])
            np.testing.assert_allclose(g_mu, j_mu, rtol=1e-4, atol=1e-8,
                                       err_msg=f"mu {layer}.{k}")
            # Adam's first step is lr g / (|g| + 1e-8): where the gradient
            # is at its rounding noise (|g| < 1e-6; the score head's bias,
            # whose exact gradient is zero) the step may take either sign
            noisy = np.abs(j_mu) < 1e-7
            tol = np.where(noisy, LR, 1e-6)
            diff = np.abs(got[layer][k] - np.asarray(jp[layer][k]))
            assert (diff <= tol).all(), (layer, k, diff.max())


@pytest.mark.parametrize("targets", ["backup", "outcome"])
def test_main_writes_the_jax_records(tmp_path, monkeypatch, capsys,
                                     targets):
    """The CLI at a tiny size, the league's 400 plies cut to 30 (the
    keys do not depend on them)."""
    inner = arena.play
    monkeypatch.setattr(arena, "play",
                        lambda *a, **kw: inner(*a[:7], 30, **kw))
    out = tmp_path / "distill.jsonl"
    records = TD.main(["--iters", "1", "--plies", "2", "--envs", "4",
                       "--epochs", "1", "--minibatch", "4", "--eval-games",
                       "2", "--targets", targets, "--out", str(out),
                       "--device", "cpu"])
    lines = [json.loads(x) for x in open(out)]
    assert [r["iter"] for r in lines] == [r["iter"] for r in records]
    assert [set(r) for r in lines] == [set(r) for r in records]
    assert set(lines[0]) == {"iter", "win_rate_vs_frozen", "finished"}
    assert set(lines[1]) == {"iter", "states", "loss", "ce", "value_mse",
                             "win_rate_vs_frozen", "finished", "collect_s",
                             "train_s"}
    assert lines[1]["iter"] == 1 and 0 <= lines[1]["win_rate_vs_frozen"] <= 1
    if targets == "backup":
        assert lines[1]["states"] == 8 and np.isfinite(lines[1]["loss"])
    printed = capsys.readouterr().out
    assert "iter 0 (baseline = frozen_v1 vs itself)" in printed
