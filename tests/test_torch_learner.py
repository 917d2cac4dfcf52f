"""Port parity: the PPO learner and the slice as a whole
(``ppo/learner.py::train_step``) at a tiny size.

JAX's ``train_step`` is ``split key -> rollout -> ppo_update``; the test
runs those two compiled pieces and replays every random draw they make
into the port through a ``Sampler``: the sampled actions (recorded from
JAX's rollout), the env draws (JAX's key schedule, ``learner.py:162`` and
``bg_env.py:255``) and the epoch permutations (``learner.py:274,
293-294``).  Then:

- every ``Rollout`` field, the env state and the bootstrap value match:
  integers and rewards bit for bit, ``logp``/``value`` to 1e-5 (float32
  products summed in another order);
- one minibatch step (clip, Adam, -lr) from the same parameters matches
  to 1e-6 in the parameters and 1e-5 in the losses;
- after the whole update (2 epochs x 2 minibatches, or one full batch)
  parameters, Adam moments and metrics match to 1e-5 (measured: at most
  1.2e-6 in the parameters, 2.8e-6 in the entropy).  Adam divides by
  sqrt(nu), so float32 noise in a small gradient moves a parameter by up
  to about lr x the noise's relative size.  The one exception is the
  score head's bias in afterstate mode, whose exact gradient is zero
  (softmax is shift invariant): there Adam turns pure rounding noise
  into steps of up to lr, and the bound is lr per step;
- the port's ``train_step`` equals the composition above.

Starting positions are near the end of the game, so rewards, wins,
gammons, dones and auto-resets all occur within T = 4 steps."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu.core.movegen import MovegenConfig as JMovegenConfig
from mlp_ppo_2ply_p3_tpu.env import bg_env as JE
from mlp_ppo_2ply_p3_tpu.models import mlp as JMLP
from mlp_ppo_2ply_p3_tpu.ppo import learner as JL
from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env as TE
from mlp_ppo_2ply_p3_tpu_torch.models import mlp as TMLP
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner as TL
from mlp_ppo_2ply_p3_tpu_torch.utils import convert

from .test_torch_utils import assert_same_tuple, jax_step_draws, nn_, tt

B, T, M, HIDDEN = 16, 4, 64, 32
WIDTHS = dict(max_moves=M, k2=64, k3=64)
JENV = JE.EnvConfig(movegen=JMovegenConfig(**WIDTHS))
TENV = TE.EnvConfig(movegen=MovegenConfig(**WIDTHS))
JMODEL = JMLP.ModelConfig(hidden_size=HIDDEN, action_size=M)
TMODEL = TMLP.ModelConfig(hidden_size=HIDDEN, action_size=M)

# the train4096 preset's learner flags at a tiny size
INDEX = dict(num_envs=B, t_horizon=T, num_epochs=2, num_minibatches=2,
             normalize_adv=True, normalize_returns=False)
MODES = {
    "index": INDEX,
    "afterstate": {**INDEX, "policy_mode": "afterstate"},
    # the parity preset's flags: MC returns, absolute credit, one full
    # batch, no clipping
    "parity": dict(num_envs=B, t_horizon=T, num_epochs=2, num_minibatches=1,
                   use_gae=False, reward_perspective="absolute",
                   normalize_returns=True, max_grad_norm=0.0),
}

ROLLOUT_FIELDS = TL.Rollout._fields
EXACT = ("obs", "n_moves", "action", "reward", "done", "turn", "overflow",
         "after")


class ReplaySampler(TL.Sampler):
    """Hands the port the JAX run's actions, env draws and permutations,
    in the order the port asks for them."""

    def __init__(self, actions, draws, perms):
        super().__init__(torch.Generator())
        self._actions, self._draws, self._perms = (
            iter(actions), iter(draws), iter(perms))

    def actions(self, masked):
        return next(self._actions)

    def env_draws(self, batch_size):
        return next(self._draws)

    def permutation(self, n, device):
        return next(self._perms)


def endgame_positions(seed):
    """B positions near the end: each side keeps 1-4 checkers in its home
    board (the rest borne off); in a quarter of the games the side not to
    move has borne off nothing and sits on its home points, the bar, or
    the mover's home (gammons, backgammons)."""
    rng = np.random.default_rng(seed)
    points = np.zeros((B, 2, 24), np.int8)
    bar = np.zeros((B, 2), np.int8)
    off = np.zeros((B, 2), np.int8)
    turn = rng.integers(0, 2, B).astype(np.int8)
    home = (np.arange(18, 24), np.arange(0, 6))
    for g in range(B):
        for p in (0, 1):
            left = int(rng.integers(1, 5))
            for pt in rng.choice(home[p], left):
                points[g, p, pt] += 1
            off[g, p] = 15 - left
        if g % 4 == 3:
            loser = 1 - turn[g]
            points[g, loser] = 0
            off[g, loser] = 0
            points[g, loser, home[loser][0]] = 13
            points[g, loser, home[1 - loser][2]] = g % 8 == 7
            bar[g, loser] = 2 - (g % 8 == 7)
    dice = rng.integers(1, 7, (B, 2)).astype(np.int8)
    return points, bar, off, turn, dice


@dataclasses.dataclass
class JaxRun:
    params0: dict           # numpy
    env0: JE.EnvState
    traj: JL.Rollout
    env1: JE.EnvState
    last_value: jax.Array
    last_turn: jax.Array
    ts1: JL.TrainState
    metrics: dict
    draws: list             # port StepDraws per rollout step
    perms: list             # torch int64 per epoch
    cfg: JL.PPOConfig
    mode: str


_rollout = jax.jit(JL.rollout, static_argnums=(3, 4, 5))
_update = jax.jit(JL.ppo_update, static_argnums=(4, 5, 6))


def jax_run(mode, ts=None, env0=None) -> JaxRun:
    """JAX train_step, in its two compiled pieces, plus its draws; from
    ``ts`` and ``env0`` when given, else from a fresh train state and
    ``endgame_positions(1)``."""
    cfg = JL.PPOConfig(**MODES[mode])
    if ts is None:
        ts = JL.init_train_state(jax.random.PRNGKey(0), JMODEL, cfg)
        env0 = JE.make_state(*(jnp.asarray(x) for x in endgame_positions(1)),
                             JENV)
    key, k_roll = jax.random.split(ts.key)          # learner.py:324
    ts = ts._replace(key=key)
    env1, traj, last_value, last_turn = _rollout(ts.params, env0, k_roll,
                                                 JENV, JMODEL, cfg)
    ts1, metrics = _update(ts, traj, last_value, last_turn, JENV, JMODEL,
                           cfg)
    draws, k = [], k_roll
    for _ in range(T):                             # learner.py:162
        k, _, k_env = jax.random.split(k, 3)
        draws.append(jax_step_draws(k_env, B))
    _, k_perm = jax.random.split(key)              # learner.py:293-294
    perms = [tt(jax.random.permutation(ek, B * T)).long()
             for ek in jax.random.split(k_perm, cfg.num_epochs)]
    params0 = jax.tree_util.tree_map(np.asarray, ts.params)
    return JaxRun(params0, env0, traj, env1, last_value, last_turn, ts1,
                  metrics, draws, perms, cfg, mode)


def port_start(run: JaxRun):
    """The port's train state, env state and replaying sampler at the
    JAX run's start."""
    model = convert.params_from_jax(run.params0, TMODEL, device="cpu")
    zero = torch.zeros((), dtype=torch.int32)
    ts = TL.TrainState(model, TL.init_optimizer(model), torch.Generator(),
                       zero, zero.clone())
    env = TE.make_state(*(tt(x) for x in endgame_positions(1)), TENV)
    sampler = ReplaySampler([tt(a) for a in np.asarray(run.traj.action)],
                            run.draws, run.perms)
    return ts, env, sampler, TL.PPOConfig(**MODES[run.mode])


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside the chain."""
    return next(s for s in opt_state if hasattr(s, "mu"))


def assert_params_close(model, jparams, atol, loose=None):
    """``loose`` maps a "head.w"/"head.b" name to its own tolerance."""
    got = convert.params_to_numpy(model)
    for name in TMLP.HEADS:
        for k in ("w", "b"):
            key = f"{name}.{k}"
            np.testing.assert_allclose(got[name][k],
                                       np.asarray(jparams[name][k]),
                                       atol=(loose or {}).get(key, atol),
                                       err_msg=key)


def check_update(ts, metrics, run: JaxRun, atol=1e-5):
    loose = {}
    if run.mode == "afterstate":
        # softmax is shift invariant, so the score head's bias gets a zero
        # gradient in exact arithmetic; Adam normalises the rounding noise
        # into steps of up to lr each (measured: 3.4e-4 after 4 steps)
        steps = run.cfg.num_epochs * run.cfg.num_minibatches
        loose["score.b"] = steps * run.cfg.learning_rate
    assert_params_close(ts.model, run.ts1.params, atol, loose)
    adam = _adam_state(run.ts1.opt_state)
    assert int(ts.opt_state.count) == int(adam.count)
    params = dict(ts.model.layers.named_parameters())
    for moments, jm in ((ts.opt_state.mu, adam.mu), (ts.opt_state.nu,
                                                     adam.nu)):
        by_name = dict(zip(params, moments))
        for name in TMLP.HEADS:
            np.testing.assert_allclose(
                nn_(by_name[f"{name}.weight"]).T,
                np.asarray(jm[name]["w"]), atol=atol)
            np.testing.assert_allclose(
                nn_(by_name[f"{name}.bias"]), np.asarray(jm[name]["b"]),
                atol=atol)
    assert int(ts.update_idx) == int(run.ts1.update_idx)
    assert int(ts.episodes) == int(run.ts1.episodes)
    for k, v in run.metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), atol=atol,
                                   rtol=1e-5, err_msg=k)


def slice_parity(mode):
    run = jax_run(mode)
    ts, env, sampler, cfg = port_start(run)
    assert_same_tuple(env, run.env0, TE.EnvState._fields)

    env1, traj, last_value, last_turn = TL.rollout(ts.model, env, sampler,
                                                   TENV, cfg)
    for name in ROLLOUT_FIELDS:
        got, want = getattr(traj, name), getattr(run.traj, name)
        if want is None:
            assert got is None, name
        elif name in EXACT:
            np.testing.assert_array_equal(nn_(got), np.asarray(want),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(nn_(got), np.asarray(want), atol=1e-5,
                                       err_msg=name)
    assert_same_tuple(env1, run.env1, TE.EnvState._fields)
    np.testing.assert_allclose(nn_(last_value), np.asarray(run.last_value),
                               atol=1e-5)
    np.testing.assert_array_equal(nn_(last_turn), np.asarray(run.last_turn))
    done = nn_(traj.done)
    assert done.any() and nn_(traj.reward).any(), "no game ended"

    ts1, metrics = TL.ppo_update(ts, traj, last_value, last_turn, TENV, cfg,
                                 sampler)
    check_update(ts1, metrics, run)
    return run


def test_slice_index_mode_and_train_step():
    """Index mode (the train4096 flags): rollout, update, and the port's
    whole ``train_step`` against the same JAX run."""
    run = slice_parity("index")
    ts, env, sampler, cfg = port_start(run)
    ts1, env1, metrics = TL.train_step(ts, env, TENV, TMODEL, cfg, sampler)
    assert_same_tuple(env1, run.env1, TE.EnvState._fields)
    check_update(ts1, metrics, run)
    assert int(metrics["movegen_overflow"]) == int(
        np.asarray(run.traj.overflow).sum())


@pytest.mark.parametrize("mode", ["afterstate", "parity"])
def test_slice_other_modes(mode):
    slice_parity(mode)


def test_one_minibatch_step():
    """One clipped-PPO step on one minibatch from the same parameters:
    JAX's value_and_grad + optax chain against ``minibatch_step``."""
    run = jax_run("index")
    cfg = run.cfg
    n = B * T
    rng = np.random.default_rng(0)
    idx = rng.permutation(n)[: n // 2]
    tr = run.traj
    adv = rng.normal(size=n).astype(np.float32)
    ret = rng.normal(size=n).astype(np.float32)
    batch = (np.asarray(tr.obs).reshape(n, -1)[idx],
             np.asarray(tr.n_moves).reshape(n)[idx],
             np.asarray(tr.action).reshape(n)[idx],
             np.asarray(tr.logp).reshape(n)[idx], ret[idx], adv[idx])
    jparams = jax.tree_util.tree_map(jnp.asarray, run.params0)
    ent = JL.entropy_coef(cfg, jnp.asarray(1000))
    (loss, aux), grads = jax.value_and_grad(JL._loss_fn, has_aux=True)(
        jparams, tuple(jnp.asarray(x) for x in batch), ent, M, JMODEL, cfg)
    opt = JL.make_optimizer(cfg)
    updates, _ = opt.update(grads, opt.init(jparams), jparams)
    want = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)

    model = convert.params_from_jax(run.params0, TMODEL, device="cpu")
    t_ent = TL.entropy_coef(cfg, torch.tensor(1000))
    np.testing.assert_allclose(float(t_ent), float(ent), rtol=1e-7)
    state, got = TL.minibatch_step(model, TL.init_optimizer(model),
                                   tuple(tt(x) for x in batch), t_ent, M,
                                   cfg)
    np.testing.assert_allclose(nn_(got), np.array([loss, *aux]), atol=1e-5)
    assert int(state.count) == 1
    assert_params_close(model, want, atol=1e-6)


def test_entropy_coef_schedule():
    cfg = TL.PPOConfig()
    for episodes in (0, 1000, cfg.entropy_anneal_episodes // 2,
                     cfg.entropy_anneal_episodes * 3):
        np.testing.assert_allclose(
            float(TL.entropy_coef(cfg, torch.tensor(episodes))),
            float(JL.entropy_coef(JL.PPOConfig(), jnp.asarray(episodes))),
            rtol=1e-6)


def test_gumbel_sampler_distribution():
    """The port's own action sampler is checked by distribution: masked
    slots are never drawn and frequencies follow softmax(logits)
    (99.9% chi-square bound for 4 dof: 18.5)."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.5, -1.0, 1.5, 0.0, 0.2, -1e9, -1e9]])
    draws = 40_000
    s = TL.Sampler(gen)
    a = s.actions(logits.expand(draws, -1).contiguous())
    assert a.dtype == torch.int32 and int(a.max()) <= 4
    counts = np.bincount(nn_(a), minlength=7)[:5]
    p = torch.softmax(logits[0, :5], 0).numpy()
    chi2 = float(((counts - draws * p) ** 2 / (draws * p)).sum())
    assert chi2 < 18.5, (counts, draws * p)
    perm = s.permutation(100, torch.device("cpu"))
    assert sorted(nn_(perm).tolist()) == list(range(100))
