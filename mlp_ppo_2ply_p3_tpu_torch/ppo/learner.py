"""PPO: rollout loop + minibatched clipped update.

Port of ``mlp_ppo_2ply_p3_tpu/ppo/learner.py``.  ``train_step`` collects
a (T, B) rollout with a Python loop over T (the JAX ``lax.scan``),
computes mover-perspective GAE (or the reference's MC returns), then
runs ``num_epochs`` x ``num_minibatches`` clipped-surrogate steps with
global-norm clipping and Adam, written out by hand so that they match
optax's arithmetic:

- ``optax.clip_by_global_norm``: scale by max/norm when norm >= max
  (``clip_grad_norm_`` adds 1e-6 to the norm, so it is not used);
- ``optax.scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, bias-corrected)
  then ``scale(-lr)``; a head the loss does not reach gets a zero
  gradient, so every Adam step count matches;
- ``jnp.std`` is the population std (``correction=0``).

Every random draw (actions, env dice, epoch permutations) goes through a
``Sampler`` built on an explicit ``torch.Generator``; tests substitute
one that replays the JAX package's draws.  The model's parameters are
updated in place: the ``TrainState`` returned shares the module.

Float32 matmuls: the caller sets ``torch.backends.cuda.matmul.allow_tf32
= False`` (PyTorch's default) so the card computes in full float32 like
the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.nn import functional as Fn

from .. import resolve_device
from ..core import features as F
from ..env import bg_env
from ..models.mlp import MLP, ModelConfig
from . import gae as gae_mod

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
MASK_FLOOR = -1e9


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    # sizes
    num_envs: int = 8
    t_horizon: int = 512
    num_epochs: int = 4
    num_minibatches: int = 8
    # optimization
    learning_rate: float = 1e-3
    gamma: float = 0.99
    gae_lambda: float = 0.95
    eps_clip: float = 0.25
    value_loss_coef: float = 0.5
    entropy_coef_start: float = 0.15
    entropy_coef_end: float = 0.01
    entropy_anneal_episodes: int = 400_000
    max_grad_norm: float = 0.5  # 0 disables (reference has no clipping)
    # semantics switches (see the JAX package's PPOConfig)
    use_gae: bool = True            # False -> reference MC returns
    reward_perspective: str = "mover"   # or "absolute" (reference credit)
    normalize_returns: bool = True
    normalize_adv: bool = False
    policy_mode: str = "index"      # or "afterstate" (score head)
    reset_each_update: bool = False


class AdamState(NamedTuple):
    count: torch.Tensor          # () int32
    mu: list                     # per parameter, first moment
    nu: list                     # per parameter, second moment


class TrainState(NamedTuple):
    model: MLP
    opt_state: AdamState
    gen: torch.Generator
    update_idx: torch.Tensor     # () int32 (env steps = update_idx * B * T)
    episodes: torch.Tensor       # () int32 real episode counter


class Rollout(NamedTuple):
    obs: torch.Tensor       # (T, B, 198)
    n_moves: torch.Tensor   # (T, B) int32 (mask = prefix)
    action: torch.Tensor    # (T, B) int32
    logp: torch.Tensor      # (T, B)
    value: torch.Tensor     # (T, B)
    reward: torch.Tensor    # (T, B)
    done: torch.Tensor      # (T, B) bool
    turn: torch.Tensor      # (T, B) int8 mover of step t
    overflow: torch.Tensor  # (T,) int32 movegen truncations per step
    after: torch.Tensor | None = None  # afterstate mode: (T, B, M, 52) int8


# shape -> float32 uniforms in [0, 1) (the agents' policies draw from one)
Rand = Callable[[tuple], torch.Tensor]


def uniforms(gen: torch.Generator) -> Rand:
    """A draw source on ``gen`` (and on its device)."""
    return lambda shape: torch.rand(shape, generator=gen, device=gen.device)


def categorical(rand: Rand, logits):
    """One sample per row of (B, M) logits, by Gumbel-max."""
    u = rand(tuple(logits.shape)).clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)


class Sampler:
    """Every random draw of ``train_step``, from one generator."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def actions(self, masked):
        """Categorical sample per row of (B, M) logits by Gumbel-max."""
        return categorical(uniforms(self.gen), masked)

    def env_draws(self, batch_size: int) -> bg_env.StepDraws:
        return bg_env.draw_step(self.gen, batch_size)

    def permutation(self, n: int, device):
        return torch.randperm(n, generator=self.gen, device=device)


def init_optimizer(model: MLP) -> AdamState:
    params = list(model.parameters())
    dev = params[0].device
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
    )


def init_train_state(seed: int, model_cfg: ModelConfig, cfg: PPOConfig,
                     device="cuda") -> TrainState:
    """Fresh model + optimizer on ``device``; one generator, seeded with
    ``seed``, draws the initial weights and then the run's randomness."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = MLP(model_cfg, device=dev, generator=gen)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return TrainState(model, init_optimizer(model), gen, zero, zero.clone())


@torch.no_grad()
def adam_step(params, grads, state: AdamState, cfg: PPOConfig) -> AdamState:
    """clip_by_global_norm -> scale_by_adam -> scale(-lr), in place on
    ``params``; returns the new optimizer state."""
    if cfg.max_grad_norm > 0:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < cfg.max_grad_norm
        grads = [torch.where(keep, g, (g / g_norm) * cfg.max_grad_norm)
                 for g in grads]
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1 - ADAM_B1 ** c
    bc2 = 1 - ADAM_B2 ** c
    mu, nu = [], []
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        m = (1 - ADAM_B1) * g + ADAM_B1 * m
        v = (1 - ADAM_B2) * (g * g) + ADAM_B2 * v
        upd = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        p.add_(upd * (-cfg.learning_rate))
        mu.append(m)
        nu.append(v)
    return AdamState(count, mu, nu)


def entropy_coef(cfg: PPOConfig, episodes):
    """Linear anneal driven by the live episode counter."""
    progress = torch.clamp(
        episodes.to(torch.float32) / cfg.entropy_anneal_episodes, max=1.0
    )
    return cfg.entropy_coef_start - progress * (
        cfg.entropy_coef_start - cfg.entropy_coef_end
    )


def _prefix_mask(n_moves, m):
    mask = torch.arange(m, device=n_moves.device)[None, :] < n_moves[:, None]
    any_valid = (n_moves > 0)[:, None]
    return mask | torch.logical_not(any_valid)


def _masked_logits(model: MLP, obs, n_moves, m):
    """Prefix-masked action logits with a finite floor; all-masked rows
    (auto-pass) keep their raw logits."""
    logits, value = model(obs)
    logits = logits[..., :m]
    return torch.where(_prefix_mask(n_moves, m), logits, MASK_FLOOR), value


def _afterstate_logits(model: MLP, after, turn, n_moves, m):
    """Score-head logits over legal afterstates; ``after`` (B, M, 52),
    ``turn`` (B,) mover."""
    feats = F.encode_canonical(after, turn[:, None])  # (B, M, 198)
    scores = model.score(feats)                        # (B, M)
    return torch.where(_prefix_mask(n_moves, m), scores, MASK_FLOOR)


@torch.no_grad()
def rollout(model: MLP, env_state, sampler: Sampler, env_cfg,
            cfg: PPOConfig):
    """Collect T steps; returns (env_state', Rollout, last_value,
    last_turn)."""
    m = env_cfg.max_moves
    afterstate = cfg.policy_mode == "afterstate"
    bsz = env_state.turn.shape[0]
    steps = []
    es = env_state
    for _ in range(cfg.t_horizon):
        obs = bg_env.observe(es)
        if afterstate:
            _, value = model(obs)
            masked = _afterstate_logits(model, es.after, es.turn, es.n_moves,
                                        m)
        else:
            masked, value = _masked_logits(model, obs, es.n_moves, m)
        action = sampler.actions(masked)
        logp = torch.gather(Fn.log_softmax(masked, dim=-1), 1,
                            action[:, None].long())[:, 0]
        pre = es
        es, info = bg_env.step_with_draws(es, action,
                                          sampler.env_draws(bsz), env_cfg)
        steps.append(Rollout(
            obs=obs, n_moves=pre.n_moves, action=action, logp=logp,
            value=value, reward=info.reward, done=info.done, turn=pre.turn,
            # every step's movegen truncations, for the overflow policy
            overflow=es.overflow.sum(dtype=torch.int32),
            after=pre.after if afterstate else None,
        ))
    traj = Rollout(*(
        None if f[0] is None else torch.stack(f) for f in zip(*steps)
    ))
    _, last_value = model(bg_env.observe(es))
    return es, traj, last_value, es.turn


def _loss_fn(model: MLP, batch, ent_coef, m, cfg: PPOConfig):
    if cfg.policy_mode == "afterstate":
        obs, n_moves, action, old_logp, returns, adv, after, turn = batch
        _, value = model(obs)
        masked = _afterstate_logits(model, after, turn, n_moves, m)
    else:
        obs, n_moves, action, old_logp, returns, adv = batch
        masked, value = _masked_logits(model, obs, n_moves, m)
    logp_all = Fn.log_softmax(masked, dim=-1)
    new_logp = torch.gather(logp_all, 1, action[:, None].long())[:, 0]
    ratio = torch.exp(new_logp - old_logp)
    surr1 = ratio * adv
    surr2 = torch.clamp(ratio, 1.0 - cfg.eps_clip, 1.0 + cfg.eps_clip) * adv
    policy_loss = -torch.mean(torch.minimum(surr1, surr2))
    value_loss = torch.mean((value - returns) ** 2)
    probs = torch.exp(logp_all)
    entropy = -torch.mean(torch.sum(probs * logp_all, dim=-1))
    loss = policy_loss + cfg.value_loss_coef * value_loss - ent_coef * entropy
    return loss, (policy_loss, value_loss, entropy)


def minibatch_step(model: MLP, opt_state: AdamState, batch, ent_coef, m,
                   cfg: PPOConfig):
    """One clipped-PPO gradient step on one minibatch.  Returns
    (opt_state', stacked (loss, policy_loss, value_loss, entropy))."""
    params = list(model.parameters())
    loss, aux = _loss_fn(model, batch, ent_coef, m, cfg)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    opt_state = adam_step(params, grads, opt_state, cfg)
    return opt_state, torch.stack([loss, *aux]).detach()


def advantages(traj: Rollout, last_value, last_turn, cfg: PPOConfig):
    """(advantages, returns) as (T, B), normalised per ``cfg``."""
    if cfg.use_gae and cfg.reward_perspective == "mover":
        turn_next = torch.cat([traj.turn[1:], last_turn[None]], dim=0)
        flips = turn_next != traj.turn
        adv, returns = gae_mod.negamax_gae(
            traj.reward, traj.value, traj.done, flips, last_value,
            cfg.gamma, cfg.gae_lambda,
        )
    elif cfg.use_gae:
        adv, returns = gae_mod.gae(
            traj.reward, traj.value, traj.done, last_value,
            cfg.gamma, cfg.gae_lambda,
        )
    else:
        returns = gae_mod.mc_returns_ref(traj.reward, traj.done, cfg.gamma)
        adv = None
    if cfg.normalize_returns:
        returns = (returns - returns.mean()) / (
            returns.std(correction=0) + 1e-5)
    if adv is None:
        adv = returns - traj.value  # reference: advantages = returns - V
    if cfg.normalize_adv:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    return adv, returns


def ppo_update(ts: TrainState, traj: Rollout, last_value, last_turn,
               env_cfg, cfg: PPOConfig, sampler: Sampler | None = None):
    """Minibatched clipped-PPO epochs over one rollout.  Returns
    (TrainState', metrics dict of 0-dim tensors)."""
    sampler = sampler or Sampler(ts.gen)
    m = env_cfg.max_moves
    t, b = traj.reward.shape
    adv, returns = advantages(traj, last_value, last_turn, cfg)

    n = t * b
    flat = (
        traj.obs.reshape(n, -1),
        traj.n_moves.reshape(n),
        traj.action.reshape(n),
        traj.logp.reshape(n),
        returns.reshape(n),
        adv.reshape(n),
    )
    if cfg.policy_mode == "afterstate":
        flat = flat + (traj.after.reshape(n, m, 52), traj.turn.reshape(n))
    nmb = cfg.num_minibatches
    mb_size = n // nmb
    ent = entropy_coef(cfg, ts.episodes)

    opt_state = ts.opt_state
    metrics = []
    for _ in range(cfg.num_epochs):
        perm = sampler.permutation(n, traj.reward.device)
        for i in range(nmb):
            idx = perm[i * mb_size:(i + 1) * mb_size]
            batch = tuple(x[idx] for x in flat)
            opt_state, mb_metrics = minibatch_step(ts.model, opt_state,
                                                   batch, ent, m, cfg)
            metrics.append(mb_metrics)
    loss, policy_loss, value_loss, entropy = torch.stack(metrics).mean(0)

    ts = TrainState(
        model=ts.model,
        opt_state=opt_state,
        gen=ts.gen,
        update_idx=ts.update_idx + 1,
        episodes=ts.episodes + traj.done.sum(dtype=torch.int32),
    )
    metrics_out = {
        "loss": loss,
        "policy_loss": policy_loss,
        "value_loss": value_loss,
        "entropy": entropy,
        "entropy_coef": ent,
        "mean_reward": traj.reward.mean(),
        "episodes_finished": traj.done.sum(dtype=torch.int32),
        "mean_episode_value": traj.value.mean(),
    }
    return ts, metrics_out


def train_step(ts: TrainState, env_state, env_cfg, model_cfg: ModelConfig,
               cfg: PPOConfig, sampler: Sampler | None = None):
    """One full PPO update: rollout T x B + minibatched epochs.  Returns
    (TrainState', env_state', metrics); no host synchronisation."""
    if ts.model.cfg != model_cfg:
        raise ValueError("train state's model was built for another "
                         "ModelConfig")
    sampler = sampler or Sampler(ts.gen)
    env_state, traj, last_value, last_turn = rollout(
        ts.model, env_state, sampler, env_cfg, cfg
    )
    ts, metrics = ppo_update(ts, traj, last_value, last_turn, env_cfg, cfg,
                             sampler)
    # game-steps (of B*T) whose movegen hit a width cap in this rollout
    metrics["movegen_overflow"] = traj.overflow.sum(dtype=torch.int32)
    return ts, env_state, metrics
