"""PPO: rollout loop + minibatched clipped update.

Port of ``mlp_ppo_2ply_p3_tpu/ppo/learner.py``.  ``train_step`` collects
a (T, B) rollout with a Python loop over T (the JAX ``lax.scan``),
computes mover-perspective GAE (or the reference's MC returns), then
runs ``num_epochs`` x ``num_minibatches`` clipped-surrogate steps with
global-norm clipping and Adam (``ops/adam.py``: optax's arithmetic, one
kernel pair a step on the card).  A head the loss does not reach gets a
zero gradient, so every Adam step count matches; ``jnp.std`` is the
population std (``correction=0``).

Every random draw (actions, env dice, epoch permutations) goes through a
``Sampler`` built on an explicit ``torch.Generator``; tests substitute
one that replays the JAX package's draws.  The model's parameters are
updated in place: the ``TrainState`` returned shares the module.

Data parallelism (``world``, a ``parallel.mesh.World``; None runs the
unsharded code): the env state holds the rank's shard of the games and
the rollout runs on it, drawing every random tensor at its global shape
(``Sampler``).  ``ppo_update`` computes GAE on the shard, gathers the
rollout once, so that the return / advantage normalisation, the episode
count and every metric are the unsharded run's, and takes the rank's
1 / size of each global minibatch; the gradient is summed over the
ranks before ``adam_step``, which then runs identically on every rank.
A world of one computes the unsharded run bit for bit.

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
from ..env import bg_env
from ..models.mlp import MLP, ModelConfig
from ..ops import adam as AD
from ..ops import afterstate as AE
from ..parallel import mesh
from ..utils.profiling import span
from . import gae as gae_mod

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
    """Every random draw of ``train_step``, from one generator.

    With a ``world`` the env batch is this rank's shard: each per-game
    draw is made for all ``world.size`` shards and the rank keeps its own
    rows, so every rank draws the unsharded run's stream."""

    def __init__(self, gen: torch.Generator, world=None):
        self.gen, self.world = gen, world

    def _global(self, batch_size: int) -> int:
        return batch_size * (self.world.size if self.world else 1)

    def actions(self, masked):
        """Categorical sample per row of (B, M) logits by Gumbel-max."""
        b, m = masked.shape
        u = mesh.shard_batch(uniforms(self.gen)((self._global(b), m)),
                             self.world)
        return categorical(lambda shape: u, masked)

    def env_draws(self, batch_size: int) -> bg_env.StepDraws:
        return mesh.shard_batch(
            bg_env.draw_step(self.gen, self._global(batch_size)), self.world)

    def permutation(self, n: int, device):
        """A permutation of the ``n`` rows of the global rollout."""
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
    ``params``; returns the new optimizer state (``ops.adam.adam_update``:
    the kernel pair on the card, the old state left as it was)."""
    with span("adam_step"):
        return AdamState(*AD.adam_update(
            params, grads, state.count, state.mu, state.nu,
            cfg.learning_rate, cfg.max_grad_norm))


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


def _afterstate_logits(model: MLP, after, turn, n_moves):
    """Score-head logits over legal afterstates; ``after`` (B, M, 52),
    ``turn`` (B,) mover: ``ops.afterstate``'s ``logits`` epilogue (the
    ``_prefix_mask`` above, with the MASK_FLOOR), a kernel on the card
    and differentiable in the weights."""
    return AE.evaluate(model, after, turn, n_moves, "score")


@torch.no_grad()
def rollout(model: MLP, env_state, sampler: Sampler, env_cfg,
            cfg: PPOConfig, world=None):
    """Collect T steps; returns (env_state', Rollout, last_value,
    last_turn).  With a ``world``, ``env_state`` is this rank's shard."""
    with span("rollout"):
        m = env_cfg.max_moves
        afterstate = cfg.policy_mode == "afterstate"
        bsz = env_state.turn.shape[0]
        steps = []
        es = env_state
        for _ in range(cfg.t_horizon):
            with span("policy"):
                obs = bg_env.observe(es)
                if afterstate:
                    _, value = model(obs)
                    masked = _afterstate_logits(model, es.after, es.turn,
                                                es.n_moves)
                else:
                    masked, value = _masked_logits(model, obs, es.n_moves,
                                                   m)
                action = sampler.actions(masked)
                logp = torch.gather(Fn.log_softmax(masked, dim=-1), 1,
                                    action[:, None].long())[:, 0]
            pre = es
            es, info = bg_env.step_with_draws(
                es, action, sampler.env_draws(bsz), env_cfg, world)
            steps.append(Rollout(
                obs=obs, n_moves=pre.n_moves, action=action, logp=logp,
                value=value, reward=info.reward, done=info.done,
                turn=pre.turn,
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
        masked = _afterstate_logits(model, after, turn, n_moves)
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
                   cfg: PPOConfig, world=None):
    """One clipped-PPO gradient step on one minibatch.  Returns
    (opt_state', stacked (loss, policy_loss, value_loss, entropy)).

    With a ``world``, ``batch`` is this rank's 1 / size of the global
    minibatch: its mean loss, divided by the size, is its share of the
    global mean, so the gradients and losses summed over the ranks are
    the global minibatch's."""
    with span("minibatch_step"):
        params = list(model.parameters())
        loss, aux = _loss_fn(model, batch, ent_coef, m, cfg)
        stats = torch.stack([loss, *aux]).detach()
        if world is not None:
            loss = loss / world.size
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if world is not None:
            *grads, stats = mesh.all_reduce_sum([*grads, stats / world.size],
                                                world)
        opt_state = adam_step(params, grads, opt_state, cfg)
        return opt_state, stats


def gae_targets(traj: Rollout, last_value, last_turn, cfg: PPOConfig):
    """(advantages or None, returns) as (T, B) before normalisation: per
    game, so a shard of the games computes its own columns."""
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
    return adv, returns


def normalize_targets(adv, returns, value, cfg: PPOConfig):
    """The normalisations of ``cfg`` over the whole (T, B) batch; with
    ``adv`` None (MC returns) the advantages are returns - V."""
    if cfg.normalize_returns:
        returns = (returns - returns.mean()) / (
            returns.std(correction=0) + 1e-5)
    if adv is None:
        adv = returns - value  # reference: advantages = returns - V
    if cfg.normalize_adv:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    return adv, returns


def _gather_rollout(traj: Rollout, adv, returns, world):
    """Every rank's games of the rollout and its targets, along the game
    axis in rank order: the unsharded run's (T, B) tensors, but for the
    afterstates, every rank's (T, B / size, M, 52) stacked in rank order in
    a buffer kept across updates (``mesh.gather_stacked``; rows by
    ``_stacked_rows``).  The per-step overflow counts are summed over the
    ranks.  The identity without a world."""
    (overflow,) = mesh.all_reduce_sum([traj.overflow], world)
    after = traj.after
    traj, adv, returns = mesh.gather_batch(
        (traj._replace(overflow=None, after=None), adv, returns), world,
        dim=1)
    if after is not None and world is not None:
        after = mesh.gather_stacked(after, world)
    return traj._replace(overflow=overflow, after=after), adv, returns


def _stacked_rows(t, b, size, device):
    """(T B,) where row t B + j of the (T, B) rollout lies in the afterstates
    gathered as (size, T, B / size): the rank holding game j, then t, then
    its place in that rank's shard."""
    g = torch.arange(t * b, device=device)
    step, game = g // b, g % b
    shard = b // size
    return (game // shard) * (t * shard) + step * shard + game % shard


def ppo_update(ts: TrainState, traj: Rollout, last_value, last_turn,
               env_cfg, cfg: PPOConfig, sampler: Sampler | None = None,
               world=None):
    """Minibatched clipped-PPO epochs over one rollout.  Returns
    (TrainState', metrics dict of 0-dim tensors).  With a ``world``,
    ``traj`` holds this rank's games; the update is the global one."""
    with span("ppo_update"):
        sampler = sampler or Sampler(ts.gen, world)
        m = env_cfg.max_moves
        adv, returns = gae_targets(traj, last_value, last_turn, cfg)
        traj, adv, returns = _gather_rollout(traj, adv, returns, world)
        adv, returns = normalize_targets(adv, returns, traj.value, cfg)
        t, b = traj.reward.shape

        n = t * b
        flat = (
            traj.obs.reshape(n, -1),
            traj.n_moves.reshape(n),
            traj.action.reshape(n),
            traj.logp.reshape(n),
            returns.reshape(n),
            adv.reshape(n),
        )
        afterstate = cfg.policy_mode == "afterstate"
        if afterstate:
            after = traj.after.reshape(n, m, 52)
            turn = traj.turn.reshape(n)
            # the afterstates' rows, where they were gathered stacked
            stacked = None if world is None else _stacked_rows(
                t, b, world.size, after.device)
        nmb = cfg.num_minibatches
        mb_size = n // nmb
        # this rank's rows of every global minibatch
        mine = slice(None) if world is None else world.rows(mb_size)
        ent = entropy_coef(cfg, ts.episodes)

        opt_state = ts.opt_state
        metrics = []
        for _ in range(cfg.num_epochs):
            perm = sampler.permutation(n, traj.reward.device)
            if afterstate:
                perm_after = perm if stacked is None else stacked[perm]
            for i in range(nmb):
                rows = slice(i * mb_size, (i + 1) * mb_size)
                idx = perm[rows][mine]
                batch = tuple(x[idx] for x in flat)
                if afterstate:
                    batch = batch + (after[perm_after[rows][mine]],
                                     turn[idx])
                opt_state, mb_metrics = minibatch_step(
                    ts.model, opt_state, batch, ent, m, cfg, world)
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
            # game-steps (of B*T) whose movegen hit a width cap in the
            # rollout
            "movegen_overflow": traj.overflow.sum(dtype=torch.int32),
        }
        return ts, metrics_out


def train_step(ts: TrainState, env_state, env_cfg, model_cfg: ModelConfig,
               cfg: PPOConfig, sampler: Sampler | None = None, world=None):
    """One full PPO update: rollout T x B + minibatched epochs.  Returns
    (TrainState', env_state', metrics); no host synchronisation apart
    from the collectives of a ``world``.  With a ``world``,
    ``env_state`` is this rank's shard of the B games and stays one."""
    if ts.model.cfg != model_cfg:
        raise ValueError("train state's model was built for another "
                         "ModelConfig")
    if world is not None:
        mesh.check_divisible(env_state.turn.shape[0] * world.size,
                             cfg.t_horizon, cfg.num_minibatches, world.size)
    with span("train_step"):
        sampler = sampler or Sampler(ts.gen, world)
        env_state, traj, last_value, last_turn = rollout(
            ts.model, env_state, sampler, env_cfg, cfg, world
        )
        ts, metrics = ppo_update(ts, traj, last_value, last_turn, env_cfg,
                                 cfg, sampler, world)
        return ts, env_state, metrics
