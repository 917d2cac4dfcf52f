"""PPO self-play training as plain PyTorch: the rollout of T half-turns
of B games, mover-perspective GAE, advantage normalisation and
minibatched clipped-PPO epochs with global-norm clipping and Adam (the
arithmetic of optax's ``clip_by_global_norm``, ``scale_by_adam`` and
``scale(-lr)``).

Every random draw is made from one ``torch.Generator`` seeded with the
run's seed, in the order of the configuration's semantics: the weights
(head by head, weight before bias), the first reset, then each half-turn
the (B, M) uniforms of the Gumbel-max sample and the env's draws, and
each epoch a permutation of the T B rows.  So a reference on the same
device draws what any faithful implementation draws.

``Trainer`` is the reference and, with ``precision="tf32"`` or a
``fault``, the control that stands in the program's place.  Given
``follow`` (the program's sampled actions, one (B,) tensor a half-turn),
it judges each: the gap by which the action's Gumbel-perturbed logit
lies below the reference's best (0 where it is the best), and then plays
it, so that the reference walks the program's trajectory and its losses
and parameters compare number for number.
"""

from __future__ import annotations

import torch
from torch.nn import functional as Fn

from . import model as Mdl
from . import rules

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
FLOOR = -1e9
FAULTS = ("half_batch", "action_altered")


def _prefix_mask(n, m):
    mask = torch.arange(m, device=n.device)[None, :] < n[:, None]
    return mask | torch.logical_not(n > 0)[:, None]


class Trainer:
    """The configuration ``cfg`` (a configuration file's dict) trained
    from ``seed`` on ``device``."""

    def __init__(self, cfg, seed, device, precision="float32", follow=None,
                 fault=None, judged=None, nudge=False):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.cfg, self.p = cfg, cfg["ppo"]
        if not (self.p["use_gae"] and self.p["reward_perspective"] == "mover"
                and not self.p["reset_each_update"]):
            raise ValueError("the reference trains with mover-perspective "
                             "GAE and no reset between updates")
        self.mg = rules.Movegen(**cfg["movegen"])
        self.precision, self.fault = precision, fault
        self.follow = None if follow is None else list(follow)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        m = cfg["model"]
        self.params = Mdl.init(self.gen, m["hidden_size"], m["action_size"],
                               device)
        if nudge:   # every weight one float32 ulp up: rounding's own drift
            self.params = {k: torch.nextafter(v, torch.full_like(v, 1e30))
                           for k, v in self.params.items()}
        self.names = list(self.params)
        self.mu = [torch.zeros_like(v) for v in self.params.values()]
        self.nu = [torch.zeros_like(v) for v in self.params.values()]
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.episodes = torch.zeros((), dtype=torch.int32, device=device)
        self.state = rules.reset(self.gen, self.p["num_envs"], self.mg)
        self.actions, self.action_gap, self.half_turns = [], 0.0, 0
        # half-turns whose followed actions are judged (all by default)
        self.judged = judged
        self.first = None   # (loss, scale, gradient norms) of step one
        self.afterstate = self.p["policy_mode"] == "afterstate"

    # --- the policy ---------------------------------------------------------

    def _logits(self, obs, after, turn, n):
        """(masked logits (B, M), value (B,))."""
        pr, m = self.precision, self.mg.max_moves
        if self.afterstate:
            value = Mdl.value(self.params, obs, pr)
            score = Mdl.board_head(self.params, after, turn.to(torch.int32),
                                   "score", pr)
            return torch.where(_prefix_mask(n, m), score, FLOOR), value
        out = Mdl.head(self.params, obs, "action", pr)
        value = Mdl.value(self.params, obs, pr)
        return torch.where(_prefix_mask(n, m), out[:, :m], FLOOR), value

    @torch.no_grad()
    def _rollout(self):
        p, s, b = self.p, self.state, self.p["num_envs"]
        steps = []
        for _ in range(p["t_horizon"]):
            obs = rules.observe(s)
            masked, value = self._logits(obs, s.after, s.turn, s.n_moves)
            u = torch.rand((b, self.mg.max_moves), generator=self.gen,
                           device=self.gen.device)
            u = u.clamp_(min=torch.finfo(torch.float32).tiny)
            pert = masked - torch.log(-torch.log(u))
            own = torch.argmax(pert, dim=-1).to(torch.int32)
            if self.follow is not None:
                action = self.follow[self.half_turns].to(torch.int32)
                if self.judged is None or self.half_turns < self.judged:
                    best = pert.amax(dim=-1)
                    mine = torch.gather(pert, 1, action[:, None].long())[:, 0]
                    self.action_gap = max(self.action_gap,
                                          float((best - mine).max()))
            else:
                action = own
                if self.fault == "action_altered":
                    action = torch.where(
                        torch.arange(b, device=own.device) == 0,
                        (own + 1) % s.n_moves.clamp(min=1), own)
            self.actions.append(action)
            self.half_turns += 1
            logp = torch.gather(Fn.log_softmax(masked, dim=-1), 1,
                                action[:, None].long())[:, 0]
            draws = rules.draw_step(self.gen, b)
            pre = s
            s, reward, done = rules.step(s, action, draws, self.mg)
            steps.append((obs, pre.n_moves, action, logp, value, reward, done,
                          pre.turn, pre.after if self.afterstate else None))
        last_value = Mdl.value(self.params, rules.observe(s), self.precision)
        self.state = s
        traj = [None if f[0] is None else torch.stack(f) for f in zip(*steps)]
        return traj, last_value, s.turn

    # --- the update ---------------------------------------------------------

    def _targets(self, reward, value, done, turn, last_value, last_turn):
        p = self.p
        g, lam = p["gamma"], p["gae_lambda"]
        flips = torch.cat([turn[1:], last_turn[None]], dim=0) != turn
        nd = 1.0 - done.to(torch.float32)
        sign = torch.where(flips, -1.0, 1.0).to(torch.float32)
        adv = torch.empty_like(value)
        a_next, v_next = torch.zeros_like(last_value), last_value
        for t in range(reward.shape[0] - 1, -1, -1):
            delta = reward[t] + g * sign[t] * v_next * nd[t] - value[t]
            a_next = delta + g * lam * sign[t] * nd[t] * a_next
            adv[t] = a_next
            v_next = value[t]
        returns = adv + value
        if p["normalize_returns"]:
            returns = (returns - returns.mean()) / (
                returns.std(correction=0) + 1e-5)
        if p["normalize_adv"]:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        return adv, returns

    def _loss(self, params, batch, ent_coef):
        p, pr = self.p, self.precision
        obs, n, action, old_logp, returns, adv = batch[:6]
        if self.fault == "half_batch":
            half = obs.shape[0] // 2
            batch = tuple(x[:half] for x in batch)
            obs, n, action, old_logp, returns, adv = batch[:6]
        saved = self.params
        self.params = params
        if self.afterstate:
            masked, value = self._logits(obs, batch[6], batch[7], n)
        else:
            masked, value = self._logits(obs, None, None, n)
        self.params = saved
        logp_all = Fn.log_softmax(masked, dim=-1)
        new_logp = torch.gather(logp_all, 1, action[:, None].long())[:, 0]
        ratio = torch.exp(new_logp - old_logp)
        surr = torch.minimum(ratio * adv, torch.clamp(
            ratio, 1.0 - p["eps_clip"], 1.0 + p["eps_clip"]) * adv)
        policy_loss = -torch.mean(surr)
        value_loss = torch.mean((value - returns) ** 2)
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
        loss = (policy_loss + p["value_loss_coef"] * value_loss
                - ent_coef * entropy)
        return loss, (policy_loss, value_loss, entropy)

    @torch.no_grad()
    def _adam(self, grads):
        p = self.p
        if p["max_grad_norm"] > 0:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < p["max_grad_norm"]
            grads = [torch.where(keep, g, (g / g_norm) * p["max_grad_norm"])
                     for g in grads]
        self.count = self.count + 1
        c = self.count.to(torch.float32)
        bc1, bc2 = 1 - ADAM_B1 ** c, 1 - ADAM_B2 ** c
        for i, (name, g) in enumerate(zip(self.names, grads)):
            m = (1 - ADAM_B1) * g + ADAM_B1 * self.mu[i]
            v = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu[i]
            upd = (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
            self.params[name] = self.params[name] + upd * (-p["learning_rate"])
            self.mu[i], self.nu[i] = m, v

    def _update(self, traj, last_value, last_turn):
        p, m = self.p, self.mg.max_moves
        obs, n_moves, action, logp, value, reward, done, turn, after = traj
        adv, returns = self._targets(reward, value, done, turn, last_value,
                                     last_turn)
        t, b = reward.shape
        n = t * b
        flat = [obs.reshape(n, -1), n_moves.reshape(n), action.reshape(n),
                logp.reshape(n), returns.reshape(n), adv.reshape(n)]
        if self.afterstate:
            flat += [after.reshape(n, m, 52), turn.reshape(n)]
        ent = p["entropy_coef_start"] - torch.clamp(
            self.episodes.to(torch.float32) / p["entropy_anneal_episodes"],
            max=1.0) * (p["entropy_coef_start"] - p["entropy_coef_end"])
        mb = n // p["num_minibatches"]
        losses = []
        for _ in range(p["num_epochs"]):
            perm = torch.randperm(n, generator=self.gen, device=reward.device)
            for i in range(p["num_minibatches"]):
                idx = perm[i * mb:(i + 1) * mb]
                batch = tuple(x[idx] for x in flat)
                params = {k: v.detach().requires_grad_()
                          for k, v in self.params.items()}
                loss, aux = self._loss(params, batch, ent)
                grads = torch.autograd.grad(loss, list(params.values()),
                                            allow_unused=True)
                grads = [torch.zeros_like(v) if g is None else g
                         for v, g in zip(params.values(), grads)]
                if self.first is None:
                    pl, vl, en = (a.detach() for a in aux)
                    scale = (pl.abs() + p["value_loss_coef"] * vl
                             + ent * en.abs())
                    self.first = (float(loss.detach()), float(scale),
                                  [float(torch.linalg.vector_norm(g))
                                   for g in grads])
                self.params = {k: v.detach() for k, v in params.items()}
                self._adam(grads)
                losses.append(torch.stack([loss, *aux]).detach())
        self.episodes = self.episodes + done.sum(dtype=torch.int32)
        loss, policy, value, entropy = torch.stack(losses).mean(0)
        scale = (policy.abs() + p["value_loss_coef"] * value
                 + ent * entropy.abs())
        return float(loss), float(scale)

    def train_step(self):
        """One update: the rollout and the epochs.  Returns its mean
        minibatch loss and the scale of its terms, |policy loss| + c_v
        value loss + c_e |entropy|, the measure of a gap in the loss."""
        traj, last_value, last_turn = self._rollout()
        return self._update(traj, last_value, last_turn)
