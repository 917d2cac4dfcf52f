"""wildbg's evaluation network as plain PyTorch, and PPO self-play with it.

The network (github.com/carsten-wenderdel/wildbg, its training code's
``Network``) on the 198 TD-Gammon features: three hidden ReLU layers of
``hidden_size`` and the configuration's ``trunk`` widths, then the heads on the last: the
action logits, the outcome logits (6: win, gammon win, backgammon win,
loss, gammon loss, backgammon loss), whose softmax weighted by the
configuration's ``outcome_rewards`` is the value, and the afterstate
score.  Parameters are drawn U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from the
run's generator layer by layer, weight before bias: fc1, fc2, ..., action,
outcome, score.  ``precision`` is ``model.py``'s: float32, or the TF32
control, every product of the forward and of the backward with both
operands rounded to TF32.

``Trainer`` is ``ppo.Trainer`` (the rollout, GAE, the loss, the replay of
the program's actions, the control and the planted faults) with this
network in place of the one-layer MLP.  Every slot of every row goes
through the network; nothing of the port is imported.
"""

from __future__ import annotations

import math

import torch

from . import model as Mdl
from . import ppo
from . import rules


def sizes(hidden, actions, outcomes, inputs=198):
    """Each layer's (fan in, fan out); ``hidden`` every hidden width."""
    widths = [inputs, *hidden]
    out = {f"fc{i + 1}": (widths[i], widths[i + 1])
           for i in range(len(hidden))}
    out.update({"action": (hidden[-1], actions),
                "outcome": (hidden[-1], outcomes), "score": (hidden[-1], 1)})
    return out


def init(gen, hidden, actions, outcomes, device):
    params = {}
    for name, (fan_in, fan_out) in sizes(hidden, actions, outcomes).items():
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.empty((fan_out, fan_in), device=device)
        b = torch.empty((fan_out,), device=device)
        params[name + ".weight"] = w.uniform_(-bound, bound, generator=gen)
        params[name + ".bias"] = b.uniform_(-bound, bound, generator=gen)
    return params


def hidden(params, x, precision="float32"):
    h, i = x, 1
    while f"fc{i}.weight" in params:
        h = torch.relu(Mdl.linear(h, params[f"fc{i}.weight"],
                                  params[f"fc{i}.bias"], precision))
        i += 1
    return h


def head(params, h, name, precision="float32"):
    return Mdl.linear(h, params[name + ".weight"], params[name + ".bias"],
                      precision)


def value(params, x, rewards, precision="float32"):
    """The expected reward of the outcome probabilities."""
    z = head(params, hidden(params, x, precision), "outcome", precision)
    r = torch.tensor(rewards, dtype=z.dtype, device=z.device)
    return (torch.softmax(z, dim=-1) * r).sum(-1)


def board_score(params, boards, mover, precision="float32"):
    """(R, M, 52) canonical boards encoded for ``mover`` (R,): the score
    head's (R, M) output."""
    feats = rules.encode_canonical(boards, mover[:, None])
    return head(params, hidden(params, feats, precision), "score",
                precision)[..., 0]


class Trainer(ppo.Trainer):
    """``ppo.Trainer`` with the deep network of ``cfg["model"]``."""

    def __init__(self, cfg, seed, device, precision="float32", follow=None,
                 fault=None, judged=None, nudge=False):
        if fault is not None and fault not in ppo.FAULTS:
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
        self.rewards = tuple(cfg["outcome_rewards"])
        self.params = init(self.gen, [m["hidden_size"], *m["trunk"]],
                           m["action_size"],
                           len(self.rewards), device)
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
        self.judged = judged
        self.first = None
        self.afterstate = self.p["policy_mode"] == "afterstate"

    def _logits(self, obs, after, turn, n):
        """(masked logits (B, M), value (B,))."""
        pr, m = self.precision, self.mg.max_moves
        val = value(self.params, obs, self.rewards, pr)
        if self.afterstate:
            score = board_score(self.params, after, turn.to(torch.int32), pr)
            return torch.where(ppo._prefix_mask(n, m), score, ppo.FLOOR), val
        out = head(self.params, hidden(self.params, obs, pr), "action", pr)
        return torch.where(ppo._prefix_mask(n, m), out[:, :m],
                           ppo.FLOOR), val

    @torch.no_grad()
    def _rollout(self):
        # ppo.Trainer's rollout bootstraps with model.value, the one-layer
        # head: swap in this network's value for the call
        saved = ppo.Mdl.value
        ppo.Mdl.value = lambda params, x, precision="float32": value(
            params, x, self.rewards, precision)
        try:
            return super()._rollout()
        finally:
            ppo.Mdl.value = saved
