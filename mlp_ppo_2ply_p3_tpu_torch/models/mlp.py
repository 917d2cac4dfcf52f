"""Backgammon MLP actor-critic as an ``nn.Module``.

Port of ``mlp_ppo_2ply_p3_tpu/models/mlp.py``: 198 -> hidden (ReLU) ->
{action logits (A), state value (1), afterstate score (1)}.  The score
head is the afterstate policy's per-candidate logit.

Initialisation is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and
biases (``nn.Linear``'s default distribution), drawn from an explicit
generator.  Parameters are float32; ``compute_dtype`` casts inputs and
weights for the matmuls (e.g. bfloat16) and outputs come back float32.
Weights carried over from the JAX package go through ``utils.convert``.

A ``trunk`` of hidden widths after ``fc1`` makes the network deep: ``fc1``
(198 -> ``hidden_size``), then ``fc2`` (-> trunk[0]), ``fc3``, ... (ReLU
after each), and the heads on the last.  With ``outcome`` the scalar ``value`` head gives
way to ``outcome`` (last width -> 6), whose softmax is the probabilities of
win, gammon win, backgammon win, loss, gammon loss and backgammon loss, and
the value is their expected reward (``OUTCOME_REWARDS``, the env's rewards
for each): wildbg's evaluation network (github.com/carsten-wenderdel/wildbg,
its training code's ``Network``: 300, 250, 200 and 6 outcomes) on the
port's 198 features.  Layers are drawn in the order fc1, fc2, ..., action,
value or outcome, score; a deep network computes in float32 (bfloat16
raises: ``DEEP_BF16_ITEM``).  The defaults keep the one-layer network, its
parameters and its draws as they were.

``race`` gives a deep network wildbg's whole evaluator: a second network of
the same widths (``race_fc1``, ..., ``race_score``, drawn after every layer
of the first) for race positions, where no checker of either side can meet
one of the other's (``core.features.is_race``), and the first for contact
positions.  Every row of the plain path goes through the network its
position's class selects (``NETS``); ``deep_weights`` gives either
network's weights to the afterstate pass, which routes each kept board on
the card (``ops.afterstate.afterstate_routed``).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn import functional as Fn

from .. import resolve_device
from ..core import features as F
from ..core.constants import (FEATURE_DIM, REWARD_WIN_BACKGAMMON,
                              REWARD_WIN_GAMMON, REWARD_WIN_NORMAL)

HEADS = ("fc1", "action", "value", "score")
# the outcome head's order and the reward of each outcome for the mover
OUTCOMES = ("win", "win_gammon", "win_backgammon", "lose", "lose_gammon",
            "lose_backgammon")
OUTCOME_REWARDS = (REWARD_WIN_NORMAL, REWARD_WIN_GAMMON,
                   REWARD_WIN_BACKGAMMON, -REWARD_WIN_NORMAL,
                   -REWARD_WIN_GAMMON, -REWARD_WIN_BACKGAMMON)
# what lifts the refusal of a deep bfloat16 network
DEEP_BF16_ITEM = "ROADMAP.md, queue 6, item C10"
# a routed model's networks, by position class, and their layers' prefixes
NETS = ("contact", "race")
PREFIX = {"contact": "", "race": "race_"}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    input_size: int = FEATURE_DIM
    hidden_size: int = 128          # reference HIDDEN_SIZE
    action_size: int = 500          # reference max_legal_moves
    compute_dtype: str = "float32"  # "bfloat16" for tensor-core inference
    trunk: tuple = ()               # a deep network's widths after fc1
    outcome: bool = False           # the value from 6 outcome probabilities
    race: bool = False              # a second network for race positions

    @property
    def widths(self) -> tuple:
        """The hidden widths, fc1's first."""
        return (self.hidden_size, *self.trunk)

    def check(self) -> None:
        """Raise on a configuration that no pass computes."""
        if self.trunk:
            if min(self.trunk) < 1:
                raise ValueError(f"a trunk's widths are positive; got "
                                 f"{self.trunk}")
            if self.compute_dtype != "float32":
                raise NotImplementedError(
                    f"a deep network computes in float32, not "
                    f"{self.compute_dtype}: see {DEEP_BF16_ITEM}")
        elif self.outcome:
            raise ValueError("the outcome head needs a trunk")
        elif self.race:
            raise ValueError("the race network needs a trunk")


class MLP(nn.Module):
    """The JAX params dict ``{"fc1", "action", "value", "score"}`` as an
    ``nn.ModuleDict`` of ``nn.Linear`` layers (``self.layers``)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        cfg.check()
        self.cfg = cfg
        widths = cfg.widths
        top = widths[-1]
        sizes = {"fc1": (cfg.input_size, widths[0])}
        for i in range(1, len(widths)):
            sizes[f"fc{i + 1}"] = (widths[i - 1], widths[i])
        sizes.update({
            "action": (top, cfg.action_size),
            "outcome" if cfg.outcome else "value":
                (top, len(OUTCOMES) if cfg.outcome else 1),
            "score": (top, 1),
        })
        if cfg.race:
            sizes.update({PREFIX["race"] + name: shape
                          for name, shape in list(sizes.items())})
        self.layers = nn.ModuleDict({
            name: nn.Linear(fan_in, fan_out, device=dev)
            for name, (fan_in, fan_out) in sizes.items()
        })
        with torch.no_grad():
            for lin in self.layers.values():
                bound = 1.0 / math.sqrt(lin.in_features)
                for p in (lin.weight, lin.bias):
                    p.uniform_(-bound, bound, generator=generator)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def _dense(self, name, x, dtype, net="contact"):
        lin = self.layers[PREFIX[net] + name]
        return Fn.linear(x.to(dtype), lin.weight.to(dtype),
                         lin.bias.to(dtype))

    def trunk(self, x, net="contact"):
        """(..., 198) -> the last hidden layer of network ``net``."""
        h = torch.relu(self._dense("fc1", x, self.dtype, net))
        for i in range(2, len(self.cfg.widths) + 1):
            h = torch.relu(self._dense(f"fc{i}", h, h.dtype, net))
        return h

    def _value(self, h, net):
        if self.cfg.outcome:
            return outcome_value(
                self._dense("outcome", h, h.dtype, net).float())
        return self._dense("value", h, h.dtype, net).float()[..., 0]

    def _routed(self, x, fn):
        """``fn(net)`` (a tensor or a tuple of them) of each row of ``x``
        from the network its position's class selects (the one network of
        a model without ``race``)."""
        if not self.cfg.race:
            return fn("contact")
        race = F.is_race(x)
        contact, raced = fn("contact"), fn("race")
        if isinstance(contact, tuple):
            return tuple(_pick(race, c, r) for c, r in zip(contact, raced))
        return _pick(race, contact, raced)

    def forward(self, x):
        """(..., 198) -> (logits (..., A), value (...,))."""
        def net_out(net):
            h = self.trunk(x, net)
            logits = self._dense("action", h, h.dtype, net).float()
            return logits, self._value(h, net)
        return self._routed(x, net_out)

    def value(self, x):
        """(..., 198) -> (...,) state/afterstate value via the value head
        (the outcome head's expected reward where the model has one)."""
        return self._routed(x, lambda net: self._value(self.trunk(x, net),
                                                       net))

    def outcome_probs(self, x):
        """(..., 198) -> (..., 6) the outcome head's probabilities."""
        return self._routed(x, lambda net: torch.softmax(self._dense(
            "outcome", self.trunk(x, net), torch.float32, net), dim=-1))

    def deep_weights(self, head, net="contact"):
        """A deep network's weights for ``ops.afterstate.afterstate_deep``:
        ([W1, b1, W2, b2, ..., W_head, b_head] of network ``net``, the
        outcome head's rewards or None) for ``head`` "score" or "value"."""
        name = "outcome" if head == "value" and self.cfg.outcome else head
        names = [f"fc{i}" for i in range(1, len(self.cfg.widths) + 1)]
        layers = [self.layers[PREFIX[net] + n] for n in names + [name]]
        weights = [p for lin in layers for p in (lin.weight, lin.bias)]
        return weights, OUTCOME_REWARDS if name == "outcome" else None

    def score(self, x):
        """(..., 198) -> (...,) afterstate policy score (logit per
        candidate)."""
        def net_score(net):
            h = self.trunk(x, net)
            return self._dense("score", h, h.dtype, net).float()[..., 0]
        return self._routed(x, net_score)


def _pick(race, contact, raced):
    """Each row's entry of ``raced`` where ``race`` (the leading dims), of
    ``contact`` elsewhere."""
    return torch.where(race.reshape(race.shape + (1,) * (contact.dim()
                                                         - race.dim())),
                       raced, contact)


def outcome_value(z):
    """(..., 6) outcome logits -> (...,) the expected reward of their
    softmax."""
    r = torch.tensor(OUTCOME_REWARDS, dtype=z.dtype, device=z.device)
    return (torch.softmax(z, dim=-1) * r).sum(-1)
