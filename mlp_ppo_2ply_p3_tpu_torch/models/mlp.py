"""Backgammon MLP actor-critic as an ``nn.Module``.

Port of ``mlp_ppo_2ply_p3_tpu/models/mlp.py``: 198 -> hidden (ReLU) ->
{action logits (A), state value (1), afterstate score (1)}.  The score
head is the afterstate policy's per-candidate logit.

Initialisation is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weights and
biases (``nn.Linear``'s default distribution), drawn from an explicit
generator.  Parameters are float32; ``compute_dtype`` casts inputs and
weights for the matmuls (e.g. bfloat16) and outputs come back float32.
Weights carried over from the JAX package go through ``utils.convert``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.nn import functional as Fn

from .. import resolve_device
from ..core.constants import FEATURE_DIM

HEADS = ("fc1", "action", "value", "score")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    input_size: int = FEATURE_DIM
    hidden_size: int = 128          # reference HIDDEN_SIZE
    action_size: int = 500          # reference max_legal_moves
    compute_dtype: str = "float32"  # "bfloat16" for tensor-core inference


class MLP(nn.Module):
    """The JAX params dict ``{"fc1", "action", "value", "score"}`` as an
    ``nn.ModuleDict`` of ``nn.Linear`` layers (``self.layers``)."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        sizes = {
            "fc1": (cfg.input_size, cfg.hidden_size),
            "action": (cfg.hidden_size, cfg.action_size),
            "value": (cfg.hidden_size, 1),
            "score": (cfg.hidden_size, 1),
        }
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

    def _dense(self, name, x, dtype):
        lin = self.layers[name]
        return Fn.linear(x.to(dtype), lin.weight.to(dtype),
                         lin.bias.to(dtype))

    def trunk(self, x):
        return torch.relu(self._dense("fc1", x, self.dtype))

    def forward(self, x):
        """(..., 198) -> (logits (..., A), value (...,))."""
        h = self.trunk(x)
        logits = self._dense("action", h, h.dtype).float()
        value = self._dense("value", h, h.dtype).float()[..., 0]
        return logits, value

    def value(self, x):
        """(..., 198) -> (...,) state/afterstate value via the value head."""
        h = self.trunk(x)
        return self._dense("value", h, h.dtype).float()[..., 0]

    def score(self, x):
        """(..., 198) -> (...,) afterstate policy score (logit per
        candidate)."""
        h = self.trunk(x)
        return self._dense("score", h, h.dtype).float()[..., 0]
