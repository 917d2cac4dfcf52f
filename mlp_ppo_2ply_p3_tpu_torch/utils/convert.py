"""Carry weights between the JAX package and the port.

The JAX package keeps the network as a dict
``{"fc1", "action", "value", "score"} x {"w", "b"}`` with ``w`` stored
(in, out); ``nn.Linear.weight`` is (out, in).  Inputs and outputs here
are numpy arrays, so neither side needs the other's framework.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.mlp import HEADS, MLP, ModelConfig


def params_from_jax(tree, cfg: ModelConfig | None = None,
                    device="cuda") -> MLP:
    """A JAX params dict of numpy arrays -> the port's ``MLP``."""
    w1 = np.asarray(tree["fc1"]["w"])
    if cfg is None:
        cfg = ModelConfig(
            input_size=w1.shape[0], hidden_size=w1.shape[1],
            action_size=np.asarray(tree["action"]["w"]).shape[1],
        )
    model = MLP(cfg, device=device)
    load_jax_params(model, tree)
    return model


def load_jax_params(model: MLP, tree) -> None:
    """Overwrite ``model``'s weights with a JAX params dict."""
    with torch.no_grad():
        for name in HEADS:
            lin = model.layers[name]
            w = np.asarray(tree[name]["w"], dtype=np.float32)
            b = np.asarray(tree[name]["b"], dtype=np.float32)
            if w.T.shape != tuple(lin.weight.shape):
                raise ValueError(f"{name}.w: JAX {w.shape} does not fit "
                                 f"{tuple(lin.weight.shape)} transposed")
            lin.weight.copy_(torch.tensor(w.T))
            lin.bias.copy_(torch.tensor(b))


def params_to_numpy(model: MLP) -> dict:
    """The port's ``MLP`` -> a JAX-layout params dict of numpy arrays."""
    return {
        name: {
            "w": model.layers[name].weight.detach().cpu().numpy().T.copy(),
            "b": model.layers[name].bias.detach().cpu().numpy().copy(),
        }
        for name in HEADS
    }
