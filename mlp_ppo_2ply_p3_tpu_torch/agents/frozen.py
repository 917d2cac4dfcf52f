"""Versioned frozen benchmark opponents for league evaluation.

Port of ``mlp_ppo_2ply_p3_tpu/agents/frozen.py``.  The committed
``frozen_v1`` asset (the final checkpoint of the JAX package's round-4
``afterstate4096`` learning run, hidden 128, action 256: the ``twoply``
preset's model) is the second fixed opponent beside pubeval, played
greedy 1-ply.  The port keeps its own byte-identical copy of it.  The
asset is self-describing: the model sizes are stored next to the
weights, under named keys in the JAX package's ``(in, out)`` layout.
"""

from __future__ import annotations

import os

import numpy as np

from ..models.mlp import HEADS, MLP, ModelConfig
from ..utils import convert

FROZEN_V1_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              os.pardir, "assets", "frozen_benchmark_v1.npz")


def save_frozen(path: str, model: MLP) -> None:
    """Write a self-describing frozen-opponent asset (the JAX package's
    keys, so either package reads it)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for layer, p in convert.params_to_numpy(model).items():
        arrays[f"{layer}_w"] = p["w"]
        arrays[f"{layer}_b"] = p["b"]
    cfg = model.cfg
    arrays["hidden_size"] = np.asarray(cfg.hidden_size)
    arrays["action_size"] = np.asarray(cfg.action_size)
    arrays["input_size"] = np.asarray(cfg.input_size)
    np.savez(path, **arrays)


def load_frozen(path: str = FROZEN_V1_PATH, device="cuda"):
    """(MLP on ``device``, ModelConfig) from a frozen asset, or None if
    the file is absent."""
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        tree = {layer: {"w": data[f"{layer}_w"], "b": data[f"{layer}_b"]}
                for layer in HEADS}
        cfg = ModelConfig(
            input_size=int(data["input_size"]),
            hidden_size=int(data["hidden_size"]),
            action_size=int(data["action_size"]),
        )
    return convert.params_from_jax(tree, cfg, device=device), cfg
