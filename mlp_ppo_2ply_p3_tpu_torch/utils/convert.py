"""Carry weights, and a whole train state, between the JAX package and
the port.

The JAX package keeps the network as a dict
``{"fc1", "action", "value", "score"} x {"w", "b"}`` with ``w`` stored
(in, out); ``nn.Linear.weight`` is (out, in).  Inputs and outputs here
are numpy arrays, so neither side needs the other's framework.

``train_state_from_jax`` reads a JAX training checkpoint saved as npz
(``utils/checkpoint.py``'s ``backend="npz"``: arrays ``arr_0`` ... in
``jax.tree_util.tree_flatten((ts, env_state))`` order, and a fingerprint
of their shapes and dtypes) into the port's ``TrainState`` and
``EnvState``, so that a JAX run can be resumed by the port.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import resolve_device
from ..env.bg_env import EnvState
from ..models.mlp import HEADS, MLP, ModelConfig
from ..parallel import mesh
from ..ppo.learner import AdamState, TrainState
from . import checkpoint


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


# EnvState fields: (shape after the batch axis B, dtype); "M" is max_moves
_ENV_LEAVES = {
    "points": ((2, 24), "int8"), "bar": ((2,), "int8"),
    "off": ((2,), "int8"), "turn": ((), "int8"), "dice": ((2,), "int8"),
    "score": ((2,), "int32"), "game_over": ((), "bool"),
    "match_over": ((), "bool"), "after": (("M", 52), "int8"),
    "n_moves": ((), "int32"), "overflow": ((), "bool"),
}


def jax_train_state_leaves(cfg) -> list:
    """(name, shape, dtype) of every leaf of the JAX package's
    ``(TrainState, EnvState)`` for the ``RunConfig`` ``cfg``, in
    ``jax.tree_util.tree_flatten`` order (39 leaves): the params dict
    sorted ``action, fc1, score, value`` x ``b, w``; optax's Adam
    ``count``, ``mu`` and ``nu`` (the clip and scale stages hold no
    leaves); the PRNG key; the two counters; the env fields in order."""
    m = cfg.model
    shapes = {
        "action": (m.hidden_size, m.action_size), "fc1": (m.input_size,
                                                          m.hidden_size),
        "score": (m.hidden_size, 1), "value": (m.hidden_size, 1),
    }
    params = [(f"{layer}/{k}", shapes[layer] if k == "w"
               else shapes[layer][1:]) for layer in sorted(shapes)
              for k in ("b", "w")]
    leaves = [(f"params/{n}", s, "float32") for n, s in params]
    leaves.append(("opt_state/count", (), "int32"))
    for moment in ("mu", "nu"):
        leaves += [(f"opt_state/{moment}/{n}", s, "float32")
                   for n, s in params]
    leaves += [("key", (2,), "uint32"), ("update_idx", (), "int32"),
               ("episodes", (), "int32")]
    b, mm = cfg.ppo.num_envs, cfg.env.max_moves
    for field in EnvState._fields:
        shape, dtype = _ENV_LEAVES[field]
        leaves.append((f"env/{field}",
                       (b,) + tuple(mm if d == "M" else d for d in shape),
                       dtype))
    return leaves


def train_state_from_jax(npz_path: str, cfg, device="cuda", world=None):
    """A JAX training checkpoint (npz) -> (``TrainState``, ``EnvState``)
    of the port on ``device``, for the ``RunConfig`` ``cfg`` it was
    trained with.  With a ``world`` (``parallel.mesh.World``) the env
    state is this rank's shard of the checkpoint's games.

    Parameters, Adam's count and moments, ``update_idx``, ``episodes``
    and the env state carry over exactly; the file's fingerprint is
    checked against ``jax_train_state_leaves(cfg)`` first and a
    difference raises ``ValueError``.  The port's generator is seeded
    with the JAX key's two words, ``(key[0] << 32) | key[1]``: the run
    continues deterministically, but with the port's draws, not JAX's
    threefry stream."""
    checkpoint.refuse_directory(npz_path)
    npz_path = checkpoint.npz_path(npz_path)
    dev = resolve_device(device)
    leaves = jax_train_state_leaves(cfg)
    with np.load(npz_path) as data:
        if "__fingerprint__" not in data:
            raise ValueError(f"{npz_path}: no __fingerprint__ entry")
        stored = json.loads(bytes(data["__fingerprint__"]).decode())
        stored = stored.get("leaves", [])
        want = [[list(s), d] for _, s, d in leaves]
        if stored != want:
            i = next((i for i, (a, b) in enumerate(zip(stored, want))
                      if a != b), min(len(stored), len(want)))
            name = leaves[i][0] if i < len(leaves) else "(extra leaf)"
            raise ValueError(
                f"{npz_path} does not hold the JAX train state of this "
                f"config: {len(stored)} leaves, expected {len(want)}; "
                f"first difference at leaf #{i} ({name}): "
                f"{stored[i] if i < len(stored) else None} != "
                f"{want[i] if i < len(want) else None}")
        arrays = {name: data[f"arr_{i}"] for i, (name, _, _) in
                  enumerate(leaves)}

    def tree(prefix):
        return {layer: {k: arrays[f"{prefix}/{layer}/{k}"]
                        for k in ("w", "b")} for layer in HEADS}

    def on_dev(x):
        return torch.from_numpy(np.array(x, order="C")).to(dev)

    model = MLP(cfg.model, device=dev)
    load_jax_params(model, tree("params"))
    moments = {}
    for moment in ("mu", "nu"):
        t = tree(f"opt_state/{moment}")
        moments[moment] = [
            on_dev(t[name.split(".")[1]]["w"].T if name.endswith("weight")
                   else t[name.split(".")[1]]["b"])
            for name, _ in model.named_parameters()
        ]
    key = arrays["key"].astype(np.uint64)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int((key[0] << np.uint64(32)) | key[1]))
    ts = TrainState(
        model=model,
        opt_state=AdamState(on_dev(arrays["opt_state/count"]),
                            moments["mu"], moments["nu"]),
        gen=gen,
        update_idx=on_dev(arrays["update_idx"]),
        episodes=on_dev(arrays["episodes"]),
    )
    env_state = EnvState(*(
        mesh.shard_batch(on_dev(arrays[f"env/{f}"]), world)
        for f in EnvState._fields))
    return ts, env_state
