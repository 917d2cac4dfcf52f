"""Full-train-state checkpointing, so that a resumed run continues where
it stopped.

Port of ``mlp_ppo_2ply_p3_tpu/utils/checkpoint.py``.  A checkpoint of
``(TrainState, EnvState)`` holds:

- the model's parameters, ``model/<parameter name>``;
- Adam's step count and moments, ``adam/count``, ``adam/mu/<parameter
  name>``, ``adam/nu/<parameter name>``: named after the parameter they
  belong to, so the pairing cannot shift;
- the generator's state, ``gen/state`` (a CUDA generator's is 16 bytes:
  its seed and Philox offset);
- ``update_idx`` and ``episodes``;
- the 11 ``EnvState`` fields, ``env/<field>``.

The format is one ``.npz`` of named arrays, with a ``__fingerprint__``
entry (names, shapes and dtypes) that ``restore`` compares with the
target before it copies anything: a structure that changed between save
and restore raises ``ValueError`` instead of restoring wrong.  Each
tensor goes through one host copy on the way out and one on the way in.

A checkpoint does not depend on the layout of a run.  A data-parallel
run (a ``parallel.mesh.World``) gathers the env state of every rank and
rank 0 writes the global one, so the file is array for array the
unsharded run's; ``restore`` reads it on every rank and keeps the
rank's games.  A run of one layout therefore resumes under any other.

The JAX package writes an orbax directory where orbax is installed
(``backend="auto"``).  The port cannot read one and says so; an npz of
the JAX package (``backend="npz"``) is read by
``utils.convert.train_state_from_jax``.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import torch

from ..env.bg_env import EnvState
from ..parallel import mesh
from ..ppo.learner import AdamState, TrainState

FORMAT = "mlp_ppo_2ply_p3_tpu_torch/train-state-v1"
_GEN = "gen/state"


def _named(state) -> dict:
    """name -> tensor of a (TrainState, EnvState), the generator aside."""
    ts, env_state = state
    names = [n for n, _ in ts.model.named_parameters()]
    out = {f"model/{n}": p for n, p in ts.model.named_parameters()}
    out["adam/count"] = ts.opt_state.count
    out.update({f"adam/mu/{n}": m for n, m in zip(names, ts.opt_state.mu)})
    out.update({f"adam/nu/{n}": v for n, v in zip(names, ts.opt_state.nu)})
    out["update_idx"] = ts.update_idx
    out["episodes"] = ts.episodes
    out.update({f"env/{f}": x for f, x in zip(EnvState._fields, env_state)})
    return out


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _fingerprint(named: dict, ranks: int = 1) -> list:
    """[name, shape, dtype] per array; the env fields' game axis counts
    the games of all ``ranks`` shards."""
    return [[k, [t.shape[0] * ranks, *t.shape[1:]] if k.startswith("env/")
             else list(t.shape), _dtype(t)] for k, t in named.items()]


def refuse_directory(path: str) -> None:
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: an orbax checkpoint of the JAX "
            f"package, which the port cannot read.  Re-save it as npz "
            f"with the JAX package (restore it, then "
            f"checkpoint.save(path, tree, backend='npz')) and load that "
            f"with utils.convert.train_state_from_jax")


def npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, state, world=None) -> str | None:
    """Write ``state = (TrainState, EnvState)`` to ``path`` (``.npz`` is
    appended when missing) and return the file's path.  The file is
    written beside its final name and renamed into place, so a run cut
    off while saving leaves the previous checkpoint as the newest.

    With a ``world`` every rank must call this: the env shards are
    gathered, rank 0 writes the global state and returns its path, the
    other ranks write nothing and return None."""
    ts, env_state = state
    if world is not None:
        env_state = mesh.gather_batch(env_state, world)
        if world.rank != 0:
            return None
    named = _named((ts, env_state))
    arrays = {k: t.detach().cpu().numpy() for k, t in named.items()}
    arrays[_GEN] = ts.gen.get_state().numpy()
    fp = {"format": FORMAT, "generator": ts.gen.device.type,
          "arrays": _fingerprint(named)}
    arrays["__fingerprint__"] = np.frombuffer(json.dumps(fp).encode(),
                                              dtype=np.uint8)
    out = npz_path(path)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    tmp = os.path.join(os.path.dirname(out),
                       "." + os.path.basename(out) + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, out)
    return out


def _reseed(device_type: str, state: bytes) -> int:
    """A 63-bit seed derived from a generator state of another device
    type (same bytes, same seed)."""
    digest = hashlib.sha256(device_type.encode() + state).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def restore(path: str, like, world=None):
    """Restore a (TrainState, EnvState) shaped like ``like``.  With a
    ``world``, ``like``'s env state is this rank's shard: the file's
    global env state is read and the rank's games are kept.

    The model's parameters and the generator are written in place into
    ``like``'s (``TrainState`` shares the module with its callers);
    every other tensor is new, on the device of its counterpart in
    ``like``.  Raises ``ValueError`` when the stored names, shapes or
    dtypes differ from ``like``'s, for a directory (an orbax checkpoint)
    and for an npz of the JAX package.

    Every tensor is restored exactly, whatever device wrote it.  The
    generator's state is restored as saved when ``like``'s generator is
    on the same device type; a state from another device type (a CPU
    generator's is 5056 bytes, a CUDA one's 16) cannot be carried over,
    so the generator is reseeded from a hash of that state instead,
    deterministically.  Only a resume on the same device type continues
    the run bit for bit."""
    refuse_directory(path)
    target = _named(like)
    with np.load(npz_path(path)) as data:
        if "__fingerprint__" not in data:
            raise ValueError(f"{path}: no __fingerprint__ entry")
        fp = json.loads(bytes(data["__fingerprint__"]).decode())
        if fp.get("format") != FORMAT:
            raise ValueError(
                f"{path} is not a checkpoint of the port (an npz of the "
                f"JAX package? read it with "
                f"utils.convert.train_state_from_jax)")
        want = _fingerprint(target, world.size if world else 1)
        if fp["arrays"] != want:
            first = next((i for i, (a, b) in enumerate(
                zip(fp["arrays"], want)) if a != b), min(
                    len(fp["arrays"]), len(want)))
            raise ValueError(
                f"checkpoint structure mismatch at {path}: saved "
                f"{len(fp['arrays'])} arrays, target expects {len(want)}; "
                f"first differing entry #{first}: saved "
                f"{fp['arrays'][first] if first < len(fp['arrays']) else None}"
                f", target {want[first] if first < len(want) else None}")
        host = {k: torch.from_numpy(data[k]) for k in target}
        gen_state = data[_GEN]
    ts, env_state = like
    with torch.no_grad():
        for n, p in ts.model.named_parameters():
            p.copy_(host[f"model/{n}"])
    names = [n for n, _ in ts.model.named_parameters()]

    def moved(key):
        x = mesh.shard_batch(host[key], world) if key.startswith(
            "env/") else host[key]
        return x.to(target[key].device)

    gen = ts.gen
    if fp["generator"] == gen.device.type:
        gen.set_state(torch.from_numpy(gen_state))
    else:
        gen.manual_seed(_reseed(fp["generator"], gen_state.tobytes()))
        print(f"checkpoint {path}: generator saved on {fp['generator']}, "
              f"restored on {gen.device.type}: reseeded (the run does not "
              f"continue bit for bit)")
    ts = TrainState(
        model=ts.model,
        opt_state=AdamState(
            count=moved("adam/count"),
            mu=[moved(f"adam/mu/{n}") for n in names],
            nu=[moved(f"adam/nu/{n}") for n in names],
        ),
        gen=gen,
        update_idx=moved("update_idx"),
        episodes=moved("episodes"),
    )
    env_state = EnvState(*(moved(f"env/{f}") for f in EnvState._fields))
    return ts, env_state


def latest(dirpath: str, prefix: str = "ckpt_"):
    """Newest ``ckpt_<update>`` entry under ``dirpath`` (an npz file, or
    a directory that ``restore`` refuses), or None."""
    if not os.path.isdir(dirpath):
        return None
    cands = [f for f in os.listdir(dirpath) if f.startswith(prefix)]
    if not cands:
        return None

    def step_of(f):
        stem = f[len(prefix):]
        stem = stem[:-4] if stem.endswith(".npz") else stem
        try:
            return int(stem)
        except ValueError:
            return -1

    return os.path.join(dirpath, max(cands, key=step_of))
