"""The port's training driver against JAX's ``train()`` on the same
configuration (``tests/test_remote.py``'s, unsharded): the same
``ckpt_<n>`` names, remote names, metrics path and metric keys; and the
league's statistics of one arena result against JAX's ``_arena_stats``.
A file of its own, since JAX compiles its ``train_step`` and both league
arenas."""

import json
import os

import numpy as np
import pytest
import torch

from mlp_ppo_2ply_p3_tpu_torch.agents import arena
from mlp_ppo_2ply_p3_tpu_torch.ppo import train as train_mod
from mlp_ppo_2ply_p3_tpu_torch.utils.remote import RemoteStore

from .test_torch_train import LEAGUE_KEYS, cap_plies, tiny_cfg, train


def _layout(root, cfg):
    ckpts = sorted(os.listdir(os.path.join(cfg.checkpoint_dir, cfg.name)))
    remote = RemoteStore(cfg.remote_url).list("")
    keys = [set(json.loads(x)) for x in open(cfg.metrics_path)]
    stem = [n.removesuffix(".npz") for n in ckpts]
    heads = sorted({"/".join(n.split("/")[:2]).removesuffix(".npz")
                    for n in remote})
    return stem, heads, os.path.relpath(cfg.metrics_path, root), keys


def test_layout_matches_jax_train(tmp_path, monkeypatch):
    """The same config through JAX's ``train()`` (unsharded) and the
    port's: the same checkpoint names (``ckpt_<n>``: JAX writes orbax
    directories here, the port ``.npz`` files; 3 updates at a checkpoint
    every 2), remote names, metrics path and metric keys on every line
    (eval every update, its arenas cut to 5 plies)."""
    from mlp_ppo_2ply_p3_tpu.agents import arena as j_arena
    from mlp_ppo_2ply_p3_tpu.core.movegen import MovegenConfig as JMG
    from mlp_ppo_2ply_p3_tpu.env import bg_env as j_env
    from mlp_ppo_2ply_p3_tpu.models.mlp import ModelConfig as JModel
    from mlp_ppo_2ply_p3_tpu.ppo import learner as j_learner
    from mlp_ppo_2ply_p3_tpu.ppo import train as j_train
    from mlp_ppo_2ply_p3_tpu.utils.config import RunConfig as JRun

    cap_plies(monkeypatch, j_arena, "play_jit", 5)
    cap_plies(monkeypatch, arena, "play", 5)
    layouts = []
    for side in ("jax", "port"):
        root = tmp_path / side
        common = dict(name="layout", num_updates=3, checkpoint_every=2,
                      eval_every=1, eval_games=2, overflow_policy="none",
                      checkpoint_dir=str(root / "ckpts"),
                      metrics_path=str(root / "metrics" / "layout.jsonl"),
                      remote_url=f"file://{root}/bucket")
        if side == "jax":
            cfg = JRun(env=j_env.EnvConfig(movegen=JMG(max_moves=64, k2=64,
                                                       k3=64)),
                       model=JModel(action_size=64, hidden_size=32),
                       ppo=j_learner.PPOConfig(num_envs=8, t_horizon=4,
                                               num_epochs=1,
                                               num_minibatches=2),
                       **common)
            j_train.train(cfg, resume=False, shard=False)
        else:
            cfg = tiny_cfg(tmp_path, **common)
            train(cfg, resume=False)
        layouts.append(_layout(root, cfg))
    (j_ckpts, j_remote, j_path, j_keys), (ckpts, remote, path, keys) = (
        layouts)
    # 3 updates at a cadence of 2: no checkpoint after the last update
    assert ckpts == j_ckpts == ["ckpt_2"]
    assert remote == j_remote == ["layout/ckpt_2", "layout/metrics.jsonl"]
    assert path == j_path
    assert keys == j_keys and LEAGUE_KEYS <= keys[0]
    assert np.all([k == keys[0] for k in keys])


@pytest.mark.parametrize("counts", [
    # wins_a, wins_b, finished, points_a, points_b, plies
    (5, 2, 7, 9, 3, 1301),
    (1, 6, 7, 2, 11, 2800),     # a negative margin
    (0, 0, 0, 0, 0, 3200),      # no game finished
])
def test_arena_stats_match_jax(counts):
    """One arena result's league statistics, field by field, against JAX's
    ``_arena_stats`` on the same counts (8 games; counts that differ from
    field to field, so a field read from the wrong place shows)."""
    import jax.numpy as jnp

    from mlp_ppo_2ply_p3_tpu.agents import arena as j_arena
    from mlp_ppo_2ply_p3_tpu.ppo import train as j_train

    want = j_train._arena_stats(j_arena.ArenaResult(
        *(jnp.int32(c) for c in counts)), 8, "heuristic")
    got = train_mod._arena_stats(arena.ArenaResult(
        *(torch.tensor(c, dtype=torch.int32) for c in counts)), 8,
        "heuristic")
    assert got == want
    assert {k: type(v) for k, v in got.items()} == {
        k: type(v) for k, v in want.items()}
