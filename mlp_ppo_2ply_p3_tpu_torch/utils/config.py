"""Typed configuration tree + named presets.

Port of ``mlp_ppo_2ply_p3_tpu/utils/config.py`` with the same presets:

- ``parity``:     reference-faithful learner semantics (MC returns,
                  return normalization, full batch), 8 games.
- ``debug``:      tiny sizes.
- ``vmap256``:    256 games.
- ``train4096``:  4096-game PPO (GAE, 32 minibatches, ``fast()`` movegen).
- ``afterstate4096``: the afterstate (score-head) policy at 4096 games.
- ``twoply``:     2-ply expectimax evaluation settings.
- ``pod``:        the multi-host scale-out sizes.

The fields of the training loop (``ppo/train.py``: checkpoints,
metrics, remote store) are kept as data so that a preset reads the same
in both packages; the port's training loop is not written yet.  Only
``SearchConfig``'s chunk sizes differ from the JAX package's: they were
sized again for the card.
"""

from __future__ import annotations

import dataclasses

from ..core.movegen import MovegenConfig
from ..env.bg_env import EnvConfig
from ..models.mlp import ModelConfig
from ..ppo.learner import PPOConfig


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """2-ply expectimax settings (``agents/twoply.py``).

    The chunks bound the reply sweep's memory: the flattened (B * top_k)
    candidate axis runs in ``game_chunk`` rows for the 15 non-doubles
    rolls and ``dbl_game_chunk`` rows for the 6 doubles dies, and reply
    values are computed in ``eval_slot_chunk``-wide feature blocks.  No
    chunking changes a result.  The JAX package's 2048 / 512 / 128 were
    set for TPU memory; these were picked on an H100 from the time and
    peak memory of B=4096 decisions at six chunkings
    (``python -m mlp_ppo_2ply_p3_tpu_torch.scripts.perf_twoply``; the
    table is in PERF.md): wider chunks than these gain little time for
    several times the memory."""

    top_k: int = 8              # 1-ply candidates kept for 2-ply expansion
    reply_max_moves: int = 512  # cap on opponent reply list width
    game_chunk: int = 8192
    dbl_game_chunk: int = 2048
    eval_slot_chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RunConfig:
    name: str = "default"
    env: EnvConfig = EnvConfig()
    model: ModelConfig = ModelConfig()
    ppo: PPOConfig = PPOConfig()
    search: SearchConfig = SearchConfig()
    num_updates: int = 1000
    seed: int = 0
    checkpoint_every: int = 10
    checkpoint_dir: str = "checkpoints"
    metrics_path: str = "metrics/{name}.jsonl"
    tb_logdir: str = ""
    log_every: int = 1
    eval_every: int = 25
    eval_games: int = 256
    overflow_policy: str = "warn"   # "none" | "warn" | "abort"
    remote_url: str = ""
    debug_nans: bool = False


def _env(max_moves: int) -> EnvConfig:
    return EnvConfig(movegen=MovegenConfig(max_moves=max_moves))


PRESETS: dict[str, RunConfig] = {}


def _register(cfg: RunConfig):
    PRESETS[cfg.name] = cfg
    return cfg


_register(RunConfig(
    name="parity",
    env=_env(500),
    model=ModelConfig(action_size=500),
    ppo=PPOConfig(
        num_envs=8, t_horizon=512, num_minibatches=1, use_gae=False,
        reward_perspective="absolute", normalize_returns=True,
        max_grad_norm=0.0, reset_each_update=True,
    ),
    num_updates=1000,
))

_register(RunConfig(
    name="debug",
    env=_env(128),
    model=ModelConfig(action_size=128),
    ppo=PPOConfig(num_envs=8, t_horizon=64, num_minibatches=2),
    num_updates=5,
    eval_every=3,
    eval_games=16,
))

_register(RunConfig(
    name="vmap256",
    env=_env(256),
    model=ModelConfig(action_size=256),
    ppo=PPOConfig(num_envs=256, t_horizon=128),
    num_updates=1000,
))

_register(RunConfig(
    # flagship throughput preset: fast() movegen widths
    name="train4096",
    env=EnvConfig(movegen=MovegenConfig.fast(256)),
    model=ModelConfig(action_size=256),
    ppo=PPOConfig(
        num_envs=4096, t_horizon=128, num_minibatches=32,
        normalize_adv=True, normalize_returns=False,
    ),
    num_updates=1000,
))

_register(RunConfig(
    # TD-Gammon-style afterstate policy at scale
    name="afterstate4096",
    env=EnvConfig(movegen=MovegenConfig.fast(256)),
    model=ModelConfig(action_size=256),
    ppo=PPOConfig(
        num_envs=4096, t_horizon=64, num_minibatches=32,
        normalize_adv=True, normalize_returns=False,
        policy_mode="afterstate",
    ),
    num_updates=1000,
))

_register(RunConfig(
    name="twoply",
    env=_env(256),
    model=ModelConfig(action_size=256),
    ppo=PPOConfig(
        num_envs=256, t_horizon=64, num_minibatches=8,
        normalize_adv=True, normalize_returns=False,
    ),
    search=SearchConfig(top_k=8, reply_max_moves=512),
    num_updates=1000,
    eval_games=64,
))

_register(RunConfig(
    name="pod",
    env=_env(256),
    model=ModelConfig(action_size=256),
    ppo=PPOConfig(
        num_envs=16384, t_horizon=128, num_minibatches=32,
        normalize_adv=True, normalize_returns=False,
    ),
    num_updates=1000,
))


def get_preset(name: str) -> RunConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
