"""The port's headline bench (``scripts/bench.py``) on the CPU.

- At BENCH_ENVS=8, BENCH_T=4, BENCH_UPDATES=2 and ``--device cpu`` it
  prints one 4-key JSON line per timed update, the last one last.
- SIGTERM after the first line re-emits the last line and exits 0.
- Its configurations equal, field by field, the JAX package's as the
  root ``bench.py`` builds them (built here: importing ``bench.py``
  boots JAX's backends and sets its cache variables).
- Its train state after the warm-up and 2 timed updates equals three
  direct ``learner.train_step`` calls from the same seeds.
- Without ``--device`` and without a card it raises."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mlp_ppo_2ply_p3_tpu.core.movegen import MovegenConfig as JMovegenConfig
from mlp_ppo_2ply_p3_tpu.env import bg_env as JE
from mlp_ppo_2ply_p3_tpu.models.mlp import ModelConfig as JModelConfig
from mlp_ppo_2ply_p3_tpu.ppo import learner as JL
from mlp_ppo_2ply_p3_tpu.utils.config import get_preset as jget_preset
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
from mlp_ppo_2ply_p3_tpu_torch.scripts import bench

from .test_torch_checkpoint import assert_equal_states

ROOT = Path(__file__).resolve().parent.parent
TINY = {"BENCH_ENVS": "8", "BENCH_T": "4", "BENCH_UPDATES": "2"}
LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}


def jax_configs(environ):
    """The root ``bench.py``'s (env, model, ppo) configs, built the way
    its ``main`` builds them."""
    num_envs = int(environ.get("BENCH_ENVS", 4096))
    t_horizon = int(environ.get("BENCH_T", 64))
    max_moves = int(environ.get("BENCH_MAX_MOVES", 256))
    mg_cfg = {
        "fast": JMovegenConfig.fast,
        "default": JMovegenConfig,
        "parity": JMovegenConfig.parity,
    }[environ.get("BENCH_MOVEGEN", "fast")](max_moves=max_moves)
    preset = environ.get("BENCH_PRESET", "")
    if preset:
        cfg = jget_preset(preset)
        ppo_cfg = dataclasses.replace(
            cfg.ppo,
            num_envs=int(environ.get("BENCH_ENVS", cfg.ppo.num_envs)),
            t_horizon=int(environ.get("BENCH_T", cfg.ppo.t_horizon)),
        )
        return cfg.env, cfg.model, ppo_cfg
    return (JE.EnvConfig(movegen=mg_cfg), JModelConfig(action_size=max_moves),
            JL.PPOConfig(num_envs=num_envs, t_horizon=t_horizon,
                         num_minibatches=32, normalize_adv=True,
                         normalize_returns=False))


@pytest.mark.parametrize("environ", [
    {},
    {"BENCH_MOVEGEN": "fast", "BENCH_MAX_MOVES": "128"},
    {"BENCH_MOVEGEN": "default"},
    {"BENCH_MOVEGEN": "parity", "BENCH_ENVS": "64", "BENCH_T": "8"},
    {"BENCH_PRESET": "train4096"},
    {"BENCH_PRESET": "train4096", "BENCH_ENVS": "512", "BENCH_T": "16"},
], ids=["defaults", "fast128", "default", "parity", "train4096",
        "train4096-resized"])
def test_config_matches_jax_bench(environ):
    """The bench's configurations equal the JAX bench's; the port's
    deep-network fields of the model hold their one-layer defaults."""
    got = bench.resolve_config(environ)
    want = jax_configs(environ)
    for g, w in zip(got, want):
        g = dataclasses.asdict(g)
        if "trunk" in g:
            assert (g.pop("trunk"), g.pop("outcome"), g.pop("race")) == (
                (), False, False)
        assert g == dataclasses.asdict(w)


def test_unknown_movegen_preset_raises():
    with pytest.raises(ValueError, match="BENCH_MOVEGEN"):
        bench.resolve_config({"BENCH_MOVEGEN": "wide"})


def test_lines_and_state(monkeypatch, capsys):
    """One line per timed update, the 4-key line last; the state equals
    three direct ``train_step`` calls (the warm-up and two timed ones)
    from the bench's seeds; stderr logs the launches of every kernel and
    the optimizer's calls, none on the CPU."""
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    res = bench.main(["--device", "cpu"])
    captured = capsys.readouterr()
    lines = captured.out.strip().splitlines()
    (launched,) = [json.loads(x.split("] launches ", 1)[1])
                   for x in captured.err.splitlines() if "] launches " in x]
    assert launched == {"compact_rows": 0, "doubles_level": 0,
                        "nondoubles": 0, "doubles_final": 0,
                        "afterstate_eval": 0,
                        "afterstate_eval_backward": 0, "adam_update": 0,
                        "afterstate_hidden": 0,
                        "afterstate_hidden_backward": 0,
                        "dense_layers": 0, "dense_layers_backward": 0,
                        "afterstate_route": 0}
    assert len(lines) == 2 and len(res.update_s) == 2
    for line in lines:
        got = json.loads(line)
        assert set(got) == LINE_KEYS
        assert got["metric"] == "env_steps_per_sec_per_chip"
        assert got["unit"] == "steps/s" and got["value"] > 0
        # both rounded from one unrounded rate: to two places apart
        assert abs(got["vs_baseline"] - got["value"] / 1000) <= 0.0051
    assert json.loads(lines[-1])["value"] == round(res.steps_per_sec, 1)
    assert res.steps_per_sec == pytest.approx(8 * 4 * 2 / sum(res.update_s))

    env_cfg, model_cfg, ppo_cfg = bench.resolve_config(TINY)
    ts = learner.init_train_state(0, model_cfg, ppo_cfg, device="cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(1)
    es = bg_env.reset(gen, env_cfg, 8, device="cpu")
    for _ in range(3):
        ts, es, _ = learner.train_step(ts, es, env_cfg, model_cfg, ppo_cfg)
    assert_equal_states((res.state, res.env_state), (ts, es))
    assert int(res.state.update_idx) == 3


def test_sigterm_reemits_last_line():
    """A long run, SIGTERM after its first line: the last stdout line is
    a line it printed before, and the exit code is 0."""
    env = {**os.environ, **TINY, "BENCH_UPDATES": "100000",
           "BENCH_TIME_BUDGET": "0"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "mlp_ppo_2ply_p3_tpu_torch.scripts.bench",
         "--device", "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        first = proc.stdout.readline()
        assert json.loads(first)["metric"] == "env_steps_per_sec_per_chip"
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    lines = [first.strip()] + rest.strip().splitlines()
    assert proc.returncode == 0
    assert len(lines) >= 2 and lines[-1] in lines[:-1]
    assert set(json.loads(lines[-1])) == LINE_KEYS


def test_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main([])
