"""Headline benchmark of the port: env-steps/s per card for full PPO
training (rollout + GAE + minibatched update, all on the card) at 4096
parallel games.

Port of the root ``bench.py``.  Prints JSON lines of the form
  {"metric": "env_steps_per_sec_per_chip", "value": N, "unit": "steps/s",
   "vs_baseline": R}
on stdout, one after EVERY timed update (each refining the estimate with
one more sample), so a run that is killed mid-way still leaves the best
number measured so far as its last stdout line.  Progress (the card's
``nvidia-smi`` name and power limit, the kernels' build, the warm-up,
each update's seconds, loss and movegen overflow, their median, the
kernels' launches) streams to stderr, so a hung run shows where it hung.

Robustness, as in ``bench.py``:
  - every stage logs to stderr before it starts, flushed;
  - the JSON line is emitted after the first timed update, not at the
    end;
  - SIGTERM/SIGINT re-emit the last JSON line before exiting;
  - a watchdog thread logs the stage every 30 s and exits once
    BENCH_TIME_BUDGET (seconds, default 480) is blown; the timed loop
    also stops early rather than overrun it.

Timing: one untimed warm-up ``train_step`` first (it holds the first
launch of every kernel; the nvcc builds of ``csrc/*.cu`` run
before it, also off the clock, and its seconds are logged).  Each timed
update is host wall time around ``train_step`` and a
``torch.cuda.synchronize``, less the fence's own round trip measured on
an idle card.  The JAX package's compile cache and remote-TPU
workarounds have no counterpart.

Baseline: 1000 env-steps/s, the comparison denominator of ``bench.py``
(the reference design's O(10^2-10^3) ceiling, BASELINE.md).

Env knobs (``bench.py``'s): BENCH_ENVS (default 4096), BENCH_T (64),
BENCH_UPDATES (3 timed), BENCH_TIME_BUDGET (480 s), BENCH_MAX_MOVES
(256), BENCH_MOVEGEN (fast | default | parity width preset, default
fast), BENCH_PRESET (a ``utils.config`` preset whose env/model/ppo
configs replace the defaults; BENCH_ENVS/BENCH_T still override sizes).

Usage:
    python -m mlp_ppo_2ply_p3_tpu_torch.scripts.bench [--device cuda]

``--device cpu`` runs the plain PyTorch path (tests, tiny sizes); the
default ``cuda`` raises without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import statistics
import sys
import threading
import time
from typing import NamedTuple

import torch

from .. import ops, resolve_device
from ..core.movegen import MovegenConfig
from ..env import bg_env
from ..models.mlp import ModelConfig
from ..ppo import learner
from ..utils.config import get_preset
from ..utils.profiling import device_label

REFERENCE_BASELINE_STEPS_PER_SEC = 1000.0
MOVEGEN_PRESETS = {"fast": MovegenConfig.fast, "default": MovegenConfig,
                   "parity": MovegenConfig.parity}


def resolve_config(environ):
    """(EnvConfig, ModelConfig, PPOConfig) from the BENCH_* variables of
    ``environ``, built as ``bench.py`` builds them."""
    max_moves = int(environ.get("BENCH_MAX_MOVES", 256))
    mg_name = environ.get("BENCH_MOVEGEN", "fast")
    if mg_name not in MOVEGEN_PRESETS:
        raise ValueError(f"BENCH_MOVEGEN must be one of "
                         f"{sorted(MOVEGEN_PRESETS)}, got {mg_name!r}")
    mg_cfg = MOVEGEN_PRESETS[mg_name](max_moves=max_moves)
    preset = environ.get("BENCH_PRESET", "")
    if preset:
        cfg = get_preset(preset)
        ppo_cfg = dataclasses.replace(
            cfg.ppo,
            num_envs=int(environ.get("BENCH_ENVS", cfg.ppo.num_envs)),
            t_horizon=int(environ.get("BENCH_T", cfg.ppo.t_horizon)),
        )
        return cfg.env, cfg.model, ppo_cfg
    ppo_cfg = learner.PPOConfig(
        num_envs=int(environ.get("BENCH_ENVS", 4096)),
        t_horizon=int(environ.get("BENCH_T", 64)),
        num_minibatches=32,
        normalize_adv=True,
        normalize_returns=False,
    )
    return (bg_env.EnvConfig(movegen=mg_cfg),
            ModelConfig(action_size=max_moves), ppo_cfg)


class Progress:
    """The run's stage and last result line, shared by the main thread,
    the signal handlers and the watchdog."""

    def __init__(self):
        self.t0 = time.time()
        self.stage = "startup"
        self.last_line = None
        self.done = threading.Event()

    def log(self, msg: str) -> None:
        print(f"[bench +{time.time() - self.t0:6.1f}s] {msg}",
              file=sys.stderr, flush=True)

    def emit(self, sps: float) -> None:
        line = json.dumps({
            "metric": "env_steps_per_sec_per_chip",
            "value": round(sps, 1),
            "unit": "steps/s",
            "vs_baseline": round(sps / REFERENCE_BASELINE_STEPS_PER_SEC, 2),
        })
        self.last_line = line
        print(line, flush=True)

    def on_signal(self, signum, frame):
        self.log(f"received signal {signum}")
        if self.last_line:
            print(self.last_line, flush=True)
        sys.exit(0 if self.last_line else 1)

    def watchdog(self, budget: float) -> None:
        """A daemon thread: a heartbeat to stderr every 30 s, and a hard
        exit (the last line re-emitted) once the budget is blown, so that
        a hung run names its stage.  Ends when ``done`` is set."""

        def run():
            while not self.done.wait(30):
                elapsed = time.time() - self.t0
                self.log(f"watchdog: stage={self.stage} "
                         f"elapsed={elapsed:.0f}s")
                if budget > 0 and elapsed > budget:
                    self.log(f"watchdog: budget {budget:.0f}s exceeded "
                             f"during stage '{self.stage}'; exiting")
                    if self.last_line:
                        print(self.last_line, flush=True)
                    os._exit(0 if self.last_line else 1)

        threading.Thread(target=run, daemon=True).start()


class BenchResult(NamedTuple):
    state: learner.TrainState
    env_state: bg_env.EnvState
    update_s: list            # each timed update's seconds
    steps_per_sec: float      # the last line's value (unrounded)


def run(progress: Progress, env_cfg, model_cfg, ppo_cfg, timed_updates: int,
        budget: float, dev: torch.device) -> BenchResult:
    num_envs, t_horizon = ppo_cfg.num_envs, ppo_cfg.t_horizon
    on_card = dev.type == "cuda"

    def fence():
        if on_card:
            torch.cuda.synchronize(dev)

    progress.log(f"device: {device_label(dev)}; torch {torch.__version__}")
    if on_card:
        from ..ops import build

        progress.stage = "build"
        t0 = time.time()
        built = build.load_all()
        sources = ", ".join(f"csrc/{name}.cu" for name in built)
        progress.log(f"kernels built and loaded ({sources}) in "
                     f"{time.time() - t0:.1f}s")

    progress.stage = "init-and-reset"
    ts = learner.init_train_state(0, model_cfg, ppo_cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    env_state = bg_env.reset(gen, env_cfg, num_envs, device=dev)

    progress.stage = "warmup"
    progress.log(f"warm-up train_step (B={num_envs}, T={t_horizon}, "
                 f"M={env_cfg.max_moves}) ...")
    t0 = time.time()
    ts, env_state, metrics = learner.train_step(ts, env_state, env_cfg,
                                                model_cfg, ppo_cfg)
    fence()
    progress.log(f"warm-up done in {time.time() - t0:.1f}s")

    # the fence's round trip on an idle card, subtracted from each timed
    # update (the per-update fence is what makes one line per update
    # possible)
    t0 = time.time()
    fence()
    sync_overhead = time.time() - t0
    progress.log(f"fence round-trip: {sync_overhead * 1e3:.3f}ms "
                 "(subtracted per timed update)")

    steps_per_update = num_envs * t_horizon
    n_chips = 1     # the cards this process uses
    ops.zero_launches()
    update_s, sps = [], 0.0
    for i in range(timed_updates):
        elapsed = time.time() - progress.t0
        if i > 0 and budget > 0:
            est_next = sum(update_s) / i + sync_overhead
            if elapsed + est_next > budget * 0.9:
                progress.log(f"time budget {budget:.0f}s: stopping after "
                             f"{i} update(s) at +{elapsed:.1f}s")
                break
        progress.stage = f"update-{i + 1}"
        t0 = time.time()
        ts, env_state, metrics = learner.train_step(ts, env_state, env_cfg,
                                                    model_cfg, ppo_cfg)
        fence()
        dt = max(1e-9, time.time() - t0 - sync_overhead)
        update_s.append(dt)
        progress.log(
            f"update {i + 1}/{timed_updates}: {dt:.3f}s "
            f"({steps_per_update / dt / n_chips:.0f} steps/s/chip); loss "
            f"{float(metrics['loss']):.6f}, movegen_overflow "
            f"{int(metrics['movegen_overflow'])}")
        sps = steps_per_update * len(update_s) / sum(update_s) / n_chips
        progress.emit(sps)
    if update_s:
        progress.log(f"median update {statistics.median(update_s):.3f}s "
                     f"over {len(update_s)}: "
                     f"{[round(x, 3) for x in update_s]}")
    progress.log("launches " + json.dumps(ops.launches()))
    return BenchResult(ts, env_state, update_s, sps)


def main(argv=None) -> BenchResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    env_cfg, model_cfg, ppo_cfg = resolve_config(os.environ)
    timed_updates = int(os.environ.get("BENCH_UPDATES", 3))
    budget = float(os.environ.get("BENCH_TIME_BUDGET", 480))

    progress = Progress()
    saved = {s: signal.signal(s, progress.on_signal)
             for s in (signal.SIGTERM, signal.SIGINT)}
    progress.watchdog(budget)
    try:
        return run(progress, env_cfg, model_cfg, ppo_cfg, timed_updates,
                   budget, dev)
    finally:
        progress.done.set()
        for s, handler in saved.items():
            signal.signal(s, handler)


if __name__ == "__main__":
    main()
