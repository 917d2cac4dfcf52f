"""One training step of a preset, its rollout and its update apart: the
wall time of each, the device time (the union of its kernels in a
``torch.profiler`` trace, ``utils.profiling.device_busy``), the idle
share 1 - device / wall, the step's peak device memory, and env-steps/s.

    python -m mlp_ppo_2ply_p3_tpu_torch.scripts.perf_step \\
        [--preset afterstate4096] [--envs B] [--t T] [--device cuda]

A warm-up ``train_step`` first, then one timed ``train_step`` (its peak
memory from ``torch.cuda.max_memory_allocated``), then one more rollout
and one more update, each timed on the host clock around synchronised
work and traced on its own.  One JSON line, naming the device it ran on;
on the CPU every device key is null.

The script imports the port by its absolute name, so that it also times
another checkout of the package (an earlier commit, for a comparison in
one call): ``PYTHONPATH=<checkout> python <path to this file>``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from mlp_ppo_2ply_p3_tpu_torch import resolve_device
from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
from mlp_ppo_2ply_p3_tpu_torch.utils import profiling
from mlp_ppo_2ply_p3_tpu_torch.utils.config import get_preset


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, dev):
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="afterstate4096")
    ap.add_argument("--envs", type=int, default=None,
                    help="games (default: the preset's)")
    ap.add_argument("--t", type=int, default=None,
                    help="rollout horizon (default: the preset's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_preset(args.preset)
    ppo = dataclasses.replace(
        cfg.ppo, num_envs=args.envs or cfg.ppo.num_envs,
        t_horizon=args.t or cfg.ppo.t_horizon)
    ts = learner.init_train_state(0, cfg.model, ppo, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    es = bg_env.reset(gen, cfg.env, ppo.num_envs, device=dev)
    (ts, es, _), warm_s = _timed(
        lambda: learner.train_step(ts, es, cfg.env, cfg.model, ppo), dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    (ts, es, metrics), step_s = _timed(
        lambda: learner.train_step(ts, es, cfg.env, cfg.model, ppo), dev)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None

    sampler = learner.Sampler(ts.gen)

    def rollout():
        return learner.rollout(ts.model, es, sampler, cfg.env, ppo)

    (_, traj, last_value, last_turn), rollout_s = _timed(rollout, dev)

    def update():
        return learner.ppo_update(ts, traj, last_value, last_turn, cfg.env,
                                  ppo, sampler)

    _, update_s = _timed(update, dev)
    row = {"preset": args.preset, "B": ppo.num_envs, "T": ppo.t_horizon,
           "policy_mode": ppo.policy_mode,
           "device": profiling.device_label(dev), "warmup_s": warm_s,
           "train_step_s": step_s,
           "env_steps_per_s": ppo.num_envs * ppo.t_horizon / step_s,
           "peak_gb": peak, "rollout_s": rollout_s, "update_s": update_s,
           "loss": float(metrics["loss"])}
    for name, fn, wall in (("rollout", rollout, rollout_s),
                           ("update", update, update_s)):
        busy = profiling.device_busy(fn, dev) if on_card else None
        row[f"{name}_device_s"] = busy
        row[f"{name}_idle_share"] = (None if busy is None
                                     else max(0.0, 1 - busy / wall))
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
