"""Where a training step's time goes, on the card: movegen (default and
``fast()`` widths, and its pieces), the env step, the rollout alone and
the whole ``train_step``, at several batch sizes.

Port of ``scripts/perf_breakdown.py``, with the JAX script's keys under
each width, each keeping the meaning of the JAX timer behind it:

- ``movegen_ms``, ``movegen_nondoubles_ms``,
  ``movegen_doubles_subbatch_ms``, ``movegen_dedup_ms``: the device's
  time of one call (``utils.profiling.timed_scan``: a CUDA graph of 20
  calls, replayed), as the JAX script's one jitted scan.  The pieces are
  the JAX script's: the non-doubles batch over all B games, the doubles
  batch over the first ``doubles_capacity(B)`` games, and the dedup.
  The port's dedup runs inside the non-doubles kernel
  (``ops/nondoubles.py::nondoubles_batch``), so no dedup input is built
  on the path; ``movegen_dedup`` times that kernel's launch alone, dedup
  on, over all B games.
  Each has an ``_eager_ms`` twin: the same calls launched one by one
  (``timed_eager``), which follows the host's launch rate.
- ``env_step_ms``, ``rollout_ms``, ``train_step_ms``: host wall time of
  synchronised back-to-back eager calls after a warm-up
  (``utils.profiling.wall_time``, JAX's ``timeit``).  Beside each,
  ``<name>_device_ms`` is the device-busy time of one such call, the
  union of its kernels' intervals in a separate ``torch.profiler`` run
  (``utils.profiling.device_busy``), and ``rollout_idle_share`` /
  ``train_step_idle_share`` are 1 - device / wall, the wall time read
  from the untraced run (the profiler slows the host).
- The JAX script's derived keys with its formulas: ``update_ms`` =
  train - rollout, ``rollout_sps`` / ``train_sps`` = B T / time,
  ``movegen_share_of_step`` = movegen / env step; and
  ``movegen_device_share_of_step`` = movegen / env-step device time.
  ``update_device_ms`` is traced on its own (``learner.ppo_update`` on
  one rollout's output): a difference of two traces would carry the
  noise of both.

Each line names the device it ran on (``"device"``: the card's
``nvidia-smi`` name and power limit, or ``"cpu"``).  On the CPU the
timers read the CPU's clock and every device-time key is null.
Numbers are printed unrounded.

Usage:
    python -m mlp_ppo_2ply_p3_tpu_torch.scripts.perf_breakdown [B ...] \\
        [--t 64] [--device cuda]

One JSON line per batch size (default 4096 8192 16384).
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import resolve_device
from ..core import board as Bd
from ..core import movegen as MG
from ..env import bg_env
from ..models.mlp import ModelConfig
from ..ops import nondoubles as OND
from ..ppo import learner
from ..utils.profiling import (device_busy, device_label, timed_eager,
                               timed_scan, wall_time)

T = 64
SIZES = (4096, 8192, 16384)
MAX_MOVES = 256


def widths():
    return (("default", MG.MovegenConfig(max_moves=MAX_MOVES)),
            ("fast", MG.MovegenConfig.fast(MAX_MOVES)))


def movegen_pieces(vecs, dice, cfg):
    """{key: (fn, args)} of the movegen pieces that the JAX script's
    ``movegen_phase_times`` times: the non-doubles batch over all B
    games, the doubles batch over the doubles sub-batch's capacity of
    games, and the non-doubles kernel that holds the dedup."""
    bsz = vecs.shape[0]
    d0 = dice[:, 0].to(torch.int32)
    d1 = dice[:, 1].to(torch.int32)
    d_hi, d_lo = torch.maximum(d0, d1), torch.minimum(d0, d1)
    mir = torch.zeros((bsz,), dtype=torch.bool, device=vecs.device)
    bd = MG.doubles_capacity(bsz, cfg)
    return {
        "movegen_nondoubles": (
            lambda v, h, lo: MG._nondoubles_batch(v, h, lo, cfg, mir),
            (vecs, d_hi, d_lo)),
        "movegen_doubles_subbatch": (
            lambda v, d: MG._doubles_batch(v, d, cfg, mir[:bd]),
            (vecs[:bd], d0[:bd])),
        "movegen_dedup": (OND.nondoubles_batch,
                          (vecs.contiguous(), d_hi, d_lo, mir, cfg.k1,
                           cfg.dedup_width, cfg.max_moves, True)),
    }


def width_row(bsz: int, t: int, mg_cfg, dev: torch.device) -> dict:
    """The keys of one (B, width) cell."""
    on_card = dev.type == "cuda"
    env_cfg = bg_env.EnvConfig(movegen=mg_cfg)
    model_cfg = ModelConfig(action_size=MAX_MOVES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    es = bg_env.reset(gen, env_cfg, bsz, device=dev)
    vecs = Bd.to_canonical(es.points, es.bar, es.off, es.turn)

    row = {}

    def scan(key, fn, *args):
        row[f"{key}_ms"] = timed_scan(fn, *args) * 1e3
        row[f"{key}_eager_ms"] = timed_eager(fn, *args) * 1e3

    scan("movegen", lambda v, d: MG.legal_afterstates_batch(v, d, mg_cfg),
         vecs, es.dice)
    for key, (fn, args) in movegen_pieces(vecs, es.dice, mg_cfg).items():
        scan(key, fn, *args)

    acts = torch.zeros((bsz,), dtype=torch.int32, device=dev)
    k = torch.Generator(device=dev)
    k.manual_seed(1)
    ppo_cfg = learner.PPOConfig(
        num_envs=bsz, t_horizon=t, num_minibatches=32,
        normalize_adv=True, normalize_returns=False,
    )
    ts = learner.init_train_state(0, model_cfg, ppo_cfg, device=dev)
    calls = {
        "env_step": lambda: bg_env.step(es, acts, k, env_cfg),
        "rollout": lambda: learner.rollout(ts.model, es, learner.Sampler(k),
                                           env_cfg, ppo_cfg),
        "train_step": lambda: learner.train_step(ts, es, env_cfg, model_cfg,
                                                 ppo_cfg),
    }
    wall = {name: wall_time(fn, n=5 if name == "env_step" else 3)
            for name, fn in calls.items()}
    # the update's device time is traced on its own, after one rollout:
    # a difference of two traces would carry both traces' noise
    _, traj, last_value, last_turn = calls["rollout"]()
    calls["update"] = lambda: learner.ppo_update(
        ts, traj, last_value, last_turn, env_cfg, ppo_cfg,
        learner.Sampler(k))
    busy = {name: device_busy(fn, dev) if on_card else None
            for name, fn in calls.items()}
    for name in wall:
        row[f"{name}_ms"] = wall[name] * 1e3
    for name in calls:
        row[f"{name}_device_ms"] = (None if busy[name] is None
                                    else busy[name] * 1e3)

    def ratio(a, b):
        return None if a is None or b is None else a / b

    row["update_ms"] = row["train_step_ms"] - row["rollout_ms"]
    row["rollout_sps"] = bsz * t / wall["rollout"]
    row["train_sps"] = bsz * t / wall["train_step"]
    row["movegen_share_of_step"] = row["movegen_ms"] / row["env_step_ms"]
    row["movegen_device_share_of_step"] = ratio(row["movegen_ms"],
                                                row["env_step_device_ms"])
    for name in ("rollout", "train_step"):
        share = ratio(busy[name], wall[name])
        row[f"{name}_idle_share"] = None if share is None else 1 - share
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", nargs="*", type=int,
                    help=f"batch sizes (default {' '.join(map(str, SIZES))})")
    ap.add_argument("--t", type=int, default=T,
                    help="rollout horizon of the rollout and train_step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    label = device_label(dev)
    results = []
    for bsz in args.sizes or SIZES:
        row = {"B": bsz, "T": args.t, "device": label}
        for name, mg_cfg in widths():
            row[name] = width_row(bsz, args.t, mg_cfg, dev)
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


if __name__ == "__main__":
    main()
