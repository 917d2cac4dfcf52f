"""Rank 0's update in a data-parallel world, traced several times from one
restored state: what varies between traces of the same work (PERF.md §7,
the four-card cell's spread).

    python3 benchmark/dp_study.py [--ranks N] [--traces K] [--out FILE] \\
        [--cpu]

Each rank trains ``afterstate4096`` on 4,096 games of its own, one card a
rank over NCCL (``--cpu``: 8 games a rank, T=4, 2 minibatches, over gloo).
Two updates warm up; then K times every rank puts back the state they
left, meets the others at a barrier and runs one update, rank 0 under the
profiler.  Rank 0 prints one JSON line a trace: its device busy time (the
union of its kernels' intervals; on the CPU, of its operators'), the
update's wall time, the allocator's retries and new segments in it, the
card's clocks (``nvidia-smi``); ``--out`` gets those lines with each
trace's 25 costliest kernels by summed time.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SEED = 2200004001
TOP = 25


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _memory(dev):
    import torch

    return torch.cuda.memory_stats(dev) if dev.type == "cuda" else {}


def _clocks(dev):
    if dev.type != "cuda":
        return ""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader", "-i", str(dev.index)],
        capture_output=True, text=True).stdout.strip()


def _traced(step, dev):
    """(busy ms, wall s, {kernel: summed ms}) of one ``step()`` on rank 0
    under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.yardstick import profiling

    cuda = dev.type == "cuda"
    kind = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        w0 = time.perf_counter()
        step()
        _sync(dev)
        wall = time.perf_counter() - w0
    events = [(e.start_ns(), e.end_ns(), e.name())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == kind]
    table = {}
    for a, b, name in events:
        table[name[:70]] = table.get(name[:70], 0.0) + (b - a) / 1e6
    busy = profiling.busy_seconds((a, b) for a, b, _ in events) / 1e6
    return busy, wall, table


def worker(rank, size, port, cpu, traces, out):
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    os.environ["LOCAL_RANK"] = str(rank)
    from benchmark.drivers.ppo import _to
    from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
    from mlp_ppo_2ply_p3_tpu_torch.parallel import mesh
    from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
    from mlp_ppo_2ply_p3_tpu_torch.utils.config import get_preset

    world = mesh.initialize_distributed(
        f"localhost:{port}", size, rank, "gloo" if cpu else "nccl",
        device="cpu" if cpu else "cuda")
    dev = world.device
    cfg = get_preset("afterstate4096")
    ppo = dataclasses.replace(cfg.ppo, num_envs=4096 * size)
    if cpu:
        ppo = dataclasses.replace(ppo, num_envs=8 * size, t_horizon=4,
                                  num_minibatches=2)
    ts = learner.init_train_state(SEED, cfg.model, ppo, device=dev)
    es = bg_env.reset(ts.gen, cfg.env, ppo.num_envs, device=dev, world=world)
    sampler = learner.Sampler(ts.gen, world)

    def step():
        nonlocal ts, es
        ts, es, _ = learner.train_step(ts, es, cfg.env, cfg.model, ppo,
                                       sampler, world)

    t0 = time.time()
    for _ in range(2):
        step()
    _sync(dev)
    warm_s = time.time() - t0
    snap = (_to(list(ts.model.parameters()), "cpu"),
            _to(ts.opt_state, "cpu"), ts.gen.get_state(),
            _to((ts.update_idx, ts.episodes), "cpu"), _to(es, "cpu"))

    def restore():
        nonlocal ts, es
        params, opt, gen, counts, state = snap
        with torch.no_grad():
            for p, s in zip(ts.model.parameters(), params):
                p.copy_(s)
        ts.gen.set_state(gen)
        upd, eps = _to(counts, dev)
        ts = ts._replace(opt_state=_to(opt, dev), update_idx=upd,
                         episodes=eps)
        es = _to(state, dev)

    rows = []
    for k in range(traces):
        restore()
        _sync(dev)
        dist.barrier()
        if rank == 0:
            before = _memory(dev)
            busy, wall, table = _traced(step, dev)
            after = _memory(dev)
            row = {"trace": k, "busy_ms": busy, "wall_s": wall,
                   "clocks": _clocks(dev),
                   "alloc_retries": after.get("num_alloc_retries", 0)
                   - before.get("num_alloc_retries", 0),
                   "new_segments": after.get("segment.all.allocated", 0)
                   - before.get("segment.all.allocated", 0),
                   "reserved_gb": after.get("reserved_bytes.all.current",
                                            0) / 1e9}
            print(json.dumps(row), flush=True)
            row["top"] = sorted(table.items(), key=lambda kv: -kv[1])[:TOP]
            rows.append(row)
        else:
            step()
            _sync(dev)
        dist.barrier()
    if rank == 0 and out:
        with open(out, "w") as f:
            json.dump({"ranks": size, "warm_s": warm_s, "rows": rows,
                       "device": str(dev) if cpu
                       else torch.cuda.get_device_name(dev)}, f)
    mesh.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (default: every card; 2 with --cpu)")
    ap.add_argument("--traces", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)

    import torch
    import torch.multiprocessing as mp

    size = args.ranks or (2 if args.cpu else torch.cuda.device_count())
    mp.spawn(worker, args=(size, _free_port(), args.cpu, args.traces,
                           args.out), nprocs=size, join=True)


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)
    main()
