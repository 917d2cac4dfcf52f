#!/usr/bin/env python3
"""Drive the PyTorch port (``mlp_ppo_2ply_p3_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--t T] [--profile] [--out DIR]

Phases (any failure exits non-zero and prints no result line):

1. Device check: needs ``torch.cuda.is_available()``; prints the card's
   ``nvidia-smi`` name and power limit.
2. Build: compiles ``csrc/compaction.cu`` (both kernels: ``compact_rows``
   and ``dedup_compact_rows``) with nvcc for sm_90a.
3. Kernels vs plain versions, bit-exact ``out`` (every slot, zero tail
   included) and ``count``: ``compact_rows`` on ragged edge cases, on
   the split-N layout (one row of tens of thousands of flags), on the
   nine compaction call shapes of the ``train4096`` table (the eight of
   one movegen call and the former final one) and on the 2-ply reply
   shapes (non-doubles at candidate chunks of 512, 2048 and 8192,
   doubles at 512 and 2048: the JAX package's chunks and the port's);
   ``dedup_compact_rows`` on planted duplicates, high-nibble copies, the
   main-path shape and the reply shape.
4. Movegen on the card at B=4096 on boards from a few env steps: the
   kernel path is bit-exact against the plain-PyTorch path on the card
   and against the CPU on a 256-game slice.  Every kernel call of one
   movegen call is captured, checked against the plain version and
   timed (CUDA events) beside its bound.  The whole call is timed
   eagerly and as a CUDA graph replay (the device's own time).  Then
   one small ``train_step`` (B=64, T=8, full width) on the card and on
   the CPU from the same weights and draws: equal env integers,
   parameters and losses within 1e-4.
5. Training path: ``get_preset("train4096")`` at B=4096, M=256, hidden
   128: one warm-up ``train_step`` and two timed ones (T=64 by default;
   the preset's 128 is cut to keep the run short).  Losses must be
   finite, ``compact_rows.launches`` must grow by exactly
   ``compactions_per_call x T`` per step and
   ``dedup_compact_rows.launches`` by ``dedups_per_call x T``.  One
   more rollout and update are timed apart.  Then one
   ``afterstate``-mode ``train_step`` at B=512.
6. Evaluation path, the ``twoply`` preset on the committed frozen_v1
   net, positions after 12 random env steps: one 2-ply decision at
   B=256 at reply width 512 and at 128 (the reply dedup branch), and one
   at B=4096 at width 512, each with exact launch counts, the kernel
   path bit-exact against the plain path, and a 32-game slice against
   the CPU (actions where the best score leads by more than 1e-4, backup
   scores within 1e-4); every distinct reply call of those decisions
   checked against its plain version and timed beside its bound;
   decisions timed at B=256 and B=4096.  Then the league runner on the
   card: 1-ply vs the pubeval heuristic over 512 games and 400 plies
   (the win rate must lie within 0.072 of the JAX package's 0.818), and
   2-ply vs 1-ply over 64 games for at most 100 plies (cut from 400),
   both with exact launch counts for the plies played.
7. Prints the ``kernels`` JSON line (launches summed over every path's
   run, and by path), then the device line
   ``{"ok": true, "device": {...}}`` last.

``--profile`` adds ``torch.profiler`` breakdowns of four env steps and of
one 2-ply decision at B=256, after every timed phase.
``--out DIR`` writes the details of every phase to ``DIR/chip_smoke.json``
(and the profile table to ``DIR/chip_smoke_profile.txt``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
# CUDA-core rate for 32-bit operations outside the tensor cores (the H100
# SXM data sheet's float32 figure; the key compares are int32)
H100_OPS_PER_S = 67e12
TPU_KERNELS = ("mlp_ppo_2ply_p3_tpu/ops/compaction.py:178, "
               "mlp_ppo_2ply_p3_tpu/ops/compaction.py:231")
# jnp in the JAX package (no Pallas): the dedup flags and the compaction
# after them, which XLA fused
DEDUP_REPLACES = ("mlp_ppo_2ply_p3_tpu/core/movegen.py:256-273, "
                  "mlp_ppo_2ply_p3_tpu/core/movegen.py:364")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events).
    A ~20 ms device sleep is queued first, so the host has enqueued all
    calls before the first starts: the events then bracket the device
    work alone, not the host's launch overhead between small kernels."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)  # cycles: ~20 ms at 1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compaction_bytes(valid, k_out: int, c: int) -> int:
    """Bytes the function must move: valid flags in, the payload rows
    that land in the output, the output and the counts out."""
    b, n = valid.shape
    count = valid.sum(dim=1)
    landed = int(count.clamp(max=k_out).sum())
    return b * n + landed * c + b * k_out * c + 4 * b


def dedup_work(torch, compaction, boards, valid, k_out: int):
    """(bytes, key-word compares) that dedup + compaction must spend:
    the valid rows and the flags in, the output and the counts out; and
    the compares of each unique valid row against all its valid
    predecessors, and of each duplicate against one (7 words a key)."""
    g, k, c = boards.shape
    keep = compaction.first_occurrence_plain(boards, valid)
    v = valid.to(torch.int64)
    nv = int(v.sum())
    before = torch.cumsum(v, dim=1) - v   # valid predecessors of each row
    unique_pred = int((before * keep.to(torch.int64)).sum())
    dups = nv - int(keep.sum())
    nbytes = g * k + nv * c + g * k_out * c + 4 * g
    return nbytes, 7 * (unique_pred + dups)


def same(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def measure(torch, fn, plain_fn, args, nbytes, ops=0):
    """Check fn against plain_fn on args, then time both in turns (plain,
    kernel, kernel, plain) beside the bound."""
    ko, kc = fn(*args)
    po, pc = plain_fn(*args)
    torch.cuda.synchronize()
    shape = f"{tuple(args[0].shape)}->{args[2]}"
    check(same(ko, po) and same(kc, pc),
          f"kernel != plain on captured {shape}")
    err = max(int((ko.int() - po.int()).abs().max()) if ko.numel() else 0,
              int((kc - pc).abs().max()))
    iters = 20
    plain = time_ms(lambda: plain_fn(*args), iters)
    kern = time_ms(lambda: fn(*args), iters)
    kern2 = time_ms(lambda: fn(*args), iters)
    plain2 = time_ms(lambda: plain_fn(*args), iters)
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_OPS_PER_S * 1e3
    return {
        "shape": list(args[0].shape), "k_out": args[2],
        "ms": (kern + kern2) / 2, "plain_ms": (plain + plain2) / 2,
        "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
        "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "max_abs_err": err,
    }


def measure_calls(torch, compaction, captured, captured_dedup):
    """measure() every captured compaction and dedup call."""
    per_call = [
        measure(torch, compaction.compact_rows, compaction.compact_rows_plain,
                args, compaction_bytes(args[1], args[2], args[0].shape[2]))
        for args in captured]
    per_dedup = [
        measure(torch, compaction.dedup_compact_rows,
                compaction.dedup_compact_rows_plain, args,
                *dedup_work(torch, compaction, *args))
        for args in captured_dedup]
    return per_call, per_dedup


class Capture:
    """Swaps both compaction wrappers for ones that keep their inputs and
    call the kernels (``record``), or for the plain versions (``plain``),
    and restores them on exit.  ``distinct`` keeps one call per (shape,
    k_out)."""

    def __init__(self, compaction, plain=False, distinct=False):
        self.compaction, self.plain, self.distinct = (compaction, plain,
                                                      distinct)
        self.compact, self.dedup = [], []

    def _wrap(self, kept, fn):
        def wrapper(payload, valid, k_out):
            key = (tuple(payload.shape), k_out)
            if not self.distinct or key not in {
                    (tuple(a[0].shape), a[2]) for a in kept}:
                kept.append((payload, valid, k_out))
            return fn(payload, valid, k_out)
        return wrapper

    def __enter__(self):
        c = self.compaction
        self.saved = (c.compact_rows, c.dedup_compact_rows)
        if self.plain:
            c.compact_rows = c.compact_rows_plain
            c.dedup_compact_rows = c.dedup_compact_rows_plain
        else:
            c.compact_rows = self._wrap(self.compact, self.saved[0])
            c.dedup_compact_rows = self._wrap(self.dedup, self.saved[1])
        return self

    def __exit__(self, *exc):
        self.compaction.compact_rows, self.compaction.dedup_compact_rows = (
            self.saved)


def launches(compaction):
    return {"compact_rows": compaction.compact_rows.launches,
            "dedup_compact_rows": compaction.dedup_compact_rows.launches}


def zero_launches(compaction):
    compaction.compact_rows.launches = 0
    compaction.dedup_compact_rows.launches = 0


# --- phase 3 -----------------------------------------------------------------


def edge_cases(torch, compaction, dev):
    """Ragged shapes, the split-N layout, the nine train4096 compaction
    call shapes and the 2-ply reply shapes, with random flags; returns
    the cases checked."""
    rng = torch.Generator(device=dev)
    rng.manual_seed(3)
    # (B, N, C, k_out, fraction valid)
    cases = [
        (1, 1, 1, 1, 1.0), (1, 7, 3, 4, 0.6), (5, 33, 52, 8, 0.5),
        (9, 129, 53, 200, 0.3), (3, 1000, 5, 17, 0.5), (7, 300, 1, 300, 1.0),
        (11, 257, 52, 64, 0.0), (2, 2049, 55, 2049, 0.7), (4, 50, 2, 0, 0.5),
        (13, 4097, 7, 100, 0.02),
        # the split-N layout: one row of many flags, the count crossing
        # k_out inside a tile
        (1, 40000, 52, 7001, 0.35), (2, 30001, 55, 30001, 0.9),
        # the train4096 compaction call shapes (rows, N, C) -> k_out
        (1, 4096, 55, 3604, 0.88), (1, 4096, 54, 875, 0.17),
        (7208, 27, 52, 16, 0.3),
        (3604, 896, 52, 288, 0.12), (3604, 288, 52, 256, 0.12),
        (875, 27, 53, 16, 0.3), (875, 432, 53, 80, 0.08),
        (875, 2160, 53, 192, 0.04), (875, 5184, 53, 256, 0.03),
    ]
    # the 2-ply reply movegen's shapes at candidate chunks C: the stacked
    # k1 and the raw non-doubles block (-> 512, and -> 288 ahead of the
    # dedup below width 482) at the JAX package's game_chunk 2048 and the
    # port's 8192; doubles L1-L4 at k2 = 128, k3 = 256, M' = 512 at
    # dbl_game_chunk 512 (JAX) and 2048 (the port); their output runs
    # reach 27 KB, above a block's 16 KB output image
    for c in (512, 2048, 8192):
        cases += [(2 * c, 27, 52, 16, 0.3), (c, 896, 52, 512, 0.12),
                  (c, 896, 52, 288, 0.12)]
    for c in (512, 2048):
        cases += [(c, 27, 53, 16, 0.3), (c, 432, 53, 128, 0.3),
                  (c, 3456, 53, 256, 0.08), (c, 6912, 53, 512, 0.08)]
    out = []
    for b, n, c, k, frac in cases:
        payload = torch.randint(-128, 128, (b, n, c), generator=rng,
                                device=dev, dtype=torch.int8)
        valid = torch.rand((b, n), generator=rng, device=dev) < frac
        if b > 2:
            valid[1] = False           # an all-invalid row
            valid[2] = True            # an all-valid row
        got = compaction.compact_rows(payload, valid, k)
        want = compaction.compact_rows_plain(payload, valid, k)
        torch.cuda.synchronize()
        ok = same(got[0], want[0]) and same(got[1], want[1])
        check(ok, f"kernel != plain at {(b, n, c)} -> {k}")
        out.append({"shape": [b, n, c], "k_out": k, "exact": ok})
    return out


def dedup_cases(torch, compaction, dev):
    """dedup_compact_rows against its plain version: planted duplicates
    (copies of earlier rows, some differing only in the high nibbles that
    pack_key drops), ragged K, k_out = 0, the main-path shape, the 2-ply
    reply shape and the parity width; returns the cases checked."""
    rng = torch.Generator(device=dev)
    rng.manual_seed(4)
    # (G, K, k_out, fraction valid, share of planted copies, nibble noise)
    cases = [
        (3, 40, 16, 0.8, 0.4, False), (5, 37, 64, 0.7, 0.5, True),
        (8, 60, 0, 0.6, 0.3, False), (6, 33, 8, 1.0, 0.7, True),
        (3604, 288, 256, 0.3, 0.3, False), (3604, 288, 256, 0.9, 0.5, True),
        (64, 512, 500, 0.9, 0.5, True),
        # the 2-ply reply dedup below width 482 (reply_max_moves 128)
        (2048, 288, 128, 0.3, 0.3, False), (2048, 288, 128, 0.9, 0.5, True),
    ]
    out = []
    for g, k, k_out, frac, planted, nibble in cases:
        boards = torch.randint(0, 16, (g, k, 52), generator=rng, device=dev,
                               dtype=torch.int8)
        pick = (torch.rand((g, k), generator=rng, device=dev)
                * torch.arange(k, device=dev)).long()
        copy = torch.rand((g, k), generator=rng, device=dev) < planted
        noise = (torch.randint(0, 16, (g, k, 52), generator=rng, device=dev,
                               dtype=torch.int8) << 4) if nibble else 0
        rows = torch.arange(g, device=dev)
        for i in range(1, k):  # in order, so copies of copies chain
            src = boards[rows, pick[:, i]]
            if nibble:
                src = (src & 0xF) | noise[:, i]
            boards[:, i] = torch.where(copy[:, i, None], src, boards[:, i])
        valid = torch.rand((g, k), generator=rng, device=dev) < frac
        got = compaction.dedup_compact_rows(boards, valid, k_out)
        want = compaction.dedup_compact_rows_plain(boards, valid, k_out)
        torch.cuda.synchronize()
        ok = same(got[0], want[0]) and same(got[1], want[1])
        check(ok, f"dedup kernel != plain at {(g, k)} -> {k_out}")
        check(bool((want[1] < valid.sum(1)).any()),
              f"no duplicate planted at {(g, k)}")
        out.append({"shape": [g, k, 52], "k_out": k_out, "exact": ok})
    return out


# --- phase 4 -----------------------------------------------------------------


def play_boards(perf_twoply, env_cfg, batch, steps, dev):
    """Canonical boards, dice and mirror flags after a few random-play
    env steps from a fresh reset."""
    from mlp_ppo_2ply_p3_tpu_torch.core import board as Bd

    es = perf_twoply.realistic_state(env_cfg, batch, steps, device=dev)
    vecs = Bd.to_canonical(es.points, es.bar, es.off, es.turn)
    return vecs, es.dice, es.turn == 1


def movegen_phase(torch, compaction, movegen, perf_twoply, env_cfg, dev):
    mg = env_cfg.movegen
    vecs, dice, mirror = play_boards(perf_twoply, env_cfg, 4096, 6, dev)

    with Capture(compaction) as cap:
        got = movegen.legal_afterstates_batch(vecs, dice, mg, mirror)
    with Capture(compaction, plain=True):
        want = movegen.legal_afterstates_batch(vecs, dice, mg, mirror)
    captured, captured_dedup = cap.compact, cap.dedup
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("boards", "n_moves", "overflow")):
        check(same(g, w), f"movegen {name}: kernel path != plain path")
    check(len(captured) == movegen.compactions_per_call(mg),
          f"{len(captured)} compactions per movegen call, expected "
          f"{movegen.compactions_per_call(mg)}")
    check(len(captured_dedup) == movegen.dedups_per_call(mg),
          f"{len(captured_dedup)} dedups per movegen call, expected "
          f"{movegen.dedups_per_call(mg)}")

    # a 256-game slice on the CPU (plain path, no sub-batch partition)
    k = 256
    cpu = movegen.legal_afterstates_batch(vecs[:k].cpu(), dice[:k].cpu(), mg,
                                          mirror[:k].cpu())
    fits = ~got[2][:k].cpu()
    for g, c, name in zip(got, cpu, ("boards", "n_moves", "overflow")):
        check(same(g[:k].cpu()[fits], c[fits]),
              f"movegen {name}: card != CPU on the 256-game slice")
    check(int(got[1].sum()) > 0, "no legal moves at all")

    # time every kernel call of this movegen call: kernel vs plain
    per_call, per_dedup = measure_calls(torch, compaction, captured,
                                        captured_dedup)

    def one_call():
        movegen.legal_afterstates_batch(vecs, dice, mg, mirror)

    one_call()
    mg_ms = time_ms(one_call, 5)
    # A movegen call is about a thousand launches, more than the launch
    # queue holds, so the events above also see the host's launch rate
    # wherever it is slower than the device.  Replaying the call as a
    # CUDA graph leaves the device's own time.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        one_call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        one_call()
    graph.replay()
    mg_graph_ms = time_ms(graph.replay, 5)
    return per_call, per_dedup, mg_ms, mg_graph_ms


# --- phase 5 -----------------------------------------------------------------


def train_phase(torch, compaction, movegen, bg_env, learner, cfg, batch, t,
                dev, timed):
    """Warm-up + ``timed`` train_steps; returns a report dict."""
    ppo = dataclasses.replace(cfg.ppo, num_envs=batch, t_horizon=t)
    ts = learner.init_train_state(0, cfg.model, ppo, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    es = bg_env.reset(gen, cfg.env, batch, device=dev)
    t0 = time.time()
    ts, es, metrics = learner.train_step(ts, es, cfg.env, cfg.model, ppo)
    torch.cuda.synchronize()
    warm_s = time.time() - t0

    zero_launches(compaction)
    t0 = time.time()
    for _ in range(timed):
        ts, es, metrics = learner.train_step(ts, es, cfg.env, cfg.model, ppo)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counted = launches(compaction)

    mg = cfg.env.movegen
    for name, per_call in (("compact_rows", movegen.compactions_per_call(mg)),
                           ("dedup_compact_rows", movegen.dedups_per_call(mg))):
        expect = timed * t * per_call
        check(counted[name] == expect,
              f"{name} launched {counted[name]} times in {timed} "
              f"train_steps, expected {expect}")
    vals = {k: float(v) for k, v in metrics.items()}
    for k in ("loss", "policy_loss", "value_loss", "entropy"):
        check(math.isfinite(vals[k]), f"{k} not finite: {vals[k]}")
    for p in ts.model.parameters():
        check(bool(torch.isfinite(p).all()), "non-finite parameter")
    check(int(ts.update_idx) == 1 + timed, "update_idx did not advance")

    # where a step's time goes: the rollout and the update, each timed
    # on its own (host clock around synchronised work)
    sampler = learner.Sampler(ts.gen)
    t0 = time.time()
    es, traj, last_value, last_turn = learner.rollout(ts.model, es, sampler,
                                                      cfg.env, ppo)
    torch.cuda.synchronize()
    rollout_s = time.time() - t0
    t0 = time.time()
    learner.ppo_update(ts, traj, last_value, last_turn, cfg.env, ppo,
                       sampler)
    torch.cuda.synchronize()
    update_s = time.time() - t0
    return {
        "batch": batch, "t_horizon": t, "timed_steps": timed,
        "policy_mode": ppo.policy_mode, "warmup_s": warm_s,
        "train_step_s": dt / timed,
        "env_steps_per_s": batch * t * timed / dt,
        "rollout_s": rollout_s, "update_s": update_s,
        "launches": counted, "metrics": vals,
    }


class RecordingSampler:
    """Draws from the card's generator and keeps every draw, so that a
    CPU run can replay them."""

    def __init__(self, learner, gen):
        self.inner = learner.Sampler(gen)
        self.actions_, self.draws, self.perms = [], [], []

    def actions(self, masked):
        self.actions_.append(self.inner.actions(masked))
        return self.actions_[-1]

    def env_draws(self, batch_size):
        self.draws.append(self.inner.env_draws(batch_size))
        return self.draws[-1]

    def permutation(self, n, device):
        self.perms.append(self.inner.permutation(n, device))
        return self.perms[-1]


class ReplaySampler:
    def __init__(self, rec: RecordingSampler, device):
        self.actions_ = iter([a.to(device) for a in rec.actions_])
        self.draws = iter([type(d)(*(x.to(device) for x in d))
                           for d in rec.draws])
        self.perms = iter([p.to(device) for p in rec.perms])

    def actions(self, masked):
        return next(self.actions_)

    def env_draws(self, batch_size):
        return next(self.draws)

    def permutation(self, n, device):
        return next(self.perms)


def small_agreement_phase(torch, bg_env, learner, cfg, dev):
    """One train_step at B=64, T=8, hidden 128 on the card (kernel path)
    and on the CPU (plain path) from the same weights and the same draws:
    the rollouts must agree exactly in their integers, and parameters and
    losses to 1e-4 (float32 sums in another order on each side).
    Returns the largest parameter difference."""
    batch, t = 64, 8
    ppo = dataclasses.replace(cfg.ppo, num_envs=batch, t_horizon=t,
                              num_minibatches=4)
    gen = torch.Generator(device=dev).manual_seed(2)
    start = bg_env.reset(gen, cfg.env, batch, device=dev)
    rec = RecordingSampler(learner, gen)
    out = []
    for where, sampler in ((dev, rec), (torch.device("cpu"), None)):
        # the same seeded weights on both sides
        ts = learner.init_train_state(0, cfg.model, ppo, device="cpu")
        model = ts.model.to(where)
        ts = ts._replace(model=model,
                         opt_state=learner.init_optimizer(model))
        sampler = sampler or ReplaySampler(rec, where)
        es = bg_env.EnvState(*(x.to(where) for x in start))
        out.append(learner.train_step(ts, es, cfg.env, cfg.model, ppo,
                                      sampler))
    (g_ts, g_es, g_m), (c_ts, c_es, c_m) = out
    for name, g, c in zip(g_es._fields, g_es, c_es):
        check(same(g.cpu(), c), f"small train_step: env {name} card != CPU")
    diff = max(float((g.detach().cpu() - c.detach()).abs().max()) for g, c in
               zip(g_ts.model.parameters(), c_ts.model.parameters()))
    check(diff < 1e-4, f"small train_step: parameters differ by {diff}")
    for k in ("loss", "policy_loss", "value_loss", "entropy"):
        d = abs(float(g_m[k]) - float(c_m[k]))
        check(d < 1e-4, f"small train_step: {k} differs by {d}")
    return diff


# --- phase 6: the evaluation path --------------------------------------------

KERNELS = ("compact_rows", "dedup_compact_rows")
# 1-ply frozen_v1 against the pubeval heuristic in the JAX package, 512
# games (docs/LEARNING.md:171), and 3 sigma of the difference of two
# 512-game win rates near it
JAX_ONEPLY_VS_HEURISTIC = 0.818
WIN_RATE_BAND = 0.072
# the 2-ply vs 1-ply arena's plies, cut from 400: about 210 ms a ply
TWOPLY_PLIES = 100


def twoply_check(torch, compaction, twoply, bg_env, model, state, scfg):
    """One 2-ply decision over the batch: exact launch counts; the kernel
    path equal to the plain path bit for bit; a 32-game slice on the CPU
    equal in actions where the best score leads by more than 1e-4, in
    overflow, and in backup scores within 1e-4.  Returns (report, the
    decision's distinct compaction and dedup calls)."""
    import copy

    batch = state.turn.shape[0]
    zero_launches(compaction)
    with Capture(compaction, distinct=True) as cap:
        got = twoply.twoply_actions_values(model, state, scfg)
    torch.cuda.synchronize()
    counted = launches(compaction)
    expect = dict(zip(KERNELS, twoply.launches_per_decision(batch, scfg)))
    check(counted == expect, f"2-ply decision at B={batch}, reply width "
          f"{scfg.reply_max_moves}: launches {counted}, expected {expect}")
    with Capture(compaction, plain=True):
        plain = twoply.twoply_actions_values(model, state, scfg)
    for g, p, name in zip(got, plain, ("actions", "backup", "overflow")):
        check(same(g, p), f"2-ply {name}: kernel path != plain path")

    k = 32
    cpu_model = copy.deepcopy(model).cpu()
    cpu_state = bg_env.EnvState(*(x[:k].cpu() for x in state))
    top_idx, score2, ovf = twoply.candidate_scores(cpu_model, cpu_state, scfg)
    best = torch.argmax(score2, dim=-1, keepdim=True)
    action = torch.gather(top_idx, 1, best)[:, 0].to(torch.int32)
    backup = torch.gather(score2, 1, best)[:, 0]
    top2 = torch.topk(score2, 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-4
    check(same(got[0][:k].cpu()[clear], action[clear]),
          "2-ply actions: card != CPU on the 32-game slice")
    check(same(got[2][:k].cpu(), ovf),
          "2-ply overflow: card != CPU on the 32-game slice")
    diff = float((got[1][:k].cpu() - backup).abs().max())
    check(diff <= 1e-4, f"2-ply backup: card and CPU differ by {diff}")
    return {
        "batch": batch, "reply_max_moves": scfg.reply_max_moves,
        "launches": counted, "cpu_slice_games": k,
        "cpu_slice_clear_margin_games": int(clear.sum()),
        "cpu_slice_max_backup_diff": diff,
        "overflow_games": int(got[2].sum()),
    }, cap


def twoply_phase(torch, compaction, twoply, perf_twoply, bg_env, cfg, model,
                 dev):
    """The ``twoply`` preset on frozen_v1, positions after 12 random env
    steps: checked at B=256 at reply width 512 (no reply dedup) and 128
    (the dedup branch), and at B=4096 at width 512; the distinct reply
    calls of those decisions checked and timed against their plain
    versions; decisions timed at B=256 and B=4096."""
    states = {b: perf_twoply.realistic_state(cfg.env, b, 12, device=dev)
              for b in (256, 4096)}
    out = {"checks": [], "timing": []}
    calls = {}
    for batch, width in ((256, 512), (256, 128), (4096, 512)):
        scfg = dataclasses.replace(cfg.search, reply_max_moves=width)
        report, calls[batch, width] = twoply_check(
            torch, compaction, twoply, bg_env, model, states[batch], scfg)
        out["checks"].append(report)
        clear = report["cpu_slice_clear_margin_games"]
        log(f"2-ply B={batch} reply width {width}: kernel path == plain "
            f"path, card == CPU on 32 games ({clear} with a clear margin, "
            f"backup within {report['cpu_slice_max_backup_diff']:.1e}); "
            f"launches {report['launches']}")
    # B=4096 shares the doubles chunk with B=256; its non-doubles calls
    # run at the port's game_chunk
    reply = calls[256, 512].compact
    seen = {(tuple(a[0].shape), a[2]) for a in reply}
    reply = reply + [a for a in calls[4096, 512].compact
                     if (tuple(a[0].shape), a[2]) not in seen]
    per_call, _ = measure_calls(torch, compaction, reply, [])
    _, per_dedup = measure_calls(torch, compaction, [], calls[256, 128].dedup)
    out["reply_calls"], out["reply_dedups"] = per_call, per_dedup
    for name, rows in (("compact", per_call), ("dedup", per_dedup)):
        for row in rows:
            log(f"reply {name} {tuple(row['shape'])} -> {row['k_out']}: "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms,"
                f" bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    del calls, reply
    for batch, reps in ((256, 3), (4096, 1)):
        row, _ = perf_twoply.time_decision(model, states[batch], cfg.search,
                                           reps)
        out["timing"].append(row)
        log(f"2-ply decision B={batch}: {row['ms_per_decision']:.1f} ms, "
            f"{row['decisions_per_s']:.1f} decisions/s, peak "
            f"{row['peak_mem_gb']:.2f} GB")
    return out


def arena_phase(torch, compaction, movegen, arena, league, twoply, cfg, dev):
    """The league CLI's ``run_pair`` on the card: 1-ply frozen_v1 against
    the pubeval heuristic over 512 games, then 2-ply against 1-ply (both
    frozen_v1) over 64 games for at most ``TWOPLY_PLIES`` plies; exact
    launch counts of both for the plies that each played."""
    import contextlib

    mg = cfg.env.movegen
    per_step = {"compact_rows": movegen.compactions_per_call(mg),
                "dedup_compact_rows": movegen.dedups_per_call(mg)}
    out = {}
    for pair, games, plies in (("oneply:pubeval", 512, 400),
                               ("twoply:oneply", 64, TWOPLY_PLIES)):
        # count the plies played: the 2-ply pair's host loop stops once
        # every game is over
        inner, played = arena._ply, [0]

        def counted_ply(*a, **kw):
            played[0] += 1
            return inner(*a, **kw)

        zero_launches(compaction)
        arena._ply = counted_ply
        try:
            with contextlib.redirect_stdout(sys.stderr):
                res = league.run_pair(cfg, pair, games, plies, 11,
                                      params_from="frozen", device=dev)
        finally:
            arena._ply = inner
        counted = launches(compaction)
        ran = played[0]
        check(ran == plies or (0 < ran < plies and res["finished"] == games),
              f"arena {pair}: {ran} plies played of {plies}, "
              f"{res['finished']} of {games} games finished")
        # the reset and every ply list the moves of all games; the 2-ply
        # side decides for every game every ply
        search = (twoply.launches_per_decision(games, cfg.search)
                  if pair.startswith("twoply") else (0, 0))
        expect = {name: (1 + ran) * per_step[name] + ran * extra
                  for name, extra in zip(KERNELS, search)}
        check(counted == expect,
              f"arena {pair}: launches {counted}, expected {expect}")
        res["launches"] = counted
        res["max_plies"] = plies
        res["plies_played"] = ran
        out[pair] = res
        log(f"arena {pair}: {json.dumps(res)}")
    wr = out["oneply:pubeval"]["win_rate_a"]
    check(out["oneply:pubeval"]["finished"] == 512,
          "1-ply vs pubeval: not every game finished in 400 plies")
    check(abs(wr - JAX_ONEPLY_VS_HEURISTIC) <= WIN_RATE_BAND,
          f"1-ply frozen_v1 vs pubeval: win rate {wr}, JAX "
          f"{JAX_ONEPLY_VS_HEURISTIC} +- {WIN_RATE_BAND}")
    return out


def profile_phase(torch, bg_env, env_cfg, dev, decide):
    """torch.profiler tables (by device time) of four env steps at
    B=4096 and of one call of ``decide``."""
    from torch.profiler import ProfilerActivity, profile

    def table(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return prof.key_averages().table(sort_by="cuda_time_total",
                                         row_limit=25)

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    es = bg_env.reset(gen, env_cfg, 4096, device=dev)
    act = torch.zeros((4096,), dtype=torch.int32, device=dev)
    es, _ = bg_env.step(es, act, gen, env_cfg)

    def steps():
        state = es
        for _ in range(4):
            state, _ = bg_env.step(state, act, gen, env_cfg)

    return ("four env steps, train4096, B=4096\n" + table(steps)
            + "\none 2-ply decision, twoply, B=256\n" + table(decide))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t", type=int, default=64,
                    help="rollout horizon T of the main-path train_steps")
    ap.add_argument("--profile", action="store_true",
                    help="also profile four env steps and a 2-ply "
                         "decision with torch.profiler")
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json (and the profile)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, HERE)
    try:
        from mlp_ppo_2ply_p3_tpu_torch.agents import (arena, frozen, league,
                                                      twoply)
        from mlp_ppo_2ply_p3_tpu_torch.core import movegen
        from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
        from mlp_ppo_2ply_p3_tpu_torch.ops import build, compaction
        from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
        from mlp_ppo_2ply_p3_tpu_torch.scripts import perf_twoply
        from mlp_ppo_2ply_p3_tpu_torch.utils.config import get_preset
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")

    # full float32 matmuls, as the reference computes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "phases": {}}
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    build.load("compaction")
    report["phases"]["build_s"] = time.time() - t0
    log(f"built compaction.cu (both kernels) in {time.time() - t0:.1f}s\n"
        f"{build.build_logs.get('compaction', '(already built)').strip()}")

    report["phases"]["edge_cases"] = edge_cases(torch, compaction, dev)
    log(f"compact_rows == plain on {len(report['phases']['edge_cases'])} "
        f"shapes")
    report["phases"]["dedup_cases"] = dedup_cases(torch, compaction, dev)
    log(f"dedup_compact_rows == plain on "
        f"{len(report['phases']['dedup_cases'])} shapes")

    cfg = get_preset("train4096")
    per_call, per_dedup, mg_ms, mg_graph_ms = movegen_phase(
        torch, compaction, movegen, perf_twoply, cfg.env, dev)
    report["phases"]["movegen"] = {"ms_per_call": mg_ms,
                                   "graph_ms_per_call": mg_graph_ms,
                                   "compactions": per_call,
                                   "dedups": per_dedup}
    for name, rows in (("compact", per_call), ("dedup", per_dedup)):
        for row in rows:
            log(f"{name} {tuple(row['shape'])} -> {row['k_out']}: kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    log(f"movegen B=4096: {mg_ms:.3f} ms/call ({mg_graph_ms:.3f} ms as a "
        f"CUDA graph), kernel path == plain path")

    diff = small_agreement_phase(torch, bg_env, learner, cfg, dev)
    report["phases"]["small_train_step_max_param_diff"] = diff
    log(f"train_step B=64 T=8: card == CPU in every env integer, "
        f"parameters within {diff:.2e}")

    t = args.t
    if t != cfg.ppo.t_horizon:
        log(f"reduced: t_horizon {cfg.ppo.t_horizon} -> {t}")
    main_path = train_phase(torch, compaction, movegen, bg_env, learner,
                            cfg, 4096, t, dev, timed=2)
    report["phases"]["train4096"] = main_path
    log(f"train4096 B=4096 T={t}: {main_path['train_step_s']:.3f} s/step, "
        f"{main_path['env_steps_per_s']:.0f} env-steps/s on {card}; "
        f"launches {main_path['launches']}; one more step: "
        f"rollout {main_path['rollout_s']:.3f} s, update "
        f"{main_path['update_s']:.3f} s")
    after_cfg = dataclasses.replace(
        cfg, ppo=dataclasses.replace(cfg.ppo, policy_mode="afterstate"))
    report["phases"]["afterstate"] = train_phase(
        torch, compaction, movegen, bg_env, learner, after_cfg, 512, 16,
        dev, timed=1)
    log(f"afterstate B=512 T=16: "
        f"{report['phases']['afterstate']['train_step_s']:.3f} s/step")

    # the evaluation path: the twoply preset on the committed frozen_v1 net
    eval_cfg = get_preset("twoply")
    model, model_cfg = frozen.load_frozen(device=dev)
    check(model_cfg == eval_cfg.model, "frozen_v1 is not the twoply model")
    t0 = time.time()
    two = twoply_phase(torch, compaction, twoply, perf_twoply, bg_env,
                       eval_cfg, model, dev)
    report["phases"]["twoply"] = two
    log(f"2-ply phase: {time.time() - t0:.1f} s")
    log(f"reduced: 2-ply vs 1-ply arena max_plies 400 -> {TWOPLY_PLIES}")
    t0 = time.time()
    arenas = arena_phase(torch, compaction, movegen, arena, league, twoply,
                         eval_cfg, dev)
    report["phases"]["arena"] = arenas
    log(f"arena phase: {time.time() - t0:.1f} s; 1-ply frozen_v1 vs pubeval "
        f"heuristic {arenas['oneply:pubeval']['win_rate_a']:.3f} over 512 "
        f"games (JAX {JAX_ONEPLY_VS_HEURISTIC})")

    # each path's launches, counted from 0 just before it
    by_path = {"train4096": main_path["launches"],
               "afterstate": report["phases"]["afterstate"]["launches"]}
    for row in two["checks"]:
        by_path[f"twoply_b{row['batch']}_reply{row['reply_max_moves']}"] = (
            row["launches"])
    for pair, res in arenas.items():
        by_path[f"arena_{pair.replace(':', '_vs_')}"] = res["launches"]
    for path, counted in by_path.items():
        for name in KERNELS:
            # replies skip the dedup from width 482
            if not (path.endswith("_reply512")
                    and name == "dedup_compact_rows"):
                check(counted[name] > 0, f"{path} never launched {name}")

    # last, so that the profiler's own cost cannot reach the timed steps
    table = None
    if args.profile:
        state = perf_twoply.realistic_state(eval_cfg.env, 256, 12,
                                            device=dev)
        table = profile_phase(
            torch, bg_env, cfg.env, dev,
            lambda: twoply.twoply_actions_values(model, state,
                                                 eval_cfg.search))
        log(table)

    def kernel_row(name, replaces, rows):
        # times: one movegen call's launches (B=4096, train4096), summed;
        # launches: every path's run, summed, and by path
        bytes_ms = sum(r["bytes_ms"] for r in rows)
        ops_ms = sum(r["ops_ms"] for r in rows)
        return {
            "name": name,
            "route": "cuda",
            "source": "mlp_ppo_2ply_p3_tpu_torch/csrc/compaction.cu",
            "replaces": replaces,
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            # no single PyTorch call computes batched stable compaction,
            # nor ordered first-occurrence dedup at a fixed width
            # (torch.unique keeps neither the order nor a static shape)
            "library_ms": None,
        }

    kernels = [kernel_row("compact_rows", TPU_KERNELS, per_call),
               kernel_row("dedup_compact_rows", DEDUP_REPLACES, per_dedup)]
    report["kernels"] = kernels
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1)
        if table is not None:
            with open(os.path.join(args.out, "chip_smoke_profile.txt"),
                      "w") as f:
                f.write(table)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
