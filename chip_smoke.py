#!/usr/bin/env python3
"""Drive the PyTorch port (``mlp_ppo_2ply_p3_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--t T] [--profile] [--out DIR]

Phases (any failure exits non-zero and prints no result line):

1. Device check: needs ``torch.cuda.is_available()``; prints the card's
   ``nvidia-smi`` name and power limit.
2. Build: compiles ``csrc/compaction.cu`` with nvcc for sm_90a.
3. Kernel vs plain on ragged edge cases and on the six movegen call
   shapes of the ``train4096`` table: bit-exact ``out`` (every slot,
   zero tail included) and ``count``.
4. Movegen on the card at B=4096 on boards from a few env steps: the
   kernel path is bit-exact against the plain-PyTorch path on the card
   and against the CPU on a 256-game slice.  Every compaction of one
   movegen call is captured, checked against the plain version and
   timed (CUDA events) beside its byte bound.  Then one small
   ``train_step`` (B=64, T=8, full width) on the card and on the CPU
   from the same weights and draws: equal env integers, parameters and
   losses within 1e-4.
5. Main path: ``get_preset("train4096")`` at B=4096, M=256, hidden 128:
   one warm-up ``train_step`` and two timed ones (T=64 by default; the
   preset's 128 is cut to keep the run short).  Losses must be finite and
   ``compact_rows.launches`` must grow by exactly
   ``compactions_per_call x T`` per step.  One more rollout and update
   are timed apart.  Then one ``afterstate``-mode ``train_step`` at
   B=512.
6. Prints the ``kernels`` JSON line, then the device line
   ``{"ok": true, "device": {...}}`` last.

``--profile`` adds a ``torch.profiler`` breakdown of four env steps,
after every timed phase.
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
TPU_KERNELS = ("mlp_ppo_2ply_p3_tpu/ops/compaction.py:178, "
               "mlp_ppo_2ply_p3_tpu/ops/compaction.py:231")


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


def same(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


# --- phase 3 -----------------------------------------------------------------


def edge_cases(torch, compaction, dev):
    """Ragged shapes and the six train4096 movegen compaction shapes,
    with random flags; returns the cases checked."""
    rng = torch.Generator(device=dev)
    rng.manual_seed(3)
    # (B, N, C, k_out, fraction valid)
    cases = [
        (1, 1, 1, 1, 1.0), (1, 7, 3, 4, 0.6), (5, 33, 52, 8, 0.5),
        (9, 129, 53, 200, 0.3), (3, 1000, 5, 17, 0.5), (7, 300, 1, 300, 1.0),
        (11, 257, 52, 64, 0.0), (2, 2049, 55, 2049, 0.7), (4, 50, 2, 0, 0.5),
        (13, 4097, 7, 100, 0.02),
        # the six call shapes of the train4096 table (rows, N, C) -> k_out
        (3604, 896, 52, 288, 0.12), (3604, 288, 52, 256, 0.12),
        (875, 27, 53, 16, 0.3), (875, 432, 53, 80, 0.08),
        (875, 2160, 53, 192, 0.04), (875, 5184, 53, 256, 0.03),
    ]
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


# --- phase 4 -----------------------------------------------------------------


def play_boards(torch, bg_env, env_cfg, batch, steps, dev):
    """Canonical boards, dice and mirror flags after a few random-play
    env steps from a fresh reset."""
    from mlp_ppo_2ply_p3_tpu_torch.core import board as Bd

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    es = bg_env.reset(gen, env_cfg, batch, device=dev)
    for _ in range(steps):
        u = torch.rand((batch,), generator=gen, device=dev)
        act = (u * es.n_moves.clamp(min=1)).to(torch.int32)
        es, _ = bg_env.step(es, act, gen, env_cfg)
    vecs = Bd.to_canonical(es.points, es.bar, es.off, es.turn)
    return vecs, es.dice, es.turn == 1


def movegen_phase(torch, compaction, movegen, bg_env, env_cfg, dev):
    mg = env_cfg.movegen
    vecs, dice, mirror = play_boards(torch, bg_env, env_cfg, 4096, 6, dev)

    captured = []
    kernel = compaction.compact_rows

    def record(payload, valid, k_out):
        captured.append((payload, valid, k_out))
        return kernel(payload, valid, k_out)

    compaction.compact_rows = record
    try:
        got = movegen.legal_afterstates_batch(vecs, dice, mg, mirror)
    finally:
        compaction.compact_rows = kernel
    compaction.compact_rows = compaction.compact_rows_plain
    try:
        want = movegen.legal_afterstates_batch(vecs, dice, mg, mirror)
    finally:
        compaction.compact_rows = kernel
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("boards", "n_moves", "overflow")):
        check(same(g, w), f"movegen {name}: kernel path != plain path")
    check(len(captured) == movegen.compactions_per_call(mg),
          f"{len(captured)} compactions per movegen call, expected "
          f"{movegen.compactions_per_call(mg)}")

    # a 256-game slice on the CPU (plain path, no sub-batch partition)
    k = 256
    cpu = movegen.legal_afterstates_batch(vecs[:k].cpu(), dice[:k].cpu(), mg,
                                          mirror[:k].cpu())
    fits = ~got[2][:k].cpu()
    for g, c, name in zip(got, cpu, ("boards", "n_moves", "overflow")):
        check(same(g[:k].cpu()[fits], c[fits]),
              f"movegen {name}: card != CPU on the 256-game slice")
    check(int(got[1].sum()) > 0, "no legal moves at all")

    # time every compaction of this call: kernel vs plain, in turns
    per_call, max_err = [], 0
    for payload, valid, k_out in captured:
        ko, kc = kernel(payload, valid, k_out)
        po, pc = compaction.compact_rows_plain(payload, valid, k_out)
        torch.cuda.synchronize()
        check(same(ko, po) and same(kc, pc),
              f"kernel != plain on captured {tuple(payload.shape)}->{k_out}")
        err = max(int((ko.int() - po.int()).abs().max()) if ko.numel() else 0,
                  int((kc - pc).abs().max()))
        max_err = max(max_err, err)
        iters = 20
        for fn in (lambda: kernel(payload, valid, k_out),
                   lambda: compaction.compact_rows_plain(payload, valid,
                                                         k_out)):
            fn()
        plain = time_ms(lambda: compaction.compact_rows_plain(
            payload, valid, k_out), iters)
        kern = time_ms(lambda: kernel(payload, valid, k_out), iters)
        kern2 = time_ms(lambda: kernel(payload, valid, k_out), iters)
        plain2 = time_ms(lambda: compaction.compact_rows_plain(
            payload, valid, k_out), iters)
        nbytes = compaction_bytes(valid, k_out, payload.shape[2])
        per_call.append({
            "shape": list(payload.shape), "k_out": k_out,
            "ms": (kern + kern2) / 2, "plain_ms": (plain + plain2) / 2,
            "bytes": nbytes, "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
        })

    def one_call():
        movegen.legal_afterstates_batch(vecs, dice, mg, mirror)

    one_call()
    mg_ms = time_ms(one_call, 5)
    return per_call, max_err, mg_ms


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

    compaction.compact_rows.launches = 0
    t0 = time.time()
    for _ in range(timed):
        ts, es, metrics = learner.train_step(ts, es, cfg.env, cfg.model, ppo)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = compaction.compact_rows.launches

    expect = timed * t * movegen.compactions_per_call(cfg.env.movegen)
    check(launches == expect,
          f"compact_rows launched {launches} times in {timed} train_steps, "
          f"expected {expect}")
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
        "launches": launches, "metrics": vals,
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


def profile_phase(torch, bg_env, env_cfg, dev):
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    es = bg_env.reset(gen, env_cfg, 4096, device=dev)
    act = torch.zeros((4096,), dtype=torch.int32, device=dev)
    es, _ = bg_env.step(es, act, gen, env_cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            es, _ = bg_env.step(es, act, gen, env_cfg)
        torch.cuda.synchronize()
    return prof.key_averages().table(sort_by="cuda_time_total",
                                     row_limit=25)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t", type=int, default=64,
                    help="rollout horizon T of the main-path train_steps")
    ap.add_argument("--profile", action="store_true",
                    help="also profile four env steps with torch.profiler")
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json (and the profile)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, HERE)
    try:
        from mlp_ppo_2ply_p3_tpu_torch.core import movegen
        from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
        from mlp_ppo_2ply_p3_tpu_torch.ops import build, compaction
        from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
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
    log(f"built compaction kernel in {time.time() - t0:.1f}s\n"
        f"{build.build_logs.get('compaction', '(already built)').strip()}")

    report["phases"]["edge_cases"] = edge_cases(torch, compaction, dev)
    log(f"kernel == plain on {len(report['phases']['edge_cases'])} shapes")

    cfg = get_preset("train4096")
    per_call, max_err, mg_ms = movegen_phase(
        torch, compaction, movegen, bg_env, cfg.env, dev)
    report["phases"]["movegen"] = {"ms_per_call": mg_ms,
                                   "compactions": per_call}
    for row in per_call:
        log(f"compact {tuple(row['shape'])} -> {row['k_out']}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms")
    log(f"movegen B=4096: {mg_ms:.3f} ms/call, kernel path == plain path")

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
        f"compact_rows launches {main_path['launches']}; one more step: "
        f"rollout {main_path['rollout_s']:.3f} s, update "
        f"{main_path['update_s']:.3f} s")
    after_cfg = dataclasses.replace(
        cfg, ppo=dataclasses.replace(cfg.ppo, policy_mode="afterstate"))
    report["phases"]["afterstate"] = train_phase(
        torch, compaction, movegen, bg_env, learner, after_cfg, 512, 16,
        dev, timed=1)
    log(f"afterstate B=512 T=16: "
        f"{report['phases']['afterstate']['train_step_s']:.3f} s/step")

    # last, so that the profiler's own cost cannot reach the timed steps
    table = None
    if args.profile:
        table = profile_phase(torch, bg_env, cfg.env, dev)
        log(table)

    kernels = [{
        "name": "compact_rows",
        "route": "cuda",
        "source": "mlp_ppo_2ply_p3_tpu_torch/csrc/compaction.cu",
        "replaces": TPU_KERNELS,
        "launches": main_path["launches"],
        "max_abs_err": max_err,
        # one movegen call's compactions (B=4096, train4096), summed
        "ms": sum(r["ms"] for r in per_call),
        "plain_ms": sum(r["plain_ms"] for r in per_call),
        "bound_ms": sum(r["bound_ms"] for r in per_call),
        "bound_by": "bytes",
        # no single PyTorch call computes batched stable compaction
        "library_ms": None,
    }]
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
