#!/usr/bin/env python3
"""Drive the PyTorch port (``mlp_ppo_2ply_p3_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--t T] [--profile] [--out DIR]

Phases (any failure exits non-zero and prints no result line):

1. Device check: needs ``torch.cuda.is_available()``; prints the card's
   ``nvidia-smi`` name and power limit.
2. Build: compiles ``csrc/compaction.cu`` (``compact_rows``),
   ``csrc/doubles.cu`` (``doubles_level``, the first three doubles levels
   in one launch, and ``doubles_final``), ``csrc/nondoubles.cu``
   (``nondoubles``), ``csrc/afterstate.cu`` (``afterstate_eval``,
   ``afterstate_eval_backward`` and the deep pass's first layer),
   ``csrc/dense.cu`` (the deep pass's dense layers) and ``csrc/adam.cu``
   (the optimizer step) with nvcc for sm_90a, one nvcc process per
   source, started together.
3. Each kernel against its plain version on inputs made up for the test
   moved to the card tests, ``python -m pytest --noconftest -m cuda
   tests/test_torch_cuda.py``.  What stays here is ``wildbg4096``'s deep
   pass on its own rollout: at the first rollout step and the first
   minibatch, the kernels against the plain version (values and gradients
   within 4 and 8 times what a one-ulp nudge of every weight moves the
   plain version, beside TF32's gap), the same bits on a second launch,
   each wrapper's time beside its least time (the benchmark's yardstick,
   ``benchmark/yardstick/deep_work.py``); then one ``train_step`` whose
   launches show that it went through the deep wrappers and never the
   shallow afterstate kernels.  The same for ``wildbg2net4096``'s routed
   pass (wildbg's contact and race networks) on its own rollout: the
   route's counts and slots of each class exactly against its plain
   version, each group's first layer against the plain first layer in the
   route's order, the whole pass against the plain routed pass under the
   same gates, the route's time beside its least time by bytes; then one
   ``train_step`` whose launches show the route once a pass and every
   other deep wrapper once a group, and whose tally of kept boards by
   network reaches both networks.
4. Movegen on the card at B=4096 on boards from a few env steps: the
   kernel path is bit-exact against the plain-PyTorch path on the card
   and against the CPU.  Every kernel call of one movegen call (the
   doubles split, the fused doubles levels, the final level writing each
   doubles game's list into the batch's output, and the non-doubles
   kernel in place over the rest of it) is captured, checked
   against the plain version and timed (CUDA events) beside its least
   time by bytes.  The whole call is
   timed eagerly and as a CUDA graph replay (the device's own time).  The
   same at the other batch sizes and widths the paths below run movegen
   at: the league eval's 256 games (``train4096``'s movegen) and the
   arenas' 512 and 64 games (``twoply``'s), where both sub-batches are the
   whole batch, with padding rows; B=4096 at the default widths and
   B=16384 (``pod``), each also against the CPU.  Movegen at
   ``MovegenConfig.parity()`` (the ``exact_order`` doubles path, its list
   put in place by one ``index_copy_``) at B=600 with a tenth of the
   games over, on the played dice and on doubles only: card == CPU.
   Then one small ``train_step`` (B=64, T=8, full width) on the card and
   on the CPU from the same weights and draws, in ``index`` and in
   ``afterstate`` mode, and in ``afterstate`` mode at hidden 64 and in
   bf16: equal env integers, parameters and losses within 1e-4 (the
   score head's bias, whose exact gradient is zero, within 2 lr a step);
   in bf16 the parameters within 4 times what a one-ulp bf16 nudge of
   the initial ones makes on the CPU, the losses within 1e-2 of their
   size.
5. Training path: ``get_preset("train4096")`` at B=4096, M=256, hidden
   128: one warm-up ``train_step`` and two timed ones (T=64 by default;
   the preset's 128 is cut to keep the run short).  Losses must be
   finite, the optimizer's kernel pair must run once a minibatch step
   (its first step checked against the plain version on its own inputs:
   the same bits where the clip does not engage, else at a global norm
   within 8 ulps of the plain version's, and timed beside its byte bound,
   the plain version and ``torch.optim.Adam(fused=True)``; so in every
   run of this phase), and each kernel's launches must grow by exactly its
   per-call count (``compactions_per_call``,
   ``doubles_levels_per_call``, ``nondoubles_per_call``,
   ``doubles_finals_per_call``) x T per step.  One more rollout and
   update are timed apart.  Then ``afterstate4096`` at its own widths
   (B=4096, T=64, M=256, hidden 128, 32 minibatches): one warm-up and one
   timed ``train_step``, finite losses, peak device memory, launches
   exact (the afterstate pass T times a rollout and once a minibatch
   step, its backward once a minibatch step), the rollout and the update
   timed apart by wall time and ``device_busy``, and the pass's first
   rollout call, first minibatch call and first backward checked and
   timed on the run's own boards.  The same at hidden 512 (``run_learning
   --hidden 512``'s config) and at hidden 128 computing in bf16.
6. Evaluation path, the ``twoply`` preset on the committed frozen_v1
   net, positions after 12 random env steps: one 2-ply decision at
   B=256 at reply width 512 and at 128 (the reply dedup branch), and one
   at B=4096 at width 512, each with exact launch counts, the kernel
   path bit-exact against the plain path, and a 32-game slice against
   the CPU (actions where the best score leads by more than 1e-4, backup
   scores within 1e-4); every distinct reply call of those decisions
   (``nondoubles`` at width 512 with the dedup off and at 128 with it on,
   the doubles levels and final levels at ``dbl_game_chunk`` games)
   checked against its plain version and timed beside its bound; the
   afterstate pass's plain version in the decision's place: backup scores
   within 1e-5, actions equal where the best score leads by more than
   1e-4, and each of its distinct calls checked and timed; decisions
   timed at B=256 and B=4096.  Then the league runner on the
   card: 1-ply vs the pubeval heuristic over 512 games and 400 plies
   (the win rate must lie within 0.072 of the JAX package's 0.818), and
   2-ply vs 1-ply over 64 games for at most 100 plies (cut from 400),
   both with exact launch counts for the plies played and the afterstate
   pass's distinct calls checked and timed on their own inputs.  Then
   frozen_v1
   computing in bf16: one 2-ply decision at B=256, reply width 512, its
   afterstate kernels against the plain path (backup scores within 1e-2
   of their size, actions equal where the best leads by more than twice
   that) and the 1-ply league against pubeval over 512 games, its win
   rate recorded beside the float32 one, its afterstate calls checked.
7. Training driver: ``ppo.train.train`` at ``train4096``'s width (B=4096,
   M=256, hidden 128, 32 minibatches, the preset's T=128) in a
   temporary directory with a ``file://``
   store.  Run A: 3 updates from scratch, a checkpoint every update, the
   league eval (256 games of 400 plies against the pubeval heuristic and
   frozen_v1) after update 1.  Run B: 2 updates from scratch, its local
   checkpoints wiped, then resumed to 3 updates from ``ckpt_2`` pulled
   from the store.  B's final parameters, Adam state, generator,
   counters and env state must equal A's bit for bit; every kernel's
   launches must match every run exactly (the first reset, T env steps
   an update, two arenas of a reset and 400 plies an eval); the league
   metrics must carry the JAX driver's keys, win rates in [0, 1] and
   finished games; every loss must be finite.  Records the driver's
   s/update and env-steps/s, the eval's seconds, checkpoint save and
   restore seconds and size, and the remote pull's seconds.
8. Data-parallel training: two ranks of this script (``--dp-worker``)
   share the card in a gloo group and run ``ppo.train.train`` at the
   ``pod`` preset (B=16384, 8192 games a rank, M=256, hidden 128,
   default movegen widths; T cut 128 -> 16, 2 updates with a checkpoint
   after each); the same config runs unsharded in this process.  After
   update 1 the two global checkpoints agree in every integer, the
   generator and the env exactly, and in the parameters' update and
   Adam's moments within 4 times what a one-ulp nudge of the parameters
   makes of them in one process (rounding, amplified by 128 Adam steps
   under clipping); the losses of both
   updates agree within a tolerance; each rank and the
   single run launch every kernel exactly.  Then a NCCL group of one
   rank: its collectives are the identity, a ``train_step`` through the
   sharded code equals the plain one bit for bit, and one rank's movegen
   call (8192 games, with a rank's sub-batch widths) is held call by call
   against the plain versions and whole against the CPU.  Two ranks on
   one card are no scaling
   number.
9. 2-ply distillation: ``scripts/run_distill.main`` on frozen_v1 at 256
   games, one iteration (plies cut 48 -> 8, eval games 512 -> 128):
   the JAX script's record keys, finite losses, exact launches; the
   afterstate pass's distinct calls (the update's 1024-state minibatch
   forward and backward, the 2-ply decisions', the evals' 1-ply) and the
   first optimizer step (clipping off) checked and timed on their own
   inputs; then a
   2-ply ``collect`` of 2 plies at 16 games and one update on the card
   against the CPU.
10. The measuring entry points: ``scripts/bench.py`` in a process of its
   own at its defaults (``train4096``'s widths, B=4096, T=64), and again
   at ``BENCH_PRESET=afterstate4096``, each with ``BENCH_UPDATES=2``:
   exit 0, one line per update, the last line the
   4-key JSON line (``env_steps_per_sec_per_chip``, value > 0,
   ``vs_baseline`` = value / 1000), and the launches of every kernel
   that it logs exact.  Then ``scripts/perf_breakdown.main(["4096"])`` here:
   every JAX key and its device or eager twin under both widths, each
   time positive, each movegen piece's CUDA-graph time at most 1.05 times
   its eager time, both idle shares in [0, 1], and each graph's launches
   at capture exact (its replays count none).
11. Checks that every path launched each of its kernels and no other (a
   2-ply decision no ``compact_rows``, an update no movegen kernel; the
   afterstate pass on
   afterstate4096's rollout and update, the league, the arenas, 2-ply and
   distillation, its backward on the update and distillation), and that
   every path that updates ran the optimizer (each path's count is also
   checked exactly in its phase: epochs x minibatches an update,
   distillation one a minibatch) and no other did, and prints the
   ``kernels`` JSON line of all six and the optimizer (launches summed
   over every path's run, and by path; the afterstate rows also with the
   widths and dtypes held and their times at hidden 512 and in bf16; the
   optimizer's also its calls and ``afterstate4096``'s step's times),
   then the device line
   ``{"ok": true, "device": {...}}`` last.

The least times beside the kernels' times come from the benchmark's
yardstick (``benchmark/yardstick``: ``work.py``'s counts and ``peaks.py``'s
peaks) where it counts the kernel, and from this script's bytes of
``compact_rows`` and the doubles kernels where it does not.  They are
logged, not gated.

``--profile`` adds ``torch.profiler`` breakdowns of four env steps and of
one 2-ply decision at B=256, after every timed phase.
``--out DIR`` writes the details of every phase to ``DIR/chip_smoke.json``
(and the profile table to ``DIR/chip_smoke_profile.txt``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import inspect
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TPU_KERNELS = ("mlp_ppo_2ply_p3_tpu/ops/compaction.py:178, "
               "mlp_ppo_2ply_p3_tpu/ops/compaction.py:231")
# the jnp doubles levels L1-L3, whose compactions are the Pallas
# compact_rows
DOUBLES_REPLACES = ("mlp_ppo_2ply_p3_tpu/core/movegen.py:395-419, "
                    "mlp_ppo_2ply_p3_tpu/ops/compaction.py:231")
# the jnp non-doubles candidates, dedup and compactions, and in place the
# non-doubles split, the gather back and the selection
NONDOUBLES_REPLACES = ("mlp_ppo_2ply_p3_tpu/core/movegen.py:286-369, "
                       "mlp_ppo_2ply_p3_tpu/core/movegen.py:576-614, "
                       "mlp_ppo_2ply_p3_tpu/ops/compaction.py:231")
# the fourth doubles level and the selection of the list after it
FINAL_REPLACES = ("mlp_ppo_2ply_p3_tpu/core/movegen.py:406-439, "
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


def levels_bytes(args) -> int:
    """Bytes that the first three doubles levels must move: each game's
    root, die and mirror flag in; the three frontiers (52 bytes a row,
    zero tails included), L3's ranks and the three counts out."""
    vecs, _, _, k1, k2, k3 = args
    g = vecs.shape[0]
    return g * (52 + 4 + 1) + g * (k1 + k2 + k3) * 52 + g * k3 + 12 * g


def final_bytes(torch, doubles, args) -> int:
    """Bytes that the final doubles level must move for each slot that
    holds a game: its valid L3 rows and ranks, its L1, L2 and L3 counts,
    die and mirror flag, and the rows of the level that stands in where L4
    is empty, in; its (M, 52) list, its count and its flag out.  In place
    (``dst`` given) every slot reads its row of ``dst``, and an empty slot
    (-1) writes its count and flag alone."""
    f1b, n1, f2b, n2, f3b, f3r, n3, die, mirror, m = args[:10]
    dst = given("doubles_final", args, "dst")
    g, k3, _ = f3b.shape
    held = torch.ones_like(n3, dtype=torch.bool) if dst is None else dst >= 0
    rows3 = int((n3.clamp(0, k3) * held).sum())
    n4 = doubles.doubles_level_plain(f3b, f3r, n3, die, mirror, m)[2]
    empty = (n4 == 0) & held
    width = (f3b.shape[1] * (n3 > 0) + f2b.shape[1] * ((n3 <= 0) & (n2 > 0))
             + f1b.shape[1] * ((n3 <= 0) & (n2 <= 0))).clamp(max=m)
    copied = int(width[empty].sum())
    lists = int(held.sum())
    return (rows3 * 53 + lists * (4 * 4 + 1) + copied * 52
            + lists * m * 52 + 5 * g + (0 if dst is None else 4 * g))


def nondoubles_bytes(args) -> int:
    """The yardstick's bytes of one ``nondoubles`` call
    (``benchmark/yardstick/work.py::nondoubles``), in place or not."""
    from benchmark.yardstick import work

    place = given("nondoubles", args, "place")
    return work.nondoubles(args[0].shape[0], args[6],
                           None if place is None else place[:2])


def same(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def _param_index(name, param):
    """The position of kernel ``name``'s wrapper's parameter ``param``
    (read from its plain version's signature, which a Capture never
    swaps), or None where it has none."""
    names = list(inspect.signature(wrapper(name, plain=True)).parameters)
    return names.index(param) if param in names else None


def given(name, args, param):
    """The argument ``param`` of a captured call of kernel ``name``'s
    wrapper; None where the call did not give it."""
    at = _param_index(name, param)
    return args[at] if at is not None and at < len(args) else None


def out_index(name, args):
    """Where an in-place call of kernel ``name`` holds the output that it
    writes into (its wrapper's ``out``, given); None for every other
    call."""
    return (_param_index(name, "out") if given(name, args, "out") is not None
            else None)


def measure(torch, fn, plain_fn, args, nbytes, k_out=None, at=None):
    """Check fn against plain_fn on args (every output bit for bit), then
    time both in turns (plain, kernel, kernel, plain) beside the least
    time of ``nbytes`` at the card's bandwidth.  ``k_out``: the output
    width (by default the last argument).  ``at``: where an in-place call
    holds its output (``out_index``); it writes into a copy of its own."""
    from benchmark.yardstick import peaks

    k_out = args[-1] if k_out is None else k_out

    def fresh():
        return (args if at is None
                else (*args[:at], args[at].clone(), *args[at + 1:]))

    got = fn(*fresh())
    want = plain_fn(*fresh())
    torch.cuda.synchronize()
    shape = f"{tuple(args[0].shape)}->{k_out}"
    check(all(same(g, w) for g, w in zip(got, want)),
          f"kernel != plain on captured {shape}")
    err = max(int((g.int() - w.int()).abs().max()) if g.numel() else 0
              for g, w in zip(got, want))
    del got, want
    iters = 20
    kargs, pargs = fresh(), fresh()
    plain = time_ms(lambda: plain_fn(*pargs), iters)
    kern = time_ms(lambda: fn(*kargs), iters)
    kern2 = time_ms(lambda: fn(*kargs), iters)
    plain2 = time_ms(lambda: plain_fn(*pargs), iters)
    return {
        "shape": list(args[0].shape), "k_out": k_out,
        "ms": (kern + kern2) / 2, "plain_ms": (plain + plain2) / 2,
        "bytes": nbytes, "bound_ms": nbytes / peaks.BYTES_PER_S * 1e3,
        "max_abs_err": err,
    }


def _home(name):
    """(module, attribute) of kernel ``name``'s wrapper: those of the
    function that owns its count (``ops.counters()``), which a Capture
    never swaps."""
    import importlib

    from mlp_ppo_2ply_p3_tpu_torch import ops

    owner = ops.counters()[name]
    return importlib.import_module(owner.__module__), owner.__name__


def wrapper(name, plain=False):
    """Kernel ``name``'s wrapper (or its plain version), as its module
    holds it now."""
    module, attr = _home(name)
    return getattr(module, attr + ("_plain" if plain else ""))


def kernel_groups():
    """(movegen's kernels, the afterstate pass's), each in ``ops.KERNELS``
    order: the afterstate pass's wrappers are those that
    ``ops/afterstate.py`` holds; movegen's are bit-exact."""
    from mlp_ppo_2ply_p3_tpu_torch import ops
    from mlp_ppo_2ply_p3_tpu_torch.ops import afterstate

    owners = ops.counters()
    after = tuple(k for k in ops.KERNELS
                  if owners[k].__module__ == afterstate.__name__)
    return tuple(k for k in ops.KERNELS if k not in after), after


def measure_calls(torch, calls):
    """measure() every captured call ({kernel: [args, ...]}); returns
    {kernel: [row, ...]} over movegen's kernels."""
    from mlp_ppo_2ply_p3_tpu_torch.ops import doubles

    nbytes = {
        "compact_rows": lambda a: compaction_bytes(a[1], a[2],
                                                   a[0].shape[2]),
        "doubles_level": levels_bytes,
        "nondoubles": nondoubles_bytes,
        "doubles_final": lambda a: final_bytes(torch, doubles, a),
    }
    k_out = {"nondoubles": 6, "doubles_final": 9}
    return {name: [measure(torch, wrapper(name), wrapper(name, plain=True),
                           a, nbytes[name](a),
                           k_out=a[k_out[name]] if name in k_out else None,
                           at=out_index(name, a))
                   for a in calls.get(name, ())]
            for name in kernel_groups()[0]}


def log_rows(prefix, rows):
    """One log line per measured call: kernel and plain time, bound."""
    for name, calls in rows.items():
        for row in calls:
            log(f"{prefix}{name} {tuple(row['shape'])} -> {row['k_out']}: "
                f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms,"
                f" bound {row['bound_ms']:.4f} ms (bytes)")


def _call_key(args):
    return tuple(tuple(a.shape) if hasattr(a, "shape")
                 else tuple(tuple(t.shape) for t in a)
                 if isinstance(a, (list, tuple)) else a for a in args)


def _copied(args):
    """``args`` with every tensor, and every tensor of a list, cloned."""
    def one(a):
        if hasattr(a, "clone"):
            return a.clone()
        if isinstance(a, (list, tuple)):
            return type(a)(one(t) for t in a)
        return a

    return tuple(one(a) for a in args)


class Capture:
    """Swaps the wrappers of ``kernels`` (by default movegen's, which are
    bit-exact) for ones that keep their inputs and call the kernel, or for
    their plain versions (``plain``), and restores them on exit.
    ``distinct`` keeps one call per shape and widths; ``copy`` keeps a
    copy of each kept call's inputs as they were before it (the
    optimizer's step writes its parameters in place; a later step or ply
    may reuse a buffer).  ``calls``: {kernel: [args, ...]} over every
    kernel of ``ops.KERNELS`` and of ``kernels``."""

    def __init__(self, plain=False, distinct=False, kernels=None,
                 copy=False):
        from mlp_ppo_2ply_p3_tpu_torch import ops

        self.plain, self.distinct, self.copy = plain, distinct, copy
        self.kernels = kernel_groups()[0] if kernels is None else kernels
        self.calls = {name: [] for name in (*ops.KERNELS, *self.kernels)}

    def _wrap(self, kept, fn):
        @functools.wraps(fn)
        def wrapped(*args):
            if not self.distinct or _call_key(args) not in {
                    _call_key(a) for a in kept}:
                kept.append(_copied(args) if self.copy else args)
            return fn(*args)
        return wrapped

    def __enter__(self):
        self.saved = []
        for name in self.kernels:
            m, attr = _home(name)
            fn = getattr(m, attr)
            self.saved.append((m, attr, fn))
            setattr(m, attr, getattr(m, attr + "_plain") if self.plain
                    else self._wrap(self.calls[name], fn))
        return self

    def __exit__(self, *exc):
        from mlp_ppo_2ply_p3_tpu_torch import ops

        # the optimizer's wrapper counts its calls through its module's
        # name (``adam_update.launches``), so while swapped the count went
        # to the stand-in, which carries the attribute as it was: it goes
        # back to the wrapper.  The kernels count through ``_COUNTERS``.
        owners = ops.counters()
        for name, (m, attr, fn) in zip(self.kernels, self.saved):
            now = getattr(m, attr)
            if owners.get(name) is now and now is not fn and hasattr(
                    now, "launches"):
                fn.launches = now.launches
            setattr(m, attr, fn)


def launches():
    from mlp_ppo_2ply_p3_tpu_torch import ops

    return ops.launches()


def zero_launches():
    from mlp_ppo_2ply_p3_tpu_torch import ops

    ops.zero_launches()


def with_optimizer(counts, calls=0, deep=None):
    """``counts`` (by kernel) with the optimizer wrapper's ``calls`` under
    ``ops.OPTIMIZER`` and the deep pass's wrappers' calls (``deep``, by
    name; 0 for those it leaves out): what ``launches()`` reads after a
    path that takes ``calls`` optimizer steps."""
    from mlp_ppo_2ply_p3_tpu_torch import ops

    return {**counts, ops.OPTIMIZER: calls,
            **{name: (deep or {}).get(name, 0) for name in ops.DEEP}}


def per_call_launches(movegen, mg):
    """Each kernel's launches in one ``legal_afterstates_batch`` call at
    widths ``mg`` (none of the afterstate pass)."""
    return {"compact_rows": movegen.compactions_per_call(mg),
            "doubles_level": movegen.doubles_levels_per_call(mg),
            "nondoubles": movegen.nondoubles_per_call(mg),
            "doubles_final": movegen.doubles_finals_per_call(mg),
            "afterstate_eval": 0, "afterstate_eval_backward": 0}


def afterstate_launches(fwd=0, bwd=0):
    """The afterstate pass's launches as a tuple in ``ops.KERNELS``
    order."""
    from mlp_ppo_2ply_p3_tpu_torch import ops

    pass_ = {"afterstate_eval": fwd, "afterstate_eval_backward": bwd}
    return tuple(pass_.get(name, 0) for name in ops.KERNELS)


def train_step_launches(movegen, env_cfg, ppo):
    """Each kernel's launches in one ``train_step``: a movegen call an env
    step; in ``afterstate`` mode also the afterstate pass an env step and
    a minibatch step, and its backward a minibatch step."""
    out = {k: ppo.t_horizon * v
           for k, v in per_call_launches(movegen, env_cfg.movegen).items()}
    if ppo.policy_mode == "afterstate":
        steps = ppo.num_epochs * ppo.num_minibatches
        out["afterstate_eval"] = ppo.t_horizon + steps
        out["afterstate_eval_backward"] = steps
    return out


# --- the afterstate pass ----------------------------------------------------

# the jnp that XLA fuses in the JAX package and afterstate.cu replaces
AFTERSTATE_REPLACES = ("mlp_ppo_2ply_p3_tpu/ppo/learner.py:143-152, "
                       "mlp_ppo_2ply_p3_tpu/agents/basic.py:36-53, "
                       "mlp_ppo_2ply_p3_tpu/agents/basic.py:82-86, "
                       "mlp_ppo_2ply_p3_tpu/agents/twoply.py:108-131, "
                       "mlp_ppo_2ply_p3_tpu/agents/twoply.py:203-207")
# the gradient of the same composition: XLA's autodiff of _loss_fn
AFTERSTATE_BACKWARD_REPLACES = ("mlp_ppo_2ply_p3_tpu/ppo/learner.py:143-152,"
                                " mlp_ppo_2ply_p3_tpu/ppo/learner.py:204-208")
# the forward pass against its plain version (features exact, the sums
# in another order) in float32 up to 256 units: within this share of each
# value's size, at least 1 (so 1e-5 where values stay within +-1, as the
# card tests' made-up ones and every value head's do; a trained score
# head's logits reach 100-260, where one float32 ulp is 0.8-3.1e-5); past
# 256 units within this many times the largest drift that a one-ulp nudge
# of the weights makes of the plain version's values, as the gradients are
# held at every width (phase 8's calibration)
AFTERSTATE_TOL = 1e-5
AFTERSTATE_NUDGE_FACTOR = 4.0
# bf16 weights (compute_dtype "bfloat16"): the kernels round where the JAX
# package does, the plain version's bf16 linear once after the bias; within
# this share of the largest kept value (at least 1), under
# tests/test_torch_models.py's bf16 2e-2 (the plain version against JAX on
# the CPU: at most 4.9e-3, tests/test_torch_afterstate.py)
AFTERSTATE_BF16_TOL = 1e-2


def afterstate_bound(args, backward=False):
    """(bytes, operations, kept boards, bytes' least time, operations'
    least time, in ms) of the pass on these inputs, as the benchmark's
    yardstick counts them (``benchmark/yardstick/work.py::afterstate``)."""
    from benchmark.yardstick import peaks, work

    boards, _, n, w1 = args[:4]
    nbytes, ops, n_kept, _ = work.afterstate(
        boards, n, w1.shape[0], w1.element_size(), args[8], backward)
    return (nbytes, ops, n_kept, nbytes / peaks.BYTES_PER_S * 1e3,
            ops / peaks.PEAK_OPS_PER_S * 1e3)


def nudged_params(torch, params):
    """Every parameter moved up by one ulp of its dtype (bf16 by its
    bits: +1 above zero, -1 below, the smallest subnormal at zero)."""
    out = []
    for p in params:
        if p.dtype != torch.bfloat16:
            out.append(torch.nextafter(p, torch.full_like(p, math.inf)))
            continue
        b = p.view(torch.int16)
        up = torch.where(p > 0, b + 1, torch.where(p < 0, b - 1,
                                                    torch.ones_like(b)))
        out.append(up.view(torch.bfloat16))
    return out


def afterstate_tol(torch, afterstate, args, want):
    """The forward's gate against its plain version ``want`` on ``args``
    (a number, or one for each value): float32 up to 256 units
    AFTERSTATE_TOL of each value's size, at least 1; past 256,
    AFTERSTATE_NUDGE_FACTOR times the largest drift that a one-ulp nudge of
    the four weights makes of the plain version's kept values; bf16
    AFTERSTATE_BF16_TOL of the largest kept value (at least 1)."""
    special = (want == afterstate.FLOOR) | (want == afterstate.POS_INF)
    w1 = args[3]
    if w1.dtype == torch.bfloat16:
        kept = want[~special]
        return AFTERSTATE_BF16_TOL * max(
            1.0, float(kept.abs().max()) if kept.numel() else 1.0)
    if w1.shape[0] <= 256:
        return AFTERSTATE_TOL * want.abs().clamp(min=1.0)
    nudged = afterstate.afterstate_eval_plain(
        *args[:3], *nudged_params(torch, args[3:7]), *args[7:10], 128)
    drift = (nudged - want)[~special]
    return AFTERSTATE_NUDGE_FACTOR * (float(drift.abs().max())
                                      if drift.numel() else 0.0)


def afterstate_measure(torch, afterstate, features, args, label, iters=5):
    """The forward kernel against its plain version on ``args``: within
    ``afterstate_tol``, the floor and an empty min's +1e9 exact, the same
    bits on a second launch; kernel, plain and library times (CUDA events;
    the library: ``Fn.linear`` for fc1 alone on prebuilt (R M, 198)
    features, in the weights' dtype) beside the least time
    (``afterstate_bound``)."""
    from torch.nn import functional as Fn

    with torch.no_grad():
        return _afterstate_measure(torch, Fn, afterstate, features, args,
                                   label, iters)


def _afterstate_measure(torch, Fn, afterstate, features, args, label,
                        iters):
    args = tuple(args[:10])
    got = afterstate.afterstate_eval(*args)
    again = afterstate.afterstate_eval(*args)
    want = afterstate.afterstate_eval_plain(*args, 128)
    torch.cuda.synchronize()
    shape = tuple(args[0].shape)
    check(got.shape == want.shape and same(got, again),
          f"afterstate_eval {label} {shape}: two launches differ")
    special = (want == afterstate.FLOOR) | (want == afterstate.POS_INF)
    check(same(got[special], want[special]),
          f"afterstate_eval {label} {shape}: masked entries differ")
    diff = torch.where(special, 0.0, (got - want).abs())
    gate = afterstate_tol(torch, afterstate, args, want)
    over = int((diff > gate).sum())
    # the largest gap, the value it is at, and its gate there
    err, value, tol = 0.0, 0.0, AFTERSTATE_TOL
    if got.numel():
        at = int(diff.argmax())
        err, value = float(diff.flatten()[at]), float(want.flatten()[at])
        tol = float(gate.flatten()[at]) if torch.is_tensor(gate) else gate
    dtype = str(args[3].dtype).replace("torch.", "")
    check(over == 0, f"afterstate_eval {label} {shape} hidden "
          f"{args[3].shape[0]} {dtype}: {over} values past their gate; the "
          f"largest gap {err} at a value of {value} (gate {tol})")
    del got, again, want, diff
    nbytes, ops, n_kept, bytes_ms, ops_ms = afterstate_bound(args)
    row = {"label": label, "shape": list(shape),
           "hidden": args[3].shape[0], "dtype": dtype, "epilogue": args[8],
           "opponent": args[7], "kept_boards": n_kept,
           "max_abs_err": err, "value_at_max_err": value, "tol": tol}
    if not args[0].numel():
        return row
    boards, mover, n, w1, b1 = args[:5]
    view = afterstate.Bd.opponent_view(boards) if args[7] else boards
    feats = features.encode_canonical(view, mover[:, None]).reshape(
        -1, 198).to(w1.dtype)
    del view
    plain = time_ms(lambda: afterstate.afterstate_eval_plain(*args, 128),
                    iters)
    kern = time_ms(lambda: afterstate.afterstate_eval(*args), iters)
    kern2 = time_ms(lambda: afterstate.afterstate_eval(*args), iters)
    plain2 = time_ms(lambda: afterstate.afterstate_eval_plain(*args, 128),
                     iters)
    lib = time_ms(lambda: Fn.linear(feats, w1, b1), iters)
    del feats
    row.update({
        "ms": (kern + kern2) / 2, "plain_ms": (plain + plain2) / 2,
        "library_ms": lib, "bytes": nbytes, "ops": ops,
        "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
    return row


def afterstate_backward_measure(torch, afterstate, args, label, iters=5):
    """The backward kernel against its plain version (torch's autograd of
    the plain pass) on ``args`` (the forward's, then the output's
    gradient): the gradients' distance from the plain ones at most
    AFTERSTATE_NUDGE_FACTOR times the distance that a one-ulp nudge of the
    parameters moves the plain ones (norms over all four), the same bits
    on a second launch (float32 tensors, of bf16 numbers for bf16
    weights, the nudge then one bf16 ulp); kernel, plain and library times
    (the library: ``torch.mm`` of an (H, R M) by an (R M, 198) matrix in
    the weights' dtype, dW1's product) beside the least time
    (``afterstate_bound``)."""
    args = tuple(args[:11])
    fwd, grad = args[:10], args[10]
    got = afterstate.afterstate_eval_backward(*args)
    again = afterstate.afterstate_eval_backward(*args)
    want = afterstate.afterstate_eval_backward_plain(*args)
    nudged = afterstate.afterstate_eval_backward_plain(
        *fwd[:3], *nudged_params(torch, fwd[3:7]), *fwd[7:], grad)
    torch.cuda.synchronize()
    shape = tuple(args[0].shape)
    check(all(same(a, b) for a, b in zip(got, again)),
          f"afterstate_eval_backward {label} {shape}: two launches differ")
    wdt = fwd[3].dtype
    check(all(g.dtype == torch.float32 and same(g, g.to(wdt).float())
              for g in got), f"afterstate_eval_backward {label} {shape}: "
          f"not float32 gradients of {wdt} numbers")

    def dist(xs, ys):
        return math.sqrt(sum(float(((x - y).double() ** 2).sum())
                             for x, y in zip(xs, ys)))

    err, floor = dist(got, want), dist(nudged, want)
    norm = math.sqrt(sum(float((w.double() ** 2).sum()) for w in want))
    max_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err <= AFTERSTATE_NUDGE_FACTOR * floor,
          f"afterstate_eval_backward {label} {shape}: the gradients differ "
          f"from the plain ones by {err:.3e} (norm {norm:.3e}), a one-ulp "
          f"nudge moves them by {floor:.3e}")
    del got, again, want, nudged
    nbytes, ops, n_kept, bytes_ms, ops_ms = afterstate_bound(fwd, True)
    row = {"label": label, "shape": list(shape), "hidden": fwd[3].shape[0],
           "dtype": str(wdt).replace("torch.", ""), "epilogue": fwd[8],
           "kept_boards": n_kept, "max_abs_err": max_err,
           "err_norm": err, "nudge_norm": floor, "grad_norm": norm}
    if not args[0].numel():
        return row
    r, m, _ = args[0].shape
    h = fwd[3].shape[0]
    dh = torch.randn((h, r * m), device=args[0].device).to(wdt)
    feats = torch.randn((r * m, 198), device=args[0].device).to(wdt)
    plain = time_ms(lambda: afterstate.afterstate_eval_backward_plain(*args),
                    iters)
    kern = time_ms(lambda: afterstate.afterstate_eval_backward(*args), iters)
    kern2 = time_ms(lambda: afterstate.afterstate_eval_backward(*args),
                    iters)
    plain2 = time_ms(lambda: afterstate.afterstate_eval_backward_plain(
        *args), iters)
    lib = time_ms(lambda: torch.mm(dh, feats), iters)
    del dh, feats
    row.update({
        "ms": (kern + kern2) / 2, "plain_ms": (plain + plain2) / 2,
        "library_ms": lib, "bytes": nbytes, "ops": ops,
        "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
    return row


def log_afterstate_rows(prefix, rows):
    for row in rows:
        if "ms" not in row:
            continue
        log(f"{prefix}{row['label']} {tuple(row['shape'])} hidden "
            f"{row['hidden']} {row['dtype']} {row['epilogue']}: kernel "
            f"{row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f}"
            f" ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{row['kept_boards']} boards kept, max err "
            f"{row['max_abs_err']:.2e}")


# what adam.cu replaces: optax's chain in the JAX package, which XLA fuses
ADAM_REPLACES = "mlp_ppo_2ply_p3_tpu/ppo/learner.py:102-106"
# a clipped step: the kernels' global norm (summed in another order)
# within this many ulps of the plain version's, as the card tests hold it
ADAM_NORM_ULPS = 8


def adam_step(torch, fn, args, norm=None):
    """``fn``'s step (the kernels' or the plain version's) on the captured
    ``args``, the parameters copied first: (the parameters and moments as
    one flat tensor, the count).  With ``norm`` the gradients are clipped
    at that global norm, and ``fn`` clips no more."""
    params, grads, count, mu, nu, lr, max_norm = args
    params = [p.clone() for p in params]
    if norm is not None:
        keep = norm < max_norm
        grads = [torch.where(keep, g, (g / norm) * max_norm) for g in grads]
        max_norm = 0.0
    count, mu, nu = fn(params, grads, count, mu, nu, lr, max_norm)
    return torch.cat([t.reshape(-1) for t in (*params, *mu, *nu)]), count


def adam_measure(torch, adam, profiling, args, label):
    """The kernel pair against its plain version on one captured step
    (``args``, the parameters as they were before it): the same bits on
    a second launch; where the clip does not engage, or is off, the plain
    version's bits; where it engages, the plain version's bits at a global
    norm within ``ADAM_NORM_ULPS`` ulps of its own.  Then the step's
    device time (``timed_scan``: CUDA graphs of back-to-back steps, so
    that the host's launches, 168 a plain step, drop out) beside its byte
    bound, the plain version's and ``torch.optim.Adam(fused=True)``'s (no
    clip; a yardstick the port never calls), and the kernels' and the
    plain version's eager times (``timed_eager``)."""
    from benchmark.yardstick import peaks

    params, grads, count, mu, nu, lr, max_norm = args
    got, got_count = adam_step(torch, adam.adam_update, args)
    again, _ = adam_step(torch, adam.adam_update, args)
    want, want_count = adam_step(torch, adam.adam_update_plain, args)
    check(torch.equal(got, again), f"adam {label}: two launches differ")
    check(torch.equal(got_count, want_count),
          f"adam {label}: counts {int(got_count)} and {int(want_count)}")
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clipped = max_norm > 0 and bool(norm >= max_norm)
    ulps = 0 if torch.equal(got, want) else None
    if clipped:
        up, down = norm.clone(), norm.clone()
        inf = torch.tensor(math.inf, device=norm.device)
        for n_ulps in range(ADAM_NORM_ULPS + 1):
            if ulps is not None:
                break
            if any(torch.equal(got, adam_step(torch, adam.adam_update_plain,
                                              args, n)[0])
                   for n in (up, down)):
                ulps = n_ulps
            up, down = torch.nextafter(up, inf), torch.nextafter(down, -inf)
    check(ulps is not None,
          f"adam {label}: the kernels' step is not the plain version's"
          + (f" at any norm within {ADAM_NORM_ULPS} ulps of its own"
             if clipped else ""))
    n = sum(p.numel() for p in params)
    out = {"label": label, "params": n, "count": int(count),
           "grad_norm": float(norm), "max_grad_norm": max_norm,
           "clipped": clipped, "norm_ulps": ulps,
           "max_abs_err": float((got - want).abs().max()),
           # p, g, m, v read and p, m, v written, each byte once
           "bound_ms": 28 * n / peaks.BYTES_PER_S * 1e3}
    del got, again, want

    def fresh():
        return ([p.clone() for p in params], grads, count, mu, nu, lr,
                max_norm)

    out["ms"] = 1e3 * profiling.timed_scan(adam.adam_update, *fresh())
    out["plain_ms"] = 1e3 * profiling.timed_scan(adam.adam_update_plain,
                                                 *fresh())
    out["eager_ms"] = 1e3 * profiling.timed_eager(adam.adam_update,
                                                  *fresh())
    out["plain_eager_ms"] = 1e3 * profiling.timed_eager(
        adam.adam_update_plain, *fresh())
    lib = [p.clone().requires_grad_() for p in params]
    for p, g in zip(lib, grads):
        p.grad = g.clone()
    opt = torch.optim.Adam(lib, lr=lr, fused=True, capturable=True)
    out["library_ms"] = 1e3 * profiling.timed_scan(lambda t: opt.step(),
                                                   count)
    return out


def log_adam(prefix, row):
    log(f"{prefix}adam ({row['label']}, {row['params']} parameters, count "
        f"{row['count']}, gradient norm {row['grad_norm']:.4g}"
        f"{' clipped' if row['clipped'] else ''}): kernels == the plain "
        f"step at a norm {row['norm_ulps']} ulps from its own (largest gap "
        f"{row['max_abs_err']:.2e}); {row['ms']:.4f} ms a step (bound "
        f"{row['bound_ms']:.5f} ms by bytes, plain {row['plain_ms']:.4f}, "
        f"torch.optim.Adam(fused=True) {row['library_ms']:.4f}); eager "
        f"{row['eager_ms']:.4f} ms (plain {row['plain_eager_ms']:.4f})")


# --- phase 3: the deep pass (wildbg4096) -------------------------------------

# the deep pass's gate: a factor times what a one-ulp nudge of every weight
# moves the plain version (values: 4 x the largest kept drift, at least
# DEEP_FLOOR; gradients: 8 x the distance of the whole set, as
# tests/test_torch_cuda.py::DEEP_GRAD_FACTOR says why)
DEEP_NUDGE_FACTOR = 4.0
DEEP_GRAD_FACTOR = 8.0
DEEP_FLOOR = 1e-6


def deep_grads(torch, plain, args, weights, grad):
    w = [x.detach().clone().requires_grad_() for x in weights]
    y = plain(*args[:3], w, *args[4:])
    return torch.autograd.grad(y, w, grad)


def deep_check(torch, afterstate, args, got, got_g=None, grad=None,
               plain=None):
    """(value gap, its gate, TF32's value gap[, gradient distance, its
    gate]) of the deep pass's outputs against the plain version on
    ``args`` (``plain``: ``afterstate_deep_plain`` unless given): the
    gates are DEEP_NUDGE_FACTOR times a one-ulp nudge's drift; TF32 is
    the plain version with TF32 products allowed."""
    plain = plain or afterstate.afterstate_deep_plain
    weights = args[3]
    want = plain(*args)
    kept = want != afterstate.FLOOR
    check(bool(torch.equal(got == afterstate.FLOOR, ~kept)),
          "deep pass: the floors differ from the plain version's")
    nudged = nudged_params(torch, weights)
    drift = (plain(*args[:3], nudged, *args[4:]) - want)[kept].abs().max()
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = plain(*args)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"value_gap": float((got - want)[kept].abs().max()),
           "value_gate": max(DEEP_NUDGE_FACTOR * float(drift), DEEP_FLOOR),
           "tf32_value_gap": float((tf32 - want)[kept].abs().max()),
           "kept": int(kept.sum())}
    check(out["value_gap"] <= out["value_gate"],
          f"deep pass forward off the plain version: {out}")
    if got_g is not None:
        want_g = deep_grads(torch, plain, args, weights, grad)
        nudge_g = deep_grads(torch, plain, args, nudged, grad)

        def dist(xs, ys):
            return sum(float(((x.double() - y.double()) ** 2).sum())
                       for x, y in zip(xs, ys)) ** 0.5

        torch.backends.cuda.matmul.allow_tf32 = True
        tf32_g = deep_grads(torch, plain, args, weights, grad)
        torch.backends.cuda.matmul.allow_tf32 = False
        out["grad_dist"] = dist(got_g, want_g)
        out["grad_gate"] = DEEP_GRAD_FACTOR * dist(nudge_g, want_g)
        out["tf32_grad_dist"] = dist(tf32_g, want_g)
        check(out["grad_dist"] <= out["grad_gate"],
              f"deep pass gradients off the plain version: {out}")
    return out


def kernel_resources(log_text):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} of the entry
    functions in an nvcc ``-Xptxas -v`` report (the mangled name's
    identifier, and its template argument: <true>/<false>, or <64>)."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            ident = re.search(r"\d+([a-z_]+kernel[a-z_]*)", m.group(1))
            name = ident.group(1) if ident else m.group(1)
            arg = re.search(r"I(?:Lb([01])|Li(\d+))E", m.group(1))
            if arg:
                name += ("<true>" if arg.group(1) == "1" else "<false>"
                         if arg.group(1) else f"<{arg.group(2)}>")
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name is not None:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name]["registers"] = int(m.group(1))
    return out


def dense_resources(build):
    """csrc/dense.cu's kernels' registers and spills from this run's build
    (a string where the library was built by an earlier command)."""
    report = kernel_resources(build.build_logs.get("dense", ""))
    return report or "built earlier: no compiler report in this run"


def deep_least_ms(boards, n, widths, passes):
    """(least time in ms, kept boards) of the first layer and the dense
    layers of a deep pass over ``boards`` with valid prefixes ``n``, once
    for each of ``passes`` (False: forward, True: backward), each layer
    at the benchmark's yardstick (``benchmark/yardstick/deep_work.py``)."""
    from benchmark.yardstick import deep_work, work

    total = 0.0
    for backward in passes:
        nbytes, ops, n_kept, _ = deep_work.hidden(boards, n, widths[0],
                                                  "logits", backward)
        total += work.least_seconds(nbytes, ops) + work.least_seconds(
            *deep_work.dense(n_kept, widths, 1, backward))
    return 1e3 * total, n_kept


class WholeRows:
    """Wraps ``afterstate.<name>`` (``afterstate_deep`` or
    ``afterstate_routed``) for one train_step: the whole rows of each
    call's inputs by the plain rule (``collapsed_plain``), and for a routed
    pass each class's kept boards under the former kept set (every slot
    of a ``logits`` row with n <= 0), summed on the card (read once,
    after the step)."""

    NAMES = {"afterstate_deep": ("boards", "mover", "n", "weights",
                                 "rewards", "opponent", "epilogue", "sign"),
             "afterstate_routed": ("boards", "mover", "n", "contact", "race",
                                   "rewards", "opponent", "epilogue",
                                   "sign")}

    def __init__(self, torch, afterstate, name):
        self.torch, self.afterstate, self.name = torch, afterstate, name
        self.whole, self.former = [], []

    def __enter__(self):
        from mlp_ppo_2ply_p3_tpu_torch.core import board as Bd

        fn, ae, torch = getattr(self.afterstate, self.name), self.afterstate, \
            self.torch
        names = self.NAMES[self.name]

        def wrapper(*args, **kwargs):
            got = dict(zip(names, args), **kwargs)
            boards, n = got["boards"], got["n"]
            epilogue = got.get("epilogue", "logits")
            self.whole.append(ae.collapsed_plain(boards, n, epilogue).sum())
            if self.name == "afterstate_routed":
                valid = ae._valid(n, boards.shape[1], epilogue)
                race = Bd.is_race(boards)
                self.former.append(torch.stack([(valid & ~race).sum(),
                                                (valid & race).sum()]))
            return fn(*args, **kwargs)

        self.saved = fn
        setattr(self.afterstate, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.afterstate, self.name, self.saved)

    def counts(self):
        """(whole rows, the former kept boards by class or None)."""
        whole = int(sum(int(x) for x in self.whole))
        former = None
        if self.former:
            former = dict(zip(self.afterstate.GROUPS, [
                int(x) for x in self.torch.stack(self.former).sum(0)]))
        return whole, former


def deep_phase(torch, afterstate, dense, bg_env, learner, get_preset, dev):
    """wildbg4096's deep pass on the card: at its first rollout step and
    its first minibatch, the kernels against the plain version (values
    and gradients within DEEP_NUDGE_FACTOR x a one-ulp nudge's drift,
    beside TF32's gap), the same bits on a second launch, each wrapper's
    time (CUDA events) beside its least time (``deep_least_ms``); then
    one timed train_step whose
    launches show that it went through them: the first layer's deep form
    and the dense layers once a rollout step and a minibatch step, their
    backwards once a minibatch step, the shallow afterstate kernels
    never, and whose tally of whole rows (each kept as one board) equals
    the plain rule's count over its calls' inputs."""
    from benchmark.yardstick import deep_work

    from mlp_ppo_2ply_p3_tpu_torch import ops

    cfg = get_preset("wildbg4096")
    widths = cfg.model.widths
    ts = learner.init_train_state(1801, cfg.model, cfg.ppo, device=dev)
    es = bg_env.reset(ts.gen, cfg.env, cfg.ppo.num_envs, device=dev)
    weights, _ = ts.model.deep_weights("score")
    weights = [w.detach() for w in weights]
    turn, n = es.turn.to(torch.int32), es.n_moves.to(torch.int32)
    out = {}

    # the first rollout step: the forward
    args = (es.after, turn, n, weights, None, False, "logits", 1.0)
    with torch.no_grad():
        got = afterstate.afterstate_deep(*args[:4])
        again = afterstate.afterstate_deep(*args[:4])
        row = deep_check(torch, afterstate, args, got)
        check(bool(torch.equal(got, again)), "deep forward not deterministic")
        (w1, b1), layers, head = afterstate._split(weights)
        out_, h1, elem, count = afterstate.afterstate_hidden(
            *args[:3], w1, b1, False, "logits")
        row.update(kept_check(torch, afterstate, *args[:3], elem, count))
        row["hidden_ms"] = time_ms(lambda: afterstate.afterstate_hidden(
            *args[:3], w1, b1, False, "logits"), 5)
        row["dense_ms"] = time_ms(lambda: dense.dense_layers(
            h1, elem, count, out_, layers, head), 5)
    row["bound_ms"], n_kept = deep_least_ms(es.after, n, widths, (False,))
    row["dense_tflops"] = (deep_work.dense(n_kept, widths, 1)[1]
                           / row["dense_ms"] / 1e9)
    out["rollout_step"] = row
    # the first minibatch: a rollout's rows in the update's first order
    sampler = learner.Sampler(ts.gen)
    _, traj, _, _ = learner.rollout(ts.model, es, sampler, cfg.env, cfg.ppo)
    rows = cfg.ppo.num_envs * cfg.ppo.t_horizon
    idx = sampler.permutation(rows, dev)[:rows // cfg.ppo.num_minibatches]
    after = traj.after.reshape(rows, *traj.after.shape[2:])[idx]
    mturn = traj.turn.reshape(rows)[idx].to(torch.int32)
    mn = traj.n_moves.reshape(rows)[idx].to(torch.int32)
    del traj
    args = (after, mturn, mn, weights, None, False, "logits", 1.0)
    w = [x.clone().requires_grad_() for x in weights]
    got = afterstate.afterstate_deep(after, mturn, mn, w)
    grad = torch.randn(got.shape, device=dev,
                       generator=torch.Generator(dev).manual_seed(3))
    grad = grad * (got > afterstate.FLOOR)
    got_g = torch.autograd.grad(got, w, grad)
    again_g = torch.autograd.grad(afterstate.afterstate_deep(
        after, mturn, mn, w), w, grad)
    check(all(bool(torch.equal(a, b)) for a, b in zip(got_g, again_g)),
          "deep backward not deterministic")
    row = deep_check(torch, afterstate, args, got.detach(), got_g, grad)

    def fwd_bwd():
        y = afterstate.afterstate_deep(after, mturn, mn, w)
        torch.autograd.grad(y, w, grad)

    row["fwd_bwd_ms"] = time_ms(fwd_bwd, 3)
    row["bound_ms"], n_kept = deep_least_ms(after, mn, widths, (False, True))
    # the dense layers alone, forward (saving h_l) and backward: their
    # effective float32 rate, logged beside the bound (not a gate)
    with torch.no_grad():
        (w1, b1), layers, head = afterstate._split(weights)
        out_, h1, elem, count = afterstate.afterstate_hidden(
            after, mturn, mn, w1, b1, False, "logits")
        row.update(kept_check(torch, afterstate, after, mturn, mn, elem,
                              count))
        acts = dense.dense_layers(h1, elem, count, out_, layers, head,
                                  save=True)
        row["dense_fwd_ms"] = time_ms(lambda: dense.dense_layers(
            h1, elem, count, out_, layers, head, save=True), 3)
        row["dense_bwd_ms"] = time_ms(lambda: dense.dense_layers_backward(
            h1, acts, elem, count, grad, layers, head), 3)
    flops = deep_work.dense(n_kept, widths, 1)[1]
    row["dense_fwd_tflops"] = flops / row["dense_fwd_ms"] / 1e9
    row["dense_bwd_tflops"] = 2 * flops / row["dense_bwd_ms"] / 1e9
    del out_, h1, elem, count, acts
    out["minibatch"] = row
    del after, w, got, got_g, again_g
    # one train_step through the wrappers
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    with WholeRows(torch, afterstate, "afterstate_deep") as seen:
        ts, es, metrics = learner.train_step(ts, es, cfg.env, cfg.model,
                                             cfg.ppo)
    torch.cuda.synchronize()
    out["train_step_s"] = time.time() - t0
    out["launches"] = launches()
    out["collapsed_rows"] = afterstate.collapsed_rows()
    out["whole_rows_plain"], _ = seen.counts()
    check(out["collapsed_rows"] == out["whole_rows_plain"] > 0,
          f"wildbg4096 train_step: {out['collapsed_rows']} whole rows "
          f"tallied, {out['whole_rows_plain']} by the plain rule")
    steps = cfg.ppo.num_epochs * cfg.ppo.num_minibatches
    calls = cfg.ppo.t_horizon + steps
    expect = {"afterstate_hidden": calls, "dense_layers": calls,
              "afterstate_hidden_backward": steps,
              "dense_layers_backward": steps}
    for name, want in expect.items():
        check(out["launches"][name] == want,
              f"wildbg4096 train_step: {name} {out['launches'][name]} "
              f"launches, expected {want}")
    check(out["launches"]["afterstate_eval"] == 0
          and out["launches"]["afterstate_eval_backward"] == 0
          and out["launches"][ops.OPTIMIZER] == steps,
          f"wildbg4096 train_step: launches {out['launches']}")
    check(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
          "wildbg4096 train_step: a metric is not finite")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def kept_check(torch, afterstate, boards, mover, n, elem, count):
    """The emit's count and elements (a whole row's board marked ``~(r
    m)``) against the plain kept order exactly; {"kept_boards", "whole",
    "slots_kept"}: the boards the kernels work on, the whole rows, and
    the slots the epilogue keeps (what the kept boards were before whole
    rows)."""
    want = afterstate._kept_order(boards, n, "logits")
    c = want.shape[0]
    check(int(count) == c and bool(torch.equal(elem[:c], want)),
          f"deep emit: {int(count)} kept boards or their order off the "
          f"plain kept order's {c}")
    return {"kept_boards": c,
            "whole": int(afterstate.collapsed_plain(boards, n,
                                                    "logits").sum()),
            "slots_kept": int(afterstate._valid(n, boards.shape[1],
                                                "logits").sum())}


def log_deep(out):
    r, mb = out["rollout_step"], out["minibatch"]
    log(f"whole rows (wildbg4096): rollout step {r['kept_boards']} kept "
        f"boards of {r['slots_kept']} kept slots ({r['whole']} whole rows); "
        f"first minibatch {mb['kept_boards']} of {mb['slots_kept']} "
        f"({mb['whole']} whole); train_step's tally {out['collapsed_rows']}"
        f" whole rows (plain rule {out['whole_rows_plain']})")
    log(f"deep pass (wildbg4096): rollout step {r['kept']} kept boards, "
        f"value gap {r['value_gap']:.2e} (gate {r['value_gate']:.2e}, TF32 "
        f"{r['tf32_value_gap']:.2e}), afterstate_hidden {r['hidden_ms']:.4f}"
        f" ms + dense_layers {r['dense_ms']:.4f} ms against a bound of "
        f"{r['bound_ms']:.4f} ms; first minibatch {mb['kept']} kept boards,"
        f" value gap {mb['value_gap']:.2e} (gate {mb['value_gate']:.2e}, "
        f"TF32 {mb['tf32_value_gap']:.2e}), gradients {mb['grad_dist']:.2e}"
        f" from plain (gate {mb['grad_gate']:.2e}, TF32 "
        f"{mb['tf32_grad_dist']:.2e}), forward and backward "
        f"{mb['fwd_bwd_ms']:.3f} ms against {mb['bound_ms']:.4f}; "
        f"train_step {out['train_step_s']:.2f} s, launches "
        f"{json.dumps(out['launches'])}, peak {out['peak_gb']:.1f} GB")
    log(f"dense layers (split bf16 products on the tensor cores): rollout "
        f"step forward {r['dense_tflops']:.1f} TFLOP/s; first minibatch "
        f"forward {mb['dense_fwd_ms']:.3f} ms ({mb['dense_fwd_tflops']:.1f} "
        f"TFLOP/s), backward {mb['dense_bwd_ms']:.3f} ms "
        f"({mb['dense_bwd_tflops']:.1f} TFLOP/s); kernels (registers, spill "
        f"stores, spill loads): {json.dumps(out.get('dense_kernels'))}")


def route_check(torch, afterstate, boards, n, route):
    """The route's floors, each row's entry of each class (its count, or
    ``WHOLE`` for a whole row's class) and its slots of each class in slot
    order against ``afterstate_route_plain``, exactly; returns the kept
    boards of each class (a whole row's one)."""
    out, lim, slots = route
    _, want_lim, want_slots = afterstate.afterstate_route_plain(
        boards, n, "logits")
    r, m, _ = boards.shape
    kept = afterstate._valid(n, m, "logits")
    check(bool((out[~kept] == afterstate.FLOOR).all()),
          "route: a slot not kept lacks the floor")
    check(bool(torch.equal(lim, want_lim)),
          "route: a row's count of a class differs from the plain version's")
    kept = torch.where(lim == afterstate.WHOLE, 1, lim)
    used = torch.arange(m, device=boards.device) < kept[..., None]
    check(bool(torch.equal(slots.view(-1, r, m)[used],
                           want_slots.view(-1, r, m)[used])),
          "route: a class's slots differ from the plain version's")
    return [int(x) for x in kept.sum(1).tolist()]


def routed_emit_check(torch, afterstate, boards, mover, route, weights):
    """Each group's first layer (``afterstate_hidden_routed``) against the
    plain first layer over the route's order of that group: the count and
    the elements exactly, the activations within DEEP_NUDGE_FACTOR x what
    a one-ulp nudge of W1 and b1 moves the plain version (at least
    DEEP_FLOOR).  [{"kept", "gap", "gate"}] by group."""
    _, lim, slots = route
    m, k = boards.shape[1], len(weights) // 2
    rows = []
    for group in range(len(afterstate.GROUPS)):
        w1, b1 = weights[group * k:group * k + 2]
        h = w1.shape[0]
        h1, elem, count = afterstate.afterstate_hidden_routed(
            boards, mover, route, group, w1, b1, False)
        order = afterstate._group_order(lim[group], slots[group], m)
        c = order.shape[0]
        want = afterstate._first_layer_plain(boards, mover, order, w1, b1,
                                             False)[0][:c, :h]
        nudge = afterstate._first_layer_plain(
            boards, mover, order, *nudged_params(torch, [w1, b1]),
            False)[0][:c, :h]
        check(int(count) == c and bool(torch.equal(elem[:c], order)),
              f"routed emit, group {group}: {int(count)} kept boards or "
              f"their order off the route's {c}")
        row = {"kept": c, "gap": 0.0, "gate": DEEP_FLOOR}
        if c:
            row["gap"] = float((h1[:c, :h] - want).abs().max())
            row["gate"] = max(DEEP_NUDGE_FACTOR * float(
                (nudge - want).abs().max()), DEEP_FLOOR)
        check(row["gap"] <= row["gate"],
              f"routed emit, group {group}, off the plain first layer: "
              f"{row}")
        rows.append(row)
        del h1, elem, want, nudge
    return rows


def routed_least_ms(boards, n, widths, backward):
    """(least time in ms of a routed pass over ``boards`` with valid
    prefixes ``n`` (and its backward), the route's alone) at the
    benchmark's yardstick (``benchmark/yardstick/routed_work.py``)."""
    from benchmark.yardstick import routed_work, work

    got, _ = routed_work.pass_work(boards, n, "logits", widths, 1, backward)
    total = sum(work.least_seconds(*v) for v in got.values())
    return 1e3 * total, 1e3 * work.least_seconds(*got["afterstate_route"])


def routed_phase(torch, afterstate, bg_env, learner, get_preset, dev):
    """wildbg2net4096's routed pass on the card: at its first rollout step
    and its first minibatch, the route against its plain version exactly,
    each group's first layer against the plain first layer, the pass
    (values, and gradients of both networks at the minibatch) against the
    plain routed pass under ``deep_check``'s gates, the same bits on a
    second launch, times (CUDA events) beside least times; then one timed
    train_step whose launches show the route once a pass, every other
    deep wrapper once a group, the shallow afterstate kernels never, and
    whose tally reaches both networks, whose tally of whole rows equals
    the plain rule's count over its calls' inputs, and whose kept boards by
    network are those before whole rows less M - 1 a whole row."""
    from mlp_ppo_2ply_p3_tpu_torch import ops

    cfg = get_preset("wildbg2net4096")
    widths = cfg.model.widths
    torch.cuda.reset_peak_memory_stats(dev)
    ts = learner.init_train_state(2201, cfg.model, cfg.ppo, device=dev)
    es = bg_env.reset(ts.gen, cfg.env, cfg.ppo.num_envs, device=dev)
    contact, race = [[w.detach() for w in ts.model.deep_weights(
        "score", net)[0]] for net in afterstate.GROUPS]
    weights = contact + race
    k = len(contact)
    plain = afterstate.afterstate_routed_plain
    out = {}

    def routed(boards, mover, n, ws):
        return afterstate.afterstate_routed(boards, mover, n, ws[:k],
                                            ws[k:])

    def one_step(boards, mover, n):
        route = afterstate.afterstate_route(boards, n, "logits")
        row = {"route_kept": route_check(torch, afterstate, boards, n,
                                         route),
               "emit": routed_emit_check(torch, afterstate, boards, mover,
                                         route, weights)}
        row["route_ms"] = time_ms(lambda: afterstate.afterstate_route(
            boards, n, "logits"), 5)
        return row

    # the first rollout step: the forward
    turn, n = es.turn.to(torch.int32), es.n_moves.to(torch.int32)
    args = (es.after, turn, n, weights, None, False, "logits", 1.0)
    with torch.no_grad():
        row = one_step(es.after, turn, n)
        got = routed(es.after, turn, n, weights)
        again = routed(es.after, turn, n, weights)
        check(bool(torch.equal(got, again)),
              "routed forward not deterministic")
        row.update(deep_check(torch, afterstate, args, got, plain=plain))
        row["pass_ms"] = time_ms(lambda: routed(es.after, turn, n,
                                                weights), 5)
    row["bound_ms"], row["route_bound_ms"] = routed_least_ms(
        es.after, n, widths, False)
    out["rollout_step"] = row
    del got, again
    # the first minibatch: a rollout's rows in the update's first order
    sampler = learner.Sampler(ts.gen)
    _, traj, _, _ = learner.rollout(ts.model, es, sampler, cfg.env, cfg.ppo)
    rows = cfg.ppo.num_envs * cfg.ppo.t_horizon
    idx = sampler.permutation(rows, dev)[:rows // cfg.ppo.num_minibatches]
    after = traj.after.reshape(rows, *traj.after.shape[2:])[idx]
    mturn = traj.turn.reshape(rows)[idx].to(torch.int32)
    mn = traj.n_moves.reshape(rows)[idx].to(torch.int32)
    del traj
    with torch.no_grad():
        row = one_step(after, mturn, mn)
    args = (after, mturn, mn, weights, None, False, "logits", 1.0)
    w = [x.clone().requires_grad_() for x in weights]
    got = routed(after, mturn, mn, w)
    grad = torch.randn(got.shape, device=dev,
                       generator=torch.Generator(dev).manual_seed(3))
    grad = grad * (got > afterstate.FLOOR)
    got_g = torch.autograd.grad(got, w, grad)
    again_g = torch.autograd.grad(routed(after, mturn, mn, w), w, grad)
    check(all(bool(torch.equal(a, b)) for a, b in zip(got_g, again_g)),
          "routed backward not deterministic")
    row.update(deep_check(torch, afterstate, args, got.detach(), got_g,
                          grad, plain=plain))

    def fwd_bwd():
        torch.autograd.grad(routed(after, mturn, mn, w), w, grad)

    row["fwd_bwd_ms"] = time_ms(fwd_bwd, 3)
    row["bound_ms"], row["route_bound_ms"] = routed_least_ms(
        after, mn, widths, True)
    out["minibatch"] = row
    del after, w, got, got_g, again_g
    # one train_step through the wrappers
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    with WholeRows(torch, afterstate, "afterstate_routed") as seen:
        ts, es, metrics = learner.train_step(ts, es, cfg.env, cfg.model,
                                             cfg.ppo)
    torch.cuda.synchronize()
    out["train_step_s"] = time.time() - t0
    out["launches"] = launches()
    out["routed_rows"] = afterstate.routed_rows()
    out["collapsed_rows"] = afterstate.collapsed_rows()
    out["whole_rows_plain"], out["former_rows"] = seen.counts()
    check(out["collapsed_rows"] == out["whole_rows_plain"] > 0,
          f"wildbg2net4096 train_step: {out['collapsed_rows']} whole rows "
          f"tallied, {out['whole_rows_plain']} by the plain rule")
    check(sum(out["former_rows"].values()) - sum(out["routed_rows"].values())
          == out["whole_rows_plain"] * (cfg.env.movegen.max_moves - 1),
          f"wildbg2net4096 train_step: kept boards by network "
          f"{out['routed_rows']}, before whole rows {out['former_rows']}")
    steps = cfg.ppo.num_epochs * cfg.ppo.num_minibatches
    calls = cfg.ppo.t_horizon + steps
    groups = len(afterstate.GROUPS)
    expect = {"afterstate_route": calls,
              "afterstate_hidden": groups * calls,
              "dense_layers": groups * calls,
              "afterstate_hidden_backward": groups * steps,
              "dense_layers_backward": groups * steps,
              "afterstate_eval": 0, "afterstate_eval_backward": 0,
              ops.OPTIMIZER: steps}
    for name, want in expect.items():
        check(out["launches"][name] == want,
              f"wildbg2net4096 train_step: {name} {out['launches'][name]} "
              f"launches, expected {want}")
    check(all(v > 0 for v in out["routed_rows"].values()),
          f"wildbg2net4096 train_step: a network got no kept board: "
          f"{out['routed_rows']}")
    check(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
          "wildbg2net4096 train_step: a metric is not finite")
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def log_routed(out):
    r, mb = out["rollout_step"], out["minibatch"]

    def emit(row):
        return ", ".join(f"{e['kept']} kept gap {e['gap']:.2e} (gate "
                         f"{e['gate']:.2e})" for e in row["emit"])

    rows = out["routed_rows"]
    log(f"routed pass (wildbg2net4096): rollout step kept boards by class "
        f"{r['route_kept']}, route {r['route_ms']:.4f} ms (bound "
        f"{r['route_bound_ms']:.5f} ms by bytes), emit {emit(r)}, value "
        f"gap {r['value_gap']:.2e} (gate {r['value_gate']:.2e}, TF32 "
        f"{r['tf32_value_gap']:.2e}), pass {r['pass_ms']:.3f} ms against "
        f"{r['bound_ms']:.4f}; first minibatch {mb['route_kept']}, route "
        f"{mb['route_ms']:.4f} ms (bound {mb['route_bound_ms']:.5f}), emit "
        f"{emit(mb)}, value gap {mb['value_gap']:.2e} (gate "
        f"{mb['value_gate']:.2e}, TF32 {mb['tf32_value_gap']:.2e}), "
        f"gradients {mb['grad_dist']:.2e} from plain (gate "
        f"{mb['grad_gate']:.2e}, TF32 {mb['tf32_grad_dist']:.2e}), forward "
        f"and backward {mb['fwd_bwd_ms']:.3f} ms against "
        f"{mb['bound_ms']:.4f}; train_step {out['train_step_s']:.2f} s, "
        f"launches {json.dumps(out['launches'])}, kept boards by network "
        f"{json.dumps(rows)} (race {rows['race'] / max(sum(rows.values()), 1):.3f})"
        f", peak {out['peak_gb']:.1f} GB")
    former = out["former_rows"]
    log(f"whole rows (wildbg2net4096): train_step's tally "
        f"{out['collapsed_rows']} (plain rule {out['whole_rows_plain']}); "
        f"kept boards by network before whole rows {json.dumps(former)} "
        f"(race {former['race'] / max(sum(former.values()), 1):.3f}), after "
        f"{json.dumps(rows)} (race "
        f"{rows['race'] / max(sum(rows.values()), 1):.3f})")


# --- phase 4 -----------------------------------------------------------------


def play_boards(perf_twoply, env_cfg, batch, steps, dev):
    """Canonical boards, dice and mirror flags after a few random-play
    env steps from a fresh reset."""
    from mlp_ppo_2ply_p3_tpu_torch.core import board as Bd

    es = perf_twoply.realistic_state(env_cfg, batch, steps, device=dev)
    vecs = Bd.to_canonical(es.points, es.bar, es.off, es.turn)
    return vecs, es.dice, es.turn == 1


def captured_movegen(torch, movegen, vecs, dice, mg, mirror,
                     world=None):
    """One movegen call on the kernel path (a rank's, with a ``world``),
    checked equal to the plain path, with the expected number of kernel
    calls; returns (its output, its Capture)."""
    batch = vecs.shape[0]
    with Capture() as cap:
        got = movegen.legal_afterstates_batch(vecs, dice, mg, mirror, world)
    with Capture(plain=True):
        want = movegen.legal_afterstates_batch(vecs, dice, mg, mirror,
                                               world)
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("boards", "n_moves", "overflow")):
        check(same(g, w), f"movegen {name} at B={batch}: kernel path != "
              f"plain path")
    counted = {name: len(calls) for name, calls in cap.calls.items()}
    check(counted == per_call_launches(movegen, mg),
          f"kernel calls {counted} per movegen call at B={batch}, expected "
          f"{per_call_launches(movegen, mg)}")
    return got, cap


def movegen_phase(torch, movegen, perf_twoply, profiling,
                  env_cfg, dev):
    mg = env_cfg.movegen
    vecs, dice, mirror = play_boards(perf_twoply, env_cfg, 4096, 6, dev)
    got, cap = captured_movegen(torch, movegen, vecs, dice, mg,
                                mirror)

    # the whole batch on the CPU (the plain path)
    cpu = movegen.legal_afterstates_batch(vecs.cpu(), dice.cpu(), mg,
                                          mirror.cpu())
    for g, c, name in zip(got, cpu, ("boards", "n_moves", "overflow")):
        check(same(g.cpu(), c), f"movegen {name}: card != CPU at B=4096")
    check(int(got[1].sum()) > 0, "no legal moves at all")

    # time every kernel call of this movegen call: kernel vs plain
    rows = measure_calls(torch, cap.calls)

    def one_call():
        movegen.legal_afterstates_batch(vecs, dice, mg, mirror)

    one_call()
    mg_ms = time_ms(one_call, 5)
    # Replaying the calls as a CUDA graph leaves the device's own time;
    # the events above also see the host's launch rate wherever it is
    # slower than the device.
    mg_graph_ms = profiling.timed_scan(
        lambda v, d, m: movegen.legal_afterstates_batch(v, d, mg, m),
        vecs, dice, mirror) * 1e3
    return rows, mg_ms, mg_graph_ms


def movegen_batches_phase(torch, movegen, perf_twoply, runs, dev,
                          world=None):
    """Movegen at the other batch sizes and widths the paths run,
    ``runs`` of (label, EnvConfig, games): below 512 games both
    sub-batches are the whole batch (the doubles levels then hold every
    game, the non-doubles batch all-zero padding rows of dice (0, 0)).
    Each: one movegen call on boards from a few env steps, kernel path ==
    plain path == the CPU (a world of one rank: its shard is the batch);
    every kernel call of it checked against its plain version and timed
    beside its least time (``measure``).  With a ``world`` each call is a
    rank's (its shapes those of a shard of any number of ranks).  Returns
    a report row per run."""
    out = []
    for label, env_cfg, batch in runs:
        vecs, dice, mirror = play_boards(perf_twoply, env_cfg, batch, 6, dev)
        got, cap = captured_movegen(torch, movegen, vecs, dice,
                                    env_cfg.movegen, mirror, world)
        if world is None or world.size == 1:   # the shard is the batch
            cpu = movegen.legal_afterstates_batch(
                vecs.cpu(), dice.cpu(), env_cfg.movegen, mirror.cpu())
            check(all(same(g.cpu(), c) for g, c in zip(got, cpu)),
                  f"{label} movegen B={batch}: card != CPU")
        rows = measure_calls(torch, cap.calls)
        out.append({"label": label, "batch": batch, "calls": rows})
        log(f"{label} movegen B={batch}: kernel path == plain path == CPU; "
            f"every call == plain")
        log_rows(f"{label} B={batch}: ", rows)
    return out


# --- phase 5 -----------------------------------------------------------------

LOSS_KEYS = ("loss", "policy_loss", "value_loss", "entropy")


def train_phase(torch, movegen, bg_env, learner, cfg, batch, t,
                dev, timed, detail=None):
    """Warm-up + ``timed`` train_steps; then one more rollout and update,
    timed apart.  Losses finite; each kernel's launches as
    ``train_step_launches`` counts them.  With ``detail`` (the modules
    ``(profiling, afterstate, features)``), also the timed steps' peak
    device memory, the rollout's and the update's device time
    (``device_busy``), and the afterstate pass's first rollout call,
    first minibatch call and first backward, each checked and timed on
    this run's data.  The timed steps' first optimizer step is checked and
    timed on its own inputs (``adam_measure``).  Returns a report
    dict."""
    from mlp_ppo_2ply_p3_tpu_torch import ops
    from mlp_ppo_2ply_p3_tpu_torch.ops import adam
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling

    ppo = dataclasses.replace(cfg.ppo, num_envs=batch, t_horizon=t)
    ts = learner.init_train_state(0, cfg.model, ppo, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    es = bg_env.reset(gen, cfg.env, batch, device=dev)
    t0 = time.time()
    ts, es, metrics = learner.train_step(ts, es, cfg.env, cfg.model, ppo)
    torch.cuda.synchronize()
    warm_s = time.time() - t0

    zero_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    cap = Capture(distinct=True, copy=True, kernels=(
        ops.OPTIMIZER, *(kernel_groups()[1] if detail else ())))
    t0 = time.time()
    with cap:
        for _ in range(timed):
            ts, es, metrics = learner.train_step(ts, es, cfg.env, cfg.model,
                                                 ppo)
        torch.cuda.synchronize()
    dt = time.time() - t0
    counted = launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    steps = ppo.num_epochs * ppo.num_minibatches    # optimizer steps
    check(counted[ops.OPTIMIZER] == timed * steps,
          f"the optimizer ran {counted[ops.OPTIMIZER]} times in {timed} "
          f"train_steps, expected {ppo.num_epochs} x {ppo.num_minibatches} "
          f"a step")

    for name, per_step in train_step_launches(movegen, cfg.env, ppo).items():
        expect = timed * per_step
        check(counted[name] == expect,
              f"{name} launched {counted[name]} times in {timed} "
              f"train_steps, expected {expect}")
    vals = {k: float(v) for k, v in metrics.items()}
    for k in LOSS_KEYS:
        check(math.isfinite(vals[k]), f"{k} not finite: {vals[k]}")
    for p in ts.model.parameters():
        check(bool(torch.isfinite(p).all()), "non-finite parameter")
    check(int(ts.update_idx) == 1 + timed, "update_idx did not advance")

    # where a step's time goes: the rollout and the update, each timed
    # on its own (host clock around synchronised work), launches counted
    # from 0 before each
    sampler = learner.Sampler(ts.gen)
    zero_launches()
    t0 = time.time()
    es, traj, last_value, last_turn = learner.rollout(ts.model, es, sampler,
                                                      cfg.env, ppo)
    torch.cuda.synchronize()
    rollout_s = time.time() - t0
    rollout_launches = launches()
    zero_launches()
    t0 = time.time()
    learner.ppo_update(ts, traj, last_value, last_turn, cfg.env, ppo,
                       sampler)
    torch.cuda.synchronize()
    update_s = time.time() - t0
    update_launches = launches()
    check(rollout_launches[ops.OPTIMIZER] == 0
          and update_launches[ops.OPTIMIZER] == steps,
          f"the optimizer ran {rollout_launches[ops.OPTIMIZER]} times in a "
          f"rollout and {update_launches[ops.OPTIMIZER]} in an update, "
          f"expected 0 and {steps}")
    out = {
        "batch": batch, "t_horizon": t, "timed_steps": timed,
        "policy_mode": ppo.policy_mode, "warmup_s": warm_s,
        "train_step_s": dt / timed,
        "env_steps_per_s": batch * t * timed / dt,
        "rollout_s": rollout_s, "update_s": update_s,
        "launches": counted, "rollout_launches": rollout_launches,
        "update_launches": update_launches, "metrics": vals,
    }
    steps = cap.calls[ops.OPTIMIZER]
    check(len(steps) == 1, f"captured optimizer steps: {len(steps)} "
          f"distinct, expected 1")
    out["adam"] = adam_measure(torch, adam, profiling, steps[0],
                               f"{batch} games, hidden "
                               f"{cfg.model.hidden_size}, "
                               f"{ppo.policy_mode}")
    del steps
    if detail:
        profiling, afterstate, features = detail
        out["peak_gb"] = peak_gb
        out["rollout_device_s"] = profiling.device_busy(
            lambda: learner.rollout(ts.model, es, sampler, cfg.env, ppo),
            dev)
        out["update_device_s"] = profiling.device_busy(
            lambda: learner.ppo_update(ts, traj, last_value, last_turn,
                                       cfg.env, ppo, sampler), dev)
        out["rollout_idle_share"] = max(
            0.0, 1 - out["rollout_device_s"] / rollout_s)
        out["update_idle_share"] = max(
            0.0, 1 - out["update_device_s"] / update_s)
        del traj
        fwd = cap.calls["afterstate_eval"]
        bwd = cap.calls["afterstate_eval_backward"]
        # a rollout's shape, then a minibatch's (one shape where they meet)
        shapes = 1 + (batch != batch * t // ppo.num_minibatches)
        check(len(fwd) == shapes and len(bwd) == 1,
              f"captured afterstate calls: {len(fwd)} forward shapes, "
              f"{len(bwd)} backward")
        out["afterstate_calls"] = [
            afterstate_measure(torch, afterstate, features, fwd[0],
                               "rollout (played)"),
            afterstate_measure(torch, afterstate, features, fwd[-1],
                               "minibatch (played)")]
        out["afterstate_backward_calls"] = [afterstate_backward_measure(
            torch, afterstate, bwd[0], "minibatch (played)")]
    return out


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


def small_agreement_phase(torch, bg_env, learner, cfg, dev,
                          policy_mode="index", model_cfg=None):
    """One train_step at B=64, T=8 (the model ``model_cfg``, by default
    ``cfg``'s, hidden 128) on the card (kernel path) and on the CPU (plain
    path) from the same weights and the same draws: the rollouts must
    agree exactly in their integers, and parameters and losses to 1e-4
    (float32 sums in another order on each side).  In ``afterstate`` mode
    the score head's bias, whose exact gradient is zero (softmax is shift
    invariant), may move by Adam's lr a step either way on each side, as
    ``tests/test_torch_learner.py`` bounds it.  A bf16 model
    (``compute_dtype``): the parameters' distance (the norm over all) at
    most AFTERSTATE_NUDGE_FACTOR times what one bf16 rounding does, the
    CPU run once more from every parameter's bf16 rounding moved up one
    bf16 ulp; losses within AFTERSTATE_BF16_TOL of their size (at least
    1).  Returns the largest parameter difference."""
    batch, t = 64, 8
    if model_cfg is not None:
        cfg = dataclasses.replace(cfg, model=model_cfg)
    bf16 = cfg.model.compute_dtype == "bfloat16"
    ppo = dataclasses.replace(cfg.ppo, num_envs=batch, t_horizon=t,
                              num_minibatches=4, policy_mode=policy_mode)
    gen = torch.Generator(device=dev).manual_seed(2)
    start = bg_env.reset(gen, cfg.env, batch, device=dev)
    rec = RecordingSampler(learner, gen)
    out = []
    cpu = torch.device("cpu")
    runs = [(dev, rec, False), (cpu, None, False)]
    if bf16:   # the CPU once more, from the nudged parameters
        runs.append((cpu, None, True))
    for where, sampler, nudge in runs:
        # the same seeded weights on both sides
        ts = learner.init_train_state(0, cfg.model, ppo, device="cpu")
        if nudge:
            params = list(ts.model.parameters())
            with torch.no_grad():
                for p, q in zip(params, nudged_params(
                        torch, [p.bfloat16() for p in params])):
                    p.copy_(q.float())
        model = ts.model.to(where)
        ts = ts._replace(model=model,
                         opt_state=learner.init_optimizer(model))
        sampler = sampler or ReplaySampler(rec, where)
        es = bg_env.EnvState(*(x.to(where) for x in start))
        out.append(learner.train_step(ts, es, cfg.env, cfg.model, ppo,
                                      sampler))
    (g_ts, g_es, g_m), (c_ts, c_es, c_m) = out[:2]
    tag = (f"{policy_mode} hidden {cfg.model.hidden_size} "
           f"{cfg.model.compute_dtype}")
    for name, g, c in zip(g_es._fields, g_es, c_es):
        check(same(g.cpu(), c), f"small train_step {tag}: env "
              f"{name} card != CPU")
    steps = ppo.num_epochs * ppo.num_minibatches
    if bf16:
        def dist(a, b):
            return math.sqrt(sum(
                float(((x.detach().cpu().double() - y.detach().double())
                       ** 2).sum())
                for x, y in zip(a.parameters(), b.parameters())))

        err = dist(g_ts.model, c_ts.model)
        floor = dist(out[2][0].model, c_ts.model)
        check(err <= AFTERSTATE_NUDGE_FACTOR * floor, f"small train_step "
              f"{tag}: parameters {err:.3e} apart, a bf16 nudge moves "
              f"them {floor:.3e}")
        for k in LOSS_KEYS:
            c = float(c_m[k])
            d = abs(float(g_m[k]) - c)
            check(d <= AFTERSTATE_BF16_TOL * max(1.0, abs(c)),
                  f"small train_step {tag}: {k} differs by {d}")
        log(f"train_step B=64 T=8 {tag}: parameters {err:.3e} apart (a "
            f"bf16 nudge {floor:.3e})")
        return max(float((g.detach().cpu() - c.detach()).abs().max())
                   for g, c in zip(g_ts.model.parameters(),
                                   c_ts.model.parameters()))
    diff = 0.0
    for (name, g), c in zip(g_ts.model.named_parameters(),
                            c_ts.model.parameters()):
        d = float((g.detach().cpu() - c.detach()).abs().max())
        if policy_mode == "afterstate" and name == "layers.score.bias":
            check(d <= 2 * steps * ppo.learning_rate, f"small train_step "
                  f"{tag}: {name} differs by {d}")
            continue
        diff = max(diff, d)
    check(diff < 1e-4, f"small train_step {tag}: parameters differ "
          f"by {diff}")
    for k in LOSS_KEYS:
        d = abs(float(g_m[k]) - float(c_m[k]))
        check(d < 1e-4, f"small train_step {tag}: {k} differs by "
              f"{d}")
    return diff


def exact_order_phase(torch, movegen, perf_twoply, bg_env, dev):
    """``legal_afterstates_batch`` at ``MovegenConfig.parity()`` (the
    reference-order doubles path: its doubles list goes into the output
    with one ``index_copy_``, every empty slot onto one spare row) at
    B=600 on boards from a few env steps, a tenth of the games over: on
    the played dice (empty doubles slots) and on doubles only (the
    doubles capacity binds).  Card == CPU bit for bit, with the launches
    of ``per_call_launches``.  Returns a report."""
    mg = movegen.MovegenConfig.parity()
    vecs, dice, mirror = play_boards(
        perf_twoply, bg_env.EnvConfig(movegen=mg), 600, 6, dev)
    over = torch.arange(600, device=dev) % 10 == 3
    vecs[over, :24] = 0
    vecs[over, 48] = 0
    vecs[over, 50] = 15
    out = {"batch": 600, "games_over": int(over.sum()),
           "doubles_capacity": movegen.doubles_capacity(600, mg)}
    for label, d in (("played", dice), ("doubles only", torch.stack(
            [dice[:, 0], dice[:, 0]], 1).contiguous())):
        zero_launches()
        got = movegen.legal_afterstates_batch(vecs, d, mg, mirror)
        torch.cuda.synchronize()
        counted = launches()
        check(counted == with_optimizer(per_call_launches(movegen, mg)),
              f"exact_order movegen ({label}): launches {counted}")
        cpu = movegen.legal_afterstates_batch(vecs.cpu(), d.cpu(), mg,
                                              mirror.cpu())
        for g, c, name in zip(got, cpu, ("boards", "n_moves", "overflow")):
            check(same(g.cpu(), c), f"exact_order movegen ({label}) {name}: "
                  f"card != CPU")
        out[label] = {"doubles": int((d[:, 0] == d[:, 1]).sum()),
                      "overflow_games": int(got[2].sum())}
    check(0 < out["played"]["doubles"] < out["doubles_capacity"] < 600,
          f"exact_order movegen: {out}")
    return out


# --- phase 6: the evaluation path --------------------------------------------

# 1-ply frozen_v1 against the pubeval heuristic in the JAX package, 512
# games (docs/LEARNING.md:171), and 3 sigma of the difference of two
# 512-game win rates near it
JAX_ONEPLY_VS_HEURISTIC = 0.818
WIN_RATE_BAND = 0.072
# the 2-ply vs 1-ply arena's plies, cut from 400: about 210 ms a ply
TWOPLY_PLIES = 100
# the league runner's pairs: (pair, games, plies)
ARENA_PAIRS = (("oneply:pubeval", 512, 400),
               ("twoply:oneply", 64, TWOPLY_PLIES))


def twoply_check(torch, twoply, bg_env, model, state, scfg):
    """One 2-ply decision over the batch: exact launch counts; the
    movegen kernels' path equal to their plain path bit for bit; the
    afterstate pass's plain path equal in overflow, in actions where the
    best score leads by more than 1e-4, and in backup scores within
    AFTERSTATE_TOL; a 32-game slice on the CPU equal in actions where the
    best score leads by more than 1e-4, in overflow, and in backup scores
    within 1e-4.  Returns (report, the Capture of the decision's distinct
    kernel calls)."""
    import copy

    from mlp_ppo_2ply_p3_tpu_torch import ops

    batch = state.turn.shape[0]
    inner, margins = twoply.candidate_scores, []

    def recorded(*a, **kw):
        top_idx, score2, ovf = inner(*a, **kw)
        top2 = torch.topk(score2, 2, dim=1).values
        margins.append(top2[:, 0] - top2[:, 1])
        return top_idx, score2, ovf

    zero_launches()
    twoply.candidate_scores = recorded
    try:
        with Capture(distinct=True, kernels=ops.KERNELS) as cap:
            got = twoply.twoply_actions_values(model, state, scfg)
    finally:
        twoply.candidate_scores = inner
    torch.cuda.synchronize()
    counted = launches()
    expect = with_optimizer(dict(zip(
        ops.KERNELS, twoply.launches_per_decision(batch, scfg))))
    check(counted == expect, f"2-ply decision at B={batch}, reply width "
          f"{scfg.reply_max_moves}: launches {counted}, expected {expect}")
    with Capture(plain=True):
        plain = twoply.twoply_actions_values(model, state, scfg)
    for g, p, name in zip(got, plain, ("actions", "backup", "overflow")):
        check(same(g, p), f"2-ply {name}: kernel path != plain path")
    with Capture(plain=True, kernels=kernel_groups()[1]):
        plain = twoply.twoply_actions_values(model, state, scfg)
    decided = margins[0] > 1e-4
    check(same(got[0][decided], plain[0][decided])
          and same(got[2], plain[2]),
          "2-ply actions or overflow: afterstate kernel != plain")
    value_diff = float((got[1] - plain[1]).abs().max())
    check(value_diff <= AFTERSTATE_TOL, f"2-ply backup: afterstate kernel "
          f"and plain differ by {value_diff}")

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
        "launches": counted, "afterstate_plain_max_backup_diff": value_diff,
        "afterstate_plain_clear_margin_games": int(decided.sum()),
        "cpu_slice_games": k,
        "cpu_slice_clear_margin_games": int(clear.sum()),
        "cpu_slice_max_backup_diff": diff,
        "overflow_games": int(got[2].sum()),
    }, cap


def twoply_phase(torch, twoply, perf_twoply, bg_env, afterstate, features,
                 cfg, model, dev):
    """The ``twoply`` preset on frozen_v1, positions after 12 random env
    steps: checked at B=256 at reply width 512 (no reply dedup) and 128
    (the dedup branch), and at B=4096 at width 512; the distinct reply
    calls of those decisions checked and timed against their plain
    versions, and the afterstate pass's distinct calls against its plain
    version; decisions timed at B=256 and B=4096."""
    states = {b: perf_twoply.realistic_state(cfg.env, b, 12, device=dev)
              for b in (256, 4096)}
    out = {"checks": [], "timing": []}
    calls = {}
    for batch, width in ((256, 512), (256, 128), (4096, 512)):
        scfg = dataclasses.replace(cfg.search, reply_max_moves=width)
        report, calls[batch, width] = twoply_check(
            torch, twoply, bg_env, model, states[batch], scfg)
        out["checks"].append(report)
        clear = report["cpu_slice_clear_margin_games"]
        log(f"2-ply B={batch} reply width {width}: kernel path == plain "
            f"path, card == CPU on 32 games ({clear} with a clear margin, "
            f"backup within {report['cpu_slice_max_backup_diff']:.1e}); "
            f"launches {report['launches']}")
    # the non-doubles replies at width 512 (no dedup) at the port's
    # game_chunk for B=256 and B=4096, and at width 128 (the dedup on);
    # the doubles levels and final levels run at dbl_game_chunk games at
    # every B, and widths 512 and 128 give them other k2, k3 and M'
    def distinct(*lists):
        kept = {}
        for a in (a for calls_ in lists for a in calls_):
            kept.setdefault(_call_key(a), a)
        return list(kept.values())

    reply = {name: distinct(*(calls[key].calls[name] for key in calls))
             for name in ("nondoubles", "doubles_level", "doubles_final")}
    out["reply"] = measure_calls(torch, reply)
    log_rows("reply ", out["reply"])
    # the afterstate pass's distinct calls: the 1-ply values and the
    # dances of each batch, the reply lists' min at each width and chunk
    out["afterstate"] = [
        afterstate_measure(torch, afterstate, features, a,
                           f"2-ply {a[8]}")
        for a in distinct(*(calls[key].calls["afterstate_eval"]
                            for key in calls))]
    log_afterstate_rows("2-ply afterstate ", out["afterstate"])
    del calls, reply
    for batch, reps in ((256, 3), (4096, 1)):
        row, _ = perf_twoply.time_decision(model, states[batch], cfg.search,
                                           reps)
        out["timing"].append(row)
        log(f"2-ply decision B={batch}: {row['ms_per_decision']:.1f} ms, "
            f"{row['decisions_per_s']:.1f} decisions/s, peak "
            f"{row['peak_mem_gb']:.2f} GB")
    return out


def run_arena(movegen, arena, league, twoply, cfg, dev, pair, games,
              plies, model=None):
    """The league CLI's ``run_pair`` on the card (frozen_v1, or ``model``
    as the network), with exact launch counts of every kernel for the
    plies played, and the afterstate pass's distinct calls of the run
    checked and timed on their own inputs (``afterstate_measure``).
    Returns its result dict."""
    import contextlib

    import torch

    from mlp_ppo_2ply_p3_tpu_torch import ops
    from mlp_ppo_2ply_p3_tpu_torch.core import features
    from mlp_ppo_2ply_p3_tpu_torch.ops import afterstate

    per_step = per_call_launches(movegen, cfg.env.movegen)
    # count the plies played: the 2-ply pair's host loop stops once every
    # game is over
    inner, played = arena._ply, [0]

    def counted_ply(*a, **kw):
        played[0] += 1
        return inner(*a, **kw)

    zero_launches()
    arena._ply = counted_ply
    cap = Capture(distinct=True, copy=True, kernels=kernel_groups()[1])
    try:
        with contextlib.redirect_stdout(sys.stderr), cap:
            res = league.run_pair(cfg, pair, games, plies, 11, params=model,
                                  params_from="frozen", device=dev)
    finally:
        arena._ply = inner
    counted = launches()
    ran = played[0]
    check(ran == plies or (0 < ran < plies and res["finished"] == games),
          f"arena {pair}: {ran} plies played of {plies}, "
          f"{res['finished']} of {games} games finished")
    # the reset and every ply list the moves of all games; each side
    # decides for every game every ply: a 2-ply decision, or one
    # afterstate pass of the 1-ply agent
    per_ply = [sum(x) for x in zip(*(
        twoply.launches_per_decision(games, cfg.search)
        if agent == "twoply" else afterstate_launches(fwd=1)
        if agent in ("oneply", "frozen") else (0,) * len(ops.KERNELS)
        for agent in pair.split(":")))]
    expect = with_optimizer({name: (1 + ran) * per_step[name] + ran * extra
                             for name, extra in zip(ops.KERNELS, per_ply)})
    check(counted == expect,
          f"arena {pair}: launches {counted}, expected {expect}")
    res["launches"] = counted
    res["max_plies"] = plies
    res["plies_played"] = ran
    check(cap.calls["afterstate_eval"], f"arena {pair}: no afterstate call")
    res["afterstate_calls"] = [
        afterstate_measure(torch, afterstate, features, a,
                           f"{pair} {a[8]}")
        for a in cap.calls["afterstate_eval"]]
    return res


def arena_log(pair, res, prefix="arena "):
    """Logs a ``run_arena`` result: its dict, then its afterstate rows."""
    log(f"{prefix}{pair}: " + json.dumps(
        {k: v for k, v in res.items() if k != "afterstate_calls"}))
    log_afterstate_rows(prefix, res["afterstate_calls"])


def arena_phase(torch, movegen, arena, league, twoply, cfg, dev):
    """The league CLI's ``run_pair`` on the card: 1-ply frozen_v1 against
    the pubeval heuristic over 512 games, then 2-ply against 1-ply (both
    frozen_v1) over 64 games for at most ``TWOPLY_PLIES`` plies; exact
    launch counts of every kernel for the plies that each played."""
    out = {}
    for pair, games, plies in ARENA_PAIRS:
        res = run_arena(movegen, arena, league, twoply, cfg, dev, pair,
                        games, plies)
        out[pair] = res
        arena_log(pair, res)
    wr = out["oneply:pubeval"]["win_rate_a"]
    check(out["oneply:pubeval"]["finished"] == 512,
          "1-ply vs pubeval: not every game finished in 400 plies")
    check(abs(wr - JAX_ONEPLY_VS_HEURISTIC) <= WIN_RATE_BAND,
          f"1-ply frozen_v1 vs pubeval: win rate {wr}, JAX "
          f"{JAX_ONEPLY_VS_HEURISTIC} +- {WIN_RATE_BAND}")
    return out


def bf16_eval_phase(torch, movegen, twoply, perf_twoply, arena, league,
                    cfg, model, dev):
    """frozen_v1 computing in bfloat16 (``compute_dtype``), the afterstate
    kernels' bf16 form: one 2-ply decision at B=256, reply width 512, with
    exact launch counts, its kernel path against the afterstate pass's
    plain path on the card (backup scores within AFTERSTATE_BF16_TOL of
    their size, at least 1; actions equal where the best score leads by
    more than twice that; the +-1e9 of a game without moves or replies
    exact); the score-head policy's logits (one launch) against the plain
    path within the same gate; then the league's 1-ply against the pubeval
    heuristic over 512 games, its win rate recorded (no gate)."""
    import copy

    from mlp_ppo_2ply_p3_tpu_torch import ops

    bmodel = copy.deepcopy(model)
    bmodel.cfg = dataclasses.replace(model.cfg, compute_dtype="bfloat16")
    state = perf_twoply.realistic_state(cfg.env, 256, 12, device=dev)
    scfg = dataclasses.replace(cfg.search, reply_max_moves=512)
    inner, margins = twoply.candidate_scores, []

    def recorded(*a, **kw):
        top_idx, score2, ovf = inner(*a, **kw)
        top2 = torch.topk(score2, 2, dim=1).values
        margins.append(top2[:, 0] - top2[:, 1])
        return top_idx, score2, ovf

    zero_launches()
    twoply.candidate_scores = recorded
    try:
        got = twoply.twoply_actions_values(bmodel, state, scfg)
    finally:
        twoply.candidate_scores = inner
    torch.cuda.synchronize()
    counted = launches()
    expect = with_optimizer(dict(zip(
        ops.KERNELS, twoply.launches_per_decision(state.turn.shape[0],
                                                  scfg))))
    check(counted == expect, f"bf16 2-ply decision: launches {counted}, "
          f"expected {expect}")
    with Capture(plain=True, kernels=kernel_groups()[1]):
        plain = twoply.twoply_actions_values(bmodel, state, scfg)
    # the +-1e9 of a game without moves or replies must match exactly
    special = plain[1].abs() >= twoply.POS_INF / 2
    check(same(got[1][special], plain[1][special]),
          "bf16 2-ply backup: the +-1e9 entries differ")
    values = plain[1][~special]
    tol = AFTERSTATE_BF16_TOL * max(
        1.0, float(values.abs().max()) if values.numel() else 1.0)
    diff = float((got[1] - plain[1])[~special].abs().max()) \
        if values.numel() else 0.0
    check(diff <= tol, f"bf16 2-ply backup: afterstate kernel and plain "
          f"differ by {diff} (gate {tol})")
    decided = margins[0] > 2 * tol
    check(same(got[0][decided], plain[0][decided]),
          "bf16 2-ply actions: afterstate kernel != plain")
    out = {"batch": 256, "reply_max_moves": 512, "launches": counted,
           "max_backup_diff": diff, "tol": tol,
           "clear_margin_games": int(decided.sum())}
    log(f"bf16 2-ply B=256 reply width 512: backups within {diff:.2e} of "
        f"the plain path (gate {tol:.2e}), actions equal on "
        f"{out['clear_margin_games']} games with a clear margin")
    # the score-head policy's logits (agents/basic.py), one launch
    from mlp_ppo_2ply_p3_tpu_torch.agents import basic

    zero_launches()
    with torch.no_grad():
        got = basic.afterstate_policy_logits(bmodel, state)
        torch.cuda.synchronize()
        check(launches() == with_optimizer(dict(zip(
                  ops.KERNELS, afterstate_launches(fwd=1)))),
              f"bf16 score-head policy: launches {launches()}")
        with Capture(plain=True, kernels=kernel_groups()[1]):
            plain = basic.afterstate_policy_logits(bmodel, state)
    special = plain == basic.NEG_INF
    kept = plain[~special]
    tol = AFTERSTATE_BF16_TOL * max(
        1.0, float(kept.abs().max()) if kept.numel() else 1.0)
    diff = float((got - plain)[~special].abs().max()) if kept.numel() \
        else 0.0
    check(same(got[special], plain[special]) and diff <= tol,
          f"bf16 score-head policy logits: kernel and plain differ by "
          f"{diff} (gate {tol})")
    out["policy_logits_max_diff"] = diff
    res = run_arena(movegen, arena, league, twoply, cfg, dev,
                    "oneply:pubeval", 512, 400, model=bmodel)
    out["oneply:pubeval"] = res
    arena_log("oneply:pubeval", res, "bf16 arena ")
    return out


# --- phase 7: the training driver --------------------------------------------

# the JAX driver's league keys (mlp_ppo_2ply_p3_tpu/ppo/train.py:84-122)
LEAGUE_KEYS = {
    f"league/{stat}_vs_{tag}"
    for stat in ("win_rate", "finished", "points_a", "points_b",
                 "point_margin", "avg_plies")
    for tag in ("heuristic", "frozen_v1")
} | {"league/win_rate_vs_baseline"}
LEAGUE_PLIES = 400


class Timed:
    """Replaces ``module.name`` with a wrapper that records each call's
    seconds (the card synchronised at the end) and result; restores it on
    exit."""

    def __init__(self, torch, module, name):
        self.torch, self.module, self.name = torch, module, name
        self.calls = []

    def __enter__(self):
        inner = self.inner = getattr(self.module, self.name)

        def wrapper(*a, **kw):
            t0 = time.time()
            out = inner(*a, **kw)
            self.torch.cuda.synchronize()
            self.calls.append((time.time() - t0, out))
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def driver_run(torch, arena, train_mod, cfg, dev, **kw):
    """One ``train`` call on the card, its stdout sent to stderr; returns
    (TrainState, EnvState, the launches of every kernel, the arenas'
    plies)."""
    import contextlib

    inner, plies = arena._ply, [0]

    def counted_ply(*a, **k):
        plies[0] += 1
        return inner(*a, **k)

    zero_launches()
    arena._ply = counted_ply
    try:
        with contextlib.redirect_stdout(sys.stderr):
            ts, es, _, _ = train_mod.train(cfg, device=dev, **kw)
    finally:
        arena._ply = inner
    torch.cuda.synchronize()
    return ts, es, launches(), plies[0]


def state_tensors(ts, es):
    """Every tensor of a train state and env state, and the generator's
    state (on the host), by name."""
    out = {f"param {n}": p.detach()
           for n, p in ts.model.named_parameters()}
    out.update({f"adam mu {i}": m for i, m in enumerate(ts.opt_state.mu)})
    out.update({f"adam nu {i}": v for i, v in enumerate(ts.opt_state.nu)})
    out.update({"adam count": ts.opt_state.count,
                "update_idx": ts.update_idx, "episodes": ts.episodes,
                "generator": ts.gen.get_state()})
    out.update({f"env {f}": x for f, x in zip(es._fields, es)})
    return out


def trainer_phase(torch, movegen, arena, train_mod, ckpt, cfg,
                  dev):
    """``ppo.train.train`` on the card at ``cfg``, in a temporary
    directory with a ``file://`` store:

    - run A: 3 updates from scratch, a checkpoint every update, the league
      eval every 2 (one eval, after update 1);
    - run B: 2 updates from scratch with the same seed, its local
      checkpoints wiped, then ``resume=True`` to 3 updates, which must
      pull ``ckpt_2`` from the store;

    B's final state must equal A's bit for bit, every kernel's
    launches must match every train() call exactly, the league metrics must have
    the JAX driver's keys with win rates in [0, 1] and games finished,
    and every loss must be finite."""
    import shutil
    import tempfile

    per_step = per_call_launches(movegen, cfg.env.movegen)
    t = cfg.ppo.t_horizon
    out = {"t_horizon": t, "batch": cfg.ppo.num_envs}
    with tempfile.TemporaryDirectory() as tmp:
        def run_cfg(tag, updates):
            return dataclasses.replace(
                cfg, num_updates=updates, checkpoint_every=1, eval_every=2,
                checkpoint_dir=os.path.join(tmp, tag, "ckpts"),
                metrics_path=os.path.join(tmp, tag, "metrics.jsonl"),
                remote_url="file://" + os.path.join(tmp, tag, "store"))

        def check_launches(label, counted, plies, updates, evals):
            check(plies == 2 * LEAGUE_PLIES * evals,
                  f"{label}: {plies} arena plies, expected "
                  f"{2 * LEAGUE_PLIES * evals}")
            # the first reset, T env steps per update, and per eval two
            # arenas of a reset and 400 plies: one movegen call each; the
            # frozen_v1 arena's greedy 1-ply side one afterstate pass a ply;
            # every update's epochs x minibatches optimizer steps
            calls = 1 + updates * t + evals * 2 * (1 + LEAGUE_PLIES)
            expect = with_optimizer(
                {k: calls * v for k, v in per_step.items()},
                updates * cfg.ppo.num_epochs * cfg.ppo.num_minibatches)
            expect["afterstate_eval"] = evals * LEAGUE_PLIES
            check(counted == expect,
                  f"{label}: launches {counted}, expected {expect}")

        cfg_a = run_cfg("a", 3)
        with Timed(torch, train_mod, "league_eval") as ev_timer, \
                Timed(torch, ckpt, "save") as save_timer:
            ts_a, es_a, counted_a, plies_a = driver_run(
                torch, arena, train_mod, cfg_a, dev,
                resume=False)
        check_launches("run A", counted_a, plies_a, 3, 1)
        lines = [json.loads(x) for x in open(cfg_a.metrics_path)]
        check([r["step"] for r in lines] == [0, 1, 2],
              f"run A logged steps {[r['step'] for r in lines]}")
        for r in lines:
            for k in LOSS_KEYS:
                check(math.isfinite(r[k]), f"run A update {r['step']}: "
                      f"{k} = {r[k]}")
        league = {k: v for k, v in lines[1].items()
                  if k.startswith("league/")}
        check(set(league) == LEAGUE_KEYS,
              f"league keys {sorted(league)} != the JAX driver's")
        for tag in ("heuristic", "frozen_v1", "baseline"):
            wr = league[f"league/win_rate_vs_{tag}"]
            check(0.0 <= wr <= 1.0, f"win rate vs {tag}: {wr}")
        for tag in ("heuristic", "frozen_v1"):
            check(league[f"league/finished_vs_{tag}"] > 0,
                  f"no league game vs {tag} finished in 400 plies")

        cfg_b = run_cfg("b", 2)
        _, _, counted_b1, plies_b1 = driver_run(
            torch, arena, train_mod, cfg_b, dev, resume=False)
        check_launches("run B, updates 0-1", counted_b1, plies_b1, 2, 1)
        shutil.rmtree(os.path.join(tmp, "b", "ckpts"))
        with Timed(torch, train_mod, "_pull_remote_latest") as pull, \
                Timed(torch, ckpt, "restore") as restore:
            ts_b, es_b, counted_b2, plies_b2 = driver_run(
                torch, arena, train_mod,
                dataclasses.replace(cfg_b, num_updates=3), dev, resume=True)
        check_launches("run B, resumed to 3", counted_b2, plies_b2, 1, 0)
        check(len(pull.calls) == 1 and str(pull.calls[0][1]).endswith(
            "ckpt_2.npz"), f"run B did not pull ckpt_2: {pull.calls}")

        want, got = state_tensors(ts_a, es_a), state_tensors(ts_b, es_b)
        check(list(want) == list(got), "train states differ in structure")
        for k in want:
            check(want[k].dtype == got[k].dtype and bool(
                torch.equal(want[k], got[k])),
                f"resumed run != uninterrupted run in {k}")
        ckpt_mb = os.path.getsize(save_timer.calls[-1][1]) / 1e6
        lines_b = [json.loads(x) for x in open(cfg_b.metrics_path)]
        out.update({
            "launches": counted_a,
            "launches_run_b": [counted_b1, counted_b2],
            "update_time_s": [r["update_time_s"] for r in lines],
            "steps_per_sec": [r["steps_per_sec"] for r in lines],
            "update_time_s_run_b": [r["update_time_s"] for r in lines_b],
            "steps_per_sec_run_b": [r["steps_per_sec"] for r in lines_b],
            "league_eval_s": ev_timer.calls[0][0],
            "league": league,
            "checkpoint_save_s": [s for s, _ in save_timer.calls],
            "checkpoint_mb": ckpt_mb,
            "checkpoint_restore_s": restore.calls[0][0],
            "remote_pull_s": pull.calls[0][0],
            "losses": {k: lines[-1][k] for k in ("loss", "policy_loss",
                                                 "value_loss", "entropy")},
        })
    return out


# --- phase 8: data-parallel training -----------------------------------------

DP_RANKS = 2
DP_T = 16              # the pod preset's T=128, cut
DP_UPDATES = 2
DP_TIMEOUT = 300       # seconds for the ranks' whole run
# Ranks vs one process after update 1: the norm of the difference over
# the norm of the single run's, for the update (parameters after update 1
# less the initial ones) and Adam's two moments.  The ranks sum each
# minibatch's gradient in another order, and an update is 4 epochs x 32
# minibatches of Adam steps under PPO's clipping, which amplify rounding
# into differences of several percent, while a fault such as a missing
# gradient all-reduce moves them by tens of percent.  The phase measures
# that amplification on the card: the single run once more, every
# parameter moved by one ulp before update 1 (``nudged``).  The ranks
# may differ by at most DP_FLOOR_FACTOR times as much.
DP_FLOOR_FACTOR = 4.0
# losses, absolute (relative above 1): update 1 runs the same rollout;
# update 2's rollout starts from the parameters above, so some actions
# differ
DP_LOSS_TOL = (1e-4, 2e-3)


def dp_cfg(get_preset, tmp, tag):
    """The ``pod`` preset (B=16384, M=256, hidden 128, default movegen
    widths, 32 minibatches) cut in depth: T=16, 2 updates with a
    checkpoint after each, no league eval, in ``tmp/tag``."""
    cfg = get_preset("pod")
    return dataclasses.replace(
        cfg, ppo=dataclasses.replace(cfg.ppo, t_horizon=DP_T),
        num_updates=DP_UPDATES, checkpoint_every=1, eval_every=0,
        checkpoint_dir=os.path.join(tmp, tag, "ckpts"),
        metrics_path=os.path.join(tmp, tag, "metrics.jsonl"))


def dp_worker(rank, size, port, tmp) -> int:
    """One rank of phase 8 (``--dp-worker``): joins a gloo group with the
    other ranks on cuda:0, runs ``ppo.train.train`` at ``dp_cfg`` and
    writes its kernels' launches to ``tmp/rank<r>.json``."""
    import contextlib

    import torch

    sys.path.insert(0, HERE)
    from mlp_ppo_2ply_p3_tpu_torch.parallel import mesh
    from mlp_ppo_2ply_p3_tpu_torch.ppo import train as train_mod
    from mlp_ppo_2ply_p3_tpu_torch.utils.config import get_preset

    torch.backends.cuda.matmul.allow_tf32 = False
    world = mesh.initialize_distributed(f"localhost:{port}", size, rank,
                                        backend="gloo", device="cuda")
    check(world is not None and world.size == size, f"rank {rank}: no "
          f"process group of {size}")
    try:
        zero_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            train_mod.train(dp_cfg(get_preset, tmp, "dp"), resume=False,
                            device="cuda", world=world)
        torch.cuda.synchronize()
        out = {"rank": rank, "device": str(world.device),
               "launches": launches(), "wall_s": time.time() - t0}
    finally:
        mesh.shutdown()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(tmp, size):
    """``size`` ranks of ``dp_worker`` at once, each one's output in a log
    file of its own; every one must exit 0 within DP_TIMEOUT."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in (
        "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs, logs = [], []
    try:
        for r in range(size):
            logs.append(os.path.join(tmp, f"rank{r}.log"))
            with open(logs[-1], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--dp-worker", str(r), str(size), str(port), tmp],
                    stdout=f, stderr=subprocess.STDOUT, env=env))
        for p in procs:
            p.wait(timeout=DP_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"data-parallel rank {r} exited "
              f"{p.returncode}:\n{open(log).read()[-6000:]}")
    return [json.load(open(os.path.join(tmp, f"rank{r}.json")))
            for r in range(size)]


def compare_checkpoints(np, path_a, path_b, init):
    """Two checkpoints of the same global state: every integer array
    (the env, the generator, the counters) and the fingerprint equal.
    Returns, for the parameters' update from ``init`` (name -> array) and
    Adam's moments, the norm of the difference over ``path_b``'s norm."""
    sq = {k: [0.0, 0.0] for k in ("update", "mu", "nu")}  # diff, reference
    with np.load(path_a) as a, np.load(path_b) as b:
        check(sorted(a.files) == sorted(b.files),
              "data-parallel and single checkpoints hold other arrays")
        for k in a.files:
            x, y = a[k], b[k]
            check(x.shape == y.shape and x.dtype == y.dtype,
                  f"checkpoint {k}: {x.shape} {x.dtype} vs {y.shape} "
                  f"{y.dtype}")
            if x.dtype.kind != "f":
                diff = int((x != y).sum())
                games = (int((x != y).reshape(x.shape[0], -1).any(1).sum())
                         if k.startswith("env/") else diff)
                check(diff == 0, f"after update 1, {k}: {diff} elements "
                      f"({games} games) differ between the ranks and the "
                      f"single-process run")
            else:
                kind = ("update" if k.startswith("model/")
                        else k.split("/")[1])
                ref = y - init[k[len("model/"):]] if kind == "update" else y
                sq[kind][0] += float(np.square(x - y, dtype=np.float64).sum())
                sq[kind][1] += float(np.square(ref, dtype=np.float64).sum())
    return {kind: math.sqrt(d / r) for kind, (d, r) in sq.items()}


def nudged(torch, ppo_update):
    """``ppo_update`` with every parameter moved up by one ulp first."""
    def run(ts, *a, **k):
        with torch.no_grad():
            for p in ts.model.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
        return ppo_update(ts, *a, **k)

    return run


def dp_phase(torch, movegen, learner, train_mod, get_preset,
             dev):
    """Phase 8: ``DP_RANKS`` gloo ranks sharing the card run the driver at
    ``dp_cfg`` (8192 games a rank); the same config runs in this process
    unsharded.  After update 1 the two checkpoints (each the global
    state) agree: every integer, the generator and the env exactly,
    the parameters' update and Adam's moments within ``DP_FLOOR_FACTOR``
    times the difference that a one-ulp nudge makes in one process; the
    losses of both updates within ``DP_LOSS_TOL``; every rank and the
    single run launch every kernel exactly (the first reset and T
    movegen calls an update)."""
    import contextlib
    import tempfile

    import numpy as np

    pod = get_preset("pod")
    mg = pod.env.movegen
    calls = 1 + DP_UPDATES * DP_T
    expect = with_optimizer(
        {k: calls * v for k, v in per_call_launches(movegen, mg).items()},
        DP_UPDATES * pod.ppo.num_epochs * pod.ppo.num_minibatches)
    out = {"ranks": DP_RANKS, "batch": pod.ppo.num_envs,
           "batch_per_rank": pod.ppo.num_envs // DP_RANKS,
           "t_horizon": DP_T, "updates": DP_UPDATES, "backend": "gloo"}
    # the ranks are other processes: hand them the memory cached here
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        ranks = run_ranks(tmp, DP_RANKS)
        out["ranks_wall_s"] = time.time() - t0
        cfg = dp_cfg(get_preset, tmp, "single")
        zero_launches()
        t0 = time.time()
        with contextlib.redirect_stdout(sys.stderr):
            train_mod.train(cfg, resume=False, device=dev, shard=False)
        torch.cuda.synchronize()
        out["single_wall_s"] = time.time() - t0
        single = launches()
        for label, counted in [(f"rank {r['rank']}", r["launches"])
                               for r in ranks] + [("single", single)]:
            check(counted == expect, f"data-parallel phase, {label}: "
                  f"launches {counted}, expected {expect}")
        out["launches"] = {f"rank{r['rank']}": r["launches"] for r in ranks}
        out["launches"]["single"] = single
        # the rounding floor: the single run again, nudged, one update
        inner = learner.ppo_update
        learner.ppo_update = nudged(torch, inner)
        try:
            with contextlib.redirect_stdout(sys.stderr):
                train_mod.train(dp_cfg(get_preset, tmp, "nudged"),
                                resume=False, updates=1, device=dev,
                                shard=False)
        finally:
            learner.ppo_update = inner
        init = {n: p.detach().cpu().numpy() for n, p in
                learner.init_train_state(cfg.seed, cfg.model, cfg.ppo,
                                         device=dev).model.named_parameters()}
        ckpt_1 = {tag: os.path.join(tmp, tag, "ckpts", "pod", "ckpt_1.npz")
                  for tag in ("dp", "single", "nudged")}
        out["rel_diff"] = compare_checkpoints(np, ckpt_1["dp"],
                                              ckpt_1["single"], init)
        out["nudged_rel_diff"] = compare_checkpoints(
            np, ckpt_1["nudged"], ckpt_1["single"], init)
        log(f"data-parallel phase, after update 1, norm of the difference "
            f"over the single run's: ranks {out['rel_diff']}, one process "
            f"nudged by one ulp {out['nudged_rel_diff']}")
        for kind, rel in out["rel_diff"].items():
            bound = DP_FLOOR_FACTOR * out["nudged_rel_diff"][kind]
            check(rel <= bound, f"after update 1 the ranks' {kind} differs "
                  f"from one process's by {rel:.4f} of its norm > {bound:.4f}"
                  f" ({DP_FLOOR_FACTOR} x a one-ulp nudge's)")
        dp_lines = [json.loads(x) for x in open(
            os.path.join(tmp, "dp", "metrics.jsonl"))]
        single_lines = [json.loads(x) for x in open(cfg.metrics_path)]
    check(len(dp_lines) == len(single_lines) == DP_UPDATES,
          f"metrics: {len(dp_lines)} and {len(single_lines)} lines")
    # statistics of the env alone, over the gathered rollout
    for k in ("episodes_finished", "movegen_overflow", "mean_reward"):
        check(dp_lines[0][k] == single_lines[0][k], f"update 1 {k}: "
              f"{dp_lines[0][k]} vs {single_lines[0][k]}")
    out["loss_max_abs_diff"] = [0.0, 0.0]
    for i, (a, b) in enumerate(zip(dp_lines, single_lines)):
        for k in LOSS_KEYS:
            check(math.isfinite(a[k]), f"data-parallel {k} = {a[k]}")
            d = abs(a[k] - b[k])
            out["loss_max_abs_diff"][i] = max(out["loss_max_abs_diff"][i], d)
            check(d <= DP_LOSS_TOL[i] * max(1.0, abs(b[k])),
                  f"update {a['step']} {k}: ranks {a[k]}, single {b[k]}")
    for tag, lines in (("dp", dp_lines), ("single", single_lines)):
        out[f"{tag}_update_time_s"] = [r["update_time_s"] for r in lines]
        out[f"{tag}_steps_per_sec"] = [r["steps_per_sec"] for r in lines]
    return out


def nccl_phase(torch, movegen, bg_env, learner, mesh, perf_twoply, cfg,
               pod, dev):
    """A 1-rank NCCL group on the card: ``all_reduce_sum`` and
    ``gather_batch`` of CUDA tensors are the identity, and one
    ``train_step`` (B=64, T=8, full width) through the sharded code ==
    the plain ``train_step`` bit for bit.  Then one rank's movegen call
    at ``pod`` (8192 games: the sub-batches a rank of phase 8 holds) is
    held call by call against the plain versions, and whole against the
    CPU.  Returns (the sharded
    step's launches, that movegen report)."""
    import torch.distributed as dist

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        world = mesh.World(0, 1, dev, "nccl")
        gen = torch.Generator(device=dev)
        gen.manual_seed(9)
        x = torch.rand((64, 7), generator=gen, device=dev)
        ints = torch.randint(-9, 9, (64, 3), generator=gen, device=dev,
                             dtype=torch.int32)
        flags = x[:, 0] < 0.5
        for got, want in zip(mesh.all_reduce_sum([x, ints, flags, x[0]],
                                                 world),
                             [x, ints, flags, x[0]]):
            check(got.device == dev and same(got, want),
                  "NCCL all_reduce_sum of one rank is not the identity")
        got = mesh.gather_batch((x, (ints, flags), None), world)
        check(got[2] is None and all(same(a, b) for a, b in zip(
            (got[0], *got[1]), (x, ints, flags))),
            "NCCL gather_batch of one rank is not the identity")
        got = mesh.gather_batch((x, ints), world, dim=1)
        check(same(got[0], x) and same(got[1], ints),
              "NCCL gather_batch of one rank (dim 1) is not the identity")
        ppo = dataclasses.replace(cfg.ppo, num_envs=64, t_horizon=8,
                                  num_minibatches=4)

        def step(w):
            ts = learner.init_train_state(0, cfg.model, ppo, device=dev)
            start = bg_env.reset(torch.Generator(device=dev).manual_seed(2),
                                 cfg.env, 64, device=dev, world=w)
            ts, es, m = learner.train_step(ts, start, cfg.env, cfg.model,
                                           ppo, world=w)
            return state_tensors(ts, es), m

        plain, plain_m = step(None)
        zero_launches()
        sharded, sharded_m = step(world)
        torch.cuda.synchronize()
        counted = launches()
        per_rank = movegen_batches_phase(
            torch, movegen, perf_twoply,
            [("pod, one rank's shard", pod.env,
              pod.ppo.num_envs // DP_RANKS)], dev, world)
    finally:
        dist.destroy_process_group()
    for k in plain:
        check(plain[k].dtype == sharded[k].dtype and bool(
            torch.equal(plain[k], sharded[k])),
            f"NCCL world of one: {k} differs from the plain train_step")
    for k in plain_m:
        check(bool(torch.equal(plain_m[k], sharded_m[k])),
              f"NCCL world of one: metric {k} differs")
    calls = 1 + ppo.t_horizon
    expect = with_optimizer(
        {k: calls * v
         for k, v in per_call_launches(movegen, cfg.env.movegen).items()},
        ppo.num_epochs * ppo.num_minibatches)
    check(counted == expect, f"NCCL world of one: launches {counted}, "
          f"expected {expect}")
    return counted, per_rank


# --- phase 9: 2-ply distillation ---------------------------------------------

DISTILL_PLIES = 8          # the script's 48, cut
DISTILL_EVAL_GAMES = 128   # the script's 512, cut
DISTILL_ENVS = 256         # the script's default
DISTILL_KEYS = {"iter", "states", "loss", "ce", "value_mse",
                "win_rate_vs_frozen", "finished", "collect_s", "train_s"}
DISTILL_LR = 3e-4


def distill_agreement(torch, np, twoply, learner, bg_env, frozen,
                      run_distill, env_cfg, scfg, dev):
    """A 2-ply ``collect`` of 2 plies at 16 games and one ``make_update``
    step on its 32 states, on the card and on the CPU from the same net
    and draws: actions equal where the best 2-ply score leads by more
    than 1e-4, states exact, backups within 1e-4 (phase 6's bound);
    losses within 1e-5; Adam's first moment (0.1 x the gradient) within
    1e-5 of the model's largest entry (the two devices sum in other
    orders, and an entry near zero, such as the score head's bias, whose
    exact gradient is zero, is a sum of much larger terms); parameters
    within 1e-6, or 2 lr where the first moment is within 10 times that
    bound of zero: Adam's first step is lr g / (|g| + 1e-8), which there
    may take either sign."""
    games, plies = 16, 2
    model_g, _ = frozen.load_frozen(device=dev)
    model_c, _ = frozen.load_frozen(device="cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    start = bg_env.reset(gen, env_cfg, games, device=dev)
    rec = RecordingSampler(learner, gen)
    margins, inner = [], twoply.candidate_scores

    def recorded(*a, **kw):
        top_idx, score2, ovf = inner(*a, **kw)
        top2 = torch.topk(score2, 2, dim=1).values
        margins.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
        return top_idx, score2, ovf

    twoply.candidate_scores = recorded
    try:
        buf_g, _ = run_distill.collect(model_g, start, rec, env_cfg, scfg,
                                       plies)
    finally:
        twoply.candidate_scores = inner
    buf_c, _ = run_distill.collect(
        model_c, bg_env.EnvState(*(x.cpu() for x in start)),
        ReplaySampler(rec, torch.device("cpu")), env_cfg, scfg, plies)
    clear = np.concatenate(margins) > 1e-4
    backup_diff, compared = 0.0, 0
    for p in range(plies):
        rows = slice(p * games, (p + 1) * games)
        for k in ("obs", "after", "n_moves", "turn"):
            check(np.array_equal(buf_g[k][rows], buf_c[k][rows]),
                  f"distill collect ply {p}: {k} card != CPU")
        check(np.array_equal(buf_g["action"][rows][clear[rows]],
                             buf_c["action"][rows][clear[rows]]),
              f"distill collect ply {p}: actions card != CPU")
        backup_diff = max(backup_diff, float(np.abs(
            buf_g["target_v"][rows] - buf_c["target_v"][rows]).max()))
        compared += 1
        if not np.array_equal(buf_g["action"][rows], buf_c["action"][rows]):
            break    # a near tie went another way: the games part here
    check(backup_diff <= 1e-4, f"distill backups: card and CPU differ by "
          f"{backup_diff}")

    m = env_cfg.max_moves
    mb = tuple(buf_g[k] for k in run_distill.KEYS)
    out = []
    for where, model in ((dev, model_g), (torch.device("cpu"), model_c)):
        update = run_distill.make_update(model, m, DISTILL_LR, 1.0, 1.0)
        state, *losses = update(learner.init_optimizer(model),
                                tuple(torch.from_numpy(x).to(where)
                                      for x in mb))
        out.append((state, [float(x) for x in losses],
                    {n: p.detach().cpu().numpy()
                     for n, p in model.named_parameters()}))
    (s_g, l_g, p_g), (s_c, l_c, p_c) = out
    loss_diff = max(abs(a - b) for a, b in zip(l_g, l_c))
    check(loss_diff <= 1e-5 * max(1.0, max(abs(x) for x in l_c)),
          f"distill update: losses {l_g} on the card, {l_c} on the CPU")
    mu_diff, param_diff = 0.0, 0.0
    bound = 1e-5 * max(float(m.abs().max()) for m in s_c.mu)
    for (name, pg), mg_, mc in zip(p_g.items(), s_g.mu, s_c.mu):
        mg_, mc = mg_.cpu().numpy(), mc.numpy()
        check(bool((np.abs(mg_ - mc) <= bound).all()),
              f"distill update: first moment of {name} card != CPU by "
              f"{float(np.abs(mg_ - mc).max())} > {bound}")
        mu_diff = max(mu_diff, float(np.abs(mg_ - mc).max()))
        noisy = np.abs(mc) < 10 * bound
        diff = np.abs(pg - p_c[name])
        check(bool((diff <= np.where(noisy, 2 * DISTILL_LR, 1e-6)).all()),
              f"distill update: {name} card != CPU by {float(diff.max())}")
        param_diff = max(param_diff, float(diff[~noisy].max(initial=0.0)))
    return {"games": games, "plies_compared": compared,
            "clear_margin_decisions": int(clear.sum()),
            "decisions": int(clear.size), "max_backup_diff": backup_diff,
            "max_loss_diff": loss_diff, "max_first_moment_diff": mu_diff,
            "max_param_diff": param_diff}


def distill_phase(torch, movegen, twoply, arena, learner, bg_env,
                  frozen, run_distill, dev):
    """Phase 9: ``scripts/run_distill.main`` on the card, frozen_v1 at the
    script's 256 games, one iteration of ``DISTILL_PLIES`` plies and two
    league evals of ``DISTILL_EVAL_GAMES`` games: the JAX record's keys,
    finite losses, exact launches; the afterstate pass's distinct calls
    and the first optimizer step (clipping off) checked and timed on their
    own inputs; then ``distill_agreement``."""
    import contextlib
    import tempfile

    import numpy as np

    from mlp_ppo_2ply_p3_tpu_torch import ops
    from mlp_ppo_2ply_p3_tpu_torch.core import features
    from mlp_ppo_2ply_p3_tpu_torch.ops import adam, afterstate
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling
    from mlp_ppo_2ply_p3_tpu_torch.core.movegen import MovegenConfig
    from mlp_ppo_2ply_p3_tpu_torch.utils.config import SearchConfig

    env_cfg = bg_env.EnvConfig(movegen=MovegenConfig.fast(256))
    scfg = SearchConfig()
    inner, plies = arena._ply, [0]

    def counted_ply(*a, **k):
        plies[0] += 1
        return inner(*a, **k)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "distill.jsonl")
        zero_launches()
        arena._ply = counted_ply
        cap = Capture(distinct=True, copy=True,
                      kernels=(*kernel_groups()[1], ops.OPTIMIZER))
        t0 = time.time()
        try:
            with contextlib.redirect_stdout(sys.stderr), cap:
                records = run_distill.main([
                    "--iters", "1", "--plies", str(DISTILL_PLIES),
                    "--envs", str(DISTILL_ENVS), "--eval-games",
                    str(DISTILL_EVAL_GAMES), "--out", path, "--device",
                    "cuda"])
            torch.cuda.synchronize()
        finally:
            arena._ply = inner
        wall = time.time() - t0
        counted = launches()
        lines = [json.loads(x) for x in open(path)]
    check(len(lines) == 2 and lines == records,
          f"distill wrote {len(lines)} records")
    check(set(lines[0]) == {"iter", "win_rate_vs_frozen", "finished"},
          f"distill baseline record keys {sorted(lines[0])}")
    rec = lines[1]
    check(set(rec) == DISTILL_KEYS, f"distill record keys {sorted(rec)} != "
          f"the JAX script's")
    for k in ("loss", "ce", "value_mse"):
        check(math.isfinite(rec[k]), f"distill {k} = {rec[k]}")
    check(rec["states"] == DISTILL_PLIES * DISTILL_ENVS,
          f"distill states {rec['states']}")
    check(plies[0] == 2 * 400, f"distill evals played {plies[0]} plies")
    # the reset, each ply's env step and each eval's reset and plies list
    # every game's moves; each ply's 2-ply decision adds its own; each
    # update step (the script's 2 epochs of 1024-state minibatches) one
    # afterstate pass and its backward; both greedy 1-ply sides of the
    # evals one pass a ply
    mg = env_cfg.movegen
    calls = 1 + DISTILL_PLIES + 2 + plies[0]
    search = twoply.launches_per_decision(DISTILL_ENVS, scfg)
    updates = 2 * (DISTILL_PLIES * DISTILL_ENVS // 1024)
    train = afterstate_launches(fwd=updates + 2 * plies[0], bwd=updates)
    per = per_call_launches(movegen, mg)
    # and one optimizer step (clipping off: one kernel) an update step
    expect = with_optimizer(
        {name: calls * per[name] + DISTILL_PLIES * extra + more
         for name, extra, more in zip(ops.KERNELS, search, train)},
        updates)
    check(counted == expect, f"distill launches {counted}, expected {expect}")
    calls = cap.calls
    check(calls["afterstate_eval_backward"] and len(calls[ops.OPTIMIZER]) == 1,
          f"distill: {len(calls['afterstate_eval_backward'])} backward "
          f"shapes, {len(calls[ops.OPTIMIZER])} optimizer steps captured")
    fwd = [afterstate_measure(torch, afterstate, features, a,
                              f"distill {a[8]}")
           for a in calls["afterstate_eval"]]
    bwd = [afterstate_backward_measure(torch, afterstate, a,
                                       "distill minibatch")
           for a in calls["afterstate_eval_backward"]]
    step = adam_measure(torch, adam, profiling, calls[ops.OPTIMIZER][0],
                        "distill, clipping off")
    del cap, calls
    log_afterstate_rows("distill ", fwd)
    log_afterstate_rows("distill backward ", bwd)
    log_adam("distill ", step)
    agree = distill_agreement(torch, np, twoply, learner, bg_env, frozen,
                              run_distill, env_cfg, scfg, dev)
    return {"wall_s": wall, "records": lines, "launches": counted,
            "eval_plies": plies[0], "afterstate_calls": fwd,
            "afterstate_backward_calls": bwd, "adam": step,
            "agreement": agree}


# --- phase 10: the measuring entry points -----------------------------------

BENCH_UPDATES = 2
BENCH_TIMEOUT = 300    # seconds for the bench's process
BREAKDOWN_B = 4096
# the keys of the JAX package's scripts/perf_breakdown.py, under each width
BREAKDOWN_JAX_KEYS = (
    "movegen_ms", "movegen_nondoubles_ms", "movegen_doubles_subbatch_ms",
    "movegen_dedup_ms", "env_step_ms", "rollout_ms", "train_step_ms",
    "update_ms", "rollout_sps", "train_sps", "movegen_share_of_step")
BREAKDOWN_SCANS = ("movegen", "movegen_nondoubles",
                   "movegen_doubles_subbatch", "movegen_dedup")
# launches of one call of each timed movegen piece, by kernel (every other
# kernel none): the non-doubles kernel; the fused doubles levels and the
# final one; the non-doubles kernel alone, which holds the dedup
PIECE_LAUNCHES = {"movegen_nondoubles": {"nondoubles": 1},
                  "movegen_doubles_subbatch": {"doubles_level": 1,
                                               "doubles_final": 1},
                  "movegen_dedup": {"nondoubles": 1}}


def bench_run(movegen, bench, preset=None):
    """``python -m mlp_ppo_2ply_p3_tpu_torch.scripts.bench`` at its
    defaults (train4096's widths, T=64), or at ``BENCH_PRESET=preset``,
    with BENCH_UPDATES=2, in a process of its own: its stdout contract and
    its launches, which it logs to stderr."""
    settings = {"BENCH_PRESET": preset} if preset else {}
    env_cfg, _, ppo = bench.resolve_config(settings)
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(settings, BENCH_UPDATES=str(BENCH_UPDATES))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "mlp_ppo_2ply_p3_tpu_torch.scripts.bench"],
        cwd=HERE, env=env, capture_output=True, text=True,
        timeout=BENCH_TIMEOUT)
    wall = time.time() - t0
    check(proc.returncode == 0, f"bench exited {proc.returncode}:\n"
          f"{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) == BENCH_UPDATES,
          f"bench printed {len(lines)} lines for {BENCH_UPDATES} updates")
    last = json.loads(lines[-1])
    check(set(last) == {"metric", "value", "unit", "vs_baseline"}
          and last["metric"] == "env_steps_per_sec_per_chip"
          and last["unit"] == "steps/s", f"bench line {lines[-1]}")
    check(last["value"] > 0 and abs(last["vs_baseline"]
                                    - last["value"] / 1000) <= 0.0051,
          f"bench value {last['value']}, vs_baseline {last['vs_baseline']}")
    counted = None
    for line in proc.stderr.splitlines():
        if "] launches " in line:
            counted = json.loads(line.split("] launches ", 1)[1])
    expect = with_optimizer(
        {name: BENCH_UPDATES * per for name, per in
         train_step_launches(movegen, env_cfg, ppo).items()},
        BENCH_UPDATES * ppo.num_epochs * ppo.num_minibatches)
    check(counted == expect, f"bench launches {counted}, expected {expect}")
    updates = [float(x.split("update ", 1)[1].split(": ", 1)[1].split("s ")[0])
               for x in proc.stderr.splitlines() if "] update " in x]
    return {"wall_s": wall, "preset": preset or "train4096 widths",
            "t_horizon": ppo.t_horizon, "line": last,
            "update_s": updates, "launches": counted,
            "stderr_tail": proc.stderr[-3000:]}


def breakdown_run(torch, movegen, profiling, perf_breakdown,
                  mgs, card):
    """``perf_breakdown.main(["4096"])`` in this process: every JAX key
    and its twin under both widths, each time positive, each graph time
    at most 1.05 times its eager twin, both idle shares in [0, 1]; the
    launches of each ``timed_scan`` (counted at capture: the replays
    count none) show that its movegen piece went through its kernels;
    every update (``train_step``'s and the traced ones) took its epochs x
    minibatches optimizer steps."""
    import contextlib

    from mlp_ppo_2ply_p3_tpu_torch import ops

    learner = perf_breakdown.learner
    inner, scans = perf_breakdown.timed_scan, []
    inner_update, steps = learner.ppo_update, [0]

    def counted_scan(fn, *args, **kw):
        before = launches()
        out = inner(fn, *args, **kw)
        after = launches()
        scans.append({k: after[k] - before[k] for k in ops.KERNELS})
        return out

    def counted_update(ts, traj, last_value, last_turn, env_cfg, cfg,
                       *a, **k):
        steps[0] += cfg.num_epochs * cfg.num_minibatches
        return inner_update(ts, traj, last_value, last_turn, env_cfg, cfg,
                            *a, **k)

    zero_launches()
    perf_breakdown.timed_scan = counted_scan
    learner.ppo_update = counted_update
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(sys.stderr):
            (row,) = perf_breakdown.main([str(BREAKDOWN_B)])
        torch.cuda.synchronize()
    finally:
        perf_breakdown.timed_scan = inner
        learner.ppo_update = inner_update
    wall = time.time() - t0
    counted = launches()
    check(row["device"] == card, f"breakdown device {row['device']}")
    check(0 < steps[0] == counted[ops.OPTIMIZER],
          f"breakdown: the optimizer ran {counted[ops.OPTIMIZER]} times, its "
          f"updates took {steps[0]} steps")
    calls = 1 + profiling.SCAN_ITERS     # the warm-up, then the capture
    check(len(scans) == len(BREAKDOWN_SCANS) * len(mgs),
          f"breakdown ran {len(scans)} timed_scans")
    for (name, mg), got in zip(mgs, [scans[i:i + len(BREAKDOWN_SCANS)]
                                     for i in range(0, len(scans),
                                                    len(BREAKDOWN_SCANS))]):
        cell = row[name]
        per_call = dict(PIECE_LAUNCHES,
                        movegen=per_call_launches(movegen, mg))
        for key, counts in zip(BREAKDOWN_SCANS, got):
            want = {k: calls * per_call[key].get(k, 0) for k in ops.KERNELS}
            check(counts == want, f"breakdown {name} {key}: launches "
                  f"{counts} at capture, expected {want}")
            check(0 < cell[f"{key}_ms"] <= 1.05 * cell[f"{key}_eager_ms"],
                  f"breakdown {name} {key}: graph {cell[f'{key}_ms']} ms, "
                  f"eager {cell[f'{key}_eager_ms']} ms")
        twins = ([f"{k}_eager_ms" for k in BREAKDOWN_SCANS]
                 + [f"{k}_device_ms" for k in ("env_step", "rollout",
                                               "train_step", "update")]
                 + ["rollout_idle_share", "train_step_idle_share",
                    "movegen_device_share_of_step"])
        for key in BREAKDOWN_JAX_KEYS + tuple(twins):
            check(key in cell and cell[key] is not None,
                  f"breakdown {name}: no {key}")
            if key.endswith("_ms"):
                check(cell[key] > 0, f"breakdown {name}: {key} = {cell[key]}")
        for key in ("rollout_idle_share", "train_step_idle_share"):
            check(0 <= cell[key] <= 1, f"breakdown {name}: {key} = "
                  f"{cell[key]}")
    return {"wall_s": wall, "row": row, "launches": counted,
            "scan_launches": scans}


def measuring_phase(torch, movegen, profiling, bench,
                    perf_breakdown, card):
    """Phase 10: the bench in a process of its own, at its defaults and at
    ``afterstate4096``, then the breakdown at B=4096 in this one."""
    runs = [bench_run(movegen, bench), bench_run(movegen, bench,
                                                 "afterstate4096")]
    breakdown = breakdown_run(torch, movegen, profiling,
                              perf_breakdown, perf_breakdown.widths(), card)
    return {"bench": runs[0], "bench_afterstate4096": runs[1],
            "breakdown": breakdown}


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
    # one rank of phase 8, started by this script: RANK SIZE PORT DIR
    ap.add_argument("--dp-worker", nargs=4, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_script = time.time()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    if args.dp_worker:
        rank, size, port, tmp = args.dp_worker
        return dp_worker(int(rank), int(size), port, tmp)
    sys.path.insert(0, HERE)
    try:
        from mlp_ppo_2ply_p3_tpu_torch import ops
        from mlp_ppo_2ply_p3_tpu_torch.agents import (arena, frozen, league,
                                                      twoply)
        from mlp_ppo_2ply_p3_tpu_torch.core import features, movegen
        from mlp_ppo_2ply_p3_tpu_torch.env import bg_env
        from mlp_ppo_2ply_p3_tpu_torch.ops import afterstate, build, dense
        from mlp_ppo_2ply_p3_tpu_torch.parallel import mesh
        from mlp_ppo_2ply_p3_tpu_torch.ppo import learner
        from mlp_ppo_2ply_p3_tpu_torch.ppo import train as train_mod
        from mlp_ppo_2ply_p3_tpu_torch.scripts import bench as bench_mod
        from mlp_ppo_2ply_p3_tpu_torch.scripts import (
            perf_breakdown, perf_twoply, run_distill)
        from mlp_ppo_2ply_p3_tpu_torch.utils import checkpoint as ckpt
        from mlp_ppo_2ply_p3_tpu_torch.utils import profiling
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
    built = build.load_all()
    report["phases"]["build_s"] = time.time() - t0
    log(f"built {', '.join(f'{n}.cu' for n in built)} (one nvcc each, in "
        f"parallel) in {time.time() - t0:.1f}s")
    for name in built:
        log(f"{name}.cu: "
            f"{build.build_logs.get(name, '(already built)').strip()}")

    t0 = time.time()
    deep = deep_phase(torch, afterstate, dense, bg_env, learner, get_preset,
                      dev)
    deep["phase_s"] = time.time() - t0
    deep["dense_kernels"] = dense_resources(build)
    report["phases"]["deep"] = deep
    log_deep(deep)
    t0 = time.time()
    routed = routed_phase(torch, afterstate, bg_env, learner, get_preset,
                          dev)
    routed["phase_s"] = time.time() - t0
    report["phases"]["routed"] = routed
    log_routed(routed)

    cfg = get_preset("train4096")
    main_rows, mg_ms, mg_graph_ms = movegen_phase(
        torch, movegen, perf_twoply, profiling, cfg.env, dev)
    report["phases"]["movegen"] = {"ms_per_call": mg_ms,
                                   "graph_ms_per_call": mg_graph_ms,
                                   "calls": main_rows}
    log_rows("", main_rows)
    log(f"movegen B=4096: {mg_ms:.3f} ms/call ({mg_graph_ms:.3f} ms as a "
        f"CUDA graph), kernel path == plain path == CPU")
    # the league eval's and the arenas' movegen batches, B=4096 at the
    # default widths, and pod's B=16384
    eval_cfg = get_preset("twoply")
    pod = get_preset("pod")
    report["phases"]["movegen_batches"] = movegen_batches_phase(
        torch, movegen, perf_twoply,
        [("league eval", cfg.env, cfg.eval_games)]
        + [(f"arena {pair}", eval_cfg.env, games)
           for pair, games, _ in ARENA_PAIRS]
        + [("default widths", eval_cfg.env, 4096),
           ("pod", pod.env, pod.ppo.num_envs)], dev)

    t0 = time.time()
    report["phases"]["exact_order"] = exact_order_phase(
        torch, movegen, perf_twoply, bg_env, dev)
    log(f"exact_order movegen (parity widths) B=600: card == CPU on the "
        f"played dice and on doubles only, {time.time() - t0:.1f} s; "
        f"{json.dumps(report['phases']['exact_order'])}")

    for mode in ("index", "afterstate"):
        diff = small_agreement_phase(torch, bg_env, learner, cfg, dev, mode)
        report["phases"][f"small_train_step_max_param_diff_{mode}"] = diff
        log(f"train_step B=64 T=8 {mode}: card == CPU in every env integer, "
            f"parameters within {diff:.2e}")
    # the afterstate kernels at another width and in bf16
    for tag, model_cfg in (
            ("h64", dataclasses.replace(cfg.model, hidden_size=64)),
            ("bf16", dataclasses.replace(cfg.model,
                                         compute_dtype="bfloat16"))):
        diff = small_agreement_phase(torch, bg_env, learner, cfg, dev,
                                     "afterstate", model_cfg)
        report["phases"][
            f"small_train_step_max_param_diff_afterstate_{tag}"] = diff
        log(f"train_step B=64 T=8 afterstate {tag}: card == CPU in every "
            f"env integer, parameters within {diff:.2e}")

    t = args.t
    if t != cfg.ppo.t_horizon:
        log(f"reduced: t_horizon {cfg.ppo.t_horizon} -> {t}")
    main_path = train_phase(torch, movegen, bg_env, learner,
                            cfg, 4096, t, dev, timed=2)
    report["phases"]["train4096"] = main_path
    log(f"train4096 B=4096 T={t}: {main_path['train_step_s']:.3f} s/step, "
        f"{main_path['env_steps_per_s']:.0f} env-steps/s on {card}; "
        f"launches {main_path['launches']}; one more step: "
        f"rollout {main_path['rollout_s']:.3f} s, update "
        f"{main_path['update_s']:.3f} s")
    log_adam("train4096 ", main_path["adam"])
    # afterstate4096 at its own widths: B=4096, T=64, M=256, hidden 128
    after_cfg = get_preset("afterstate4096")
    t0 = time.time()
    after = train_phase(torch, movegen, bg_env, learner, after_cfg,
                        after_cfg.ppo.num_envs, after_cfg.ppo.t_horizon, dev,
                        timed=1, detail=(profiling, afterstate, features))
    report["phases"]["afterstate4096"] = after
    log(f"afterstate4096 B={after['batch']} T={after['t_horizon']}: "
        f"{after['train_step_s']:.3f} s/step, "
        f"{after['env_steps_per_s']:.0f} env-steps/s, peak "
        f"{after['peak_gb']:.2f} GB on {card}; rollout "
        f"{after['rollout_s']:.3f}"
        f" s (device {after['rollout_device_s']:.4f} s, idle "
        f"{after['rollout_idle_share']:.3f}), update {after['update_s']:.3f} s"
        f" (device {after['update_device_s']:.4f} s, idle "
        f"{after['update_idle_share']:.3f}); losses "
        f"{json.dumps({k: after['metrics'][k] for k in LOSS_KEYS})}"
        f"; launches {after['launches']}; phase {time.time() - t0:.1f} s")
    log_afterstate_rows("afterstate4096 ", after["afterstate_calls"])
    log_afterstate_rows("afterstate4096 backward ",
                        after["afterstate_backward_calls"])
    log_adam("afterstate4096 ", after["adam"])
    # the same preset at run_learning --hidden 512, and computing in bf16
    forms = {}
    for tag, model_cfg in (
            ("h512", dataclasses.replace(after_cfg.model, hidden_size=512)),
            ("bf16", dataclasses.replace(after_cfg.model,
                                         compute_dtype="bfloat16"))):
        t0 = time.time()
        run = train_phase(torch, movegen, bg_env, learner,
                          dataclasses.replace(after_cfg, model=model_cfg),
                          after_cfg.ppo.num_envs, after_cfg.ppo.t_horizon,
                          dev, timed=1,
                          detail=(profiling, afterstate, features))
        run["hidden"] = model_cfg.hidden_size
        run["compute_dtype"] = model_cfg.compute_dtype
        forms[tag] = run
        report["phases"][f"afterstate4096_{tag}"] = run
        log(f"afterstate4096 {tag} (hidden {model_cfg.hidden_size}, "
            f"{model_cfg.compute_dtype}): {run['train_step_s']:.3f} s/step, "
            f"peak {run['peak_gb']:.2f} GB on {card}; rollout device "
            f"{run['rollout_device_s']:.4f} s (idle "
            f"{run['rollout_idle_share']:.3f}), update device "
            f"{run['update_device_s']:.4f} s (idle "
            f"{run['update_idle_share']:.3f}); losses "
            f"{json.dumps({k: run['metrics'][k] for k in LOSS_KEYS})}; "
            f"launches {run['launches']}; phase {time.time() - t0:.1f} s")
        log_afterstate_rows(f"afterstate4096 {tag} ", run["afterstate_calls"])
        log_afterstate_rows(f"afterstate4096 {tag} backward ",
                            run["afterstate_backward_calls"])
        log_adam(f"afterstate4096 {tag} ", run["adam"])

    # the evaluation path: the twoply preset on the committed frozen_v1 net
    model, model_cfg = frozen.load_frozen(device=dev)
    check(model_cfg == eval_cfg.model, "frozen_v1 is not the twoply model")
    t0 = time.time()
    two = twoply_phase(torch, twoply, perf_twoply, bg_env, afterstate,
                       features, eval_cfg, model, dev)
    report["phases"]["twoply"] = two
    log(f"2-ply phase: {time.time() - t0:.1f} s")
    log(f"reduced: 2-ply vs 1-ply arena max_plies 400 -> {TWOPLY_PLIES}")
    t0 = time.time()
    arenas = arena_phase(torch, movegen, arena, league, twoply,
                         eval_cfg, dev)
    report["phases"]["arena"] = arenas
    log(f"arena phase: {time.time() - t0:.1f} s; 1-ply frozen_v1 vs pubeval "
        f"heuristic {arenas['oneply:pubeval']['win_rate_a']:.3f} over 512 "
        f"games (JAX {JAX_ONEPLY_VS_HEURISTIC})")
    # frozen_v1 computing in bf16: a 2-ply decision and the 1-ply league
    t0 = time.time()
    bf16_eval = bf16_eval_phase(torch, movegen, twoply, perf_twoply, arena,
                                league, eval_cfg, model, dev)
    report["phases"]["bf16_eval"] = bf16_eval
    log(f"bf16 evaluation phase: {time.time() - t0:.1f} s; 1-ply frozen_v1 "
        f"in bf16 vs pubeval heuristic "
        f"{bf16_eval['oneply:pubeval']['win_rate_a']:.3f} over 512 games "
        f"(float32 {arenas['oneply:pubeval']['win_rate_a']:.3f}, recorded "
        f"only)")

    # the training driver, at the preset's horizon
    t0 = time.time()
    trainer = trainer_phase(torch, movegen, arena, train_mod,
                            ckpt, cfg, dev)
    report["phases"]["trainer"] = trainer
    league = trainer["league"]
    log(f"trainer phase: {time.time() - t0:.1f} s; B=4096 "
        f"T={cfg.ppo.t_horizon}: "
        f"s/update {[round(x, 3) for x in trainer['update_time_s']]}, "
        f"env-steps/s {[round(x) for x in trainer['steps_per_sec']]} on "
        f"{card}; league_eval {trainer['league_eval_s']:.2f} s (vs "
        f"heuristic {league['league/win_rate_vs_heuristic']:.3f}, vs "
        f"frozen_v1 {league['league/win_rate_vs_frozen_v1']:.3f}); "
        f"checkpoint {trainer['checkpoint_mb']:.1f} MB, save "
        f"{[round(x, 3) for x in trainer['checkpoint_save_s']]} s, restore "
        f"{trainer['checkpoint_restore_s']:.3f} s, remote pull "
        f"{trainer['remote_pull_s']:.3f} s; resumed == uninterrupted bit "
        f"for bit; launches {trainer['launches']}")

    # data-parallel training: two gloo ranks on the card against one
    # process, the kernels at one rank's movegen call, a NCCL world of one
    t0 = time.time()
    dp = dp_phase(torch, movegen, learner, train_mod,
                  get_preset, dev)
    log(f"reduced: pod t_horizon {pod.ppo.t_horizon} -> {DP_T}, "
        f"{DP_UPDATES} updates, no league eval")
    dp["nccl_world1_launches"], dp["movegen_per_rank"] = nccl_phase(
        torch, movegen, bg_env, learner, mesh, perf_twoply, cfg, pod, dev)
    dp["phase_s"] = time.time() - t0
    report["phases"]["data_parallel"] = dp
    log(f"data-parallel phase: {dp['phase_s']:.1f} s; pod B={dp['batch']} "
        f"T={DP_T}: {DP_RANKS} gloo ranks of {dp['batch_per_rank']} games "
        f"== one process (env exact after update 1; relative to its norm "
        f"the update differs by {dp['rel_diff']['update']:.2e}, Adam's "
        f"moments by {dp['rel_diff']['mu']:.2e} and "
        f"{dp['rel_diff']['nu']:.2e}; a one-ulp nudge by "
        f"{dp['nudged_rel_diff']['update']:.2e}, "
        f"{dp['nudged_rel_diff']['mu']:.2e} and "
        f"{dp['nudged_rel_diff']['nu']:.2e}; losses "
        f"by {dp['loss_max_abs_diff'][0]:.2e} and "
        f"{dp['loss_max_abs_diff'][1]:.2e}); s/update ranks "
        f"{[round(x, 3) for x in dp['dp_update_time_s']]}, one process "
        f"{[round(x, 3) for x in dp['single_update_time_s']]}; env-steps/s "
        f"ranks {[round(x) for x in dp['dp_steps_per_sec']]}, one process "
        f"{[round(x) for x in dp['single_steps_per_sec']]} on {card} (two "
        f"ranks share this one card: not a scaling number); launches "
        f"{dp['launches']}; NCCL world of one == plain train_step bit for "
        f"bit")

    # 2-ply distillation on frozen_v1
    t0 = time.time()
    distill = distill_phase(torch, movegen, twoply, arena,
                            learner, bg_env, frozen, run_distill, dev)
    distill["phase_s"] = time.time() - t0
    report["phases"]["distill"] = distill
    rec, agree = distill["records"][1], distill["agreement"]
    log(f"reduced: distill plies 48 -> {DISTILL_PLIES}, eval games 512 -> "
        f"{DISTILL_EVAL_GAMES}")
    log(f"distill phase: {distill['phase_s']:.1f} s; {json.dumps(rec)}; "
        f"launches {distill['launches']}; card == CPU on 16 games x "
        f"{agree['plies_compared']} plies (backups within "
        f"{agree['max_backup_diff']:.1e}, update losses within "
        f"{agree['max_loss_diff']:.1e}, parameters within "
        f"{agree['max_param_diff']:.1e})")

    # the measuring entry points: the bench and the breakdown
    t0 = time.time()
    measuring = measuring_phase(torch, movegen, profiling,
                                bench_mod, perf_breakdown, card)
    measuring["phase_s"] = time.time() - t0
    report["phases"]["measuring"] = measuring
    bench, bd = measuring["bench"], measuring["breakdown"]
    bench_as = measuring["bench_afterstate4096"]
    log(f"measuring phase: {measuring['phase_s']:.1f} s; bench "
        f"({bench['wall_s']:.1f} s, B=4096 T={bench['t_horizon']}): "
        f"{json.dumps(bench['line'])}, updates {bench['update_s']} s, "
        f"launches {bench['launches']}; bench afterstate4096 "
        f"({bench_as['wall_s']:.1f} s, T={bench_as['t_horizon']}): "
        f"{json.dumps(bench_as['line'])}, updates {bench_as['update_s']} s, "
        f"launches {bench_as['launches']}; breakdown B={BREAKDOWN_B} "
        f"({bd['wall_s']:.1f} s) on {card}: {json.dumps(bd['row'])}; "
        f"launches {bd['launches']}")

    # each path's launches, counted from 0 just before it
    by_path = {"train4096": main_path["launches"]}
    for tag, run in (("afterstate4096", after),
                     ("afterstate4096_h512", forms["h512"]),
                     ("afterstate4096_bf16", forms["bf16"])):
        by_path[tag] = run["launches"]
        by_path[f"{tag}_rollout"] = run["rollout_launches"]
        by_path[f"{tag}_update"] = run["update_launches"]
    for row in two["checks"]:
        by_path[f"twoply_b{row['batch']}_reply{row['reply_max_moves']}"] = (
            row["launches"])
    by_path["twoply_bf16_b256_reply512"] = bf16_eval["launches"]
    for pair, res in arenas.items():
        by_path[f"arena_{pair.replace(':', '_vs_')}"] = res["launches"]
    by_path["arena_bf16_oneply_vs_pubeval"] = bf16_eval["oneply:pubeval"][
        "launches"]
    by_path["trainer"] = trainer["launches"]
    by_path["dp_rank0"] = dp["launches"]["rank0"]
    by_path["dp_rank1"] = dp["launches"]["rank1"]
    by_path["dp_single"] = dp["launches"]["single"]
    by_path["nccl_world1"] = dp["nccl_world1_launches"]
    by_path["distill"] = distill["launches"]
    by_path["bench"] = bench["launches"]
    by_path["bench_afterstate4096"] = bench_as["launches"]
    by_path["breakdown"] = bd["launches"]
    by_path["wildbg4096"] = deep["launches"]
    # the kernels each path must launch; it may launch no other.  A 2-ply
    # decision splits no sub-batch; an update lists no moves; the
    # afterstate pass runs in afterstate mode, in
    # every 1-ply and 2-ply agent and in distillation, its backward in
    # every update of the afterstate scores
    movegen_set = {"compact_rows", "doubles_level", "nondoubles",
                   "doubles_final"}
    fwd, bwd = {"afterstate_eval"}, {"afterstate_eval_backward"}
    for path, counted in by_path.items():
        want = set(movegen_set)
        if path.startswith("twoply_"):
            want = movegen_set - {"compact_rows"} | fwd
        elif path.startswith("afterstate4096") and path.endswith("_update"):
            want = fwd | bwd
        elif path.startswith("afterstate4096") and path.endswith(
                "_rollout"):
            want |= fwd
        elif path.startswith("afterstate4096") or path in (
                "distill", "bench_afterstate4096"):
            want |= fwd | bwd
        elif path.startswith(("arena_", "trainer")):
            want |= fwd
        for name in ops.KERNELS:
            if name in want:
                check(counted[name] > 0, f"{path} never launched {name}")
            else:
                check(counted[name] == 0, f"{path} launched {name}")
        # every path but the rollouts, 2-ply decisions and arenas updates
        if path.startswith(("twoply_", "arena_")) or path.endswith(
                "_rollout"):
            check(counted[ops.OPTIMIZER] == 0, f"{path} ran the optimizer")
        else:
            check(counted[ops.OPTIMIZER] > 0,
                  f"{path} never ran the optimizer")

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

    def kernel_row(name, replaces, source):
        # times: one movegen call's launches (B=4096, train4096), summed;
        # launches: every path's run, summed, and by path
        rows = main_rows[name]
        return {
            "name": name,
            "route": "cuda",
            "source": f"mlp_ppo_2ply_p3_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes",
            # no single PyTorch call computes batched stable compaction,
            # nor ordered first-occurrence dedup at a fixed width
            # (torch.unique keeps neither the order nor a static shape),
            # nor the expansion of boards by backgammon submoves
            "library_ms": None,
        }

    def afterstate_row(name, replaces, key, checked):
        # times: afterstate4096's first rollout call (forward) or its first
        # minibatch backward, on this run's boards (hidden 128, float32),
        # and the same at hidden 512 and in bf16 ("forms"); the error: the
        # largest over every call checked (phases 5, 6 and 9), float32 and
        # bf16 apart; the widths and dtypes held
        row = after[key][0]

        def form(run):
            r = run[key][0]
            return {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms",
                                      "max_abs_err")}

        return {
            "name": name, "route": "cuda",
            "source": "mlp_ppo_2ply_p3_tpu_torch/csrc/afterstate.cu",
            "replaces": replaces,
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in checked),
            "max_abs_err_by_dtype": {
                dt: max(r["max_abs_err"] for r in checked
                        if r["dtype"] == dt)
                for dt in sorted({r["dtype"] for r in checked})},
            "widths_held": sorted({(r["hidden"], r["dtype"])
                                   for r in checked}),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            # Fn.linear for fc1 alone on prebuilt features (forward);
            # torch.mm for dW1's product alone (backward)
            "library_ms": row["library_ms"],
            "forms": {"hidden 512 float32": form(forms["h512"]),
                      "hidden 128 bfloat16": form(forms["bf16"])},
        }

    played = [*arenas.values(), bf16_eval["oneply:pubeval"], distill]
    kernels = [kernel_row("compact_rows", TPU_KERNELS, "compaction.cu"),
               kernel_row("doubles_level", DOUBLES_REPLACES, "doubles.cu"),
               kernel_row("nondoubles", NONDOUBLES_REPLACES,
                          "nondoubles.cu"),
               kernel_row("doubles_final", FINAL_REPLACES, "doubles.cu"),
               afterstate_row("afterstate_eval", AFTERSTATE_REPLACES,
                              "afterstate_calls",
                              two["afterstate"] + [
                                  r for run in (after, *forms.values(),
                                                *played)
                                  for r in run["afterstate_calls"]]),
               afterstate_row("afterstate_eval_backward",
                              AFTERSTATE_BACKWARD_REPLACES,
                              "afterstate_backward_calls",
                              [r for run in (after, *forms.values(),
                                             distill)
                               for r in run["afterstate_backward_calls"]])]
    # the optimizer: its calls by path, each checked above, one a step;
    # a call launches two kernels, one where clipping is off
    # (distillation's); times: afterstate4096's first step (adam_measure),
    # on its own inputs; the error: the largest over every step checked
    calls = {p: c[ops.OPTIMIZER] for p, c in by_path.items()}
    steps = [run["adam"] for run in (main_path, after, *forms.values(),
                                     distill)]
    kernels.append({
        "name": "adam", "route": "cuda",
        "source": "mlp_ppo_2ply_p3_tpu_torch/csrc/adam.cu",
        "replaces": ADAM_REPLACES,
        "launches": sum((1 if p == "distill" else 2) * n
                        for p, n in calls.items()),
        "calls": sum(calls.values()), "calls_by_path": calls,
        "max_abs_err": max(r["max_abs_err"] for r in steps),
        "norm_ulps": max(r["norm_ulps"] for r in steps),
        "checked": [{k: r[k] for k in ("label", "params", "clipped",
                                       "norm_ulps", "max_abs_err")}
                    for r in steps],
        **{k: after["adam"][k] for k in ("params", "ms", "plain_ms",
                                         "eager_ms", "plain_eager_ms",
                                         "bound_ms")},
        "bound_by": "bytes",
        # torch.optim.Adam(fused=True), without the clip
        "library_ms": after["adam"]["library_ms"]})
    report["kernels"] = kernels
    report["script_s"] = time.time() - t_script
    log(f"chip_smoke.py ran {report['script_s']:.1f} s")
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
