"""Host training driver: the only Python loop above ``train_step``.

Port of ``mlp_ppo_2ply_p3_tpu/ppo/train.py``.  Each iteration runs one
``learner.train_step`` (rollout + GAE + minibatched PPO), fetches its
scalars with one device-to-host copy, logs them, and on its
cadences evaluates the policy in the league (``league_eval``) and
checkpoints the full train state (``utils.checkpoint``), uploading
checkpoints and, at the end, the metrics file to the remote store.
As in the JAX driver, checkpoints are written every
``checkpoint_every`` updates only: a run that ends between two of them
resumes from the last one it wrote.

Resume precedence is **local first, then remote**, as in the JAX
package: with ``resume``, the newest ``ckpt_<n>`` under
``checkpoint_dir/<name>`` wins; only when there is none is the newest
checkpoint in the store (``remote_url``) pulled into that directory and
restored.  A stale local checkpoint therefore shadows a newer remote
one.  With neither, the run starts fresh.

Randomness: the train state's generator (seeded with ``cfg.seed``)
draws the initial weights, the first reset and every draw of the
updates, and is checkpointed.  The JAX package's per-update keys
``fold_in(seed, update)`` (the reset of ``reset_each_update``) and
``fold_in(seed + 7, update)`` (the league's games) become generators
seeded from ``(seed, update)`` and ``(seed + 7, update)``, so a resumed
run draws them again exactly.

Scale-out: where the JAX driver shards the games over every visible
chip, this one shards them over the ranks of a ``torch.distributed``
process group (``parallel/mesh.py``), one process per rank:
``initialize_distributed`` joins it from the ``--num-processes /
--coordinator / --process-id`` flags or from ``torchrun``'s
environment.  Each rank steps B / size games; the update is the global
one (see ``ppo/learner.py``), so a sharded run trains as the unsharded
one does.  Rank 0 alone evaluates, writes metrics and checkpoints (the
global state, readable under any layout) and uploads.  B and the
global minibatch must divide by the number of ranks.  Without a
process group (or with ``shard=False``) the driver runs on one device,
``cuda:0`` by default.

Usage:
    python -m mlp_ppo_2ply_p3_tpu_torch.ppo.train --preset train4096 \\
        --updates 100 [--device cuda]
    torchrun --nproc-per-node 4 -m mlp_ppo_2ply_p3_tpu_torch.ppo.train \\
        --preset pod --updates 100
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..agents import arena, basic, frozen, pubeval
from ..env import bg_env
from ..parallel import mesh
from ..utils import checkpoint as ckpt
from ..utils import profiling
from ..utils.config import get_preset
from ..utils.metrics import MetricsWriter, to_host
from ..utils.remote import maybe_store
from . import learner

LOSSES = ("loss", "policy_loss", "value_loss", "entropy")


def fold_in(seed: int, data: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, data)`` through
    numpy's ``SeedSequence`` (the counterpart of ``jax.random.fold_in``:
    another stream for every pair, the same stream for the same pair)."""
    words = np.random.SeedSequence([seed, data]).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 32) | int(words[1]))
    return gen


def _league_policies(policy_mode: str):
    """(policy under evaluation, pubeval opponent), both argmax."""
    if policy_mode == "afterstate":
        def pol(model, state, rand):
            return basic.afterstate_policy(model, state, rand, sample=False)
    else:
        def pol(model, state, rand):
            return basic.index_policy(model, state, rand, sample=False)
    return pol, pubeval.pubeval_actions


def _frozen_opponent(model, state, rand):
    """A frozen net played greedy 1-ply."""
    return basic.greedy_1ply(model, state)


def _arena_stats(res, n_games: int, tag: str) -> dict:
    # one device-to-host copy for the six counters
    wins_a, _, done, points_a, points_b, plies = torch.stack(
        list(res)).tolist()
    finished = max(1, done)
    return {
        f"league/win_rate_vs_{tag}": wins_a / finished,
        f"league/finished_vs_{tag}": done,
        f"league/points_a_vs_{tag}": points_a,
        f"league/points_b_vs_{tag}": points_b,
        # signed points margin per finished game (gammons 2, bg 3)
        f"league/point_margin_vs_{tag}": float(points_a - points_b)
        / finished,
        f"league/avg_plies_vs_{tag}": float(plies) / max(1, n_games),
    }


def league_eval(cfg, model, gen: torch.Generator) -> dict:
    """Win rates of the current policy (argmax mode) against the fixed
    opponents: the linear heuristic over the exact pubeval encoding, and
    (when the committed asset exists) the frozen benchmark net
    ``frozen_v1`` played greedy 1-ply; ``cfg.eval_games`` games of at most
    400 plies each, on ``gen``'s device, every draw from ``gen``."""
    dev = gen.device
    pol, base = _league_policies(cfg.ppo.policy_mode)
    res = arena.play(pol, model, base, pubeval.default_weights(dev), gen,
                     cfg.env, cfg.eval_games, 400, device=dev)
    out = _arena_stats(res, cfg.eval_games, "heuristic")
    # the alias that earlier curves and plots read
    out["league/win_rate_vs_baseline"] = out["league/win_rate_vs_heuristic"]
    asset = frozen.load_frozen(device=dev)
    if asset is not None:
        fres = arena.play(pol, model, _frozen_opponent, asset[0], gen,
                          cfg.env, cfg.eval_games, 400, device=dev)
        out.update(_arena_stats(fres, cfg.eval_games, "frozen_v1"))
    return out


def _handle_overflow(cfg, update: int, metrics: dict, warned: list):
    n_over = int(metrics.get("movegen_overflow", 0))
    if n_over == 0 or cfg.overflow_policy == "none":
        return
    total = cfg.ppo.num_envs * cfg.ppo.t_horizon
    msg = (
        f"movegen width-cap saturation in update {update}: {n_over} of "
        f"{total} rollout game-steps truncated (affected games degrade "
        f"toward forced pass). Widen MovegenConfig caps or lower num_envs."
    )
    if cfg.overflow_policy == "abort":
        raise RuntimeError(msg)
    if not warned:
        print(f"WARNING: {msg} (warning once; see movegen_overflow metric)")
        warned.append(True)


def _check_finite(update: int, metrics: dict):
    """``debug_nans``: raise at the first update whose losses are not
    finite.  JAX's ``jax_debug_nans`` re-runs the offending computation
    op by op and raises at the primitive that made a NaN; this check
    runs once per update on the fetched losses (NaN or infinity), so it
    names the update, not the operation, and the update's parameter
    steps have been applied by then."""
    bad = {k: metrics[k] for k in LOSSES if not math.isfinite(metrics[k])}
    if bad:
        raise FloatingPointError(
            f"non-finite loss in update {update}: {bad}")


def _pull_remote_latest(store, cfg, ckpt_dir):
    """Download the newest remote checkpoint for this run into the local
    checkpoint dir and return its local path (None if the store holds
    none): a worker restarted on a wiped disk resumes from the store it
    has been uploading to."""
    names = store.list(cfg.name)
    steps = set()
    for n in names:
        head = n[len(cfg.name) + 1:].split("/", 1)[0]
        stem = head[len("ckpt_"):] if head.startswith("ckpt_") else ""
        stem = stem[:-4] if stem.endswith(".npz") else stem
        try:
            steps.add(int(stem))
        except ValueError:
            continue
    if not steps:
        return None
    best = max(steps)
    heads = {f"ckpt_{best}", f"ckpt_{best}.npz"}
    for n in names:
        if n[len(cfg.name) + 1:].split("/", 1)[0] in heads:
            store.get(n, os.path.join(cfg.checkpoint_dir, n))
    path = ckpt.latest(ckpt_dir)
    if path:
        print(f"pulled remote checkpoint {cfg.name}/ckpt_{best} from "
              f"{cfg.remote_url}")
    return path


def _make_world(dev, shard: bool, world):
    """The ``World`` the run shards its games over (``world``, else the
    initialised process group's), or None: with ``shard=False``, without
    a process group, or with one rank, as the JAX driver places nothing
    on one device."""
    if not shard:
        return None
    world = world or mesh.current_world(dev)
    if world is None or world.size == 1:
        return None
    if world.device.type != dev.type:
        raise ValueError(f"the process group's ranks run on "
                         f"{world.device}, the run on {dev}")
    return world


def _resume_path(cfg, store, ckpt_dir, world):
    """The checkpoint to resume from, or None: local first, then remote,
    decided on rank 0; every rank gets its name under
    ``cfg.checkpoint_dir``, and a rank whose disk lacks the file pulls it
    from the store."""
    rel = None
    if world is None or world.rank == 0:
        path = ckpt.latest(ckpt_dir)
        if path is None and store is not None:
            path = _pull_remote_latest(store, cfg, ckpt_dir)
        if world is None:
            return path
        rel = path and os.path.relpath(path, cfg.checkpoint_dir)
    rel = mesh.broadcast_object(rel, world)
    if rel is None:
        return None
    path = os.path.join(cfg.checkpoint_dir, rel)
    if not os.path.exists(path) and not (store is not None
                                         and store.get(rel, path)):
        raise FileNotFoundError(
            f"rank {world.rank}: {path}, rank 0's checkpoint, is not on "
            f"this rank's disk, and no remote store holds it")
    return path


def train(cfg, resume: bool = True, updates: int | None = None,
          write_metrics: bool = True, profile: bool = False,
          device="cuda", shard: bool = True, world=None):
    """Run updates ``update_idx .. updates`` (default ``cfg.num_updates``)
    on ``device``.  Returns (TrainState, EnvState, the last update's
    metrics as Python numbers, wall seconds).

    With ``shard`` and a process group of more than one rank (``world``,
    or the one ``parallel.mesh.initialize_distributed`` joined), each
    rank runs B / size games on its own device and every rank returns
    the same TrainState and its shard of the env state; only rank 0
    evaluates, prints, writes metrics and checkpoints, and uploads."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    world = _make_world(dev, shard, world)
    if world is not None:
        dev = world.device
        mesh.check_divisible(cfg.ppo.num_envs, cfg.ppo.t_horizon,
                             cfg.ppo.num_minibatches, world.size)
    lead = world is None or world.rank == 0
    num_updates = updates if updates is not None else cfg.num_updates
    ts = learner.init_train_state(cfg.seed, cfg.model, cfg.ppo, device=dev)
    env_state = bg_env.reset(ts.gen, cfg.env, cfg.ppo.num_envs, device=dev,
                             world=world)

    ckpt_dir = os.path.join(cfg.checkpoint_dir, cfg.name)
    store = maybe_store(cfg.remote_url)
    if resume:
        path = _resume_path(cfg, store, ckpt_dir, world)
        if path:
            ts, env_state = ckpt.restore(path, (ts, env_state), world)
            if lead:
                print(f"resumed from {path} at update "
                      f"{int(ts.update_idx)}")
    if world is not None:
        mesh.replicate([*ts.model.parameters(), ts.opt_state.count,
                        *ts.opt_state.mu, *ts.opt_state.nu, ts.update_idx,
                        ts.episodes, ts.gen.get_state()], world)
        if lead:
            print(f"sharded: {cfg.ppo.num_envs} games over {world.size} "
                  f"ranks (backend {world.backend})")

    metrics_path = cfg.metrics_path.format(name=cfg.name)
    writer = MetricsWriter(
        metrics_path if write_metrics and lead else None,
        tb_logdir=(cfg.tb_logdir.format(name=cfg.name) or None) if lead
        else None,
    )
    steps_per_update = cfg.ppo.num_envs * cfg.ppo.t_horizon
    last_metrics = {}
    t_start = time.time()
    start_update = int(ts.update_idx)
    # the overflow warning is printed once, by rank 0
    overflow_warned: list = [] if lead else [True]

    for update in range(start_update, num_updates):
        if cfg.ppo.reset_each_update:
            env_state = bg_env.reset(fold_in(cfg.seed, update, dev), cfg.env,
                                     cfg.ppo.num_envs, device=dev,
                                     world=world)
        if dev.type == "cuda":  # the clock starts on an idle card
            torch.cuda.synchronize(dev)
        t0 = time.time()
        with profiling.section("train_step", sync=profile):
            ts, env_state, metrics = learner.train_step(
                ts, env_state, cfg.env, cfg.model, cfg.ppo, world=world
            )
            metrics = to_host(metrics)  # waits for the update to finish
        dt = time.time() - t0
        metrics["steps_per_sec"] = steps_per_update / dt
        metrics["update_time_s"] = dt
        if cfg.debug_nans:
            _check_finite(update, metrics)
        _handle_overflow(cfg, update, metrics, overflow_warned)
        last_metrics = metrics
        ran_eval = lead and cfg.eval_every and (
            update + 1) % cfg.eval_every == 0
        if ran_eval:
            with profiling.section("league_eval", sync=profile):
                ev = league_eval(cfg, ts.model,
                                 fold_in(cfg.seed + 7, update, dev))
            metrics.update(ev)
            frozen_part = (
                f" vs_frozen_v1={ev['league/win_rate_vs_frozen_v1']:.3f}"
                if "league/win_rate_vs_frozen_v1" in ev
                else ""
            )
            print(
                f"  league: vs_heuristic="
                f"{ev['league/win_rate_vs_heuristic']:.3f}"
                f"{frozen_part} "
                f"({ev['league/finished_vs_heuristic']} games)"
            )
        # eval updates are always persisted, whatever the log cadence
        if lead and (ran_eval or update % cfg.log_every == 0):
            writer.write(update, metrics)
            print(
                f"update {update}: loss={metrics['loss']:.4f} "
                f"pi={metrics['policy_loss']:.4f} "
                f"v={metrics['value_loss']:.4f} "
                f"ent={metrics['entropy']:.3f} "
                f"eps={int(metrics['episodes_finished'])} "
                f"sps={metrics['steps_per_sec']:.0f}"
            )
        if cfg.checkpoint_every and (update + 1) % cfg.checkpoint_every == 0:
            with profiling.section("checkpoint", sync=profile):
                local = ckpt.save(
                    os.path.join(ckpt_dir, f"ckpt_{update + 1}"),
                    (ts, env_state), world)
                if store is not None and lead:
                    store.put(local,
                              os.path.relpath(local, cfg.checkpoint_dir))

    total = time.time() - t_start
    if profile:
        report = profiling.report()
        if lead:
            print("profile sections:\n" + report)
    writer.close()
    if (store is not None and write_metrics and lead
            and os.path.exists(metrics_path)):
        store.put(metrics_path, f"{cfg.name}/metrics.jsonl")
    return ts, env_state, last_metrics, total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="debug")
    ap.add_argument("--updates", type=int, default=None)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="per-section host timers and the program's spans "
                         "(+ set PROFILE_TRACE_DIR for a torch.profiler "
                         "trace of the run that shows them)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    # the process group of a multi-process run (parallel/mesh.py); with
    # none of them, torchrun's environment is detected
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--coordinator", default=None,
                    help="host:port where rank 0 meets the others")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", choices=mesh.BACKENDS, default=None,
                    help="nccl (the default on cuda; one card a rank) or "
                         "gloo (the CPU, or ranks sharing one card)")
    args = ap.parse_args(argv)

    world = mesh.initialize_distributed(
        coordinator=args.coordinator, num_processes=args.num_processes,
        process_id=args.process_id, backend=args.backend,
        device=args.device)
    try:
        cfg = get_preset(args.preset)
        trace_dir = (os.environ.get("PROFILE_TRACE_DIR") if args.profile
                     else None)
        kw = dict(resume=not args.no_resume, updates=args.updates,
                  device=args.device, world=world)
        with contextlib.ExitStack() as stack:
            if trace_dir:
                stack.enter_context(profiling.device_trace(trace_dir))
            if args.profile:
                # the program's spans, marked in the trace over its kernels
                stack.enter_context(profiling.recording())
            out = train(cfg, profile=args.profile, **kw)
        ts, _, metrics, total = out
        if world is None or world.rank == 0:
            print(f"done: {int(ts.update_idx)} updates in {total:.1f}s")
    finally:
        if world is not None:
            mesh.shutdown()


if __name__ == "__main__":
    main()
