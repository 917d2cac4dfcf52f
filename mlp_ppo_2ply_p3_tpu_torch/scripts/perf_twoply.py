"""2-ply expectimax throughput on one card: ms per batched decision,
decisions/s and peak device memory of ``twoply_actions_values`` at the
``twoply`` preset on the committed frozen_v1 net, on positions after 12
random env steps, at each batch size and ``SearchConfig`` chunking.

The port's twin of ``scripts/perf_twoply.py``.  The chunkings are
visited in order and then in reverse, each visit a warm-up decision and
``--reps`` timed ones (host clock around synchronised decisions), and a
row reports the mean of its two visits, so that no chunking is always
measured first.  No chunking changes a result: every row says whether
its actions and backup scores equal the first chunking's.

    python -m mlp_ppo_2ply_p3_tpu_torch.scripts.perf_twoply \\
        [--batch 256 4096] [--chunks 2048/512/128 8192/2048/128 ...] \\
        [--reps 2] [--device cuda]

``--chunks`` takes ``game_chunk/dbl_game_chunk/eval_slot_chunk``
triples (default: the preset's).  Prints one JSON line per (batch,
chunking).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from .. import resolve_device
from ..agents import frozen, twoply
from ..env import bg_env
from ..utils.config import SearchConfig, get_preset

CHUNK_FIELDS = ("game_chunk", "dbl_game_chunk", "eval_slot_chunk")


def realistic_state(env_cfg, batch: int, steps: int = 12, seed: int = 11,
                    device="cuda") -> bg_env.EnvState:
    """Reachable mid-game positions: ``steps`` uniformly random plies of
    ``batch`` games from a fresh reset."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    es = bg_env.reset(gen, env_cfg, batch, device=dev)
    for _ in range(steps):
        u = torch.rand((batch,), generator=gen, device=dev)
        act = (u * es.n_moves.clamp(min=1)).to(torch.int32)
        es, _ = bg_env.step(es, act, gen, env_cfg)
    return es


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_decision(model, state: bg_env.EnvState, scfg: SearchConfig,
                  reps: int):
    """(row, the last decision's output): host clock around ``reps``
    synchronised decisions after a warm-up, and their peak device memory
    (None on the CPU)."""
    dev = state.turn.device
    twoply.twoply_actions_values(model, state, scfg)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = twoply.twoply_actions_values(model, state, scfg)
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    batch = state.turn.shape[0]
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    row = {"batch": batch, "top_k": scfg.top_k,
           "reply_max_moves": scfg.reply_max_moves,
           **{f: getattr(scfg, f) for f in CHUNK_FIELDS},
           "ms_per_decision": dt * 1e3, "decisions_per_s": batch / dt,
           "peak_mem_gb": peak, "overflow_games": int(out[2].sum()),
           "reps": reps}
    return row, out


def sweep(model, state: bg_env.EnvState, search: SearchConfig, chunkings,
          reps: int) -> list[dict]:
    """One row per chunking: the mean of a visit in order and one in
    reverse, with the largest peak, and whether every visit's actions and
    backup scores equal the first visit's."""
    chunkings = [tuple(c) for c in chunkings]
    visits = {c: [] for c in chunkings}
    first = None
    for c in chunkings + chunkings[::-1]:
        scfg = dataclasses.replace(search, **dict(zip(CHUNK_FIELDS, c)))
        row, out = time_decision(model, state, scfg, reps)
        first = first or out
        row["equal_first"] = (torch.equal(out[0], first[0])
                              and torch.equal(out[1], first[1]))
        visits[c].append(row)
    rows = []
    for c in chunkings:
        a, b = visits[c]
        ms = (a["ms_per_decision"] + b["ms_per_decision"]) / 2
        peaks = [v["peak_mem_gb"] for v in (a, b)]
        rows.append({
            **a, "ms_per_decision": ms,
            "ms_visits": [a["ms_per_decision"], b["ms_per_decision"]],
            "decisions_per_s": a["batch"] / ms * 1e3,
            "peak_mem_gb": None if None in peaks else max(peaks),
            "equal_first": a["equal_first"] and b["equal_first"],
        })
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[256, 4096])
    ap.add_argument("--chunks", nargs="+", default=None,
                    help="game_chunk/dbl_game_chunk/eval_slot_chunk "
                         "triples (default: the twoply preset's)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # full float32 matmuls, as the reference computes
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_preset("twoply")
    model, _ = frozen.load_frozen(device=dev)
    chunkings = ([tuple(int(x) for x in c.split("/")) for c in args.chunks]
                 if args.chunks else
                 [tuple(getattr(cfg.search, f) for f in CHUNK_FIELDS)])
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    for batch in args.batch:
        state = realistic_state(cfg.env, batch, device=dev)
        for row in sweep(model, state, cfg.search, chunkings, args.reps):
            print(json.dumps({"metric": "twoply_decisions_per_sec",
                              "device": kind, **row}), flush=True)


if __name__ == "__main__":
    main()
