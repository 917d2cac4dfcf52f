"""Micro-benchmark of movegen's pieces on the card.

Port of ``scripts/perf_movegen.py``: the same sections and keys, on the
boards and dice of a fresh reset of B games and on random candidate
blocks of the shapes each piece sees at ``MovegenConfig(max_moves=256)``.
Each key is the device's time of one call, from
``utils.profiling.timed_scan`` (a CUDA graph of 20 calls, replayed), the
counterpart of the JAX script's one jitted scan; beside it,
``<name>_eager_ms`` is the same calls launched one by one
(``timed_eager``), which follows the host wherever the host is slower
than the device.  On the CPU both are the CPU's time, and the line says
``"device": "cpu"``.  ``nondoubles_ms`` times the non-doubles batch, one
``ops/nondoubles.py::nondoubles_batch`` launch that dedups on chip;
``dedup384_ms`` times ``dedup_compact_rows_plain``, the dedup and
compaction in plain PyTorch at the JAX key's shape (movegen's dedup runs
inside the non-doubles kernel); ``nd_one_order_ms`` times the plain
PyTorch enumeration of one die order.

The JAX script's ``kernels`` section timed each compaction shape three
ways: jnp and the two Pallas formulations (a global one-hot matmul and
128-wide segments).  Those were TPU shapes of one function, which the
port computes with one CUDA kernel (``ops/compaction.py::compact_rows``),
so here each shape is timed as the plain PyTorch version
(``<shape>_plain_ms``) and the kernel (``<shape>_kernel_ms``, null off
the card, where the wrapper runs the plain version).

Usage:
    python -m mlp_ppo_2ply_p3_tpu_torch.scripts.perf_movegen [B] \\
        [section,section,...] [--device cuda]

Sections: full, nd, dbl, ndoo, c832, dedup, c384, c5600, exp4, kernels.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import resolve_device
from ..core import board as Bd
from ..core import movegen as MG
from ..env import bg_env
from ..ops import compaction as OC
from ..ops import doubles as OD
from ..ops import nondoubles as OND
from ..utils.profiling import device_label, timed_eager, timed_scan


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batch", nargs="?", type=int, default=4096)
    ap.add_argument("sections", nargs="?", default=None,
                    help="comma-separated sections (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    bsz = args.batch
    only = set(args.sections.split(",")) if args.sections else None
    dev = resolve_device(args.device)

    def want(name):
        return only is None or name in only

    cfg = MG.MovegenConfig(max_moves=256)
    env_cfg = bg_env.EnvConfig(movegen=cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    es = bg_env.reset(gen, env_cfg, bsz, device=dev)
    vecs = Bd.to_canonical(es.points, es.bar, es.off, es.turn)
    dice = es.dice
    d0 = dice[:, 0].to(torch.int32)
    d1 = dice[:, 1].to(torch.int32)
    d_hi, d_lo = torch.maximum(d0, d1), torch.minimum(d0, d1)
    gen.manual_seed(7)

    def boards(*shape):
        return torch.randint(0, 15, (*shape, 52), generator=gen, device=dev,
                             dtype=torch.int8)

    def flags(p, *shape):
        return torch.rand(shape, generator=gen, device=dev) < p

    res = {"B": bsz, "device": device_label(dev)}

    def timed(key, fn, *args, card_only=False):
        """``key``: the device time; its ``_eager_ms`` twin beside it
        (both null for a kernel off the card)."""
        eager = key[:-len("_ms")] + "_eager_ms"
        if card_only and dev.type != "cuda":
            res[key] = res[eager] = None
            return
        res[key] = timed_scan(fn, *args) * 1e3
        res[eager] = timed_eager(fn, *args) * 1e3

    if want("full"):
        timed("full_ms",
              lambda v, d: MG.legal_afterstates_batch(v, d, cfg), vecs, dice)

    mir = torch.zeros((bsz,), dtype=torch.bool, device=dev)
    if want("nd"):
        timed("nondoubles_ms",
              lambda v, h, lo: MG._nondoubles_batch(v, h, lo, cfg, mir),
              vecs, d_hi, d_lo)

    bd = MG.doubles_capacity(bsz, cfg)
    if want("dbl"):
        timed("doubles_ms",
              lambda v, d: MG._doubles_batch(v[:bd], d[:bd], cfg, mir[:bd]),
              vecs, d0)

    if want("ndoo"):
        timed("nd_one_order_ms",
              lambda v, h, lo: OND.one_order(v, h, lo, cfg.k1, mir),
              vecs, d_hi, d_lo)

    n_raw = 2 * (cfg.k1 * 25 + cfg.k1)
    cand, val = boards(bsz, n_raw), flags(0.15, bsz, n_raw)
    if want("c832"):
        timed("compact832to384_ms",
              lambda c, v: MG._compact_batch((c,), v, cfg.dedup_width),
              cand, val)

    cand2 = boards(bsz, cfg.dedup_width)
    val2 = flags(0.2, bsz, cfg.dedup_width)
    if want("dedup"):
        timed("dedup384_ms", OC.dedup_compact_rows_plain, cand2, val2,
              cfg.max_moves)

    if want("c384"):
        timed("compact384to256_ms",
              lambda c, v: MG._compact_batch((c,), v, cfg.max_moves),
              cand2, val2)

    n4 = cfg.k3 * 25
    cand3, val3 = boards(bd, n4), flags(0.05, bd, n4)
    if want("c5600"):
        timed("dbl_compact5600to256_ms",
              lambda c, v: MG._compact_batch((c,), v, cfg.max_moves),
              cand3, val3)

    f3, f3v = boards(bd, cfg.k3), flags(0.5, bd, cfg.k3)
    die = torch.full((bd,), 3, dtype=torch.int32, device=dev)
    if want("exp4"):
        timed("dbl_expand_L4_ms",
              lambda f, v, d: OD.expand_one_die(f, v, d, mir[:bd]),
              f3, f3v, die)

    if want("kernels"):
        # the compaction shapes that dominate movegen: plain PyTorch
        # version against the kernel
        fast = MG.MovegenConfig.fast()
        shapes = {
            "ndblock": (bsz, n_raw, fast.dedup_width, 0.15),
            "ndfinal": (bsz, fast.dedup_width, cfg.max_moves, 0.2),
            "dblL3": (bd, fast.k2 * 27, fast.k3, 0.1),
            "dblL4": (bd, fast.k3 * 27, cfg.max_moves, 0.05),
        }
        for name, (b_, n_, k_, dens) in shapes.items():
            pay, va = boards(b_, n_), flags(dens, b_, n_)
            timed(f"{name}_plain_ms", OC.compact_rows_plain, pay, va, k_)
            timed(f"{name}_kernel_ms", OC.compact_rows, pay, va, k_,
                  card_only=True)

    for k, v in res.items():
        if k not in ("B", "device") and v is not None:
            res[k] = round(v, 2)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
