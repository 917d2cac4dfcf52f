"""The readings that the limits of ``correct`` are set from, for one
cell, in one process and with no measured window:

- the program on each of ``--seeds`` (its set-up's checked updates, or
  ``--plies`` plies of self-play), judged by the reference;
- the control on each of ``--control-seeds``: the reference in the
  program's place, computed in TF32 (the nearest precision below the
  configuration's float32), judged by the float32 reference; and, for a
  training cell, the reference with every initial weight nudged up by
  one float32 ulp, which reads what rounding alone does over the
  checked updates;
- each planted fault on each of ``--fault-seeds``: the reference in the
  program's place with ``half_batch`` (the loss's mean over half of each
  minibatch; in 2-ply the chance node's mean over half of the rolls) or
  ``action_altered`` (game 0's move changed where it is chosen).  The
  fault ``state_unchanged`` reads 1 on the parameters' change by the
  measure itself (``reference/compare.py::leaf_gap``) and needs no run.

    python3 benchmark/study.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--plies 40]

One JSON line a reading on standard output.  The benchmark's own runs
never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--faults", default="half_batch,action_altered")
    ap.add_argument("--plies", type=int, default=40,
                    help="plies of a 2-ply cell's program (its control "
                         "plays checked_plies + 1)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from benchmark import run as harness

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg = harness.load_json(HERE, "configs", f"{wl['config']}.json")
    traffic = harness.load_json(HERE, "traffic", f"{wl['traffic']}.json")
    cell = harness.load_json(HERE, "workloads", f"{args.workload}.json")
    if args.tiny:
        cfg = harness.merge(cfg, cell["cpu_test"].get("config", {}))
        traffic = harness.merge(traffic, cell["cpu_test"].get("traffic", {}))
    dev = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = traffic["driver"]
    if kind == "ppo":
        from benchmark.drivers import ppo as drv
    else:
        from benchmark.drivers import twoply as drv

    def report(who, seed, numbers, t0):
        row = {"cell": args.workload, "who": who, "seed": seed,
               "seconds": time.perf_counter() - t0, **numbers}
        if dev.type == "cuda":
            row["card"] = torch.cuda.get_device_name(dev)
        print(json.dumps(row), flush=True)

    def judge(who, seed, record):
        t0 = time.perf_counter()
        if kind == "ppo":
            numbers = drv.reference_numbers(cfg, seed, dev, record,
                                            traffic["checked_updates"])
        else:
            numbers = drv.reference_numbers(cfg, traffic, seed, dev, record)
        report(who, seed, numbers, t0)

    plays = traffic.get("checked_plies", 0) + 1
    for seed in args.seeds:
        if kind == "ppo":
            prog = drv.Program(cfg, seed, dev, traffic["checked_updates"])
            record = prog.record
        else:
            prog = drv.Program(cfg, traffic, seed, dev)
            for _ in range(args.plies):
                prog.ply()
            record = prog.kept
        del prog
        judge("program", seed, record)
    runs = [("control", s, "tf32", None) for s in args.control_seeds]
    if kind == "ppo":
        runs += [("nudge", s, "float32", "nudge") for s in args.control_seeds]
    runs += [(f"fault:{f}", s, "float32", f) for f in args.faults.split(",")
             if f for s in args.fault_seeds]
    for who, seed, precision, fault in runs:
        if kind == "ppo":
            record = drv.control_record(
                cfg, seed, dev, traffic["checked_updates"], precision,
                None if fault == "nudge" else fault, nudge=fault == "nudge")
        else:
            record = drv.control_kept(cfg, traffic, seed, dev, plays,
                                      precision, fault)
        judge(who, seed, record)


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)
    main()
