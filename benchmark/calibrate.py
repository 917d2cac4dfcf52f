"""The readings that the limits of ``correct`` are set from, for a PPO
cell whose traffic names the driver ``ppo_deep`` (``study.py`` picks
``ppo`` or ``twoply`` by the traffic's ``driver`` key alone), whose
program and reference have a deep network:

- the program on each of ``--seeds``, judged by the reference;
- the control on each of ``--control-seeds``: the reference in TF32 in
  the program's place, and the reference with every initial weight one
  float32 ulp up (rounding's own drift over the checked updates);
- each planted fault on each of ``--fault-seeds`` (``half_batch``,
  ``action_altered``).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2 \\
        [--control-seeds 3,4] [--fault-seeds 5,6]

One JSON line a reading on standard output, as ``study.py`` prints them.
The benchmark's own runs never run this.
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
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from benchmark import run as harness
    from benchmark.drivers import ppo, ppo_deep

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg = harness.load_json(HERE, "configs", f"{wl['config']}.json")
    traffic = harness.load_json(HERE, "traffic", f"{wl['traffic']}.json")
    cell = harness.load_json(HERE, "workloads", f"{args.workload}.json")
    if args.tiny:
        cfg = harness.merge(cfg, cell["cpu_test"].get("config", {}))
    dev = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checked = traffic["checked_updates"]
    if traffic["driver"] != "ppo_deep":
        ap.error(f"{traffic['driver']}: use benchmark/study.py")
    cfg = ppo_deep.program_cfg(cfg)
    judge_fn, control_fn = ppo_deep.reference_numbers, \
        ppo_deep.control_record

    def judge(who, seed, record):
        t0 = time.perf_counter()
        numbers = judge_fn(cfg, seed, dev, record, checked)
        row = {"cell": args.workload, "who": who, "seed": seed,
               "seconds": time.perf_counter() - t0, **numbers}
        if dev.type == "cuda":
            row["card"] = torch.cuda.get_device_name(dev)
        print(json.dumps(row), flush=True)

    for seed in args.seeds:
        prog = ppo.Program(cfg, seed, dev, checked)
        record = prog.record
        del prog
        judge("program", seed, record)
    runs = [("control", s, "tf32", None) for s in args.control_seeds]
    runs += [("nudge", s, "float32", "nudge") for s in args.control_seeds]
    runs += [(f"fault:{f}", s, "float32", f) for f in args.faults.split(",")
             if f for s in args.fault_seeds]
    for who, seed, precision, fault in runs:
        record = control_fn(cfg, seed, dev, checked, precision,
                            None if fault == "nudge" else fault,
                            nudge=fault == "nudge")
        judge(who, seed, record)


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)
    main()
