"""The readings that the limits of ``correct`` are set from, for a PPO
cell whose traffic names the driver ``ppo_routed`` (a routed model:
wildbg's contact and race networks), by ``calibrate.py``'s method:

- the program on each of ``--seeds``, judged by the routed reference;
- the control on each of ``--control-seeds``: the reference in TF32 in
  the program's place; and on each of ``--nudge-seeds`` the reference
  with every initial weight one float32 ulp up (rounding's own drift over
  the checked updates);
- each planted fault on each of ``--fault-seeds``: by default
  ``calibrate.py``'s ``half_batch`` (the loss over half of each
  minibatch) and the two routing faults, every position through the
  contact network (``all_contact``) and the two classes swapped
  (``swapped``).

    python3 benchmark/calibrate_routed.py --workload <cell> --seeds 1,2 \\
        [--control-seeds 3,4] [--nudge-seeds 3,4] [--fault-seeds 5,6] \\
        [--faults a,b]

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
    ap.add_argument("--nudge-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--faults", default="half_batch,all_contact,swapped")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from benchmark import run as harness
    from benchmark.drivers import ppo, ppo_deep, ppo_routed

    bench = harness.load_json(ROOT, "BENCHMARK.json")
    wl = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg = harness.load_json(HERE, "configs", f"{wl['config']}.json")
    traffic = harness.load_json(HERE, "traffic", f"{wl['traffic']}.json")
    cell = harness.load_json(HERE, "workloads", f"{args.workload}.json")
    if traffic["driver"] != "ppo_routed":
        ap.error(f"{traffic['driver']}: use benchmark/calibrate.py or "
                 f"benchmark/study.py")
    if args.tiny:
        cfg = harness.merge(cfg, cell["cpu_test"].get("config", {}))
    dev = torch.device(args.device, 0) if args.device == "cuda" \
        else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checked = traffic["checked_updates"]
    cfg = ppo_deep.program_cfg(cfg)

    def judge(who, seed, record):
        t0 = time.perf_counter()
        numbers = ppo_routed.reference_numbers(cfg, seed, dev, record,
                                               checked)
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
    runs += [("nudge", s, "float32", "nudge") for s in args.nudge_seeds]
    runs += [(f"fault:{f}", s, "float32", f) for f in args.faults.split(",")
             if f for s in args.fault_seeds]
    for who, seed, precision, fault in runs:
        record = ppo_routed.control_record(
            cfg, seed, dev, checked, precision,
            None if fault == "nudge" else fault, nudge=fault == "nudge")
        judge(who, seed, record)


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)
    main()
