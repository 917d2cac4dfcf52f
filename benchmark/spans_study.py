"""The readings of the program's spans in one cell, in one process, as a
``--trace 1`` run would take them after its window
(``yardstick/spans.py``), beside the device times they are checked
against, and what recording the spans costs on the host:

- set-up as the cell's driver makes it (the PPO cells' checked
  updates; the 2-ply cell's first ply and ``--plies`` more);
- the device time of one update (one decision) as the per-layer
  readings trace it: ``update_device_ms`` (``decision_device_ms``);
- the spans' readings, ``--repeat`` times;
- with ``--cost N``, N pairs of ``--seconds`` windows, recording off
  and on in turn (starting with off), each a host rate as the cell's
  window reads it.

    python3 benchmark/spans_study.py --workload <cell> --seed <n> \\
        [--repeat 2] [--cost 3 --seconds 10]

One JSON line a reading on standard output; the idle gaps by span and
the device time outside any span on standard error.  The benchmark's
own runs never run this.
"""

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--cost", type=int, default=0,
                    help="pairs of windows, recording off and on")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--plies", type=int, default=4,
                    help="plies a 2-ply cell plays after its first")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from benchmark import run as harness
    from benchmark.yardstick import profiling, spans
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling as program

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
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = program.device_label(dev)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def emit(what, row):
        print(json.dumps({"cell": args.workload, "seed": args.seed,
                          "what": what, "card": card, **row}), flush=True)

    ppo = traffic["driver"] == "ppo"
    if ppo:
        from benchmark.drivers import ppo as drv
        from mlp_ppo_2ply_p3_tpu_torch.ppo import learner

        prog = drv.Program(cfg, args.seed, dev, traffic["checked_updates"])
        start = prog.snapshot()
        per = prog.ppo.num_envs * prog.ppo.t_horizon
        unit = "host_env_steps_per_s"
        step = prog.step
    else:
        from benchmark.drivers import twoply as drv

        prog = drv.Program(cfg, traffic, args.seed, dev)
        prog.ply()
        prog.advance(args.plies)
        per = prog.games
        unit = "host_decisions_per_s"
        step = lambda: prog.advance(1)  # noqa: E731
    sync()

    checks = {}
    if on_card and ppo:
        # the driver's update_device_ms: one update on the rollout of the
        # state set-up left, traced on its own
        prog.restore(start)
        sampler = learner.Sampler(prog.ts.gen)
        _, traj, last_value, last_turn = learner.rollout(
            prog.ts.model, prog.es, sampler, prog.env_cfg, prog.ppo)
        checks["update_device_ms"] = 1e3 * profiling.device_busy(
            lambda: learner.ppo_update(prog.ts, traj, last_value, last_turn,
                                       prog.env_cfg, prog.ppo, sampler),
            dev)[0]
        del traj
    elif on_card:
        checks["decision_device_ms"] = 1e3 * profiling.device_busy(
            prog.decide, dev)[0]
    emit("device", checks)

    for i in range(args.repeat):
        if ppo:
            r = spans.ppo_readings(prog, start, dev)
            names = {"adam_device_ms": "adam_device_s",
                     "rollout_host_ms": "rollout_host_s",
                     "update_host_ms": "update_host_s"}
            counts = {"update_launches": "train_step_launches"}
        else:
            r = spans.twoply_readings(prog, traffic["traced_plies"], dev)
            names = {"reply_movegen_device_ms": "reply_movegen_device_s",
                     "reply_eval_device_ms": "reply_eval_device_s",
                     "decision_host_ms": "decision_host_s"}
            counts = {"decision_launches": "decision_launches"}
        row = {k: 1e3 * r[v] for k, v in names.items()}
        row.update({k: r[v] for k, v in counts.items()})
        row.update(spans_device_ms=1e3 * r["spans_device_s"],
                   outside_ms=1e3 * r["spans_outside_s"],
                   unmatched=r["spans_unmatched"],
                   kernel_launches=r["spans_kernel_launches"],
                   ops_launches=r["spans_ops_launches"],
                   idle_s=list(r["spans_idle"].items())[:spans.TOP])
        emit(f"spans {i}", row)

    rates = {False: [], True: []}
    for _ in range(args.cost):
        for on in (False, True):
            if ppo:
                prog.restore(start)
            sync()
            n, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < args.seconds:
                if on:
                    with program.recording():
                        step()
                else:
                    step()
                sync()
                n += 1
            rates[on].append(n * per / (time.perf_counter() - t0))
    if args.cost:
        row = {}
        for on, got in rates.items():
            key = "on" if on else "off"
            q = statistics.quantiles(got, n=4) if len(got) > 1 else got * 3
            med = statistics.median(got)
            row[key] = {"runs": got, "median": med,
                        "spread": (q[2] - q[0]) / med}
        emit(f"cost {unit}", row)


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)
    main()
