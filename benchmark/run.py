"""Run one cell of the benchmark of the PyTorch port on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``: it names a
configuration (``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``driver`` names the code
that drives it, ``benchmark/drivers/<driver>.py``); the cell's own file,
``benchmark/workloads/<cell>.json``, holds the limits of the numbers that
decide ``correct``.  Each metric is read by ``benchmark/metrics/<name>.py``
from what the run measured; a cell reports the entries of
``BENCHMARK.json`` whose ``workloads`` name it (or that name none): with
``--trace 0`` the ``end_to_end`` ones, with ``--trace 1`` the
``per_layer`` ones.  So a cell, a configuration, a traffic mix or a
metric is added by adding files and entries.

A run loads, warms up every shape the cell uses, measures for
``--seconds`` seconds, checks what the timed path produced against the
plain reference (``benchmark/reference/``), prints each number compared
beside its limit on standard error, and prints one JSON line last on
standard output.  It fails, printing no result, without a CUDA card (or
with fewer than the cell asks for), and if JAX or the JAX package has
been loaded.  ``--device cpu --tiny`` runs the plain PyTorch path at the
cell's test sizes (``cpu_test`` in its file), for the CPU tests.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "mlp_ppo_2ply_p3_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_metric(name):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell, kind):
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def merge(base, over):
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def forbidden_modules():
    return sorted({n.partition(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


class Context:
    """What a driver is given: the run's arguments, the cell's
    configuration and traffic, and the device."""

    def __init__(self, args, device, config, traffic):
        self.seed, self.seconds, self.trace = args.seed, args.seconds, \
            bool(args.trace)
        self.device, self.config, self.traffic = device, config, traffic
        self.t_start = T_START

    def log(self, what):
        """A progress line on standard error, seconds since the start."""
        print(f"[{time.perf_counter() - self.t_start:8.2f} s] {what}",
              file=sys.stderr, flush=True)

    def memory_peak(self):
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self):
        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain path, for the tests only")
    ap.add_argument("--tiny", action="store_true",
                    help="the cell's test sizes (with --device cpu)")
    args = ap.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}; have {sorted(cells)}",
              file=sys.stderr)
        return 2
    wl = cells[args.workload]

    import torch

    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < wl["chips"]:
            print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
                  f"torch sees {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(min(4, torch.get_num_threads()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    config = load_json(HERE, "configs", f"{wl['config']}.json")
    traffic = load_json(HERE, "traffic", f"{wl['traffic']}.json")
    cell = load_json(HERE, "workloads", f"{args.workload}.json")
    if args.tiny:
        config = merge(config, cell["cpu_test"].get("config", {}))
        traffic = merge(traffic, cell["cpu_test"].get("traffic", {}))
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    readings, numbers, attempted, failed = driver.run(
        Context(args, device, config, traffic))

    compared = {name: {"value": value, "limit": cell["limits"][name]}
                for name, value in numbers.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in compared.values())
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, args.workload, kind):
        value = load_metric(m["name"]).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": wl["chips"],
           "memory_peak_bytes": readings["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"], dev["window_s"] = readings["busy_s"], \
            readings["traced_s"]
        line["breakdown"] = readings["trace"].breakdown()
    line["compared"] = compared

    bad = forbidden_modules()
    if bad:
        print(f"loaded forbidden modules: {bad}", file=sys.stderr)
        return 3
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    sys.path.insert(0, ROOT)
    sys.exit(main())
