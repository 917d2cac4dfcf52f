"""The harness on the CPU at the cells' test sizes: every cell runs end
to end and prints the contract's last line; a run without a card fails;
no run loads JAX or the JAX package; the reference loads nothing of the
program; a cell, a traffic mix and a metric added as files are picked up
with no edit.

    python -m pytest benchmark/tests -q
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w["name"] for w in json.load(open(
    os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]
SEED = 3_000_000_019   # past 32 signed bits, as the driver's are


def _run(*args, cwd=ROOT, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "benchmark", "run.py"), *args],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env={**os.environ, **(env or {})})


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_end_to_end(cell):
    proc = _run("--workload", cell, "--seed", str(SEED), "--seconds", "0.5",
                "--trace", "0", "--device", "cpu", "--tiny")
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    want = {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])}
    # the device's trace is the card's: on the CPU those metrics find
    # nothing to read and are left out of the line
    traced = {m["name"] for m in bench["end_to_end"]
              if m["source"] == "device_trace"}
    assert want & traced and want - traced
    assert set(line["metrics"]) == want - traced
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    # each number compared beside its limit, the last lines of stderr
    tail = proc.stderr.strip().splitlines()[-len(line["compared"]):]
    for text, (name, c) in zip(tail, line["compared"].items()):
        assert text == f"{name} {c['value']!r} limit {c['limit']!r}"


def test_no_card_no_result():
    proc = _run("--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                "--trace", "0", env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, the
    program is missing: the run fails and prints no result."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--device", "cpu", "--tiny"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


_MODULES = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{n.partition(".")[0] for n in sys.modules}})))
"""


def _top_level_modules(body):
    code = _MODULES.format(root=ROOT, body=body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", CELLS)
def test_runs_load_no_jax(cell):
    names = _top_level_modules(
        "from benchmark import run\n"
        f"assert run.main(['--workload', {cell!r}, '--seed', '5', "
        "'--seconds', '0.2', '--device', 'cpu', '--tiny']) == 0")
    assert "mlp_ppo_2ply_p3_tpu_torch" in names
    # whole top-level names: the port's name begins with the JAX package's
    assert not names & {"jax", "jaxlib", "flax", "mlp_ppo_2ply_p3_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = _top_level_modules(
        "import torch\n"
        "from benchmark import run\n"
        "from benchmark.reference import compare, model, ppo, rules, twoply\n"
        "cfg = run.load_json('benchmark', 'configs', 'afterstate4096.json')\n"
        "cfg['ppo'].update(num_envs=4, t_horizon=2, num_minibatches=2, "
        "num_epochs=1)\n"
        "t = ppo.Trainer(cfg, 1, torch.device('cpu'))\n"
        "t.train_step()\n"
        "p = twoply.Player(model.load_npz('mlp_ppo_2ply_p3_tpu_torch/assets/"
        "frozen_benchmark_v1.npz', 'cpu'), rules.Movegen(**cfg['movegen']), "
        "2, 1, torch.device('cpu'), 8, 512)\n"
        "p.ply()\n")
    assert "torch" in names
    assert not names & {"mlp_ppo_2ply_p3_tpu_torch", "mlp_ppo_2ply_p3_tpu",
                        "jax", "jaxlib", "flax"}


def test_forbidden_compares_whole_names(monkeypatch):
    sys.path.insert(0, ROOT)
    from benchmark import run

    monkeypatch.setitem(sys.modules, "mlp_ppo_2ply_p3_tpu_torch_x", sys)
    assert "mlp_ppo_2ply_p3_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mlp_ppo_2ply_p3_tpu.core", sys)
    assert "mlp_ppo_2ply_p3_tpu" in run.forbidden_modules()


def test_added_files_are_picked_up(tmp_path):
    """A new cell, traffic mix and metric, added as files and entries of
    a copy, run with no edit to any file already there."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b = tmp_path / "benchmark"
    traffic = json.load(open(b / "traffic" / "selfplay-ppo.json"))
    traffic["checked_updates"] = 2
    json.dump(traffic, open(b / "traffic" / "selfplay-ppo-two.json", "w"))
    cell = json.load(open(b / "workloads" / "train4096-ppo.json"))
    json.dump(cell, open(b / "workloads" / "train4096-ppo-two.json", "w"))
    (b / "metrics" / "updates_done.py").write_text(
        "def read(r):\n    return float(r['updates'])"
        " if 'updates' in r else None\n")
    bench["workloads"].append({"name": "train4096-ppo-two",
                               "config": "train4096",
                               "traffic": "selfplay-ppo-two", "chips": 1,
                               "why": "a copy"})
    bench["end_to_end"].append({"name": "updates_done", "unit": "updates",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["train4096-ppo-two"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    proc = _run("--workload", "train4096-ppo-two", "--seed", "8",
                "--seconds", "0.3", "--device", "cpu", "--tiny",
                cwd=tmp_path, env={"PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    # train_step_device_ms names its cells, which do not include the new
    # one, and the CPU has no device trace
    assert set(line["metrics"]) == {"updates_done", "setup_s"}


@pytest.mark.parametrize("cell", ["afterstate4096-ppo", "train4096-ppo"])
def test_restored_state_repeats_the_update(cell):
    """The state that the device-time traces start from is put back
    whole: the update run after ``restore`` is the first one, bit for
    bit, however many updates ran in between."""
    import torch

    sys.path.insert(0, ROOT)
    from benchmark import run
    from benchmark.drivers import ppo

    wl = {w["name"]: w for w in json.load(open(
        os.path.join(ROOT, "BENCHMARK.json")))["workloads"]}[cell]
    test = run.load_json(ROOT, "benchmark", "workloads", f"{cell}.json")
    cfg = run.merge(run.load_json(ROOT, "benchmark", "configs",
                                  f"{wl['config']}.json"),
                    test["cpu_test"]["config"])
    prog = ppo.Program(cfg, SEED, torch.device("cpu"), 1)
    start = prog.snapshot()
    runs = []
    for later in (2, 0):
        prog.restore(start)
        loss = float(prog.step()["loss"])
        runs.append((loss, [p.detach().clone()
                            for p in prog.ts.model.parameters()],
                     ppo._fields(prog.es)))
        for _ in range(later):
            prog.step()
    (l0, p0, e0), (l1, p1, e1) = runs
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert all(torch.equal(e0[f], e1[f]) for f in e0)
