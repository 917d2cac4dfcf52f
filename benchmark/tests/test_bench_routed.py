"""The routed cell's pieces on the CPU: its reference loads nothing of the
program and trains at test sizes; its class rule is the program's; the
work of a pass is each kept board's once, on its own network.

    python -m pytest benchmark/tests/test_bench_routed.py -q
"""

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.reference import routed as ref_routed  # noqa: E402
from benchmark.yardstick import deep_work, routed_work, work  # noqa: E402


def _cfg(**ppo):
    cfg = run.load_json(ROOT, "benchmark", "configs", "wildbg2net4096.json")
    cfg["model"] = dict(cfg["model"], hidden_size=12, trunk=[10, 8])
    cfg["ppo"] = dict(cfg["ppo"], num_envs=4, t_horizon=2,
                      num_minibatches=2, num_epochs=1, **ppo)
    return cfg


def test_routed_reference_loads_nothing_of_the_program():
    code = (
        "import sys, torch\n"
        "from benchmark.reference import routed\n"
        "from benchmark.tests.test_bench_routed import _cfg\n"
        "t = routed.Trainer(_cfg(), 1, torch.device('cpu'), "
        "fault='swapped')\n"
        "t.train_step()\n"
        "print(sorted({n.partition('.')[0] for n in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(json.loads(proc.stdout.strip().splitlines()[-1]
                           .replace("'", '"')))
    assert "torch" in names
    assert not names & {"mlp_ppo_2ply_p3_tpu_torch", "mlp_ppo_2ply_p3_tpu",
                        "jax", "jaxlib", "flax"}


def _boards(seed=3, batch=6, m=40):
    """Random canonical boards, a third of them races by construction."""
    gen = torch.Generator().manual_seed(seed)
    pts = torch.randint(0, 4, (batch, m, 48), generator=gen)
    pts = pts * (torch.rand((batch, m, 48), generator=gen) < 0.3)
    tail = torch.randint(0, 2, (batch, m, 4), generator=gen)
    boards = torch.cat([pts, tail], -1).to(torch.int8)
    race = torch.rand((batch, m), generator=gen) < 0.33
    raced = boards.clone()
    raced[..., 0:12] = 0
    raced[..., 36:50] = 0
    return torch.where(race[..., None], raced, boards)


def test_the_reference_rule_is_the_programs():
    from mlp_ppo_2ply_p3_tpu_torch.core import board as Bd
    from mlp_ppo_2ply_p3_tpu_torch.core import features as F

    boards = _boards()
    race = ref_routed.race_of_boards(boards)
    assert torch.equal(race, Bd.is_race(boards))
    assert 0 < int(race.sum()) < race.numel()
    for mover in (0, 1):
        x = F.encode_canonical(boards, torch.tensor(mover))
        assert torch.equal(ref_routed.race_of_features(x), race)
        assert torch.equal(F.is_race(x), race)


def test_a_pass_counts_each_kept_board_once():
    """Both groups' kept boards are the pass's kept boards; the operations
    are the single network's over them, the weights' bytes read once a
    network; the route reads each kept board's bytes once."""
    boards = _boards()
    n = torch.tensor([0, 5, 40, 17, 1, 33], dtype=torch.int32)
    widths, heads = (300, 250, 200), 6
    got, rows = routed_work.pass_work(boards, n, "logits", widths, heads,
                                      True)
    kept = work._kept(n, 40, "logits")
    assert sum(rows) == int(kept.sum())
    race = ref_routed.race_of_boards(boards) & kept
    assert rows[1] == int(race.sum()) > 0
    one = deep_work.hidden(boards, n, 300, "logits")
    assert got["afterstate_hidden"][1] == one[1]
    params = 198 * 300 + 300
    floors = 4 * (boards.shape[0] * 40 - rows[0] - rows[1])
    assert got["afterstate_hidden"][0] == one[0] - floors + 4 * params \
        + 8 * boards.shape[0]
    dense = [a + b for a, b in zip(deep_work.dense(sum(rows), widths, heads),
                                   deep_work.dense(sum(rows), widths, heads,
                                                   True))]
    assert got["dense_layers"][1] == dense[1]
    assert got["afterstate_route"] == [routed_work.route_bytes(
        boards, n, "logits"), 0]
