"""``dp_study.py`` on the CPU: two gloo ranks, rank 0's update traced twice
from one restored state, its readings written.

    python -m pytest benchmark/tests -q
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import dp_study  # noqa: E402


def test_rank0_traced_from_one_state(tmp_path, capfd):
    out = tmp_path / "dp.json"
    dp_study.main(["--cpu", "--traces", "2", "--out", str(out)])
    got = json.loads(out.read_text())
    assert got["ranks"] == 2 and got["device"] == "cpu"
    rows = got["rows"]
    assert [r["trace"] for r in rows] == [0, 1]
    assert all(r["busy_ms"] > 0 and r["wall_s"] > 0 and r["top"]
               for r in rows), rows
    # the same update twice: the same operators
    assert {n for n, _ in rows[0]["top"]} & {n for n, _ in rows[1]["top"]}
    printed = [json.loads(line) for line in
               capfd.readouterr().out.splitlines() if line.startswith("{")]
    assert [r["trace"] for r in printed] == [0, 1]
