"""The yardstick against hand counts: the frozen work functions, the
least time, the union of device intervals, the leaf comparison and the
control's TF32 rounding.

    python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.reference import compare, model, rules  # noqa: E402
from benchmark.yardstick import peaks, profiling, work  # noqa: E402


def _initial_board():
    pts = rules.initial_points("cpu")[None]
    zero = torch.zeros((1, 2), dtype=torch.int8)
    return rules.to_canonical(pts, zero, zero, torch.zeros(1,
                                                           dtype=torch.int8))


def test_features_of_the_initial_board():
    # a point of 2, 5, 3 and 5 checkers sets 2, 4, 3 and 4 features, for
    # each side, and the mover's one-hot one
    board = _initial_board()
    assert int(work._nnz(board)[0]) == 2 * (2 + 4 + 3 + 4) + 1
    feats = rules.encode_canonical(board, torch.zeros(1, dtype=torch.int32))
    assert int((feats != 0).sum()) == 27


def _boards(m=3):
    return _initial_board().expand(1, m, 52).clone()


def test_afterstate_work_by_hand():
    n = torch.tensor([2], dtype=torch.int32)
    params = 4 * 198 + 2 * 4 + 1
    got = work.afterstate(_boards(), n, 4, 4, "masked")
    assert got == (2 * 52 + 8 + 4 * params + 4 * 3,
                   2 * 54 * 4 + 2 * (3 * 4 + 1), 2, 54)
    got = work.afterstate(_boards(), n, 4, 4, "masked", backward=True)
    assert got == (2 * 56 + 8 + 8 * params, 4 * 54 * 4 + 2 * 5 * 4, 2, 54)
    # the min writes one value a row; logits keep every slot of a row
    # without moves, whose raw values the policy keeps
    assert work.afterstate(_boards(), n, 4, 4, "min")[0] == \
        2 * 52 + 8 + 4 * params + 4
    none = torch.tensor([0], dtype=torch.int32)
    assert work.afterstate(_boards(), none, 4, 4, "logits")[2:] == (3, 81)
    assert work.afterstate(_boards(), none, 4, 4, "masked")[2:] == (0, 0)


def test_nondoubles_bytes_by_hand():
    assert work.nondoubles(2, 3) == 2 * 61 + 2 * 3 * 52 + 10
    place = (torch.tensor([0, -1]), torch.tensor([True, False]))
    # one non-double game; one doubles game past the capacity, which
    # writes its row
    assert work.nondoubles(2, 3, place) == 10 + 61 + 10 + 2 * 3 * 52 + 10


def test_least_time_and_flops():
    assert work.least_seconds(peaks.BYTES_PER_S) == pytest.approx(1.0)
    assert work.least_seconds(0, peaks.PEAK_OPS_PER_S) == pytest.approx(1.0)
    assert work.least_seconds(peaks.BYTES_PER_S, 2 * peaks.PEAK_OPS_PER_S) \
        == pytest.approx(2.0)
    assert work.mlp_flops(27, 1, 128, 257) == 2 * 128 * 27 + 2 * 128 * 257


def test_busy_seconds_is_the_union():
    assert profiling.busy_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_leaf_gap_leaves_out_quiet_leaves():
    assert compare.leaf_gap([1, 1, 5], [1, 2, 0], [1, 1, 0]) == 0.5
    assert compare.leaf_gap([0, 0], [1, 3], [1, 1]) == 1.0


def test_tf32_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0])
    assert model.tf32(one + 2 ** -11).item() == 1 + 2 ** -10
    assert model.tf32(one + 2 ** -12).item() == 1.0
    assert model.tf32(-(one + 2 ** -11)).item() == -(1 + 2 ** -10)
