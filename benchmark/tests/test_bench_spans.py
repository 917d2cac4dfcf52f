"""The spans' reading (``yardstick/spans.py``) on synthetic event lists,
with no card: attribution by correlation id, the union of overlapping
intervals, idle gaps by the innermost span, a graph launch counting
one; and the program's spans in a CPU trace.

    python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.yardstick import spans  # noqa: E402

# train_step [0, 1000] holds rollout [10, 400] (its policy [20, 60]) and
# ppo_update [500, 990] (its adam_step [600, 700]); times in ns
SPANS = [("train_step", 0, 1000), ("rollout", 10, 400), ("policy", 20, 60),
         ("ppo_update", 500, 990), ("adam_step", 600, 700)]


def test_a_kernel_is_its_launchs_span_after_the_span_closed():
    # launched in adam_step at 650, run on the card at 1200-1300, after
    # every span has closed on the host
    att = spans.Attribution(SPANS, [(7, 650, "cudaLaunchKernel")],
                            [(7, 1200, 1300, "k")])
    assert att.device[0][3] == ("train_step", "ppo_update", "adam_step")
    assert att.device_seconds("adam_step") == pytest.approx(100e-9)
    assert att.device_seconds("rollout") == 0
    assert att.launches("adam_step") == att.launches("train_step") == 1
    assert att.outside_seconds() == 0 and att.unmatched == 0


def test_a_span_is_open_from_its_start_to_before_its_end():
    times = [0, 10, 59, 60, 400, 1000, 2000]
    assert spans._stacks(SPANS, times) == [
        ("train_step",), ("train_step", "rollout"),
        ("train_step", "rollout", "policy"), ("train_step", "rollout"),
        ("train_step",), (), ()]


def test_overlapping_intervals_count_once():
    calls = [(1, 610, "cudaLaunchKernel"), (2, 620, "cudaMemcpyAsync"),
             (3, 30, "cudaLaunchKernel")]
    device = [(1, 2000, 2100, "a"), (2, 2050, 2150, "Memcpy DtoD"),
              (3, 2140, 2200, "b")]
    att = spans.Attribution(SPANS, calls, device)
    assert att.device_seconds("adam_step") == pytest.approx(150e-9)
    assert att.device_seconds("policy") == pytest.approx(60e-9)
    assert att.device_seconds() == pytest.approx(200e-9)
    assert att.launches("train_step") == 3


def test_a_graph_launch_counts_one():
    calls = [(5, 650, "cudaGraphLaunch"), (6, 655, "cudaStreamSynchronize")]
    device = [(5, 1000, 1010, "k1"), (5, 1010, 1030, "k2"),
              (5, 1100, 1110, "k3")]
    att = spans.Attribution(SPANS, calls, device)
    assert att.launches("adam_step") == 1
    assert att.device_seconds("adam_step") == pytest.approx(40e-9)


def test_work_outside_every_span():
    calls = [(1, 1500, "cudaLaunchKernel"), (2, 700, "cuLaunchKernel")]
    device = [(1, 2000, 2100, "a"), (2, 2100, 2130, "b"),
              (9, 3000, 3050, "no call")]
    att = spans.Attribution(SPANS, calls, device)
    assert att.unmatched == 1
    assert att.outside_seconds() == pytest.approx(150e-9)
    # the driver's launch at 700 is ppo_update's, after adam_step closed
    assert att.device_seconds("ppo_update") == pytest.approx(30e-9)
    assert att.device_seconds("adam_step") == 0


def test_idle_gaps_go_to_the_innermost_span_open_when_they_end():
    # busy [0, 30] and [25, 50] merge; the gap to 55 ends in policy, the
    # gap to 650 in adam_step, the gap to 800 in ppo_update, the gap to
    # 1500 outside every span
    iv = [(0, 30), (25, 50), (55, 100), (650, 700), (800, 900),
          (1500, 1600)]
    device = [(i, a, b, "k") for i, (a, b) in enumerate(iv)]
    att = spans.Attribution(SPANS, [], device)
    assert att.idle_by_span() == pytest.approx(
        {"policy": 5e-9, "adam_step": 550e-9, "ppo_update": 100e-9,
         spans.NONE: 600e-9})
    assert list(att.idle_by_span())[0] == spans.NONE


def test_the_hand_written_kernels_by_their_wrapper():
    device = [(1, 0, 1, "void (anonymous namespace)::afterstate_eval_"
               "kernel<0, false>(Args)"),
              (2, 1, 2, "(anonymous namespace)::afterstate_fill_kernel"),
              (3, 2, 3, "compact_tiles_kernel<true>"),
              (4, 3, 4, "tile_count_kernel"),
              (5, 4, 5, "nondoubles_kernel(signed char const*)")]
    got = spans.Attribution([], [], device).kernel_launches()
    assert got == {"compact_rows": 1, "dedup_compact_rows": 0,
                   "doubles_level": 0, "nondoubles": 1, "doubles_final": 0,
                   "afterstate_eval": 1, "afterstate_eval_backward": 0}


@pytest.mark.parametrize("name,call", [
    ("cudaLaunchKernel", True), ("cudaLaunchKernelExC_v11060", True),
    ("cuLaunchKernelEx", True), ("cudaDeviceSynchronize", True),
    ("aten::mul", False), ("cub::DeviceRadixSort", False),
    ("adam_step", False)])
def test_runtime_and_driver_calls_by_name(name, call):
    assert spans._is_call(name) == call


def test_the_programs_spans_in_a_cpu_trace():
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling as program

    assert spans._program_profiling() is program
    with program.recording() as records, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with program.span("train_step"):
            with program.span("adam_step"):
                torch.ones(3).sum()
    got, calls, device = spans._events(prof)
    assert sorted(n for n, _, _ in got) == ["adam_step", "train_step"]
    assert calls == [] and device == []
    (_, a0, b0), = [s for s in got if s[0] == "train_step"]
    (_, a1, b1), = [s for s in got if s[0] == "adam_step"]
    assert a0 <= a1 <= b1 <= b0
    assert [r[0] for r in records] == ["train_step", "adam_step"]
    assert spans.host_seconds(records, "adam_step") == [
        (records[1][4] - records[1][3]) / 1e9]


@pytest.mark.parametrize("reads,kept", [
    ([100, 101], 2), ([100, 150, 151], 3),
    ([100, 200, 100, 200, 100, 200], 6)])
def test_traced_until_two_traces_agree(monkeypatch, reads, kept):
    """Each trace after ``before()``; the later of the first two that
    agree within 2% is kept, or the last of ``MAX_TRACES``."""
    made, befores = [], []

    def once(fn, device, program):
        n = reads[len(made)]
        made.append(spans.Attribution([], [], [(0, 0, n, "k")]))
        return made[-1], {}

    monkeypatch.setattr(spans, "_trace_once", once)
    att, _ = spans.trace(None, None, None, lambda: befores.append(1))
    assert len(made) == len(befores) == kept
    assert att is made[-1]
