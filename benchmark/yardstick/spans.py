"""The program's spans on the device trace's clock.

The port marks its layer boundaries with spans
(``mlp_ppo_2ply_p3_tpu_torch/utils/profiling.py``: ``span``,
``recording``).  While they record, each span is also a
``torch.profiler.record_function`` range, so a trace with host and
device activity holds the spans and the card's work on one clock.  This
module puts each piece of the card's work (a kernel, copy or fill) down
to the spans that were open on the host when it was launched: the
device event and the runtime or driver call that launched it share a
correlation id.  A kernel that runs after its span has closed on the
host is still its span's.

- ``Attribution`` does that on plain event lists, so that it is tested
  without a card, and reads it: the device time launched inside spans of a
  name (the union of their intervals), the launch calls inside them,
  the device's idle gaps by the innermost span open when each gap
  ended, and the device time launched outside every span;
- ``ppo_readings`` and ``twoply_readings`` trace one update (one
  decision) of a benchmark driver's program until two traces agree,
  then time the spans on the host with no profiler.  They return {}
  where the program has no spans.
"""

from __future__ import annotations

import statistics
import sys

import torch

from .profiling import AGREE, MAX_TRACES, busy_seconds

# every span the program opens
SPANS = ("train_step", "rollout", "policy", "env_step", "movegen",
         "ppo_update", "minibatch_step", "adam_step", "decision", "one_ply",
         "reply_movegen", "reply_eval")
# runtime and driver calls that put work on the card, by the start of
# their name (versioned forms end in a suffix); a graph launch counts one
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
            "cudaMemsetAsync", "cudaGraphLaunch")
NONE = "(no span)"
TOP = 10                # idle-gap entries logged
HOST_UPDATES = 3        # updates whose spans are timed on the host
# the hand-written kernels by the wrapper that counts their launches
# (``ops.launches()``): the kernel each wrapper call launches once
KERNELS = {"compact_rows": ("compact_rows_kernel", "compact_tiles_kernel"),
           "dedup_compact_rows": ("dedup_compact_kernel",),
           "doubles_level": ("doubles_levels_kernel",),
           "nondoubles": ("nondoubles_kernel",),
           "doubles_final": ("doubles_final_kernel",),
           "afterstate_eval": ("afterstate_eval_kernel",),
           "afterstate_eval_backward": ("afterstate_backward_kernel",)}


def _is_call(name):
    """A CUDA runtime (``cuda*``) or driver (``cu`` + capital) call."""
    return name.startswith("cuda") or (name[:2] == "cu" and
                                       name[2:3].isupper())


def _stacks(spans, times):
    """For each of ``times``, the names of the spans open then (start <=
    t < end), outermost first.  Spans nest: they come from one thread."""
    marks = sorted([(a, 1, i) for i, (_, a, _) in enumerate(spans)]
                   + [(b, 0, i) for i, (_, _, b) in enumerate(spans)])
    out, stack, k = [()] * len(times), [], 0
    for j in sorted(range(len(times)), key=times.__getitem__):
        while k < len(marks) and marks[k][0] <= times[j]:
            _, opens, i = marks[k]
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            k += 1
        out[j] = tuple(spans[i][0] for i in stack)
    return out


class Attribution:
    """The card's work and the launch calls of one trace, each with the
    spans open on the host at its launch."""

    def __init__(self, spans, calls, device):
        """``spans`` (name, start, end) on the host; ``calls``
        (correlation id, start, name) of the runtime and driver;
        ``device`` (correlation id, start, end, name) of the card's
        kernels, copies and fills; all in ns on one clock."""
        self.spans = spans
        launch = {corr: t for corr, t, _ in calls}
        known = [d for d in device if d[0] in launch]
        stacks = _stacks(spans, [launch[d[0]] for d in known])
        self.device = [(a, b, name, s) for (_, a, b, name), s
                       in zip(known, stacks)]
        self.device += [(a, b, name, ()) for corr, a, b, name in device
                        if corr not in launch]
        self.unmatched = len(device) - len(known)
        ours = [(t, name) for _, t, name in calls
                if name.startswith(LAUNCHES)]
        self.calls = list(zip(ours, _stacks(spans, [t for t, _ in ours])))

    def device_seconds(self, name=None) -> float:
        """The union of the device intervals launched inside a span
        ``name`` (None: all of them)."""
        return busy_seconds((a, b) for a, b, _, s in self.device
                            if name is None or name in s) / 1e9

    def outside_seconds(self) -> float:
        """The union of the device intervals launched outside every span
        (or by a call the trace lacks)."""
        return busy_seconds((a, b) for a, b, _, s in self.device
                            if not s) / 1e9

    def launches(self, name) -> int:
        """Launch calls inside a span ``name``."""
        return sum(name in s for _, s in self.calls)

    def kernel_launches(self) -> dict:
        """{wrapper: its kernel's launches in the trace}, as ``KERNELS``."""
        return {w: sum(any(k in n for k in ks) for _, _, n, _ in self.device)
                for w, ks in KERNELS.items()}

    def idle_by_span(self) -> dict:
        """Each gap between the device's merged busy intervals, in
        seconds, summed by the innermost span open on the host when the
        gap ended (the launch that ended it, or the work the host was
        doing then)."""
        merged = []
        for a, b in sorted((a, b) for a, b, _, _ in self.device):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        gaps = [(m[1], n[0]) for m, n in zip(merged, merged[1:])]
        by = {}
        for (a, b), s in zip(gaps, _stacks(self.spans, [b for _, b in gaps])):
            key = s[-1] if s else NONE
            by[key] = by.get(key, 0.0) + (b - a) / 1e9
        return dict(sorted(by.items(), key=lambda kv: -kv[1]))


def _events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    spans, calls, device = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            # the device's copy of a record_function range is no work
            if name not in SPANS:
                device.append((e.correlation_id(), e.start_ns(), e.end_ns(),
                               name))
        elif name in SPANS:
            spans.append((name, e.start_ns(), e.end_ns()))
        elif _is_call(name):
            calls.append((e.correlation_id(), e.start_ns(), name))
    return spans, calls, device


def _program_profiling():
    """The program's ``utils.profiling``, or None where it has no spans."""
    from mlp_ppo_2ply_p3_tpu_torch.utils import profiling

    return profiling if hasattr(profiling, "recording") else None


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _trace_once(fn, device, program):
    from torch.profiler import ProfilerActivity, profile

    from mlp_ppo_2ply_p3_tpu_torch import ops

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    before = ops.launches()
    _sync(device)
    with program.recording(), profile(activities=activities) as prof:
        fn()
        _sync(device)
    rise = {k: v - before[k] for k, v in ops.launches().items()}
    return Attribution(*_events(prof)), rise


def trace(fn, device, program, before=None):
    """(Attribution, the rise of ``ops.launches()``) of one ``fn()`` call
    traced with host and device activity and the spans of ``program``
    (its ``utils.profiling``) recording.  As ``profiling.device_busy``
    does, the call is traced until two traces in a row agree on the
    device time within ``AGREE`` (at most ``MAX_TRACES``): one trace now
    and then reads long where the card ran slower.  The later of the two
    is kept; where none agree, the last.  ``before()``, where given, runs
    ahead of each trace."""
    got = []
    for _ in range(MAX_TRACES):
        if before is not None:
            before()
        got.append(_trace_once(fn, device, program))
        if len(got) >= 2:
            a, b = (att.device_seconds() for att, _ in got[-2:])
            if abs(a - b) <= AGREE * max(a, b):
                break
    return got[-1]


def host_seconds(records, name) -> list:
    """The host durations of the recorded spans ``name``, in seconds."""
    return [(b - a) / 1e9 for n, _, _, a, b in records if n == name]


def _common(att, rise, root):
    """The readings both kinds of trace give; logs the two lines."""
    idle = att.idle_by_span()
    total = att.device_seconds()
    print(f"idle gaps by span (traced time, s): "
          f"{[[k, v] for k, v in list(idle.items())[:TOP]]}",
          file=sys.stderr)
    print(f"device time outside any span: {att.outside_seconds():.6f} s of "
          f"{total:.6f} s ({att.unmatched} device events with no launch "
          f"call in the trace)", file=sys.stderr)
    return {"spans_device_s": total, "spans_outside_s": att.outside_seconds(),
            "spans_unmatched": att.unmatched, "spans_idle": idle,
            f"{root}_launches": att.launches(root),
            "spans_kernel_launches": att.kernel_launches(),
            "spans_ops_launches": rise}


def ppo_readings(prog, start, device) -> dict:
    """One update from ``start`` (a ``drivers.ppo.Program`` snapshot)
    traced with the spans (``trace``), then ``HOST_UPDATES`` updates
    from it with the spans and no profiler: {reading: value}."""
    spans = _program_profiling()
    if spans is None:
        return {}
    att, rise = trace(prog.step, device, spans, lambda: prog.restore(start))
    r = _common(att, rise, "train_step")
    r["adam_device_s"] = att.device_seconds("adam_step")
    rollout, update = [], []
    for _ in range(HOST_UPDATES):
        prog.restore(start)
        _sync(device)
        with spans.recording() as records:
            prog.step()
            _sync(device)
        rollout += host_seconds(records, "rollout")
        update += host_seconds(records, "ppo_update")
    r["rollout_host_s"] = statistics.median(rollout)
    r["update_host_s"] = statistics.median(update)
    return r


def twoply_readings(prog, plies, device) -> dict:
    """One decision of a ``drivers.twoply.Program`` traced with the
    spans (``trace``), then ``plies`` plies (each a decision and an env
    step, ended on the card) with the spans and no profiler: {reading:
    value}."""
    spans = _program_profiling()
    if spans is None:
        return {}
    att, rise = trace(prog.decide, device, spans)
    r = _common(att, rise, "decision")
    r["reply_movegen_device_s"] = att.device_seconds("reply_movegen")
    r["reply_eval_device_s"] = att.device_seconds("reply_eval")
    decisions = []
    for _ in range(plies):
        _sync(device)
        with spans.recording() as records:
            prog.advance(1)
            _sync(device)
        decisions += host_seconds(records, "decision")
    r["decision_host_s"] = statistics.median(decisions)
    return r
