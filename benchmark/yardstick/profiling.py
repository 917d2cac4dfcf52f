"""Device time from the card: a frozen copy of the PyTorch port's
``utils/profiling.py`` (``busy_seconds``, ``device_busy``, ``timed_scan``),
so that a later change to the program cannot change how it is measured,
and the reading of one ``torch.profiler`` trace with host and device
activity (``Trace``): kernel time by name and the breakdown of the
device's work and of its idle gaps by what the host was doing.
"""

from __future__ import annotations

import torch

SCAN_ITERS = 20     # calls captured in one timed_scan graph
GRAPH_REPLAYS = 3   # timed replays of that graph
AGREE = 0.02        # two traces of one call agree within this share
MAX_TRACES = 6      # of the larger; a call is traced at most this often
TOP = 10            # entries of each breakdown list


def busy_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, reach = 0.0, None
    for a, b in sorted(intervals):
        if reach is None or a > reach:
            total += b - a
            reach = b
        elif b > reach:
            total += b - reach
            reach = b
    return total


def _cuda_spans(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def device_busy(fn, device, before=None):
    """(busy, window): the seconds in which the card ran work of one
    ``fn()`` call, the union of its CUDA intervals in a ``torch.profiler``
    trace with device activity alone, and the host's seconds for that
    traced call.  The call is traced until two traces in a row agree
    within ``AGREE`` of the larger (at most ``MAX_TRACES``), the larger of
    the two kept; where none agree, the largest.  A trace now and then
    drops records, which can only shorten the union.  ``before()``, where
    given, runs ahead of each trace and outside it (to put back the
    state that each traced call starts from)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    readings = []
    for _ in range(MAX_TRACES):
        if before is not None:
            before()
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        readings.append((busy_seconds((a, b) for a, b, _ in
                                      _cuda_spans(prof)) / 1e9, wall))
        if len(readings) >= 2:
            a, b = readings[-2][0], readings[-1][0]
            if abs(a - b) <= AGREE * max(a, b):
                return max(readings[-2:])
    return max(readings)


def timed_scan(fn, *args, iters: int = SCAN_ITERS) -> float:
    """Seconds per call of ``fn(*args)`` on the card: one warm-up call on
    a side stream, then ``iters`` calls captured into one CUDA graph whose
    replays are timed with CUDA events, so the host's launches drop out.
    A function that cannot be captured raises."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    current = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn(*args)
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / (GRAPH_REPLAYS * iters)


class Trace:
    """One call traced with host and device activity."""

    def __init__(self, fn, device):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize(device)
        cpu = torch.autograd.DeviceType.CPU
        events = list(prof.profiler.kineto_results.events())
        self.kernels = [(e.start_ns(), e.end_ns(), e.name()) for e in events
                        if e.device_type() == torch.autograd.DeviceType.CUDA]
        # the host's operators; the CUDA runtime's own calls (launches,
        # copies, synchronisations) name no work of the program
        self.host = [(e.start_ns(), e.end_ns(), e.name()) for e in events
                     if e.device_type() == cpu
                     and not e.name().startswith(("ProfilerStep", "cuda"))]

    def kernel_seconds(self, stems) -> float:
        """Summed device time of the kernels whose name holds any of
        ``stems``."""
        return sum(b - a for a, b, name in self.kernels
                   if any(s in name for s in stems)) / 1e9

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        between the device's busy intervals, summed by the host operation
        that started last before each gap ended (the one whose launch
        ended it, or the host work still running then)."""
        import bisect

        ops = {}
        for a, b, name in self.kernels:
            key = name[:120]
            ops[key] = ops.get(key, 0.0) + (b - a) / 1e9
        merged = []
        for a, b in sorted((a, b) for a, b, _ in self.kernels):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        host = sorted(self.host)
        starts = [a for a, _, _ in host]
        gaps = {}
        for (_, end), (start, _) in zip(merged, merged[1:]):
            i = bisect.bisect_right(starts, start) - 1
            label = host[i][2][:120] if i >= 0 else "(no host operation)"
            gaps[label] = gaps.get(label, 0.0) + (start - end) / 1e9
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}
