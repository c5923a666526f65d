"""The traced run's readings: spans that the benchmark's own loop records
around its calls into each layer, and the device operations from
``torch.profiler``'s trace, each tied to the span its launch lies in.

A span is a ``torch.profiler.record_function`` label on the host, named
``bench.<part>``; the loop wraps each part of a step in one. A device
operation (a kernel, a copy or a memset) shares its correlation id with
the runtime call that launched it (``cudaLaunchKernel``,
``cudaMemcpyAsync``, ...); the span it belongs to is the one whose
interval holds that launch, on whichever thread it ran (autograd runs a
backward on a thread of its own). Where the trace holds no such call,
the host operation that the profiler links the device operation to
stands in for it. Times are in seconds on the profiler's clock.
"""

from __future__ import annotations

import bisect
import dataclasses

SPAN_PREFIX = "bench."
MARK_PREFIX = "bench.mark."


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    launch: float | None   # host time of the launch, where the trace links it


@dataclasses.dataclass
class Trace:
    spans: list          # (name, start, end) of the main thread, by start
    marks: list          # (name, time) of instants marked from any thread
    ops: list            # DeviceOp, by start
    window: tuple        # (start, end) of the traced window


def union_seconds(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def idle_gaps(intervals, lo: float, hi: float):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(clip(intervals, lo, hi)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def reduce(events, window_marks=("bench.window",)) -> Trace:
    """A ``Trace`` from the profiler's raw events (``kineto_results
    .events()``): ``events`` may also be any objects with the same
    methods, as the tests give."""
    runtime, frontend, annotations, ops_raw = {}, {}, [], []
    for e in events:
        dev = str(e.device_type()).rsplit(".", 1)[-1]
        start, end = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        name = e.name()
        if dev == "CPU":
            # a runtime call is linked to the host operation it ran in; a
            # host operation is linked to nothing. Their ids are two
            # counts, which may hold the same number
            if e.linked_correlation_id():
                runtime[e.correlation_id()] = start
            else:
                frontend[e.correlation_id()] = start
            if e.is_user_annotation() and name.startswith(SPAN_PREFIX):
                annotations.append((name, start, end, e.start_thread_id()))
        elif not e.is_user_annotation():
            ops_raw.append((name, start, end, e.correlation_id(),
                            e.linked_correlation_id()))
    win = [a for a in annotations if a[0] in window_marks]
    if not win:
        raise RuntimeError("the trace holds no window span")
    main = win[0][3]
    window = (min(a[1] for a in win), max(a[2] for a in win))
    spans = sorted((n, s, e) for n, s, e, th in annotations
                   if th == main and not n.startswith(MARK_PREFIX)
                   and n not in window_marks)
    spans.sort(key=lambda x: x[1])
    marks = sorted(((n, s) for n, s, _, _ in annotations
                    if n.startswith(MARK_PREFIX)), key=lambda x: x[1])
    ops = sorted((DeviceOp(n, s, e, runtime.get(c) or frontend.get(lc or -1))
                  for n, s, e, c, lc in ops_raw), key=lambda o: o.start)
    return Trace(spans, marks, ops, window)


def ops_in(trace: Trace, lo: float, hi: float):
    """The device operations launched in [lo, hi] (host clock)."""
    return [o for o in trace.ops
            if o.launch is not None and lo <= o.launch <= hi]


def spans_named(trace: Trace, name: str):
    return [(s, e) for n, s, e in trace.spans if n == SPAN_PREFIX + name]


def busy_seconds(trace: Trace) -> float:
    lo, hi = trace.window
    return union_seconds(clip([(o.start, o.end) for o in trace.ops], lo, hi))


def host_span_at(trace: Trace, t: float) -> str:
    """The name of the main thread's innermost span open at ``t``, or
    "between spans"."""
    starts = [s for _, s, _ in trace.spans]
    i = bisect.bisect_right(starts, t)
    best = None
    for n, s, e in trace.spans[max(0, i - 8):i]:
        if s <= t <= e and (best is None or s >= best[1]):
            best = (n, s)
    return best[0][len(SPAN_PREFIX):] if best else "between spans"


def breakdown(trace: Trace, top: int = 10):
    """The device operations that took most time and the longest idle
    gaps by what the host was doing when each began, in seconds."""
    by_op = {}
    lo, hi = trace.window
    for o in trace.ops:
        if o.end > lo and o.start < hi:
            by_op[o.name] = by_op.get(o.name, 0.0) + min(o.end, hi) \
                - max(o.start, lo)
    by_gap = {}
    for s, e in idle_gaps([(o.start, o.end) for o in trace.ops], lo, hi):
        k = host_span_at(trace, s)
        by_gap[k] = by_gap.get(k, 0.0) + (e - s)
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in order(by_op)],
            "idle_gaps": [[k, v] for k, v in order(by_gap)]}
