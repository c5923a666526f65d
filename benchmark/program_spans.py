"""The program's own spans in a traced run, which the per-layer metrics
``port_host_ms``, ``launch_us`` and ``idle_in_port_ms`` read.

While ``torch.profiler`` records, the port opens its spans as profiler
annotations named ``enoki.<name>`` and keeps each, as it closes, in
``enoki_tpu_torch._build.SPANS``: (name, start, end, thread), start and
end in ns of the profiler's clock, so that they lie beside the device
operations of ``tracing.reduce``'s trace. ``enoki.render.forward`` holds
one render call, from the port's entry to the return of its autograd
Function; ``enoki.render.backward`` the render's backward, on autograd's
thread; ``enoki.render.prepass`` the cone prepass; ``enoki.launch.<kernel>``
one ctypes launch.

A program older than its spans has no such record, and its metrics are
left out of the result line. A program that has it, but whose traced
window holds no ``enoki.render.`` span, fails the run: it lost its spans,
and its metrics would read 0.
"""

from __future__ import annotations

import collections

RENDER = "enoki.render."
LAUNCH = "enoki.launch."

# start and end in seconds from the traced window's start
Span = collections.namedtuple("Span", "name start end thread")


def window_spans(run):
    """The program's spans that began in the traced window, by start;
    None where the program keeps no record of its spans."""
    from enoki_tpu_torch import _build

    record = getattr(_build, "SPANS", None)
    if record is None:
        return None
    lo, hi = run.trace_data.window
    lo_ns, hi_ns = round(lo * 1e9), round(hi * 1e9)
    spans = sorted((Span(n, (s - lo_ns) * 1e-9, (e - lo_ns) * 1e-9, th)
                    for n, s, e, th in list(record) if lo_ns <= s <= hi_ns),
                   key=lambda x: x.start)
    if not any(x.name.startswith(RENDER) for x in spans):
        raise RuntimeError("the program keeps its spans, but the traced "
                           "window holds no enoki.render span")
    return spans
