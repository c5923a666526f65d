"""``idle_in_port_ms``: the idle time that the port's host path holds the
card in. The stretches of the traced window in which no operation ran on
the device (``tracing.idle_gaps``) that lie inside any of the program's
``enoki.`` spans, on any thread, over the window's steps, in ms."""

from benchmark import program_spans, tracing


def read(run):
    spans = program_spans.window_spans(run)
    if spans is None:
        return None
    td = run.trace_data
    lo, hi = td.window
    gaps = tracing.idle_gaps([(o.start - lo, o.end - lo) for o in td.ops],
                             0.0, hi - lo)
    port = [(s.start, min(s.end, hi - lo)) for s in spans]
    # |gaps and port| = |gaps| + |port| - |gaps or port|
    inside = (tracing.union_seconds(gaps) + tracing.union_seconds(port)
              - tracing.union_seconds(gaps + port))
    return 1e3 * inside / len(run.steps.marks)
