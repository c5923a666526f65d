"""``port_host_ms``: the port's own host time a step. The union, over
every thread, of the program's ``enoki.render.`` spans (a render call
from the port's entry to the return of its autograd Function, and the
render's backward) in the traced window, over the window's steps, in ms:
the port's share of ``host_ms``."""

from benchmark import program_spans, tracing


def read(run):
    spans = program_spans.window_spans(run)
    if spans is None:
        return None
    end = run.trace_data.window[1] - run.trace_data.window[0]
    render = [(s.start, min(s.end, end)) for s in spans
              if s.name.startswith(program_spans.RENDER)]
    return 1e3 * tracing.union_seconds(render) / len(run.steps.marks)
