"""``roofline.histogram``: a step of the histogram mini-app's share of
its roofline. For each step that the traced run kept (drawn from the
seed), the least time of the step's work (``work/histogram.py``'s
``draws``: the larger of bytes over the memory's peak and operations,
INT32 weighted twice, over the FP32 peak), over the device time of every
operation that began between the start of the step's ``draw`` span and
the end of its ``readback`` span, whatever kernels they are: the eager
launches, the lazy trace's generated kernels, the counts' copy; summed
over the kept steps.

An operation is tied to its step by when it ran, not by its launch: the
step ends with a read that waits for all of its work, and the next step
launches nothing before it, so no operation of another step runs
there. (The profiler does not link the generated kernels' launches,
made by ctypes from a library of their own, to a runtime call, so
``tracing.ops_in`` would miss them.)"""

from benchmark import peaks, tracing


def read(run):
    td = run.trace_data
    draws = tracing.spans_named(td, "draw")
    reads = tracing.spans_named(td, "readback")
    least = device = 0.0
    for w, args in run.traced_work:
        lo, hi = draws[w][0], reads[w][1]
        ops = [o for o in td.ops if lo <= o.start <= hi]
        t = peaks.least_seconds(run.device_kind, *run.work.draws(**args))
        if t is None:
            return None
        if not ops:
            raise RuntimeError(f"no device operation ran in the step of "
                               f"window step {w}")
        least += t[0]
        device += sum(min(o.end, hi) - o.start for o in ops)
    return 100.0 * least / device if device else None
