"""``roofline.render_fwd``: the forward render's share of its roofline.
For each step that the traced run kept (drawn from the seed), the least
time the card could take for the work that the step's inputs need
(``work/<config>.py``'s ``render_fwd`` on the reference march's counts
at those inputs: the larger of bytes over the memory's peak and FP32
operations over their peak; the root's bytes only where a backward
reads it), over the device time of every operation launched inside
that step's forward span, whatever kernels they are; summed over the
kept steps."""

from benchmark import peaks, tracing


def read(run):
    least = device = 0.0
    spans = tracing.spans_named(run.trace_data, "forward")
    for w, args in run.traced_work:
        lo, hi = spans[w]
        ops = tracing.ops_in(run.trace_data, lo, hi)
        t = peaks.least_seconds(run.device_kind, *run.work.render_fwd(**args))
        if t is None:
            return None
        if not ops:
            raise RuntimeError(f"no device operation is linked to the "
                               f"forward span of window step {w}")
        least += t[0]
        device += sum(o.end - o.start for o in ops)
    return 100.0 * least / device if device else None
