"""``roofline.render_bwd``: the backward render's share of its roofline.
For each step that the traced run kept, the least time of the work that
the step's inputs need (``work/<config>.py``'s ``render_bwd`` on the
reference march's counts at those inputs), over the device time of
every operation launched from the moment the image's cotangent is whole
(a mark from a hook on the image) to the end of the step's backward
span: the render's backward, whatever kernels it takes; summed over the
kept steps."""

from benchmark import peaks, tracing


def read(run):
    td = run.trace_data
    spans = tracing.spans_named(td, "backward")
    marks = [t for n, t in td.marks if n == tracing.MARK_PREFIX + "render_bwd"]
    if not spans or len(marks) != len(spans):
        return None
    least = device = 0.0
    for w, args in run.traced_work:
        ops = tracing.ops_in(td, marks[w], spans[w][1])
        t = peaks.least_seconds(run.device_kind, *run.work.render_bwd(**args))
        if t is None:
            return None
        if not ops:
            raise RuntimeError(f"no device operation is linked to the "
                               f"render's backward in window step {w}")
        least += t[0]
        device += sum(o.end - o.start for o in ops)
    return 100.0 * least / device if device else None
