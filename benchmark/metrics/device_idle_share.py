"""``device_idle_share``: the share of the traced window in which no
operation ran on the device: 1 - (the union of the device operations'
intervals in the window) / (the window), from torch.profiler's trace."""

from benchmark import tracing


def read(run):
    td = run.trace_data
    lo, hi = td.window
    return 100.0 * (1.0 - tracing.busy_seconds(td) / (hi - lo))
