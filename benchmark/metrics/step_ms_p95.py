"""``step_ms_p95``: the 95th percentile of the wall time of every step of
the window, in ms, by the host clock (each step from its start to its
read-back or synchronise)."""

from benchmark import stats


def read(run):
    return 1e3 * stats.percentile(run.steps.durations(), 95)
