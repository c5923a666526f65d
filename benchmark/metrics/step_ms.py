"""``step_ms``: the whole measured window over the steps completed in it,
in ms, by the host clock; a step ends when its result is on the host."""

from benchmark import stats


def read(run):
    return stats.step_ms(run.steps.window(), len(run.steps.marks))
