"""``host_ms``: the mean, over every step of the traced window, of the
host's time from the step's start until it begins to wait for the
step's result (the read-back call), by the host clock."""


def read(run):
    host = run.steps.host()
    return 1e3 * sum(host) / len(host) if host else None
