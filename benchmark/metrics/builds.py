"""``builds``: the nvcc builds that the run's process made, by the
program's counter ``_build.BUILDS["compile"]`` at the end of the run: 0
in a checkout whose kernels are built; above 0 where a kernel was built
(again)."""


def read(run):
    from enoki_tpu_torch import _build

    builds = getattr(_build, "BUILDS", None)
    return None if builds is None else builds["compile"]
