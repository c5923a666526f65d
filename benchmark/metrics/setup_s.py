"""``setup_s``: process start to the first timed step, in s, by the host
clock: imports, the CUDA context, the build or load of the kernels, the
inputs made from the seed, the warm-up and the checked steps. The
seconds in which the plain reference makes inputs (a fit's targets) are
left out: they are not the program's."""


def read(run):
    return run.setup_s
