"""``load_s``: the wall time of the cell's first call into the program's
build (the kernels' library found and loaded in a warm checkout; traced
and compiled by nvcc in a fresh one), by the host clock."""


def read(run):
    return run.load_s
