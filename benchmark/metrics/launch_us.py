"""``launch_us``: what one kernel launch of the port costs the host. The
mean length of the program's ``enoki.launch.<kernel>`` spans (the ctypes
call: its arguments' conversion and ``cudaLaunchKernel``) in the traced
window, in us."""

from benchmark import program_spans


def read(run):
    spans = program_spans.window_spans(run)
    if spans is None:
        return None
    launches = [s.end - s.start for s in spans
                if s.name.startswith(program_spans.LAUNCH)]
    if not launches:
        raise RuntimeError("the traced window holds render spans but no "
                           "enoki.launch span")
    return 1e6 * sum(launches) / len(launches)
