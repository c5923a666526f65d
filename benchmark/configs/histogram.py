"""The ``histogram`` configuration as the program runs it: upstream
Enoki's histogram mini-app (``tests/histogram.cpp``), written once over
the port's ``PCG32``, ``ops.erfinv`` and ``ops.histogram``, as a user of
``ops`` writes it, and instantiated over either array type:

* eager: the generator's state an int64 tensor on the card, each
  operation a launch of its own, the counts by the ``hist`` kernels;
* lazy: the generator over ``trace.LazyArray`` lanes, the step recorded
  and evaluated once, counts and next state together, as one fused
  program of generated kernels found in the kernel cache after the
  first step. The state comes out of each eval as a buffer on the card,
  the next step's input, so the trace does not grow.

A step draws one float a lane, takes its probit ``erfinv(2u - 1) *
sqrt(2)``, bins it over [lo, hi) and counts the bins (lanes outside the
range dropped), and reads the counts to the host.
"""

from __future__ import annotations

import math

import torch

SQRT2 = math.sqrt(2.0)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def bin_index(g, lo: float, hi: float, bins: int):
    """The bin of each sample, int32; a sample outside [lo, hi) gets -1
    or ``bins``, which ``ops.histogram`` drops. The float is clamped to
    [-1, bins] before the cast: erfinv(-1) is -inf, whose cast to an
    integer differs between devices."""
    from enoki_tpu_torch import ops
    b = ops.floor((g - lo) * (bins / (hi - lo)))
    return ops.clamp(b, -1.0, float(bins)).to(torch.int32)


class Histogram:
    """The mini-app over ``n`` lanes of one generator, stepped by
    ``launch`` (the draws, the probit, the bins and the counts, left on
    the card) and ``read`` (the counts on the host, which ends a step).

    ``params`` is the weight a draw adds to its bin (1, as
    histogram.cpp's ``scatter_add`` adds), a host parameter: the counts
    ``read`` gives are differentiable in it, as ``ops.histogram``'s are
    in its weights. ``bins_of`` is the binning, a method a fault may
    replace."""

    def __init__(self, cfg: dict, weight, n: int, dtype: str, device,
                 lazy: bool, initstate: int):
        from enoki_tpu_torch import trace
        from enoki_tpu_torch.types import PCG32
        self.lo, self.hi = cfg["range"]
        self.bins, self.n, self.lazy = cfg["bins"], n, lazy
        self.dtype = DTYPES[dtype]
        self.params = torch.nn.Parameter(
            weight.detach().to("cpu", torch.float32).reshape(-1)[:1].clone())
        if lazy:
            self.gen = PCG32.create_lazy(n, initstate=initstate,
                                         device=device)
            # the seeded state and the stream's increment become buffers,
            # so that every step records the same program
            trace.eval(self.gen.state.v, self.gen.inc.v)
        else:
            self.gen = PCG32.create(n, initstate=initstate, device=device)

    def bins_of(self, g):
        return bin_index(g, self.lo, self.hi, self.bins)

    def probit(self, u):
        from enoki_tpu_torch import ops
        x = 2.0 * u - 1.0
        if self.dtype != torch.float32:
            return (ops.erfinv(x.to(self.dtype)) * SQRT2).to(torch.float32)
        return ops.erfinv(x) * SQRT2

    def launch(self):
        """One step's draws and counts, (bins,) float32 on the device."""
        from enoki_tpu_torch import ops, trace
        u, gen = self.gen.next_float32()
        counts = ops.histogram(self.bins_of(self.probit(u)), self.bins)
        # an array still referenced at an eval is one of its outputs: the
        # draws are not, so that the lazy step writes only counts and state
        del u
        if self.lazy:
            trace.eval(counts, gen.state.v)
            counts = counts.torch()
        self.gen = gen
        return counts

    def read(self, counts):
        return counts.cpu() * self.params

    def __call__(self):
        return self.read(self.launch())

    def state(self):
        """The generator's state, the uint64 bit patterns in int64."""
        v = self.gen.state.v
        return (v.torch().view(torch.int64) if self.lazy else v).clone()


class Program:
    """``path`` (``"eager"`` or ``"lazy"``) and ``initstate`` are the
    run's: the traffic's kind sets them from the mix and the seed before
    it makes the model."""

    path = "eager"

    def __init__(self, cfg: dict, device):
        from enoki_tpu_torch.types import PCG32_DEFAULT_STATE
        self.cfg, self.device = cfg, device
        self.initstate = PCG32_DEFAULT_STATE

    def load(self):
        """The first calls into the program's builds: the hist kernels'
        library, and the lazy trace's native core."""
        from enoki_tpu_torch import _build, trace  # noqa: F401
        _build.load("hist")

    def model(self, vec, n: int, dtype: str | None = None):
        """The mini-app over ``n`` lanes whose draws weigh ``vec[0]``;
        ``dtype`` the probit's, the configuration's unless given."""
        return Histogram(self.cfg, vec, n, dtype or self.cfg["dtype"],
                         self.device, self.path == "lazy", self.initstate)
