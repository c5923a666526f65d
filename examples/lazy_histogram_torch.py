"""Histogram mini-app on the port's lazy trace -- the twin of
examples/lazy_histogram.py: tests/histogram.cpp as it runs on CUDAArray.

PCG32<UInt64C> generation, the probit transform (erfinv,
histogram.cpp:37-47), the clamp to the bins and the conflict-safe
scatter_add are all recorded into one trace and evaluated once (the
source paper fuses the same pipeline into one PTX kernel, docs/gpu.rst).
On the card that eval runs the trace's generated CUDA kernel, the
scatter_add into a private row of the 32 bins a thread in shared memory
(trace/codegen.py's route 1); on the CPU its plain interpreter.

Run: python examples/lazy_histogram_torch.py [n]
Needs a CUDA card unless main() is called with device="cpu".
"""

import math
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import torch

import enoki_tpu_torch.trace as tr
from enoki_tpu_torch import resolve_device
from enoki_tpu_torch.ops.special import erfinv
from enoki_tpu_torch.trace import LazyArray
from enoki_tpu_torch.types.random import PCG32

BINS = 32
LO, HI = -4.0, 4.0


def probit(n, device):
    """n normal samples as a lazy float32 array: lazy PCG32 lanes, a
    uniform draw, and erfinv's Giles fit from trace opcodes."""
    u, _ = PCG32.create_lazy(n, device=device).next_float32()
    return erfinv(2.0 * u - 1.0) * math.sqrt(2.0)


def histogram(n, device):
    """The lazy histogram of ``probit(n)`` into BINS bins over [LO, HI)
    (the samples outside clamped into the end bins); nothing evaluated."""
    idx = ((probit(n, device) - LO) * (BINS / (HI - LO))).cast(torch.int32)
    hist = LazyArray.zeros(BINS, torch.float32, device=device)
    hist.scatter_add(tr.clamp(idx, 0, BINS - 1),
                     LazyArray.full(1.0, n, device=device))
    return hist


def main(n=1 << 20, device=None):
    """Builds and evaluates the histogram (one eval: seed, draws, erfinv,
    scatter_add), prints it as a bar chart and returns the counts."""
    device = resolve_device(device)
    hist = histogram(n, device)
    evals_before = tr.stats()["n_evals"]
    counts = hist.torch().cpu()
    assert tr.stats()["n_evals"] == evals_before + 1
    assert float(counts.sum()) == n

    peak = float(counts.max())
    for b in range(BINS):
        bar = "*" * int(round(40 * float(counts[b]) / peak))
        print(f"{LO + (HI - LO) * b / BINS:5.1f} | {bar}")
    print(f"\n{n:,} normal samples from lazy PCG32 + erfinv, {BINS} bins, "
          "one eval")
    return counts


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 20)
