"""Histogram mini-app on the PyTorch/CUDA port -- the twin of
examples/histogram.py (parity with reference tests/histogram.cpp).

16M normal-distributed samples generated on the card (PCG32 -> uniform ->
probit via erfinv), binned with the dense histogram kernel, timed with
CUDA events, and printed as a terminal bar chart like the reference's
main().

Run: python examples/histogram_torch.py [n]
Needs a CUDA card (the kernel is built with nvcc at its first use).
"""

import math
import subprocess
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import torch

from enoki_tpu_torch import ops
from enoki_tpu_torch.types import PCG32

BINS = 64
LO, HI = -4.0, 4.0


def bin_index(g):
    """The bin of each sample, int32; a sample outside [LO, HI) gets an
    index that ``ops.histogram`` drops. The float is clamped to [-1, BINS]
    before the cast: what the cast of +-inf (erfinv(+-1)) gives differs
    between devices."""
    b = torch.floor((g - LO) * (BINS / (HI - LO)))
    return torch.clamp(b, -1.0, float(BINS)).to(torch.int32)


def build_histogram(gen: PCG32, erfinv_impl: str = "native"):
    u, gen = gen.next_float32()
    g = ops.erfinv(2.0 * u - 1.0, erfinv_impl) * math.sqrt(2.0)  # probit
    # ops.histogram: the named dense-histogram op (out-of-range indices
    # drop, the reference's masked-scatter_add semantics)
    hist = ops.histogram(bin_index(g), BINS)
    return hist, gen


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 24  # 16M
    gen = PCG32.create(n)

    hist, gen2 = build_histogram(gen)  # warm: builds the kernel
    torch.cuda.synchronize()

    iters = 10
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g = gen2
    for _ in range(iters):
        hist, g = build_histogram(g)  # chained: iteration i+1 needs i
    end.record()
    torch.cuda.synchronize()
    dt = start.elapsed_time(end) * 1e-3 / iters

    hist = hist.cpu().numpy()
    print(f"samples: {n:,}   time: {dt * 1e3:.3f} ms   "
          f"({n / dt / 1e9:.2f} G samples/s: RNG + erfinv + histogram; "
          f"{card()})")
    peak = hist.max()
    for i in range(0, BINS, 2):  # 32 rows
        x = LO + (i + 0.5) * (HI - LO) / BINS
        bar = "*" * int(round(40 * (hist[i] + hist[i + 1]) / (2 * peak)))
        print(f"{x:+5.2f} | {bar}")


if __name__ == "__main__":
    main()
