"""Vectorized method calls mini-app on the PyTorch port -- the twin of
examples/calls.py (parity with docs/calls.rst).

A sphere scene where every pixel's hit is shaded by one of three
registered materials, dispatched per lane two ways, the masked select
tree (``dispatch_masked``) and the sort-based partition
(``dispatch_partition``). The two must agree bit for bit; each is timed
with CUDA events over chained iterations (each iteration's input depends
on the one before) and printed beside the card's name and power limit.

Run: python examples/calls_torch.py [n]      (n x n lanes, default 1024)
Runs on the CUDA card (``main(n, device="cpu")`` runs it on the CPU).
"""

import statistics
import subprocess
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import torch

from enoki_tpu_torch import resolve_device
from enoki_tpu_torch.ops import router
from enoki_tpu_torch.struct import dispatch_masked, dispatch_partition

# --- three "materials" (the virtual classes of docs/calls.rst) -----------


def lambert(mask, n_dot_l, base):
    return 0.2 + torch.clamp_min(n_dot_l, 0.0) * base


def glossy(mask, n_dot_l, base):
    s = torch.clamp_min(n_dot_l, 0.0)
    # s ** 8 as jnp computes a Python-int power (integer_pow: three
    # squarings); PyTorch's pow takes another route, up to 5 ulp away
    s2 = s * s
    s4 = s2 * s2
    return 0.1 + (s4 * s4) * base * 1.5


def emissive(mask, n_dot_l, base):
    return base * 2.0 + 0 * n_dot_l


MATERIALS = [lambert, glossy, emissive]


def scene_rays(n, device=None):
    """n*n lanes: each lane's shading inputs and material id (three
    vertical stripes; background lanes take id 0)."""
    device = resolve_device(device)
    ax = router.linspace(-1.2, 1.2, n, device=device)
    px, py = router.meshgrid(ax, ax)
    r2 = px * px + py * py
    n_dot_l = torch.where(r2 < 1.0, router.sqrt(torch.clamp_min(1 - r2, 0.0)),
                          0.0)
    # a division by a 0-d tensor: one IEEE division on the CPU and the card
    stripe = (px + 1.2) / torch.tensor(0.8, device=device)
    ids = torch.clamp(stripe.to(torch.int32), 0, 2)
    base = torch.full_like(px, 60.0)
    return ids, n_dot_l, base


def shade_masked(ids, n_dot_l, base):
    return dispatch_masked(MATERIALS, ids, n_dot_l, base)


def shade_partition(ids, n_dot_l, base):
    return dispatch_partition(MATERIALS, ids, n_dot_l, base)


def chained_ms(fn, ids, n_dot_l, base, iters=50, windows=5):
    """Median over windows of the time of one iteration, where each
    iteration shades an input moved by the mean of the last output (so
    that no iteration can start before the one before has ended); CUDA
    events on the card, the wall clock on the CPU."""
    card = n_dot_l.device.type == "cuda"
    times = []
    for _ in range(windows):
        x = n_dot_l
        if card:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda.synchronize()
            start.record()
        t0 = time.perf_counter()
        for k in range(iters):
            out = fn(ids, x, base)
            x = n_dot_l + out.mean() * 1e-12 + 1e-6 * k
        if card:
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            times.append(1e3 * (time.perf_counter() - t0) / iters)
    return statistics.median(times)


def card_name(device):
    """The card's name and power limit, as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(device)


def main(n=1024, device=None, iters=50, windows=5):
    """Shade n*n lanes both ways, check that they agree bit for bit, time
    each; returns (masked ms, partition ms)."""
    device = resolve_device(device)
    ids, n_dot_l, base = scene_rays(n, device)
    a = shade_masked(ids, n_dot_l, base)
    b = shade_partition(ids, n_dot_l, base)
    same = bool(torch.equal(a, b))
    print(f"masked == partition (bit for bit): {same}")
    if not same:
        raise SystemExit("dispatch_masked and dispatch_partition disagree")
    t_m = chained_ms(shade_masked, ids, n_dot_l, base, iters, windows)
    t_p = chained_ms(shade_partition, ids, n_dot_l, base, iters, windows)
    lanes = n * n
    where = card_name(device)
    for name, t in (("dispatch_masked   ", t_m), ("dispatch_partition", t_p)):
        print(f"{name}: {t:8.4f} ms a chained iteration "
              f"({lanes / (t * 1e-3) / 1e9:6.2f} G lanes/s), {n}x{n} lanes, "
              f"3 materials, on {where}")
    return t_m, t_p


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024)
