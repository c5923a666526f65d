"""Haversine-distance mini-app on the PyTorch/CUDA port -- the twin of
examples/haversine.py (parity with docs/dynamic.rst "A benchmark").

The great-circle distance between n coordinate pairs (10M by default)
stored as a struct of four tensors, computed with the port's ``ops.sin``,
``ops.cos``, ``ops.asin`` and ``ops.sqrt`` (``--impl native``: PyTorch's
own functions; ``--impl poly``: the reference's range reductions and
polynomials). Times 100 data-chained steps (each step's first latitude
moved by the previous step's mean distance times 1e-12) with CUDA events
on the card, and the vectorised numpy float32 version on the host, and
prints the max relative error against numpy float64, beside the card's
name and power limit.

Run: python examples/haversine_torch.py [n] [--impl native|poly]
                                         [--iters 100] [--device cpu]
Needs a CUDA card unless --device cpu is given.
"""

import argparse
import dataclasses
import subprocess
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np
import torch

from enoki_tpu_torch import ops, resolve_device


@dataclasses.dataclass
class GeoRecord:
    """The record batch, one tensor per field (a dataclass of tensors
    until the port has ``struct/``)."""
    lat1: torch.Tensor
    lon1: torch.Tensor
    lat2: torch.Tensor
    lon2: torch.Tensor


EARTH_RADIUS_KM = 6371.0


def haversine(r: GeoRecord, impl="native"):
    """Great-circle distance in km (the docs/dynamic.rst kernel)."""
    dlat = r.lat2 - r.lat1
    dlon = r.lon2 - r.lon1
    a = (ops.sin(dlat * 0.5, impl) ** 2
         + ops.cos(r.lat1, impl) * ops.cos(r.lat2, impl)
         * ops.sin(dlon * 0.5, impl) ** 2)
    return 2.0 * EARTH_RADIUS_KM * ops.asin(ops.sqrt(a), impl)


def haversine_numpy(lat1, lon1, lat2, lon2):
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = (np.sin(dlat * 0.5) ** 2
         + np.cos(lat1) * np.cos(lat2) * np.sin(dlon * 0.5) ** 2)
    return 2.0 * EARTH_RADIUS_KM * np.arcsin(np.sqrt(a))


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def chained(rec, impl, iters):
    """``iters`` steps, each on a first latitude moved by the previous
    step's mean distance (times 1e-12: the steps cannot overlap); returns
    the last mean, still on the device."""
    carry = torch.zeros((), device=rec.lat1.device)
    for _ in range(iters):
        r = dataclasses.replace(rec, lat1=rec.lat1 + carry * 1e-12)
        carry = torch.mean(haversine(r, impl))
    return carry


def seconds_per_step(rec, impl, iters):
    """Device time per step of the chained loop on the card (CUDA events),
    host time on the CPU; after a warm-up of two steps."""
    chained(rec, impl, 2)
    if rec.lat1.device.type != "cuda":
        t0 = time.perf_counter()
        float(chained(rec, impl, iters))
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    chained(rec, impl, iters)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3 / iters


def main(n=10_000_000, impl="native", iters=100, device=None):
    """Times the chained loop and numpy; returns (seconds per step, max
    relative error of one step against numpy float64)."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    lat = rng.uniform(-np.pi / 2, np.pi / 2, (4, n)).astype(np.float32)
    rec = GeoRecord(*(torch.from_numpy(x).to(device) for x in lat))
    t_dev = seconds_per_step(rec, impl, iters)

    t0 = time.perf_counter()
    haversine_numpy(*lat)
    t_np = time.perf_counter() - t0

    out = haversine(rec, impl).cpu().numpy().astype(np.float64)
    ref64 = haversine_numpy(*(x.astype(np.float64) for x in lat))
    err = float((np.abs(out - ref64) / np.maximum(ref64, 1e-9)).max())
    where = (card() if device.type == "cuda"
             else f"{device.type} host time, not a device time")
    print(f"records               : {n:,} (impl={impl})")
    print(f"port ({where}): {t_dev * 1e3:8.3f} ms   "
          f"{n / t_dev / 1e9:6.2f} G records/s")
    print(f"numpy (host, vector)  : {t_np * 1e3:8.3f} ms   "
          f"{n / t_np / 1e9:6.2f} G records/s")
    print(f"max rel err vs f64    : {err:.2e}")
    return t_dev, err


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=int, default=10_000_000)
    p.add_argument("--impl", choices=("native", "poly"), default="native")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--device", default=None)
    a = p.parse_args()
    main(a.n, a.impl, a.iters, a.device)
