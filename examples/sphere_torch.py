"""Sphere ray tracer mini-app on the PyTorch/CUDA port -- the twin of
examples/sphere.py (parity with reference tests/sphere.cpp).

Renders n x n pixels (1024 by default), times the staged path (rays, hits
and shade each materialised) and the fused one over a chained loop of
frames, each frame's radius depending on the previous frame's mean, and
writes sphere1.ppm (staged) and sphere2.ppm (fused) like the reference's
main() (tests/sphere.cpp:129-151). On the card the loop is timed with CUDA
events, and the times are printed beside the card's name and power limit.

Run: python examples/sphere_torch.py [n]
Needs a CUDA card unless main() is called with device="cpu".
"""

import dataclasses
import os
import subprocess
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import torch

from enoki_tpu_torch import resolve_device
from enoki_tpu_torch.render import SphereScene, render_fused, render_staged
from enoki_tpu_torch.render.io import write_ppm


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip() or torch.cuda.get_device_name(0)


def chained(renderer, scene, n, iters):
    """``iters`` frames, each on a radius moved by the previous frame's
    mean (times 1e-12: the image stays the same, the frames cannot
    overlap); returns the last mean, still on the device."""
    carry = torch.zeros((), device=scene.radius.device)
    for _ in range(iters):
        s = dataclasses.replace(scene, radius=scene.radius + carry * 1e-12)
        carry = torch.mean(renderer(s, n))
    return carry


def seconds_per_frame(renderer, scene, n, iters):
    """Device time per frame of the chained loop on the card (CUDA
    events), host time on the CPU; after one warm-up loop."""
    chained(renderer, scene, n, 2)
    if scene.radius.device.type != "cuda":
        t0 = time.perf_counter()
        float(chained(renderer, scene, n, iters))
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    chained(renderer, scene, n, iters)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e-3 / iters


def main(n=1024, iters=100, device=None, out_dir="."):
    """Times both paths and writes both images; returns the seconds per
    frame of (staged, fused)."""
    device = resolve_device(device)
    scene = SphereScene.reference(device)
    where = (card() if device.type == "cuda"
             else f"{device.type} host time, not a device time")
    times = []
    for label, renderer, name in (
            ("Separate kernels", render_staged, "sphere1.ppm"),
            ("Combined kernels", render_fused, "sphere2.ppm")):
        t = seconds_per_frame(renderer, scene, n, iters)
        times.append(t)
        print(f"{label}: {t * 1e3:.3f} ms per {n}x{n} frame ({where})",
              file=sys.stderr)
        write_ppm(os.path.join(out_dir, name),
                  renderer(scene, n).reshape(n, n).cpu().numpy())
    return tuple(times)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024)
