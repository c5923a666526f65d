"""Sphere ray tracer on the port's lazy trace -- the twin of
examples/lazy_sphere.py, the docs/gpu.rst workflow end to end.

The source paper's GPU chapter builds the sphere demo statement by
statement on ``FloatC`` arrays: every line appends to the trace, nothing
runs until the image is read, and the whole render fuses into one kernel
(docs/gpu.rst; tests/sphere.cpp math). This example does that on
``enoki_tpu_torch.trace.LazyArray``: eager-looking code, one eval at the
first read (on the card the trace's generated CUDA kernels, built by
nvcc the first time; on the CPU the plain interpreter), and a kernel
cache hit for the second frame, whose scene differs only in a literal.
It writes sphere_lazy.ppm.

Run: python examples/lazy_sphere_torch.py [n]
Needs a CUDA card unless main() is called with device="cpu".
"""

import os
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import torch

import enoki_tpu_torch.trace as tr
from enoki_tpu_torch import resolve_device
from enoki_tpu_torch.trace import LazyArray


def _grid(n, extent, device):
    """The flat (n*n,) pixel grid, x varying along columns (sphere.cpp:
    130-131's linspace + meshgrid), as lazy float32 coordinates."""
    idx = LazyArray.arange(n * n, device=device)
    col = (idx % n).cast(torch.float32)
    row = (idx / n).cast(torch.int32).cast(torch.float32)
    step = 2.0 * extent / (n - 1)
    return col * step - extent, row * step - extent


def _scalar(v, device):
    """A scene parameter as a size-1 float32 literal of its own."""
    return LazyArray.literal(v, 1, torch.float32, device=device)


def render_lazy(n: int, cx=0.0, cy=0.0, radius=1.0, extent=1.2,
                device=None):
    """tests/sphere.cpp:58-88's semantics, a statement at a time; returns
    the lazy (n*n,) image."""
    device = resolve_device(device)
    px, py = _grid(n, extent, device)

    # rays: o = (px, py, -1), d = (0, 0, 1), relative to the sphere's
    # centre, whose coordinates are literals of their own (a Python
    # number would share one literal with any other of its value, and
    # the program's structure would depend on the scene)
    ox, oy = px - _scalar(cx, device), py - _scalar(cy, device)
    oz = LazyArray.full(-1.0, 1, device=device)

    # the quadratic: a = 1, b = 2*oz, c = |o|^2 - r^2
    b = oz * 2.0
    c = ox * ox + oy * oy + oz * oz - radius * radius
    discrim = b * b - c * 4.0
    valid = discrim >= 0.0
    t = (-b + tr.sqrt(tr.maximum(discrim, 0.0))) * 0.5

    # the hit normal (the hit position on the origin-centred unit sphere)
    nx, ny, nz = ox, oy, oz + t
    zero = LazyArray.full(0.0, 1, device=device)
    nx = tr.select(valid, nx, zero)
    ny = tr.select(valid, ny, zero)
    nz = tr.select(valid, nz, zero)

    # shade: 0.2 + max(dot(n, L), 0) * 90, L = (-1, -1, 2)
    lam = tr.maximum(nx * -1.0 + ny * -1.0 + nz * 2.0, 0.0)
    return lam * 90.0 + 0.2


def render_lazy_struct(n: int, cx=0.0, cy=0.0, radius=1.0, extent=1.2,
                       device=None):
    """The same program in Ray-struct form (Ray3fC): a struct of lazy
    arrays flows through intersect and shade, and the whole of it still
    fuses into one program (the struct helpers dispatch per leaf)."""
    from enoki_tpu_torch.render.vec import Vec3, dot3
    from enoki_tpu_torch.struct import enoki_struct, select_struct

    @enoki_struct
    class Ray:
        o: Vec3
        d: Vec3

    device = resolve_device(device)
    px, py = _grid(n, extent, device)

    def full(v):
        return LazyArray.full(v, 1, device=device)

    ray = Ray(o=Vec3(px - _scalar(cx, device), py - _scalar(cy, device),
                     full(-1.0)),
              d=Vec3(full(0.0), full(0.0), full(1.0)))
    b = 2.0 * dot3(ray.o, ray.d)
    c = dot3(ray.o, ray.o) - radius * radius
    disc = b * b - 4.0 * c
    valid = disc >= 0.0
    t = (-b + tr.sqrt(tr.maximum(disc, 0.0))) * 0.5
    hit = ray.o + ray.d * t
    nrm = select_struct(valid, hit, Vec3(full(0.0), full(0.0), full(0.0)))
    lam = tr.maximum(nrm.x * -1.0 + nrm.y * -1.0 + nrm.z * 2.0, 0.0)
    return lam * 90.0 + 0.2


def main(n=1024, device=None, out_dir="."):
    """Renders the lazy frame, a second frame (a kernel cache hit), the
    struct form, and compares them with the eager ``render_fused``;
    returns a dict of what it measured."""
    from enoki_tpu_torch.render import SphereScene, render_fused
    from enoki_tpu_torch.render.io import write_ppm

    device = resolve_device(device)
    img = render_lazy(n, device=device)
    print("before eval:", img)              # still lazy
    t0 = time.perf_counter()
    out = img.torch()                       # one eval
    t_first = time.perf_counter() - t0
    print(f"first frame (build + run): {t_first * 1e3:8.1f} ms")

    misses = tr.cache_stats()[1]
    t0 = time.perf_counter()
    render_lazy(n, cx=0.05, device=device).torch()
    t_second = time.perf_counter() - t0
    second_hit = tr.cache_stats()[1] == misses
    print(f"second frame             : {t_second * 1e3:8.1f} ms "
          f"(cache hits, misses: {tr.cache_stats()})")

    s0 = tr.stats()["n_evals"]
    out_s = render_lazy_struct(n, device=device).torch()
    assert tr.stats()["n_evals"] == s0 + 1, "the struct form did not fuse"
    err_s = float((out_s - out).abs().max())
    print(f"Ray-struct form: one eval, max |err| {err_s:.2e}")

    ref = render_fused(SphereScene.reference(device), n).reshape(-1)
    err = float((out - ref).abs().max())
    print(f"max |err| vs render_fused: {err:.2e}")
    img_np = out.cpu().numpy()
    print(f"image mean {img_np.mean():.4f} (hit fraction "
          f"{(img_np > 0.3).mean():.3f})")
    write_ppm(os.path.join(out_dir, "sphere_lazy.ppm"), img_np.reshape(n, n))
    print("wrote sphere_lazy.ppm")
    return {"first_s": t_first, "second_s": t_second,
            "second_hit": second_hit, "struct_err": err_s,
            "fused_err": err, "image": out}


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024)
