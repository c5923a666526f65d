"""Inverse rendering on the port's lazy trace: the FloatD optimisation
loop -- the twin of examples/lazy_fit.py.

The source paper's flagship AD workflow (docs/autodiff.rst) is gradient
descent over ``FloatD = DiffArray<CUDAArray<float>>`` scene parameters:
every step re-traces the render, ``backward(loss)`` walks the tape, and
the kernel cache makes every step after the first free of compilation.
This example is that loop on ``enoki_tpu_torch.trace``: it recovers a
sphere's (cx, cy, radius) from a target image with the trace's AD
(requires_grad / backward / gradient). The forward program and its
adjoint are each one eval a step (on the card the trace's generated CUDA
kernels, on the CPU its plain interpreter), and from the second step on
both are kernel cache hits.

The render is written against the public ``ops`` surface (one source,
every backend): the same ``render`` runs eagerly on tensors.

The step is the reference's, ``LR * gradient * n^2 / 4096``, with that
factor capped at 1 (``RATE_CAP``): at 64^2 and below it is the
reference's step exactly, and above it the step stays that of 64^2. The
loss is a mean over the pixels, so its gradient does not grow with n^2,
and the uncapped factor overshoots: at 256^2 the loss oscillates and at
1024^2 the fit diverges. Capped, the loss falls at every step at 64^2,
256^2 and 1024^2; ``fit(n, 10, device="cpu")`` reads, as a fraction of the
first, 0.629, 0.393, 0.257, 0.176, 0.122 after steps 1-5 at 64^2 and
0.621, 0.392, 0.251, 0.163, 0.108 at 1024^2, and 0.032 after step 9 at
1024^2.

Run: python examples/lazy_fit_torch.py [n] [steps]
Needs a CUDA card unless main() is called with device="cpu".
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np
import torch

import enoki_tpu_torch.trace as tr
from enoki_tpu_torch import ops, resolve_device
from enoki_tpu_torch.trace import LazyArray

TRUE = (0.12, -0.08, 0.85)     # the target sphere's (cx, cy, radius)
INIT = (0.0, 0.0, 1.0)
LR = (4e-6, 4e-6, 2e-6)        # the reference's rates of (cx, cy, r)
RATE_CAP = 1.0                 # the most n^2 / 4096 may scale them by


def render(cx, cy, radius, n, device, extent=1.2):
    """The sphere image against the unified ops surface (tests/sphere.cpp:
    58-88's math); the pixel grid is a LazyArray.arange on ``device``, so
    the whole pipeline is a trace program whatever the parameters are."""
    idx = LazyArray.arange(n * n, device=device)
    col = (idx % n).cast(torch.float32)
    row = (idx / n).cast(torch.int32).cast(torch.float32)
    step = 2.0 * extent / (n - 1)
    px = col * step - extent - cx
    py = row * step - extent - cy
    oz = -1.0

    b = 2.0 * oz
    c = px * px + py * py + oz * oz - radius * radius
    disc = b * b - 4.0 * c
    valid = disc >= 0.0
    # safe_sqrt: the zero-at-the-boundary derivative (the square root of
    # the clamped discriminant would send 0 * inf = NaN into the backward)
    t = (-b + ops.safe_sqrt(disc)) * 0.5
    nz = ops.select(valid, oz + t, 0.0)
    nx = ops.select(valid, px, 0.0)
    ny = ops.select(valid, py, 0.0)
    lam = ops.clamp(nx * -1.0 + ny * -1.0 + nz * 2.0, 0.0, 1e9)
    return lam * 90.0 + 0.2


def loss_of(params, target, n, device):
    """The mean squared difference of the render from ``target``; only the
    loss is returned, so that no intermediate becomes an output of the
    program (every array still referenced at an eval is one)."""
    diff = render(*params, n, device) - target
    return (diff * diff).hsum() * (1.0 / (n * n))


def target_image(n, device):
    """The image at the true parameters, evaluated."""
    return render(*(LazyArray.full(v, 1, device=device) for v in TRUE),
                  n, device).eval()


def fit(n=256, steps=40, device=None, hook=None):
    """``steps`` gradient steps from INIT; returns a dict with the losses,
    the parameters, the cache's (hits, misses) and the host wall ms of
    each step (forward eval, backward). ``hook(k, loss, params)``, when
    given, is called with each step's evaluated loss before its backward
    and may return a callable, which then receives the step's gradients
    (tensors)."""
    device = resolve_device(device)
    target = target_image(n, device)
    p = np.array(INIT, np.float32)
    lr = np.array(LR, np.float32) * np.float32(min(n * n / 4096.0,
                                                   RATE_CAP))
    losses, walls = [], []
    for k in range(steps):
        tr.clear_gradients()
        params = [tr.requires_grad(LazyArray(p[i:i + 1], device=device))
                  for i in range(3)]
        t0 = time.perf_counter()
        loss = loss_of(params, target, n, device)
        loss.eval()
        t1 = time.perf_counter()
        after = hook(k, loss, params) if hook is not None else None
        t2 = time.perf_counter()
        tr.backward(loss)  # the tape walked in reverse, then freed
        grads = [tr.gradient(q).torch() for q in params]
        g = np.array([float(v[0]) for v in grads], np.float32)
        walls.append((1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t2)))
        if after is not None:
            after(grads)
        p = p - lr * g
        losses.append(float(loss.torch()[0]))
    hits, misses = tr.cache_stats()
    return {"losses": losses, "params": p, "hits": hits, "misses": misses,
            "walls_ms": walls}


def main(n=256, steps=40, device=None):
    """The fit with the reference's asserts: the last loss below 0.2 of
    the first, and at most 6 kernel cache misses (one forward and one
    adjoint structure, reused by every later step)."""
    t0 = time.perf_counter()
    out = fit(n, steps, device)
    dt = time.perf_counter() - t0
    losses, p = out["losses"], out["params"]
    print(f"{steps} steps in {dt:.2f} s ({dt / steps * 1e3:.1f} ms/step "
          f"with the host loop); kernel cache: {out['hits']} hits / "
          f"{out['misses']} misses")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"recovered (cx, cy, r) = ({p[0]:+.4f}, {p[1]:+.4f}, {p[2]:.4f})"
          f"  true = ({TRUE[0]:+.4f}, {TRUE[1]:+.4f}, {TRUE[2]:.4f})")
    assert losses[-1] < losses[0] * 0.2, "optimisation failed to converge"
    assert out["misses"] <= 6, f"unexpected rebuilds: {out['misses']}"
    print(f"abs parameter error: {np.abs(p - np.array(TRUE))}")
    return out


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 256,
         int(sys.argv[2]) if len(sys.argv) > 2 else 40)
