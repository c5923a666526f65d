"""Core ops used by the render (counterpart of enoki_tpu/ops/router.py).

Only the eager subset the SDF render needs: ``linspace``, ``meshgrid``,
``safe_sqrt`` and ``rsqrt``. The lazy ``LazyArray`` dispatch of the
reference waits for the port of ``trace/``.
"""

from __future__ import annotations

import torch

from .._device import resolve_device


def linspace(start, stop, num, dtype=torch.float32, device=None):
    """``linspace<Array>(min, max, size)``: endpoints inclusive.

    jnp.linspace's formula, ``start*(1 - i/div) + stop*(i/div)`` with the
    last entry set to ``stop``, in the form XLA compiles it to: the
    division by the constant ``div`` becomes a product with ``r = 1/div``,
    and ``stop*(i/div)`` becomes ``i*(stop*r)``. Written literally the
    formula lands up to 2 ulp (of ``stop``) from the reference at n=64,
    this form within 1; ``torch.linspace`` rounds differently again
    (hundreds of entries at n=1024).
    """
    device = resolve_device(device)
    start_t = torch.tensor(start, dtype=dtype, device=device)
    stop_t = torch.tensor(stop, dtype=dtype, device=device)
    if num == 1:
        return start_t.reshape(1)
    div = num - 1
    r = 1 / torch.tensor(div, dtype=dtype, device=device)
    i = torch.arange(div, dtype=dtype, device=device)
    out = start_t * (1 - i * r) + i * (stop_t * r)
    return torch.cat([out, stop_t.reshape(1)])


def meshgrid(x, y):
    """``meshgrid(x, y)`` with 'xy' indexing, flattened: x varies fastest.
    Returns ``(xs, ys)`` of length ``len(x) * len(y)``."""
    xs, ys = torch.meshgrid(x, y, indexing="xy")
    return xs.reshape(-1), ys.reshape(-1)


class _SafeSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        # sqrt in float64, rounded back once: the correctly rounded sqrt
        # that XLA and CUDA's sqrt give. PyTorch's CPU float32 sqrt goes
        # through MKL's vector library, which is 1 ulp off for ~0.6% of
        # inputs, and that moves silhouette pixels of the sphere render.
        y = torch.sqrt(torch.clamp_min(x, 0.0).double()).to(x.dtype)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        pos = x > 0
        return g * torch.where(pos, 0.5 / torch.where(pos, y, 1.0), 0.0)


def safe_sqrt(x):
    """sqrt(max(x, 0)), correctly rounded, with a zero (not infinite)
    gradient at x <= 0."""
    return _SafeSqrt.apply(x)


def rsqrt(x):
    """Reciprocal square root."""
    return torch.rsqrt(x)
