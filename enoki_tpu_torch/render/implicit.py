"""Implicit-function-theorem backward for frozen ray-march roots
(counterpart of enoki_tpu/render/implicit.py).

The march returns t* with sdf(ray(t*), theta) = eps, so

    dt*/dtheta^T . t_bar = -(t_bar / (d sdf/dt)) . (d sdf/dtheta)^T

and the loop is never reversed.
"""

from __future__ import annotations

import torch


def implicit_t_vjp(f, args, t, t_bar, hit, guard: float = 1e-6):
    """Backward of a frozen march root.

    ``f(args, t) -> per-lane sdf residual`` at the root; ``args`` is a
    sequence of tensors. ``t_bar`` is the cotangent that reached t; miss
    lanes (``~hit``) get zero. At grazing hits (|d sdf/dt| <= guard) the
    slope is clamped to +-1, keeping its sign, instead of amplifying the
    cotangent through a near-zero divisor; exact zeros take the
    entering-hit convention (negative slope). Returns one cotangent per
    entry of ``args``, shaped like it.
    """
    with torch.enable_grad():
        a = [x.detach().requires_grad_(True) for x in args]
        tv = t.detach().requires_grad_(True)
        out = f(a, tv)
        (df_dt,) = torch.autograd.grad(out.sum(), tv, retain_graph=True)
        sgn = torch.where(df_dt == 0.0, -1.0, torch.sign(df_dt))
        df_dt = torch.where(torch.abs(df_dt) > guard, df_dt, sgn)
        w = torch.where(hit, -t_bar / df_dt, 0.0)
        grads = torch.autograd.grad(out, a, grad_outputs=w,
                                    allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g
                 for x, g in zip(args, grads))
