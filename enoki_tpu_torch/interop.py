"""Interop with numpy and other array libraries, and scene parameters and
generator state carried across from numpy (counterpart of
enoki_tpu/interop.py).

``to_numpy`` / ``from_numpy`` copy to and from numpy (``from_numpy`` puts
the tensor on the card unless given ``device``); ``to_torch`` takes any
DLPack producer (a tensor passes through) and ``from_torch`` hands a
detached, contiguous tensor on. ``torch_wrap(f)`` makes an
``autograd.Function`` of a differentiable function of tensors, as the
reference's makes one of a JAX function: forward runs ``f`` and keeps its
graph, backward is ``torch.autograd.grad`` with one cotangent per output.
The reference's bridges JAX to torch; the port's keeps its contract (a
torch function in, grads out) on the tape.

The reference's scene leaves leave JAX as numpy arrays (for example
``np.asarray(scene_to_vec(scene))``); these helpers turn them into the
port's 16-vector, a ``SphereScene`` or ``SDFScene``, or the parameter
vector of a ``make_sdf_renderer`` scene, on a device, and back. Values
are copied exactly, in float32. ``pcg32_from_numpy`` / ``pcg32_to_numpy``
carry a PCG32's state between the reference's (hi, lo) uint32 halves and
the port's int64 lanes, bit for bit.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.utils._pytree as pytree

from ._device import resolve_device
from .render.sdf import SDFScene
from .render.sdf_kernels import N_PARAMS, scene_to_vec, vec_to_scene
from .types import PCG32, u64 as U


def params_from_numpy(v, device=None) -> torch.Tensor:
    """The flat parameter vector (9 live entries, or all 16) -> a float32
    tensor of shape (16,) on ``device`` (cuda by default)."""
    a = np.asarray(v, dtype=np.float32).reshape(-1)
    if a.size not in (9, N_PARAMS):
        raise ValueError(f"expected 9 or {N_PARAMS} parameters, got {a.size}")
    out = np.zeros(N_PARAMS, np.float32)
    out[:a.size] = a
    return torch.tensor(out, device=resolve_device(device))


def generic_params_from_numpy(v, n_params=None, device=None) -> torch.Tensor:
    """The parameter vector of a ``make_sdf_renderer`` scene (any length
    from 5: ambient, gain, light, then the scene's own) -> a float32 tensor
    of that length on ``device`` (cuda by default), unpadded: the generic
    kernels read exactly ``n_params`` entries. ``n_params``, if given, is
    checked against the length."""
    a = np.asarray(v, dtype=np.float32).reshape(-1)
    if a.size < 5 or (n_params is not None and a.size != n_params):
        raise ValueError(f"expected {n_params or 'at least 5'} parameters, "
                         f"got {a.size}")
    return torch.tensor(a, device=resolve_device(device))


def scene_from_numpy(v, device=None, cls=SDFScene):
    """The flat parameter vector -> a ``cls`` (SDFScene or SphereScene)
    of 0-d tensors."""
    return vec_to_scene(params_from_numpy(v, device), cls)


def scene_to_numpy(scene) -> np.ndarray:
    """A SphereScene or SDFScene (of parameters or of gradients) -> its
    (16,) vector."""
    return scene_to_vec(scene).detach().cpu().numpy()


def _u64_from_halves(hi, lo, device) -> U.U64:
    hi = np.asarray(hi).astype(np.uint64)
    lo = np.asarray(lo).astype(np.uint64)
    v = ((hi << np.uint64(32)) | lo).view(np.int64)
    return U.U64(torch.tensor(v, device=device))


def pcg32_from_numpy(state_hi, state_lo, inc_hi, inc_lo,
                     device=None) -> PCG32:
    """A generator from the reference's state, ``np.asarray`` of
    ``gen.state.hi``, ``gen.state.lo``, ``gen.inc.hi``, ``gen.inc.lo``
    (uint32 arrays of one shape): it continues the reference's stream
    draw for draw. On ``device`` (cuda by default)."""
    device = resolve_device(device)
    return PCG32(_u64_from_halves(state_hi, state_lo, device),
                 _u64_from_halves(inc_hi, inc_lo, device))


def pcg32_to_numpy(gen: PCG32):
    """``(state_hi, state_lo, inc_hi, inc_lo)`` as uint32 arrays, the
    reference's layout."""
    return tuple(h.detach().cpu().numpy().astype(np.uint32)
                 for u in (gen.state, gen.inc) for h in (u.hi, u.lo))


def to_numpy(x) -> np.ndarray:
    """A tensor as a numpy array (a copy off the card)."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def from_numpy(x, device=None) -> torch.Tensor:
    """A numpy array as a tensor on ``device`` (None: the card, or
    raise)."""
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def to_torch(x) -> torch.Tensor:
    """Any DLPack producer as a tensor, zero-copy (enoki_to_torch,
    common.h:241); a tensor passes through."""
    return x if isinstance(x, torch.Tensor) else torch.from_dlpack(x)


def from_torch(x) -> torch.Tensor:
    """A tensor as the port takes it: detached and contiguous
    (torch_to_enoki, common.h:243)."""
    return x.detach().contiguous()


def torch_wrap(f: Callable):
    """``f`` (tensors in, a tensor or a pytree of tensors out) as an
    ``autograd.Function``: forward runs ``f`` on detached inputs that
    require grad, under ``enable_grad``, and keeps the outputs; backward is
    ``torch.autograd.grad`` of them with one cotangent per output leaf.
    Returns a callable taking and returning tensors."""

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *tensors):
            inputs = tuple(t.detach().requires_grad_(t.dtype.is_floating_point)
                           for t in tensors)
            with torch.enable_grad():
                out = f(*inputs)
            leaves, ctx.out_tree = pytree.tree_flatten(out)
            ctx.inputs, ctx.outputs = inputs, leaves
            # one tensor per output leaf: backward then gets one cotangent
            # for each
            if len(leaves) == 1:
                return leaves[0].detach()
            return tuple(l.detach() for l in leaves)

        @staticmethod
        def backward(ctx, *gs):
            wanted = [i for i, t in enumerate(ctx.inputs) if t.requires_grad]
            outs = [(o, g) for o, g in zip(ctx.outputs, gs)
                    if o.requires_grad and g is not None]
            grads = torch.autograd.grad(
                [o for o, _ in outs], [ctx.inputs[i] for i in wanted],
                [g for _, g in outs], allow_unused=True,
                materialize_grads=True) if outs else \
                [torch.zeros_like(ctx.inputs[i]) for i in wanted]
            out = [None] * len(ctx.inputs)
            for i, g in zip(wanted, grads):
                out[i] = g
            return tuple(out)

    def apply(*tensors):
        return _Fn.apply(*tensors)

    return apply
