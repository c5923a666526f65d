"""Carry scene parameters and generator state across from numpy
(counterpart of the parameter side of enoki_tpu/interop.py).

The reference's scene leaves leave JAX as numpy arrays (for example
``np.asarray(scene_to_vec(scene))``); these helpers turn them into the
port's 16-vector, a ``SphereScene`` or ``SDFScene``, or the parameter
vector of a ``make_sdf_renderer`` scene, on a device, and back. Values
are copied exactly, in float32. ``pcg32_from_numpy`` / ``pcg32_to_numpy``
carry a PCG32's state between the reference's (hi, lo) uint32 halves and
the port's int64 lanes, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

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
