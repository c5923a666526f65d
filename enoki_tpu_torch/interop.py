"""Carry scene parameters across from numpy (counterpart of the parameter
side of enoki_tpu/interop.py).

The reference's scene leaves leave JAX as numpy arrays (for example
``np.asarray(scene_to_vec(scene))``); these helpers turn them into the
port's 16-vector, a ``SphereScene`` or ``SDFScene``, or the parameter
vector of a ``make_sdf_renderer`` scene, on a device, and back. Values
are copied exactly, in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .render.sdf import SDFScene
from .render.sdf_kernels import N_PARAMS, scene_to_vec, vec_to_scene


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
