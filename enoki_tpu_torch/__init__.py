"""enoki_tpu_torch -- the PyTorch/CUDA port of enoki_tpu.

A second package beside ``enoki_tpu`` (the JAX reference, which stays as
it is). Module and function names follow the reference so that each part
has an obvious counterpart; plain tensor code is PyTorch, and every Pallas
kernel of the reference becomes a hand-written CUDA kernel for Hopper
(``csrc/``, built with nvcc on first use by ``_build``).

Imports ``torch`` and never ``jax`` or anything of ``enoki_tpu``.
Entry points run on the CUDA card unless the caller passes ``device``.

Ported so far (``render``): the differentiable SDF sphere-march render,
with its forward kernels in every option and both backward kernels
(``render.sdf_kernels``); the closed-form sphere render of the reference
mini-app, with its f32 and bf16 forward kernels and analytic backward
(``render.sphere_kernels``); and the bring-your-own-SDF renderer
(``render.generic``, ``render.sdflib``), whose two kernels are generated
per scene from the scene's Python functions (``render.sdf_trace``).
Beside the renders: the histogram mini-app's path, a vectorised PCG32
(``types``), the dense histogram kernel (``ops.histogram``),
``ops.rounding`` with its stochastic-rounding kernel, and the rest of
``ops`` in plain PyTorch: the op layer of ``ops.router`` and
``ops.horiz``, the transcendental and special functions of ``ops.math``
and ``ops.special``, and ``ops.backend``'s dispatch point.
"""

from ._device import resolve_device  # noqa: F401
from . import config, interop, ops, render, types  # noqa: F401
