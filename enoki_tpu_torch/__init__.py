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
``ops`` and ``types`` in plain PyTorch; ``struct`` (struct support,
vectorized method calls), ``ad`` (differentiation helpers on autograd),
``runtime`` (introspection, checkpoints), ``cache``, ``config`` and
``interop``; ``dist``, the distributed render and train steps over a
``torch.distributed`` process group (one process a GPU, ``nccl``).
``trace`` (the lazy runtime) waits for its port.
"""

__version__ = "0.4.0"

from ._device import resolve_device  # noqa: F401
from . import config  # noqa: F401
from . import cache  # noqa: F401

# the build directory, chosen and bounded once (ENOKI_TPU_COMPILE_CACHE);
# nothing is built here
cache.enable_default_compile_cache()
from . import ops, types, struct, ad, runtime, render, interop  # noqa: F401,E402
from . import dist  # noqa: F401,E402
from .config import set_log_level, log_level  # noqa: F401,E402
