"""Closed-form sphere render kernels for the GPU: forward (f32 and bf16
compute) and analytic backward.

Counterpart of the sphere part of enoki_tpu/render/pallas_kernels.py
(``_sphere_fwd_kernel``, ``_sphere_bwd_kernel``, ``render_sphere_pallas``).
The kernels are CUDA C++ in ``enoki_tpu_torch/csrc/sphere_render.cu``,
built with nvcc on first use (``enoki_tpu_torch._build``).

Each kernel has a plain PyTorch version beside it (``sphere_fwd_plain``,
``sphere_bwd_plain``) that repeats its arithmetic. A wrapper takes the
plain version only for a tensor on the CPU; for a CUDA tensor it launches
the kernel or raises. ``_build.LAUNCHES`` counts the kernel launches.

The flat parameter layout is that of the reference and of
``sdf_kernels``: [cx, cy, cz, radius, ambient, gain, lx, ly, lz, 0 x 7].
"""

from __future__ import annotations

import torch
from torch import nn

from .. import _build
from ..ops.router import safe_sqrt
from .sdf_kernels import (N_PARAMS, pixel_step, scene_to_vec, tile_pixels,
                          vec_to_scene)
from .sphere import SphereScene, combined
from .vec import Vec2

# the forward kernel of each compute dtype, by launch-counter name
FWD_KERNELS = {torch.float32: "sphere_fwd", torch.bfloat16: "sphere_fwd_bf16"}


def _fwd_kernel(dtype) -> str:
    if dtype not in FWD_KERNELS:
        raise ValueError(f"compute dtype must be torch.float32 or "
                         f"torch.bfloat16, got {dtype}")
    return FWD_KERNELS[dtype]


def sphere_fwd_plain(params, n: int, extent: float = 1.2,
                     dtype=torch.float32):
    """Plain version of the sphere_fwd kernels -> (n, n) image of
    ``dtype``: ``combined`` on the kernels' pixel grid, with the pixel
    coordinates made in f32 and then cast, and the parameters cast to
    ``dtype`` (pallas_kernels.py:56-92)."""
    px, py = tile_pixels(n, extent, params.device)
    scene = vec_to_scene(params.to(dtype))
    return combined(Vec2(px.to(dtype), py.to(dtype)), scene)


def sphere_bwd_plain(params, g, n: int, extent: float = 1.2):
    """Plain version of the sphere_bwd kernels: the closed-form cotangent
    of the 16 parameters (entries 9-15 zero) of the f32 render for the
    image cotangent ``g`` (any float dtype, taken in f32)."""
    cx, cy, cz, rad, gain = (params[k] for k in (0, 1, 2, 3, 5))
    lx, ly, lz = params[6], params[7], params[8]
    px, py = tile_pixels(n, extent, params.device)
    g = g.to(torch.float32)
    # the f32 forward up to the hit mask, in its order (a = 1, b = 2 ocz)
    ocx = px - cx
    ocy = py - cy
    ocz = -1.0 - cz
    b = 2.0 * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = b * b - 4.0 * c
    hit = disc >= 0.0
    sq = safe_sqrt(disc)
    hz = (-1.0 + (-b + sq) * 0.5) - cz
    s = ocx * lx + ocy * ly + hz * lz
    relu_g = torch.where(s > 0.0, 1.0, torch.where(s == 0.0, 0.5, 0.0))
    m = torch.where(hit, g * gain * relu_g, 0.0)  # cotangent of n . l
    dhx, dhy, dhz = m * lx, m * ly, m * lz
    pos = disc > 0.0
    dd = torch.where(pos, dhz * 0.25 / torch.where(pos, sq, 1.0), 0.0)
    dc = -4.0 * dd
    db = -0.5 * dhz + 2.0 * b * dd
    dp = torch.stack([
        torch.sum(-(dhx + 2.0 * ocx * dc)),
        torch.sum(-(dhy + 2.0 * ocy * dc)),
        torch.sum(-(dhz + 2.0 * ocz * dc + 2.0 * db)),
        torch.sum(-2.0 * rad * dc),
        torch.sum(g),
        torch.sum(torch.where(hit, g * torch.clamp_min(s, 0.0), 0.0)),
        torch.sum(m * ocx), torch.sum(m * ocy), torch.sum(m * hz)])
    return torch.cat([dp, dp.new_zeros(N_PARAMS - 9)])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def fwd_vector_stores(img, n: int) -> bool:
    """Whether the sphere_fwd kernels store a thread's 4 pixels as one
    vector (16 bytes in f32, 8 in bf16): a row is whole vectors (n % 4 ==
    0) and ``img`` starts on 16 bytes. Otherwise they store every pixel on
    its own."""
    return n % 4 == 0 and img.data_ptr() % 16 == 0


def bwd_vector_loads(g, n: int) -> bool:
    """Whether the sphere_bwd kernel loads ``g`` as float4: a row is whole
    float4s (n % 4 == 0) and ``g`` starts on 16 bytes. Otherwise it loads
    every pixel on its own."""
    return n % 4 == 0 and g.data_ptr() % 16 == 0


def sphere_fwd(params, n: int, extent: float = 1.2, dtype=torch.float32):
    """Forward render -> (n, n) image of ``dtype`` (f32 or bf16): the
    sphere_fwd kernel of that dtype for a CUDA tensor, the plain version
    for a CPU one."""
    kernel = _fwd_kernel(dtype)
    if not _build.is_cuda(params):
        return sphere_fwd_plain(params, n, extent, dtype)
    _build.check(params, "params", (N_PARAMS,), params.device)
    lib = _build.load("sphere_render")
    img = torch.empty((n, n), dtype=dtype, device=params.device)
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(kernel, getattr(lib, f"{kernel}_launch"),
                      params.data_ptr(), img.data_ptr(), n,
                      pixel_step(n, extent), extent,
                      int(fwd_vector_stores(img, n)), stream)
    return img


def sphere_bwd(params, g, n: int, extent: float = 1.2):
    """Parameter cotangent dp[16] of the f32 render for the image
    cotangent ``g`` (a bf16 ``g`` is upcast) in one launch of the
    sphere_bwd kernel, whose blocks write per-block sums and whose last
    block sums them in a fixed order, for CUDA tensors; the plain version
    for CPU ones."""
    if not _build.is_cuda(params):
        return sphere_bwd_plain(params, g, n, extent)
    dev = params.device
    g = g.to(torch.float32).contiguous()
    _build.check(params, "params", (N_PARAMS,), dev)
    _build.check(g, "g", (n, n), dev)
    lib = _build.load("sphere_render")
    rows = lib.sphere_bwd_num_blocks(n)
    partial = torch.empty((rows, 9), dtype=torch.float32, device=dev)
    dp = torch.empty(N_PARAMS, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "sphere_bwd", lib.sphere_bwd_launch, params.data_ptr(),
            g.data_ptr(), partial.data_ptr(),
            _build.ticket(dev, stream).data_ptr(), dp.data_ptr(), n,
            pixel_step(n, extent), extent, int(bwd_vector_loads(g, n)),
            stream)
    return dp


# sphere_bwd as the backward calls it; under vmap(grad(...)) one launch an
# item of the batch
_sphere_bwd_call = _build.kernel_call("_SphereBwdFn", sphere_bwd)


class _SphereRenderFn(_build.KernelFunction):
    """Forward: sphere_fwd in the compute dtype. Backward: sphere_bwd,
    which recomputes from the parameters alone (no residual). ``vmap``:
    one forward an item of the batch."""

    @staticmethod
    def forward(params, n, extent, dtype):
        return sphere_fwd(params, n, extent, dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        params, n, extent, _ = inputs
        ctx.save_for_backward(params)
        ctx.n, ctx.extent = n, extent

    @staticmethod
    def backward(ctx, g):
        with _build.span("render.backward"):
            (params,) = ctx.saved_tensors
            return (_sphere_bwd_call(params.detach(), g, ctx.n, ctx.extent),
                    None, None, None)

    vmap = _build.loop_vmap("_SphereRenderFn",
                            lambda *a: _SphereRenderFn.apply(*a))


def render_sphere_cuda(params, n: int = 1024, extent: float = 1.2,
                       tile: int = 256, dtype=torch.float32):
    """Closed-form sphere render of the 16-vector ``params`` -> (n, n)
    image in the compute dtype (f32 or bf16), differentiable in
    ``params`` through the analytic backward kernel, which is f32 for
    either dtype.

    The parameters are ``render_sphere_pallas``'s, in order. ``tile`` must
    divide ``n`` as in the reference and changes nothing else: the CUDA
    kernels set their own launch geometry.
    """
    with _build.span("render.forward"):
        if n % tile:
            raise ValueError("image size must be divisible by the tile size")
        if tuple(params.shape) != (N_PARAMS,):
            raise ValueError(f"params must have shape ({N_PARAMS},), got "
                             f"{tuple(params.shape)}")
        return _SphereRenderFn.apply(params, n, extent, dtype)


class SphereRender(nn.Module):
    """The closed-form sphere render as a module whose one parameter is
    the f32 16-vector; ``dtype`` is the forward's compute dtype.
    ``forward()`` returns the (n, n) image."""

    def __init__(self, params=None, n: int = 1024, extent: float = 1.2,
                 dtype=torch.float32, device=None):
        super().__init__()
        if params is None:
            params = scene_to_vec(SphereScene.reference(device))
        elif device is not None:
            params = params.to(device)
        self.params = nn.Parameter(params.detach().to(torch.float32).clone())
        self.n, self.extent, self.dtype = n, extent, dtype

    def forward(self):
        # one tile of the whole image: the tile only has to divide n
        return render_sphere_cuda(self.params, self.n, self.extent,
                                  tile=self.n, dtype=self.dtype)
