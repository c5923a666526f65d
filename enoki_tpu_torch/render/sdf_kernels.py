"""SDF render kernels for the GPU: forward march and analytic backward.

Counterpart of enoki_tpu/render/pallas_kernels.py (its SDF forward
``_sdf_fwd_kernel``, plain f32 branch, and ``_sdf_bwd_kernel_analytic``).
The module has another name because nothing here is Pallas: the kernels
are CUDA C++ in ``enoki_tpu_torch/csrc/sdf_render.cu``, built with nvcc on
first use (``enoki_tpu_torch._build``).

Each kernel has a plain PyTorch version beside it (``sdf_fwd_plain``,
``sdf_bwd_plain``) that repeats its arithmetic. A wrapper takes the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises. ``_build.LAUNCHES`` counts the kernel launches.

The flat parameter layout is that of the reference:
[cx, cy, cz, radius, ambient, gain, lx, ly, lz, 0 x 7] (N_PARAMS = 16).

``render_sdf_cuda`` keeps ``render_sdf_pallas``'s parameters in order, but
only the plain configuration is ported. Its ``coarse`` defaults to 0 (no
cone prepass), where the reference defaults to 8: the prepass is not
ported yet, and 0 is the configuration the benchmark runs.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import _build
from .sdf import SDFScene
from .sphere import SphereScene, scene_from_leaves, scene_leaves

N_PARAMS = 16
EPS = 1e-4      # march convergence eps, as hardcoded in the TPU kernel
T_MAX = 10.0    # march escape distance, likewise


def scene_to_vec(scene) -> torch.Tensor:
    v = torch.stack([x.to(torch.float32) for x in scene_leaves(scene)])
    return torch.cat([v, v.new_zeros(N_PARAMS - 9)])


def vec_to_scene(v, cls=SphereScene):
    return scene_from_leaves([v[k] for k in range(9)], cls)


def pixel_step(n: int, extent: float) -> float:
    """The pixel pitch 2*extent/(n-1), rounded to f32 as the reference's
    kernel rounds it."""
    return torch.tensor(2.0 * extent / (n - 1), dtype=torch.float32).item()


def tile_pixels(n: int, extent: float, device):
    """Pixel coordinates of the whole (n, n) image from the integer index,
    ``col * step - extent`` in f32 with an f32 step: x varies along
    columns, y along rows. Matches linspace + meshgrid 'xy' to 1 ulp."""
    step = torch.tensor(pixel_step(n, extent), dtype=torch.float32,
                        device=device)
    ext = torch.tensor(extent, dtype=torch.float32, device=device)
    coords = torch.arange(n, device=device).to(torch.float32) * step - ext
    return coords[None, :].expand(n, n), coords[:, None].expand(n, n)


def _march_z(rxy2, z0, rad, n_steps: int):
    """The z-carry march of _march_sphere_tile, masked over every lane:
    returns (z, hit, advances per lane). A lane advances while
    |p-c| >= rad + eps and z + |p-c| <= t_max + z0 + rad, and never at
    step n_steps - 1."""
    s_hit = rad + EPS
    esc = T_MAX + z0 + rad
    z = torch.zeros_like(rxy2) + z0
    adv = torch.zeros_like(rxy2, dtype=torch.int32)
    for _ in range(n_steps - 1):
        x = rxy2 + z * z
        s = x * torch.rsqrt(x)
        alive = (s >= s_hit) & (z + s <= esc)
        z = torch.where(alive, z + (s - rad), z)
        adv += alive
    x = rxy2 + z * z
    hit = (x * torch.rsqrt(x) - rad) < EPS
    return z, hit, adv


def _ray_parts(params, n, extent):
    cx, cy, cz = params[0], params[1], params[2]
    px, py = tile_pixels(n, extent, params.device)
    dx = px - cx
    dy = py - cy
    return dx, dy, dx * dx + dy * dy + 1e-12, -1.0 - cz


def sdf_fwd_plain(params, n: int, n_steps: int, extent: float = 1.2):
    """Plain version of the sdf_fwd kernel -> (img, ts), each (n, n) f32.
    ts = t on a hit and -t-1 on a miss."""
    rad, amb, gain = params[3], params[4], params[5]
    lx, ly, lz = params[6], params[7], params[8]
    dx, dy, rxy2, z0 = _ray_parts(params, n, extent)
    z, hit, _ = _march_z(rxy2, z0, rad, n_steps)
    t = z - z0
    # closed-form normal: the gradient of sqrt(|d|^2 + 1e-12) - rad
    dz = (-1.0 + t) - params[2]
    q = torch.rsqrt(dx * dx + dy * dy + dz * dz + 1e-12)
    gx, gy, gz = dx * q, dy * q, dz * q
    inv = torch.rsqrt(gx * gx + gy * gy + gz * gz + 1e-12)
    lam = torch.clamp_min((gx * lx + gy * ly + gz * lz) * inv, 0.0)
    img = torch.where(hit, amb + lam * gain, amb)
    return img, torch.where(hit, t, -t - 1.0)


def march_counts(params, n: int, n_steps: int, extent: float = 1.2):
    """The work of the sdf_fwd kernel's march, per pixel, as two (n, n)
    tensors: the distance evaluations it executes (the advances, the
    evaluation that found the lane frozen unless it ran to the step cap,
    and the final hit test) and the advances."""
    _, _, rxy2, z0 = _ray_parts(params, n, extent)
    _, _, adv = _march_z(rxy2, z0, params[3], n_steps)
    return torch.clamp_max(adv + 1, max(n_steps - 1, 0)) + 1, adv


def sdf_bwd_plain(params, g, ts, n: int, extent: float = 1.2):
    """Plain version of the sdf_bwd kernel: the closed-form cotangent of
    the 16 parameters (entries 9-15 zero) for the image cotangent ``g``
    and the forward's packed residual ``ts``."""
    cz, gain = params[2], params[5]
    lx, ly, lz = params[6], params[7], params[8]
    px, py = tile_pixels(n, extent, params.device)
    hit = ts >= 0.0
    t = torch.where(hit, ts, -1.0 - ts)
    dx = px - params[0]
    dy = py - params[1]
    dz = (-1.0 + t) - cz
    q = torch.rsqrt(dx * dx + dy * dy + dz * dz + 1e-12)
    ux, uy, uz = dx * q, dy * q, dz * q
    inv = torch.rsqrt(ux * ux + uy * uy + uz * uz + 1e-12)
    s = ux * lx + uy * ly + uz * lz
    y = s * inv
    lam = torch.clamp_min(y, 0.0)
    hf = hit.to(torch.float32)
    # subgradient at the relu kink: max(y, 0) splits a tie 0.5/0.5
    relu_g = torch.where(y > 0.0, 1.0, torch.where(y == 0.0, 0.5, 0.0))
    m = g * gain * relu_g * hf
    mi = m * inv
    si2 = s * (inv * inv)
    vx = mi * (lx - si2 * ux)
    vy = mi * (ly - si2 * uy)
    vz = mi * (lz - si2 * uz)
    uv = ux * vx + uy * vy + uz * vz
    ddx = q * (vx - ux * uv)
    ddy = q * (vy - uy * uv)
    ddz = q * (vz - uz * uv)
    # implicit-root term; the grazing guard keeps the slope's sign
    sgn = torch.where(uz == 0.0, -1.0, torch.sign(uz))
    slope = torch.where(torch.abs(uz) > 1e-6, uz, sgn)
    w = torch.where(hit, -ddz / slope, 0.0)
    dp = torch.stack([torch.sum(-ddx - w * ux), torch.sum(-ddy - w * uy),
                      torch.sum(-ddz - w * uz), torch.sum(-w), torch.sum(g),
                      torch.sum(g * lam * hf), torch.sum(mi * ux),
                      torch.sum(mi * uy), torch.sum(mi * uz)])
    return torch.cat([dp, dp.new_zeros(N_PARAMS - 9)])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def sdf_fwd(params, n: int, n_steps: int, extent: float = 1.2):
    """Forward render -> (img, ts): the sdf_fwd kernel for a CUDA tensor,
    the plain version for a CPU one."""
    if not _build.is_cuda(params):
        return sdf_fwd_plain(params, n, n_steps, extent)
    _build.check(params, "params", (N_PARAMS,), params.device)
    lib = _build.load("sdf_render")
    img = torch.empty((n, n), dtype=torch.float32, device=params.device)
    ts = torch.empty_like(img)
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdf_fwd_launch(params.data_ptr(), img.data_ptr(),
                                 ts.data_ptr(), n, n_steps,
                                 pixel_step(n, extent), extent, stream)
    _build.launched(err, "sdf_fwd")
    return img, ts


def sdf_bwd(params, g, ts, n: int, extent: float = 1.2):
    """Parameter cotangent dp[16]: the sdf_bwd kernels (per-block partial
    sums, then one fixed-order reduce) for CUDA tensors, the plain version
    for CPU ones."""
    if not _build.is_cuda(params):
        return sdf_bwd_plain(params, g, ts, n, extent)
    dev = params.device
    _build.check(params, "params", (N_PARAMS,), dev)
    _build.check(g, "g", (n, n), dev)
    _build.check(ts, "ts", (n, n), dev)
    lib = _build.load("sdf_render")
    rows = lib.sdf_bwd_num_blocks(n)
    partial = torch.empty((rows, 9), dtype=torch.float32, device=dev)
    dp = torch.empty(N_PARAMS, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdf_bwd_partial_launch(
            params.data_ptr(), g.data_ptr(), ts.data_ptr(),
            partial.data_ptr(), n, pixel_step(n, extent), extent, stream)
        _build.launched(err, "sdf_bwd")
        err = lib.sdf_bwd_reduce_launch(partial.data_ptr(), rows,
                                        dp.data_ptr(), stream)
        _build.launched(err, "sdf_bwd_reduce")
    return dp


class _SDFRenderFn(torch.autograd.Function):
    """Forward: sdf_fwd, keeping the packed residual ts (one float per
    pixel) for the backward. Backward: sdf_bwd on that residual."""

    @staticmethod
    def forward(ctx, params, n, n_steps, extent):
        img, ts = sdf_fwd(params, n, n_steps, extent)
        ctx.save_for_backward(params, ts)
        ctx.n, ctx.extent = n, extent
        return img

    @staticmethod
    def backward(ctx, g):
        params, ts = ctx.saved_tensors
        return (sdf_bwd(params.detach(), g.contiguous(), ts, ctx.n,
                        ctx.extent), None, None, None)


def render_sdf_cuda(params, n: int = 1024, n_steps: int = 64,
                    extent: float = 1.2, tile: int = 128, tile_c=None,
                    coarse: int = 0, chunk: int = 16, dtype=torch.float32,
                    bands: int = 1, relax: float = 1.0,
                    unimodal: bool = False, split: int = 0):
    """SDF sphere-march render of the 16-vector ``params`` -> (n, n) image,
    differentiable in ``params`` through the analytic backward kernel.

    The parameters are ``render_sdf_pallas``'s, in order. Only the plain
    configuration is ported: every other value raises NotImplementedError
    naming its ROADMAP item. ``tile``/``tile_c`` must divide ``n`` as in
    the reference, and ``chunk`` is accepted; neither changes the result,
    and the CUDA kernels set their own launch geometry (each thread leaves
    its march on its own, which subsumes the chunked exit).
    """
    if coarse:
        raise NotImplementedError(
            "coarse > 0 (the cone-march prepass) is not ported: ROADMAP A3")
    if dtype != torch.float32:
        raise NotImplementedError(
            "a bf16 march is not ported: ROADMAP B4")
    if bands != 1:
        raise NotImplementedError(
            "bands > 1 (sub-tile early exit) is not ported: ROADMAP B4")
    if relax != 1.0 or unimodal:
        raise NotImplementedError(
            "relax != 1 / unimodal (over-relaxed march) are not ported: "
            "ROADMAP B4")
    if split:
        raise NotImplementedError(
            "split > 0 (the two-pass compacted march) is not ported: "
            "ROADMAP B5")
    tile_c = tile_c or tile
    if n % tile or n % tile_c:
        raise ValueError("image size must be divisible by the tile size")
    if tuple(params.shape) != (N_PARAMS,):
        raise ValueError(f"params must have shape ({N_PARAMS},), got "
                         f"{tuple(params.shape)}")
    return _SDFRenderFn.apply(params, n, n_steps, extent)


class SDFRender(nn.Module):
    """The SDF render as a module whose one parameter is the 16-vector.
    ``forward()`` returns the (n, n) image."""

    def __init__(self, params=None, n: int = 1024, n_steps: int = 64,
                 extent: float = 1.2, device=None):
        super().__init__()
        if params is None:
            params = scene_to_vec(SDFScene.reference(device))
        elif device is not None:
            params = params.to(device)
        self.params = nn.Parameter(params.detach().to(torch.float32).clone())
        self.n, self.n_steps, self.extent = n, n_steps, extent

    def forward(self):
        # one tile of the whole image: the tile only has to divide n
        return render_sdf_cuda(self.params, self.n, self.n_steps,
                               self.extent, tile=self.n)
