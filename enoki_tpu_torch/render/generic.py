"""Bring-your-own-SDF renderer (counterpart of
enoki_tpu/render/generic.py): hand ``make_sdf_renderer`` any distance
function over the flat parameter vector and get back the fused forward
kernel + implicit-diff backward kernel pair, plus the plain PyTorch twin
for parity gating. Compose scenes from render/sdflib.py primitives:

    from enoki_tpu_torch.render import make_sdf_renderer, sdflib as sd, Vec3

    def my_sdf(p, pv):
        return sd.op_union(
            sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8]),
            sd.sd_torus(p, Vec3(0.0, 0.0, 0.5), pv[9], pv[10]))

    render, render_plain = make_sdf_renderer(my_sdf, n_params=11)
    img = render(params, n=1024)           # one generic_fwd launch
    img.mean().backward()                  # one generic_bwd launch + reduce

Parameter-vector convention: pv[0] = ambient, pv[1] = gain, pv[2:5] =
light direction; geometry parameters from pv[5] on are the user's.
Everything is differentiable, including through the march (implicit
function theorem at the converged hit).

The two kernels are made per scene, as in the reference, which closes its
Pallas kernels over ``sdf_fn`` and ``ray_fn``: ``sdf_trace`` traces both
Python functions into C++ templates, which are compiled with the kernel
skeleton of csrc/generic_render.cuh at the scene's first render on the
card (``SceneKernels``). On the card nothing falls back: a function that
cannot be traced, a failed nvcc or a failed launch raises. Each kernel has
its plain PyTorch version here (``generic_fwd_plain``,
``generic_bwd_plain``), which a wrapper takes only for a CPU tensor.
"""

from __future__ import annotations

import time

import torch
from torch import nn

from .. import _build
from .._device import resolve_device
from ..ops.router import _plain_rsqrt, linspace
from . import sdf_trace
from .implicit import implicit_t_vjp
from .sdf_kernels import cone_t0, march_tile, pixel_step, tile_pixels
from .sdf_trace import full_like, ones_like, rsqrt, zeros_like
from .vec import Vec3

AMBIENT, GAIN, LIGHT = 0, 1, slice(2, 5)
MAX_PARAMS = 256  # kSumThreads of csrc/common.cuh: one reduce thread each


def ortho_camera(px, py, pvec):
    """Default sensor: parallel rays along +z from z = -1
    (tests/sphere.cpp:58-64)."""
    one = ones_like(px)
    zero = zeros_like(px)
    return Vec3(px, py, -one), Vec3(zero, zero, one)


def perspective_camera(origin_z=-2.5, focal=1.8):
    """Pinhole at (0, 0, origin_z) looking down +z; directions normalized
    so the march parameter stays unit-speed (sphere tracing requires
    |d| = 1)."""

    def ray_fn(px, py, pvec):
        dz = full_like(px, focal)
        inv = rsqrt(px * px + py * py + dz * dz)
        o = Vec3(zeros_like(px), zeros_like(px), full_like(px, origin_z))
        return o, Vec3(px * inv, py * inv, dz * inv)

    return ray_fn


def _shade(o, d, t, hit, pvec, sdf_fn):
    """Lambert shade at the (frozen-t) hit point with the SDF normal taken
    by autograd (``create_graph``, so that the shade stays differentiable
    in pvec and t, which needs second derivatives of ``sdf_fn``); a miss
    shades to exactly the ambient term."""
    p = o + d * t
    with torch.enable_grad():
        xs = [c if c.requires_grad else c.detach().requires_grad_(True)
              for c in (p.x, p.y, p.z)]
        s = sdf_fn(Vec3(*xs), pvec)
        grads = torch.autograd.grad(s.sum(), xs, create_graph=True,
                                    allow_unused=True)
    # a scene that ignores a coordinate has a zero partial there
    gx, gy, gz = (torch.zeros_like(x) if g is None else g
                  for g, x in zip(grads, xs))
    inv = _plain_rsqrt(gx * gx + gy * gy + gz * gz + 1e-12)
    light = pvec[LIGHT]
    lam = (gx * light[0] + gy * light[1] + gz * light[2]) * inv
    img = pvec[AMBIENT] + torch.maximum(lam, torch.zeros_like(lam)) \
        * pvec[GAIN]
    return torch.where(hit, img, pvec[AMBIENT] + torch.zeros_like(img))


def _cone_t0_generic(sdf_fn, ray_fn, params, n, n_steps, extent, s, eps,
                     t_max, margin=1e-3):
    """Cone-march prepass for the generic factory: the shared engine
    (``sdf_kernels.cone_t0``, one implementation of the deflation radius
    and margin) over the user SDF along the caller's ``ray_fn`` rays,
    which the gate in ``render`` asserts are the parallel orthographic
    camera's."""

    def dist_factory(px, py):
        o, dd = ray_fn(px, py, params)
        return lambda t: sdf_fn(o + dd * t, params)

    return cone_t0(dist_factory, n, n_steps, extent, s, eps, t_max, margin,
                   device=params.device)


# ---------------------------------------------------------------------------
# The plain versions of the two kernels
# ---------------------------------------------------------------------------


def _rays(ray_fn, params, n, extent):
    px, py = tile_pixels(n, extent, params.device)
    return ray_fn(px, py, params), px


def generic_fwd_plain(sdf_fn, ray_fn, params, n: int, n_steps: int,
                      extent: float = 1.2, t0=None, relax: float = 1.0,
                      unimodal: bool = False, eps: float = 1e-4,
                      t_max: float = 10.0):
    """Plain version of the generic_fwd kernel -> (img, ts), each (n, n)
    f32: the march of ``march_tile`` over ``sdf_fn`` along ``ray_fn``'s
    rays from the start map ``t0`` (None = 0), the shade of ``_shade``,
    and the packed residual ``ts`` = t on a hit, -t-1 on a miss."""
    with torch.no_grad():
        (o, d), px = _rays(ray_fn, params, n, extent)
        t, hit = march_tile(lambda tv: sdf_fn(o + d * tv, params), px,
                            n_steps, eps, t_max, t0=t0, relax=relax,
                            unimodal=unimodal)
    img = _shade(o, d, t, hit, params, sdf_fn).detach()
    return img, torch.where(hit, t, -t - 1.0)


def generic_march_counts(sdf_fn, ray_fn, params, n: int, n_steps: int,
                         extent: float = 1.2, t0=None, eps: float = 1e-4,
                         t_max: float = 10.0):
    """The distance evaluations per pixel that a generic_fwd thread
    executes in the plain march (relax = 1, not unimodal): one per advance
    and one more, the evaluation that found the lane frozen, whose distance
    is the hit test's, or at the step cap the hit test's own. Nothing on a
    render's path calls this: it replays the march to count it."""
    with torch.no_grad():
        (o, d), px = _rays(ray_fn, params, n, extent)
        t = torch.zeros_like(px) if t0 is None else t0
        adv = torch.zeros_like(px, dtype=torch.int32)
        for _ in range(n_steps - 1):
            dist = sdf_fn(o + d * t, params)
            alive = (dist >= eps) & (t + dist <= t_max)
            t = torch.where(alive, t + dist, t)
            adv += alive
    return adv + 1


def generic_bwd_plain(sdf_fn, ray_fn, params, g, ts, n: int,
                      extent: float = 1.2):
    """Plain version of the generic_bwd kernel: the cotangent dp[n_params]
    for the image cotangent ``g`` and the forward's packed residual
    ``ts``, by autograd through ``_shade`` (in pvec and t) plus
    ``implicit_t_vjp`` of the SDF at the frozen root, the rays inside the
    differentiated function (a camera parameter may live in pvec). A miss
    adds its ``g`` to the ambient slot and nothing else."""
    px, py = tile_pixels(n, extent, params.device)
    hit = ts >= 0.0
    t = torch.where(hit, ts, -1.0 - ts)
    with torch.enable_grad():
        pv = params.detach().requires_grad_(True)
        tv = t.detach().requires_grad_(True)
        o, d = ray_fn(px, py, pv)
        img = _shade(o, d, tv, hit, pv, sdf_fn)
        dp_direct, t_bar = torch.autograd.grad(img, (pv, tv), grad_outputs=g,
                                               allow_unused=True)
    if t_bar is None:  # no pixel's shade depends on t
        t_bar = torch.zeros_like(t)

    def f_sdf_at(a, tv):
        o, d = ray_fn(px, py, a[0])
        return sdf_fn(o + d * tv, a[0])

    (dp_implicit,) = implicit_t_vjp(f_sdf_at, [params], t, t_bar, hit)
    return dp_direct + dp_implicit


# ---------------------------------------------------------------------------
# The kernels of one scene and their wrappers
# ---------------------------------------------------------------------------


class SceneKernels:
    """The generic_fwd / generic_bwd kernels of one scene: traced from
    ``sdf_fn`` and ``ray_fn`` and built with nvcc at first use, once. Two
    scenes give two libraries; the same scene gives the same source, the
    same hash and so the same library file."""

    def __init__(self, sdf_fn, ray_fn, n_params: int):
        if not 5 <= n_params <= MAX_PARAMS:
            raise ValueError(f"n_params must be 5 (ambient, gain, light) to "
                             f"{MAX_PARAMS}, got {n_params}")
        self.sdf_fn, self.ray_fn, self.n_params = sdf_fn, ray_fn, n_params
        self._traced = None
        self._lib = None
        self.trace_seconds = None   # the scene's one trace
        self.load_seconds = None    # nvcc (or finding the built file) + load

    @property
    def traced(self) -> sdf_trace.TracedScene:
        if self._traced is None:
            t0 = time.perf_counter()
            self._traced = sdf_trace.trace_scene(self.sdf_fn, self.ray_fn,
                                                 self.n_params)
            self.trace_seconds = time.perf_counter() - t0
        return self._traced

    @property
    def lib(self):
        if self._lib is None:
            source = self.traced.source
            t0 = time.perf_counter()
            self._lib = _build.load_generated("generic_render", source)
            self.load_seconds = time.perf_counter() - t0
            if self._lib.generic_n_params() != self.n_params:
                raise RuntimeError("generic_render library built for another "
                                   "parameter count")
        return self._lib


def _check_params(kernels, params):
    _build.check(params, "params", (kernels.n_params,), params.device)


def generic_fwd(kernels: SceneKernels, params, n: int, n_steps: int,
                extent: float = 1.2, t0=None, relax: float = 1.0,
                unimodal: bool = False, eps: float = 1e-4,
                t_max: float = 10.0):
    """Forward render -> (img, ts): the scene's generic_fwd kernel for a
    CUDA tensor, the plain version for a CPU one."""
    if not _build.is_cuda(params):
        return generic_fwd_plain(kernels.sdf_fn, kernels.ray_fn, params, n,
                                 n_steps, extent, t0, relax, unimodal, eps,
                                 t_max)
    dev = params.device
    _check_params(kernels, params)
    t0_ptr = 0
    if t0 is not None:
        _build.check(t0, "t0", (n, n), dev)
        t0_ptr = t0.data_ptr()
    lib = kernels.lib
    img = torch.empty((n, n), dtype=torch.float32, device=dev)
    ts = torch.empty_like(img)
    relaxed = relax != 1.0 or unimodal
    with torch.cuda.device(dev):
        err = lib.generic_fwd_launch(
            params.data_ptr(), t0_ptr, img.data_ptr(), ts.data_ptr(), n,
            n_steps, pixel_step(n, extent), extent, eps, t_max, relax,
            1.0 - 1.0 / relax, int(relaxed), int(unimodal),
            torch.cuda.current_stream().cuda_stream)
    _build.launched(err, "generic_fwd")
    return img, ts


def generic_bwd(kernels: SceneKernels, params, g, ts, n: int,
                extent: float = 1.2):
    """Parameter cotangent dp[n_params]: per-block partial sums by the
    scene's generic_bwd kernel, then one fixed-order reduce, for CUDA
    tensors; the plain version for CPU ones."""
    if not _build.is_cuda(params):
        return generic_bwd_plain(kernels.sdf_fn, kernels.ray_fn, params, g,
                                 ts, n, extent)
    dev = params.device
    _check_params(kernels, params)
    _build.check(g, "g", (n, n), dev)
    _build.check(ts, "ts", (n, n), dev)
    lib = kernels.lib
    rows = lib.generic_bwd_num_blocks(n)
    partial = torch.empty((rows, kernels.n_params), dtype=torch.float32,
                          device=dev)
    dp = torch.empty(kernels.n_params, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.generic_bwd_partial_launch(
            params.data_ptr(), g.data_ptr(), ts.data_ptr(),
            partial.data_ptr(), n, pixel_step(n, extent), extent, stream)
        _build.launched(err, "generic_bwd")
        err = lib.generic_bwd_reduce_launch(partial.data_ptr(), rows,
                                            dp.data_ptr(), stream)
        _build.launched(err, "generic_bwd_reduce")
    return dp


# generic_bwd as the backward calls it; under vmap(grad(...)) one launch
# an item of the batch
_generic_bwd_call = _build.kernel_call(
    "_GenericBwdFn", lambda params, g, ts, kernels, n, extent:
    generic_bwd(kernels, params, g, ts, n, extent))


class _GenericRenderFn(_build.KernelFunction):
    """Forward: the cone prepass if ``coarse``, then generic_fwd -> (img,
    ts), ts the packed residual (one float per pixel) that the backward
    reads and no gradient reaches. Backward: generic_bwd on that
    residual. ``vmap``: one forward an item of the batch."""

    @staticmethod
    def forward(params, kernels, n, n_steps, extent, coarse, relax,
                unimodal, eps, t_max):
        p = params.detach().to(torch.float32).contiguous()
        t0 = None
        if coarse:
            t0 = _cone_t0_generic(kernels.sdf_fn, kernels.ray_fn, p, n,
                                  n_steps, extent, coarse, eps, t_max)
        return generic_fwd(kernels, p, n, n_steps, extent, t0, relax,
                           unimodal, eps, t_max)

    @staticmethod
    def setup_context(ctx, inputs, output):
        params, kernels, n, _, extent = inputs[:5]
        ctx.mark_non_differentiable(output[1])
        # no (n, n) zeros for ts's gradient, which the backward ignores
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(params, output[1])
        ctx.kernels, ctx.n, ctx.extent = kernels, n, extent

    @staticmethod
    def backward(ctx, g, _ts_bar):
        params, ts = ctx.saved_tensors
        p = params.detach().to(torch.float32).contiguous()
        dp = _generic_bwd_call(p, g.to(torch.float32).contiguous(), ts,
                               ctx.kernels, ctx.n, ctx.extent)
        # the cotangent's dtype is the primal's
        return (dp.to(params.dtype),) + (None,) * 9

    vmap = _build.loop_vmap("_GenericRenderFn",
                            lambda *a: _GenericRenderFn.apply(*a))


class _MarchImplicit(torch.autograd.Function):
    """The twin's masked march over ``sdf_fn`` with the implicit-function
    backward (``implicit_t_vjp``) instead of reversing the loop; plain
    PyTorch in both directions, so ``torch.func`` batches it through its
    own operations (``generate_vmap_rule``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(pv, px, py, sdf_fn, ray_fn, n_steps, eps, t_max):
        o, dd = ray_fn(px, py, pv)
        t = torch.zeros_like(px)
        active = torch.ones_like(px, dtype=torch.bool)
        hit = torch.zeros_like(active)
        for _ in range(n_steps):
            d = sdf_fn(o + dd * t, pv)
            converged = d < eps
            hit = hit | (active & converged)
            t_new = t + d
            active = active & ~converged & (t_new <= t_max)
            t = torch.where(active, t_new, t)
        return t, hit

    @staticmethod
    def setup_context(ctx, inputs, output):
        pv, px, py, sdf_fn, ray_fn = inputs[:5]
        t, hit = output
        ctx.save_for_backward(pv, px, py, t, hit)
        ctx.fns = sdf_fn, ray_fn
        ctx.mark_non_differentiable(hit)

    @staticmethod
    def backward(ctx, t_bar, _hit_bar):
        pv, px, py, t, hit = ctx.saved_tensors
        sdf_fn, ray_fn = ctx.fns

        def f(a, tv):
            o, dd = ray_fn(px, py, a[0])
            return sdf_fn(o + dd * tv, a[0])

        (dpv,) = implicit_t_vjp(f, [pv], t, t_bar, hit)
        return (dpv,) + (None,) * 7


def make_sdf_renderer(sdf_fn, n_params: int, eps: float = 1e-4,
                      t_max: float = 10.0, ray_fn=ortho_camera):
    """(render, render_plain) for ``sdf_fn(p: Vec3, pvec) -> d``.

    ``render(params, n=1024, n_steps=64, extent=1.2, tile=128,
    tile_c=None, coarse=0, bands=1, relax=1.0, unimodal=False)`` has the
    reference's parameters, order and defaults and returns the (n, n)
    image through the scene's two CUDA kernels, under one
    ``torch.autograd.Function``; ``render_plain(params, n, n_steps,
    extent)`` is the plain PyTorch twin (the reference's ``render_xla``):
    the masked march with the implicit-diff backward embedded, the normal
    and the shade by autograd. Both run where ``params`` lies (a CPU
    tensor takes the kernels' plain versions) and are differentiable with
    respect to ``params``.

    ``ray_fn(px, py, pvec) -> (o: Vec3, d: Vec3)`` maps pixel coordinates
    to unit-speed rays; defaults to the reference's orthographic sensor,
    ``perspective_camera()`` gives a pinhole. Camera parameters may live
    in pvec: the backward differentiates through the ray origin and
    direction as well.

    ``coarse`` is the cone prepass's block side (0 = off; orthographic
    camera only: the conservativeness proof needs parallel rays),
    ``relax`` over-relaxes the march with the overlap safety test (valid
    for any SDF), and ``unimodal`` adds the divergence exit (only for a
    scene whose distance along every ray is unimodal, e.g. one convex
    body). ``tile``/``tile_c`` must divide ``n`` as in the reference and
    ``bands`` may be any number >= 1; none of them changes the result: the
    kernel sets its own launch geometry and each thread leaves its march
    on its own, which does per lane what the bands and the miss-tile fast
    path do per tile.

    ``n_params`` may be 5 to ``MAX_PARAMS``. The backward kernel runs the
    scene's cotangent as one reverse-mode program per hit pixel, which
    grows with the scene and its parameters, and nvcc's time and the
    kernel's registers with it: scenes of 9, 12 and 32 parameters (264
    and 969 operations a hit for 12 and 32) have been built and checked
    on an H100 (chip_smoke.py, tests/test_torch_cuda.py); wider ones are
    untried.
    """
    kernels = SceneKernels(sdf_fn, ray_fn, n_params)

    def render(params, n=1024, n_steps=64, extent=1.2, tile=128,
               tile_c=None, coarse=0, bands=1, relax=1.0, unimodal=False):
        tile_c = tile_c or tile
        if n % tile or n % tile_c:
            raise ValueError("image size must be divisible by the tile size")
        if bands < 1:
            raise ValueError(f"bands must be >= 1, got {bands}")
        if coarse:
            if ray_fn is not ortho_camera:
                raise ValueError(
                    "the cone prepass is only conservative for parallel "
                    "(orthographic) rays; pass coarse=0 for custom cameras")
            if n % coarse:
                raise ValueError(f"image size must be divisible by the cone "
                                 f"prepass block, got n={n}, coarse={coarse}")
        if tuple(params.shape) != (n_params,):
            raise ValueError(f"params must have shape ({n_params},), got "
                             f"{tuple(params.shape)}")
        img, _ = _GenericRenderFn.apply(params, kernels, n, n_steps,
                                        extent, coarse, relax, unimodal, eps,
                                        t_max)
        return img

    def render_plain(params, n=1024, n_steps=64, extent=1.2):
        params = params.to(torch.float32)
        ax = linspace(-extent, extent, n, device=params.device)
        px, py = torch.meshgrid(ax, ax, indexing="xy")
        t, hit = _MarchImplicit.apply(params, px, py, sdf_fn, ray_fn,
                                      n_steps, eps, t_max)
        o, dd = ray_fn(px, py, params)
        return _shade(o, dd, t, hit, params, sdf_fn)

    render.kernels = kernels
    return render, render_plain


class GenericRender(nn.Module):
    """A ``make_sdf_renderer`` render as a module whose one parameter is
    the scene's f32 vector. ``render`` is the first function that
    ``make_sdf_renderer`` returned; ``params`` is a tensor (kept on its
    device unless ``device`` is given) or array-like (put on ``device``,
    cuda by default). ``forward()`` returns the (n, n) image; ``options``
    are ``render``'s (coarse, bands, relax, unimodal)."""

    def __init__(self, render, params, n: int = 1024, n_steps: int = 64,
                 extent: float = 1.2, device=None, **options):
        super().__init__()
        if not isinstance(params, torch.Tensor) or device is not None:
            params = torch.as_tensor(params, dtype=torch.float32,
                                     device=resolve_device(device))
        self.params = nn.Parameter(params.detach().to(torch.float32).clone())
        self.render = render
        self.n, self.n_steps, self.extent = n, n_steps, extent
        self.options = options

    def forward(self):
        # one tile of the whole image: the tile only has to divide n
        return self.render(self.params, self.n, self.n_steps, self.extent,
                           self.n, None, **self.options)
