"""SDF render kernels for the GPU: the forward march in every option of
the reference (a cone-prepass start map, an f32 or bf16 march, the plain
or the over-relaxed march, the two-pass split march) and the backward by
two routes (closed form, and reverse mode written out per pixel).

Counterpart of the SDF half of enoki_tpu/render/pallas_kernels.py
(``_march_tile``, ``_march_sphere_tile``, ``cone_t0``, ``_sdf_fwd_kernel``,
``_sdf_fwd_kernel_split``, ``_sdf_tail_kernel``,
``_sdf_bwd_kernel_analytic``, ``_sdf_bwd_kernel_ad``,
``render_sdf_pallas``). The module has another name because nothing here
is Pallas: the kernels are CUDA C++ in ``enoki_tpu_torch/csrc/
sdf_render.cu`` and ``sdf_bwd_ad.cu``, built with nvcc on first use
(``enoki_tpu_torch._build``).

Each kernel has a plain PyTorch version beside it (``sdf_fwd_plain``,
``sdf_fwd_split_plain`` and ``sdf_fwd_split_list_plain`` with its
survivor list, ``sdf_tail_plain``, ``sdf_bwd_plain``,
``sdf_bwd_ad_plain``) that repeats its arithmetic. A wrapper takes the
plain version only for a tensor on the CPU; for a CUDA tensor it launches
the kernel or raises. ``_build.LAUNCHES`` counts the kernel launches, by
kernel: ``sdf_fwd``, ``sdf_fwd_bf16``, ``sdf_fwd_relax``,
``sdf_fwd_relax_bf16``, ``sdf_fwd_split``, ``sdf_tail``, ``sdf_bwd`` and
``sdf_bwd_ad`` (each backward is one launch).

The cone prepass (``cone_t0``) and the generic march engine
(``march_tile``) are plain PyTorch, as they are plain jnp in the
reference.

The flat parameter layout is that of the reference:
[cx, cy, cz, radius, ambient, gain, lx, ly, lz, 0 x 7] (N_PARAMS = 16).

``render_sdf_cuda`` has ``render_sdf_pallas``'s parameters, order and
defaults (so ``coarse=8``: the cone prepass is on unless it is turned
off), and refuses the compositions the reference refuses.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import _build
from .._device import resolve_device
from ..ops.router import _plain_rsqrt, safe_sqrt
from .implicit import implicit_t_vjp
from .sdf import SDFScene, sdf, sdf_ortho_dist
from .sphere import SphereScene, scene_from_leaves, scene_leaves
from .vec import Vec3

N_PARAMS = 16
EPS = 1e-4      # f32 march convergence eps, as hardcoded in the TPU kernel
T_MAX = 10.0    # march escape distance, likewise
CONT_FROZEN = -1e9   # pass 1's ``cont`` for a lane that froze before the cap
MARCH_DTYPES = (torch.float32, torch.bfloat16)
BWD_KERNELS = ("analytic", "ad")


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


def march_eps(dtype) -> float:
    """Convergence eps of a march in ``dtype``: 1e-4 in f32, 2 ulp in
    bf16, whose spacing at t ~ 1 (3.9e-3) the f32 eps could never reach."""
    return EPS if dtype == torch.float32 else 2.0 * torch.finfo(dtype).eps


def _const(v, like):
    """A Python scalar as a 0-dim tensor of ``like``'s dtype and device.
    Every scalar that meets a march tensor goes through here: as a bare
    Python number PyTorch's CUDA ops would take it in f32 against a bf16
    tensor, where the reference (and the kernel) round it to bf16 first."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _sqrt(x):
    """sqrt in f32, correctly rounded, then rounded once to ``x``'s dtype
    (what CUDA's sqrt and the kernels' __fsqrt_rn give; PyTorch's CPU f32
    sqrt is 1 ulp off on ~0.6% of inputs)."""
    return safe_sqrt(x.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Plain march engines
# ---------------------------------------------------------------------------


def _relax_step(dist_at, pos, stp, last, eps, t_max, w, back, unimodal):
    """One over-relaxed sphere-trace step (``_relax_step`` of the
    reference): returns (new_pos, new_stp, alive | over). ``last`` is
    whether this is step n_steps - 1, where no lane advances."""
    d = dist_at(pos)
    zero = torch.zeros_like(pos)
    back_stp = back * stp
    over = d < back_stp
    alive = (d >= eps) & (pos + d <= t_max)
    if unimodal:
        diverged = (~over) & (stp > zero) & (d >= eps) & (d * w > stp)
        alive = alive & ~diverged
    adv = alive & ~over & (not last)
    new_stp = torch.where(adv, w * d, zero)
    # revert (overlap failed) to the plain-step position pos - stp +
    # stp/relax; advance otherwise; frozen lanes add 0
    new_pos = torch.where(over, pos - back_stp, pos + new_stp)
    if unimodal:
        new_pos = torch.where(diverged, t_max, new_pos)
    return new_pos, new_stp, alive | over


def _relax_consts(t, eps, t_max, relax):
    """(eps, t_max, w, back) of the relaxed march as 0-dim tensors of the
    march dtype."""
    return (_const(eps, t), _const(t_max, t), _const(relax, t),
            _const(1.0 - 1.0 / relax, t))


def _march_relaxed(dist_at, t, n_steps, eps, t_max, relax, unimodal):
    """The (pos, stp) march of ``_march_tile``: returns (pos, hit)."""
    eps, t_max, w, back = _relax_consts(t, eps, t_max, relax)
    pos, stp = t, torch.zeros_like(t)
    for k in range(n_steps):
        pos, stp, _ = _relax_step(dist_at, pos, stp, k == n_steps - 1, eps,
                                  t_max, w, back, unimodal)
    return pos, dist_at(pos) < eps


def march_tile(dist_at, like, n_steps: int, eps: float = 1e-4,
               t_max: float = 10.0, chunk: int = 16, t0=None,
               relax: float = 1.0, unimodal: bool = False):
    """Sphere-trace every lane of ``like``'s shape and dtype: the
    reference's ``_march_tile`` -> (t, hit).

    ``dist_at(t) -> distance`` evaluates the scene SDF at parameter ``t``
    along each lane's ray; ``t0`` optionally starts each lane at a
    proven-safe parameter (``cone_t0``). ``relax > 1`` over-relaxes each
    advance with the overlap test and its revert; ``unimodal`` freezes a
    lane whose distance grew after a proven-safe step as a miss. With
    ``relax == 1 and not unimodal`` the carry is ``t`` alone.

    Masked over all lanes with no early exit: a frozen lane never
    advances, so the reference's chunked tile-level exit changes no value
    and ``chunk`` is accepted and ignored.
    """
    t = torch.zeros_like(like) if t0 is None else t0
    if relax != 1.0 or unimodal:
        return _march_relaxed(dist_at, t, n_steps, eps, t_max, relax,
                              unimodal)
    eps, t_max = _const(eps, t), _const(t_max, t)
    for _ in range(n_steps - 1):  # the advance at step n_steps - 1 is masked
        d = dist_at(t)
        alive = (d >= eps) & (t + d <= t_max)
        t = torch.where(alive, t + d, t)
    return t, dist_at(t) < eps


def _dist_len(rxy2, z):
    x = rxy2 + z * z
    return x * _plain_rsqrt(x)


def _march_z(rxy2, z0, rad, n_steps: int, eps: float = EPS, t0=None,
             z_init=None):
    """The z-carry march of _march_sphere_tile in ``rxy2``'s dtype, masked
    over every lane: returns (z, hit, advances per lane, alive), ``alive``
    being the lanes that would still advance at the final z. A lane
    advances while |p-c| >= rad + eps and z + |p-c| <= t_max + z0 + rad,
    and never at step n_steps - 1. It starts at ``z_init`` or z0 + t0."""
    eps = _const(eps, rxy2)
    s_hit = rad + eps
    esc = _const(T_MAX, rxy2) + z0 + rad
    if z_init is not None:
        z = z_init
    else:
        z = z0 + (torch.zeros_like(rxy2) if t0 is None else t0)
    adv = torch.zeros_like(rxy2, dtype=torch.int32)
    for _ in range(n_steps - 1):
        s = _dist_len(rxy2, z)
        alive = (s >= s_hit) & (z + s <= esc)
        z = torch.where(alive, z + (s - rad), z)
        adv += alive
    s = _dist_len(rxy2, z)
    return z, (s - rad) < eps, adv, (s >= s_hit) & (z + s <= esc)


def _march_parts(params, px, py, dtype):
    """(rxy2, z0, rad) of sdf_ortho_parts in the march dtype: the scene
    scalars and the pixel coordinates are cast, and each Python scalar of
    the reference rounds to the dtype on its own."""
    pm = params.to(dtype)
    dx = px.to(dtype) - pm[0]
    dy = py.to(dtype) - pm[1]
    rxy2 = dx * dx + dy * dy + _const(1e-12, dx)
    return rxy2, _const(-1.0, dx) - pm[2], pm[3]


def _march_t0(t0, dtype):
    """The start map in the march dtype. A bf16 march scales it down by
    one ulp in f32 before the cast, so that rounding to nearest never
    lifts it past the f32 bound the cone prepass proved."""
    if t0 is None or dtype == torch.float32:
        return t0
    return (t0 * (1.0 - torch.finfo(dtype).eps)).to(dtype)


def _relaxed_parts(params, px, py, t0, dtype):
    """(dist_at, start, eps) of the forward kernel's (pos, stp) march in
    ``dtype``, over sqrt(rxy2 + (z0+t)^2) - rad."""
    rxy2, z0, rad = _march_parts(params, px, py, dtype)
    t0 = _march_t0(t0, dtype)

    def dist_at(t):
        u = z0 + t
        return _sqrt(rxy2 + u * u) - rad

    return (dist_at, torch.zeros_like(rxy2) if t0 is None else t0,
            march_eps(dtype))


def _forward_march(params, px, py, n_steps, t0, dtype, relax, unimodal):
    """The march of the forward kernel -> (t in f32, hit)."""
    if relax == 1.0 and not unimodal:
        rxy2, z0, rad = _march_parts(params, px, py, dtype)
        z, hit, _, _ = _march_z(rxy2, z0, rad, n_steps, march_eps(dtype),
                                _march_t0(t0, dtype))
        return (z - z0).float(), hit
    dist_at, t, eps = _relaxed_parts(params, px, py, t0, dtype)
    pos, hit = _march_relaxed(dist_at, t, n_steps, eps, T_MAX, relax,
                              unimodal)
    return pos.float(), hit


def _shade(params, px, py, t, hit):
    """(img, ts) of the forward kernels from the march's (t, hit), in f32:
    the closed-form normal, the gradient of sqrt(|d|^2 + 1e-12) - rad, and
    the Lambert shade; ts = t on a hit and -t-1 on a miss."""
    amb, gain = params[4], params[5]
    lx, ly, lz = params[6], params[7], params[8]
    dx = px - params[0]
    dy = py - params[1]
    dz = (-1.0 + t) - params[2]
    q = _plain_rsqrt(dx * dx + dy * dy + dz * dz + 1e-12)
    gx, gy, gz = dx * q, dy * q, dz * q
    inv = _plain_rsqrt(gx * gx + gy * gy + gz * gz + 1e-12)
    lam = torch.clamp_min((gx * lx + gy * ly + gz * lz) * inv, 0.0)
    img = torch.where(hit, amb + lam * gain, amb)
    return img, torch.where(hit, t, -t - 1.0)


def sdf_fwd_plain(params, n: int, n_steps: int, extent: float = 1.2,
                  t0=None, dtype=torch.float32, relax: float = 1.0,
                  unimodal: bool = False):
    """Plain version of the sdf_fwd kernels -> (img, ts), each (n, n) f32.
    ``t0`` is the cone prepass's (n, n) f32 start map or None, ``dtype``
    the march dtype; ``relax != 1`` or ``unimodal`` take the (pos, stp)
    march over sqrt(rxy2 + (z0+t)^2) - rad, else the z-carry march over
    x * rsqrt(x)."""
    px, py = tile_pixels(n, extent, params.device)
    t, hit = _forward_march(params, px, py, n_steps, t0, dtype, relax,
                            unimodal)
    return _shade(params, px, py, t, hit)


def march_counts(params, n: int, n_steps: int, extent: float = 1.2,
                 t0=None, dtype=torch.float32, relax: float = 1.0,
                 unimodal: bool = False):
    """The work of an sdf_fwd kernel's march, per pixel, as two (n, n)
    tensors: the distance evaluations a thread executes, and the
    advances; for the relaxed march, the evaluations and the steps, a
    thread's steps running up to and including the first one that found
    its lane frozen. The z-carry march evaluates once per advance and once
    more (the evaluation that found the lane frozen, or at the step cap
    the hit test's own): the hit test takes that last distance. The
    relaxed march evaluates once a step and once more for the hit test.
    Nothing on a render's path calls this: it replays the march to count
    it."""
    px, py = tile_pixels(n, extent, params.device)
    if relax == 1.0 and not unimodal:
        rxy2, z0, rad = _march_parts(params, px, py, dtype)
        adv = _march_z(rxy2, z0, rad, n_steps, march_eps(dtype),
                       _march_t0(t0, dtype))[2]
        return adv + 1, adv
    dist_at, pos, eps = _relaxed_parts(params, px, py, t0, dtype)
    eps, t_max, w, back = _relax_consts(pos, eps, T_MAX, relax)
    stp = torch.zeros_like(pos)
    going = torch.ones_like(pos, dtype=torch.bool)
    steps = torch.zeros_like(pos, dtype=torch.int32)
    for k in range(n_steps):
        steps += going
        pos, stp, go = _relax_step(dist_at, pos, stp, k == n_steps - 1, eps,
                                   t_max, w, back, unimodal)
        going = going & go
    return steps + 1, steps


def sdf_fwd_split_plain(params, n: int, split: int, extent: float = 1.2,
                        t0=None):
    """Plain version of the sdf_fwd_split kernel (pass 1 of the two-pass
    march) -> (img, ts, cont): the f32 z-carry march capped at ``split``
    steps, and ``cont`` = the carry z itself where the lane is still alive
    by the march's own freeze rule, -1e9 otherwise."""
    px, py = tile_pixels(n, extent, params.device)
    rxy2, z0, rad = _march_parts(params, px, py, torch.float32)
    z, hit, _, alive = _march_z(rxy2, z0, rad, split, EPS, t0)
    img, ts = _shade(params, px, py, z - z0, hit)
    return img, ts, torch.where(alive, z, CONT_FROZEN)


def sdf_fwd_split_list_plain(params, n: int, split: int, extent: float = 1.2,
                             t0=None):
    """Plain version of the sdf_fwd_split kernel with its survivor list ->
    (img, ts, cont, pairs, counters): ``sdf_fwd_split_plain``'s outputs,
    ``pairs`` an (n*n, 2) int32 tensor whose first ``count`` rows are the
    survivors (flat pixel index, bits of the carry z = cont[index]) in
    row-major order, zeros after them, and ``counters`` the int32 pair
    (count, 0). The kernel's list holds the same pairs in the order of its
    blocks' atomics."""
    img, ts, cont = sdf_fwd_split_plain(params, n, split, extent, t0)
    idx = survivors(cont)
    pairs = torch.zeros((n * n, 2), dtype=torch.int32, device=params.device)
    pairs[:idx.numel(), 0] = idx.to(torch.int32)
    pairs[:idx.numel(), 1] = cont.reshape(-1)[idx].view(torch.int32)
    counters = torch.tensor([idx.numel(), 0], dtype=torch.int32,
                            device=params.device)
    return img, ts, cont, pairs, counters


def survivor_entries(pairs, counters):
    """(flat pixel indices as int32, carries z) of a survivor list, in its
    order. Reads the count on the host, a sync on the card: for checks,
    never on a render's path."""
    k = int(counters[0].item())
    return pairs[:k, 0], pairs[:k, 1].view(torch.float32)


def _tail_plain(params, idx, z, img, ts, n, n_steps, split, extent):
    """The tail's march for survivors ``idx`` (int64) from carries ``z``;
    writes ``img`` and ``ts`` at ``idx`` in place."""
    coords = tile_pixels(n, extent, params.device)[0][0]
    row = torch.div(idx, n, rounding_mode="floor")
    px, py = coords[idx - row * n], coords[row]
    rxy2, z0, rad = _march_parts(params, px, py, torch.float32)
    z = _march_z(rxy2, z0, rad, 2, EPS, z_init=z)[0]
    z, hit, _, _ = _march_z(rxy2, z0, rad, n_steps - split, EPS, z_init=z)
    img_c, ts_c = _shade(params, px, py, z - z0, hit)
    img.view(-1)[idx] = img_c
    ts.view(-1)[idx] = ts_c
    return img, ts


def sdf_tail_plain(params, idx, cont, img, ts, n: int, n_steps: int,
                   split: int, extent: float = 1.2):
    """Plain version of the sdf_tail kernel (pass 2): for the survivors
    ``idx`` (flat pixel indices, int64) replay the advance that pass 1's
    last step masked, march ``n_steps - split`` more steps from the carry
    ``cont[idx]``, shade, and write ``img`` and ``ts`` at ``idx`` in
    place. Returns (img, ts)."""
    return _tail_plain(params, idx, cont.reshape(-1)[idx], img, ts, n,
                       n_steps, split, extent)


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
    q = _plain_rsqrt(dx * dx + dy * dy + dz * dz + 1e-12)
    ux, uy, uz = dx * q, dy * q, dz * q
    inv = _plain_rsqrt(ux * ux + uy * uy + uz * uz + 1e-12)
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


def shade_tile(px, py, t, hit, pvec):
    """Shade at fixed (t, hit), differentiable in ``pvec`` and ``t``
    (``_sdf_shade_tile`` of the reference): the normal is the SDF's
    gradient taken by autograd, not written in closed form."""
    scene = vec_to_scene(pvec, SDFScene)
    with torch.enable_grad():
        xs = [c if c.requires_grad else c.detach().requires_grad_(True)
              for c in (px, py, -1.0 + t)]
        gx, gy, gz = torch.autograd.grad(sdf(Vec3(*xs), scene).sum(), xs,
                                         create_graph=True)
    inv = _plain_rsqrt(gx * gx + gy * gy + gz * gz + 1e-12)
    lam = (gx * scene.light.x + gy * scene.light.y
           + gz * scene.light.z) * inv
    img = scene.ambient + torch.maximum(lam, torch.zeros_like(lam)) \
        * scene.gain
    return torch.where(hit, img, scene.ambient + torch.zeros_like(img))


def sdf_bwd_ad_plain(params, g, ts, n: int, extent: float = 1.2):
    """Plain version of the sdf_bwd_ad kernel: the same cotangent as
    ``sdf_bwd_plain`` by autograd through ``shade_tile`` plus
    ``implicit_t_vjp`` of the SDF at the frozen root, a route that shares
    nothing with either kernel's derivation."""
    px, py = tile_pixels(n, extent, params.device)
    hit = ts >= 0.0
    t = torch.where(hit, ts, -1.0 - ts)
    with torch.enable_grad():
        pv = params.detach().requires_grad_(True)
        tv = t.detach().requires_grad_(True)
        img = shade_tile(px, py, tv, hit, pv)
        dp_direct, t_bar = torch.autograd.grad(img, (pv, tv), grad_outputs=g)
    (dp_indirect,) = implicit_t_vjp(
        lambda a, tv: sdf(Vec3(px, py, -1.0 + tv),
                          vec_to_scene(a[0], SDFScene)),
        [params], t, t_bar, hit)
    return dp_direct + dp_indirect


# ---------------------------------------------------------------------------
# The cone prepass (plain PyTorch, as it is plain jnp in the reference)
# ---------------------------------------------------------------------------


def cone_t0(dist_factory, n: int, n_steps: int, extent: float, s: int,
            eps: float = 1e-4, t_max: float = 10.0, margin: float = 1e-3,
            device=None):
    """Cone-march prepass: a conservative (n, n) march start map.

    One coarse ray per s x s block of fine pixels, marched with the SDF
    deflated by R, the largest transverse offset between the block's
    center ray and any fine ray of its footprint. The SDF is 1-Lipschitz,
    so sdf(fine(t)) >= sdf(coarse(t)) - R and no fine ray can cross the
    surface before the returned t0. ``dist_factory(px, py) -> (t ->
    distance)`` supplies the SDF along orthographic rays at the coarse
    pixel centers. The map is upsampled, lowered by ``margin``, clamped at
    0 and detached. Runs ``n_steps`` masked steps of eager ops on an
    (n/s)^2 array."""
    device = resolve_device(device)
    m = n // s
    step = 2.0 * extent / (n - 1)
    half = (s - 1) / 2.0
    coords = (torch.arange(m, dtype=torch.float32, device=device) * s
              + half) * step - extent
    px = coords[None, :].expand(m, m)
    py = coords[:, None].expand(m, m)
    r_cone = (2.0 ** 0.5) * half * step
    dist_at = dist_factory(px, py)
    t = torch.zeros((m, m), dtype=torch.float32, device=device)
    for _ in range(n_steps):
        d = dist_at(t) - r_cone
        alive = (d >= eps) & (t + d <= t_max)
        t = torch.where(alive, t + d, t)
    t = t.repeat_interleave(s, dim=0).repeat_interleave(s, dim=1)
    return torch.clamp_min(t - margin, 0.0).detach()


def _cone_t0(pvec, n, n_steps, extent, s, eps=1e-4, t_max=10.0,
             margin=1e-3):
    """cone_t0 over the sphere scene's hoisted orthographic SDF."""
    scene = vec_to_scene(pvec.detach(), SDFScene)
    return cone_t0(lambda px, py: sdf_ortho_dist(px, py, scene), n, n_steps,
                   extent, s, eps, t_max, margin, device=pvec.device)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def fwd_kernel_name(dtype, relax: float = 1.0, unimodal: bool = False) -> str:
    """The launch-counter name of the sdf_fwd instantiation that marches in
    ``dtype`` with these options."""
    if dtype not in MARCH_DTYPES:
        raise ValueError(f"march dtype must be torch.float32 or "
                         f"torch.bfloat16, got {dtype}")
    return ("sdf_fwd" + ("_relax" if relax != 1.0 or unimodal else "")
            + ("_bf16" if dtype == torch.bfloat16 else ""))


def _check_t0(t0, n, device):
    if t0 is None:
        return 0
    _build.check(t0, "t0", (n, n), device)
    return t0.data_ptr()


def sdf_fwd(params, n: int, n_steps: int, extent: float = 1.2, t0=None,
            dtype=torch.float32, relax: float = 1.0,
            unimodal: bool = False):
    """Forward render -> (img, ts): the sdf_fwd kernel of these options
    for a CUDA tensor, the plain version for a CPU one."""
    kernel = fwd_kernel_name(dtype, relax, unimodal)
    if not _build.is_cuda(params):
        return sdf_fwd_plain(params, n, n_steps, extent, t0, dtype, relax,
                             unimodal)
    dev = params.device
    _build.check(params, "params", (N_PARAMS,), dev)
    t0_ptr = _check_t0(t0, n, dev)
    lib = _build.load("sdf_render")
    img = torch.empty((n, n), dtype=torch.float32, device=dev)
    ts = torch.empty_like(img)
    bf16 = int(dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        head = (params.data_ptr(), t0_ptr, img.data_ptr(), ts.data_ptr(), n,
                n_steps, pixel_step(n, extent), extent, bf16)
        if "relax" in kernel:
            # w and back rounded to the march dtype, as the plain version
            # holds them
            w = torch.tensor(relax, dtype=dtype).item()
            back = torch.tensor(1.0 - 1.0 / relax, dtype=dtype).item()
            err = lib.sdf_fwd_relax_launch(*head, w, back, int(unimodal),
                                           stream)
        else:
            err = lib.sdf_fwd_launch(*head, stream)
    _build.launched(err, kernel)
    return img, ts


def _check_list_size(n):
    if n * n >= 2 ** 31:
        raise ValueError(f"the split march's survivor list takes 32-bit "
                         f"pixel indices: n*n must be below 2^31, got n={n}")


def sdf_fwd_split_list(params, n: int, split: int, extent: float = 1.2,
                       t0=None, counters=None):
    """Pass 1 of the two-pass march with its survivor list -> (img, ts,
    cont, pairs, counters): the sdf_fwd_split kernel for a CUDA tensor,
    which appends each survivor (flat pixel index, bits of its carry z)
    to ``pairs`` (n*n rows of two int32, the first ``counters[0]`` of them
    filled, in no fixed order) and counts them in ``counters[0]`` on the
    card; ``sdf_fwd_split_list_plain`` for a CPU one. ``counters`` is an
    int32 pair of zeros, allocated (one memset on the stream) for each
    call unless it is given: the count, and a work counter that the
    shipped tail leaves alone and the refill schedules that chip_smoke.py
    times draw from. No host reads the count."""
    if not _build.is_cuda(params):
        return sdf_fwd_split_list_plain(params, n, split, extent, t0)
    dev = params.device
    _build.check(params, "params", (N_PARAMS,), dev)
    _check_list_size(n)
    t0_ptr = _check_t0(t0, n, dev)
    if counters is None:
        counters = torch.zeros(2, dtype=torch.int32, device=dev)
    _build.check(counters, "counters", (2,), dev, torch.int32)
    lib = _build.load("sdf_render")
    img = torch.empty((n, n), dtype=torch.float32, device=dev)
    ts, cont = torch.empty_like(img), torch.empty_like(img)
    pairs = torch.empty((n * n, 2), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdf_fwd_split_launch(
            params.data_ptr(), t0_ptr, img.data_ptr(), ts.data_ptr(),
            cont.data_ptr(), pairs.data_ptr(), counters.data_ptr(), n, split,
            pixel_step(n, extent), extent, stream)
    _build.launched(err, "sdf_fwd_split")
    return img, ts, cont, pairs, counters


def sdf_fwd_split(params, n: int, split: int, extent: float = 1.2, t0=None):
    """Pass 1 of the two-pass march -> (img, ts, cont): the sdf_fwd_split
    kernel for a CUDA tensor, the plain version for a CPU one
    (``sdf_fwd_split_list`` without its list)."""
    if not _build.is_cuda(params):
        return sdf_fwd_split_plain(params, n, split, extent, t0)
    return sdf_fwd_split_list(params, n, split, extent, t0)[:3]


def sdf_tail(params, pairs, counters, img, ts, n: int, n_steps: int,
             split: int, extent: float = 1.2):
    """Pass 2 of the two-pass march over pass 1's survivor list ``pairs``,
    ``counters`` (``sdf_fwd_split_list``'s): writes ``img`` and ``ts`` at
    the survivors in place and returns them. The sdf_tail kernel for CUDA
    tensors, which reads the count on the card and launches with no
    survivor too; the plain version over the list's entries for CPU
    ones."""
    if not _build.is_cuda(params):
        idx, z = survivor_entries(pairs, counters)
        return _tail_plain(params, idx.long(), z, img, ts, n, n_steps, split,
                           extent)
    dev = params.device
    _build.check(params, "params", (N_PARAMS,), dev)
    _check_list_size(n)
    for x, name in ((img, "img"), (ts, "ts")):
        _build.check(x, name, (n, n), dev)
    _build.check(pairs, "pairs", (n * n, 2), dev, torch.int32)
    _build.check(counters, "counters", (2,), dev, torch.int32)
    lib = _build.load("sdf_render")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdf_tail_launch(
            params.data_ptr(), pairs.data_ptr(), counters.data_ptr(),
            img.data_ptr(), ts.data_ptr(), n, n_steps - split,
            pixel_step(n, extent), extent, stream)
    _build.launched(err, "sdf_tail")
    return img, ts


def survivors(cont):
    """The flat indices of pass 1's survivors, in row-major order
    (``torch.nonzero``, whose length the host has to know: a sync on the
    card). The plain route's list, and the order the card's list is held
    against."""
    return torch.nonzero(cont.reshape(-1) > 0.1 * CONT_FROZEN).reshape(-1)


def sdf_split(params, n: int, n_steps: int, extent: float = 1.2,
              split: int = 16, t0=None):
    """The two-pass compacted forward -> (img, ts), the one-pass march's
    bit for bit: pass 1 capped at ``split`` steps appends its survivors to
    a list on the card, and pass 2 marches them on, both on the current
    stream with no host sync between or after them (the list's count
    stays on the card); on the CPU the plain versions of both."""
    img, ts, _, pairs, counters = sdf_fwd_split_list(params, n, split,
                                                     extent, t0)
    return sdf_tail(params, pairs, counters, img, ts, n, n_steps, split,
                    extent)


def sdf_split_plain(params, n: int, n_steps: int, extent: float = 1.2,
                    split: int = 16, t0=None):
    """``sdf_split`` through the plain versions of both passes, the
    survivors compacted by ``survivors`` in row-major order."""
    img, ts, cont = sdf_fwd_split_plain(params, n, split, extent, t0)
    return sdf_tail_plain(params, survivors(cont), cont, img, ts, n, n_steps,
                          split, extent)


def bwd_vector_loads(g, ts, n: int) -> bool:
    """Whether the backward kernels load ``g`` and ``ts`` as float4: a row
    is whole float4s (n % 4 == 0) and both start on 16 bytes. Otherwise
    they load every pixel on its own."""
    return n % 4 == 0 and g.data_ptr() % 16 == 0 and ts.data_ptr() % 16 == 0


def sdf_bwd(params, g, ts, n: int, extent: float = 1.2,
            kernel: str = "analytic"):
    """Parameter cotangent dp[16] in one launch of the sdf_bwd kernel
    (``kernel="analytic"``, the closed form) or of the sdf_bwd_ad kernel
    (``"ad"``, reverse mode), whose blocks write per-block sums and whose
    last block sums them in a fixed order, for CUDA tensors; the kernel's
    plain version for CPU ones."""
    if kernel not in BWD_KERNELS:
        raise ValueError(f"kernel must be one of {BWD_KERNELS}, got "
                         f"{kernel!r}")
    if not _build.is_cuda(params):
        plain = sdf_bwd_plain if kernel == "analytic" else sdf_bwd_ad_plain
        return plain(params, g, ts, n, extent)
    dev = params.device
    _build.check(params, "params", (N_PARAMS,), dev)
    _build.check(g, "g", (n, n), dev)
    _build.check(ts, "ts", (n, n), dev)
    if kernel == "analytic":
        lib, name = _build.load("sdf_render"), "sdf_bwd"
    else:
        lib, name = _build.load("sdf_bwd_ad"), "sdf_bwd_ad"
    rows = getattr(lib, f"{name}_num_blocks")(n)
    partial = torch.empty((rows, 9), dtype=torch.float32, device=dev)
    dp = torch.empty(N_PARAMS, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_launch")(
            params.data_ptr(), g.data_ptr(), ts.data_ptr(),
            partial.data_ptr(), _build.ticket(dev, stream).data_ptr(),
            dp.data_ptr(), n, pixel_step(n, extent), extent,
            int(bwd_vector_loads(g, ts, n)), stream)
        _build.launched(err, name)
    return dp


# sdf_bwd as the backward calls it; under vmap(grad(...)) one launch an
# item of the batch
_sdf_bwd_call = _build.kernel_call(
    "_SDFBwdFn", lambda params, g, ts, n, extent, kernel:
    sdf_bwd(params, g.contiguous(), ts, n, extent, kernel))


class _SDFRenderFn(_build.KernelFunction):
    """Forward: the cone prepass if ``coarse``, then sdf_split or sdf_fwd
    -> (img, ts), ts the packed residual (one float per pixel) that the
    backward reads and no gradient reaches. Backward: sdf_bwd on that
    residual, whatever the forward's options. ``vmap``: one forward an
    item of the batch."""

    @staticmethod
    def forward(params, n, n_steps, extent, coarse, dtype, relax,
                unimodal, split, bwd_kernel):
        p = params.detach()
        t0 = _cone_t0(p, n, n_steps, extent, coarse) if coarse else None
        if split:
            return sdf_split(p, n, n_steps, extent, split, t0)
        return sdf_fwd(p, n, n_steps, extent, t0, dtype, relax, unimodal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        params, n, _, extent = inputs[:4]
        ctx.mark_non_differentiable(output[1])
        # no (n, n) zeros for ts's gradient, which the backward ignores
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(params, output[1])
        ctx.n, ctx.extent, ctx.bwd_kernel = n, extent, inputs[9]

    @staticmethod
    def backward(ctx, g, _ts_bar):
        params, ts = ctx.saved_tensors
        dp = _sdf_bwd_call(params.detach(), g, ts, ctx.n, ctx.extent,
                           ctx.bwd_kernel)
        return (dp,) + (None,) * 9

    vmap = _build.loop_vmap("_SDFRenderFn",
                            lambda *a: _SDFRenderFn.apply(*a))


def _render_sdf(params, n, n_steps, extent, tile, tile_c, coarse, dtype,
                bands, relax, unimodal, split, bwd_kernel):
    fwd_kernel_name(dtype)  # raises on another march dtype
    if bwd_kernel not in BWD_KERNELS:
        raise ValueError(f"bwd_kernel must be one of {BWD_KERNELS}, got "
                         f"{bwd_kernel!r}")
    if bands < 1:
        raise ValueError(f"bands must be >= 1, got {bands}")
    if split:
        if (dtype != torch.float32 or bands != 1 or relax != 1.0
                or unimodal):
            raise ValueError("split composes only with the plain march "
                             "(f32, bands=1, relax=1, not unimodal)")
        if not 0 < split < n_steps or (n_steps - split) % 2:
            raise ValueError(f"split must satisfy 0 < split < n_steps with "
                             f"an even n_steps - split, got split={split}, "
                             f"n_steps={n_steps}")
    tile_c = tile_c or tile
    if n % tile or n % tile_c:
        raise ValueError("image size must be divisible by the tile size")
    if coarse and n % coarse:
        raise ValueError(f"image size must be divisible by the cone "
                         f"prepass block, got n={n}, coarse={coarse}")
    if tuple(params.shape) != (N_PARAMS,):
        raise ValueError(f"params must have shape ({N_PARAMS},), got "
                         f"{tuple(params.shape)}")
    img, _ = _SDFRenderFn.apply(params, n, n_steps, extent, coarse, dtype,
                                relax, unimodal, split, bwd_kernel)
    return img


def render_sdf_cuda(params, n: int = 1024, n_steps: int = 64,
                    extent: float = 1.2, tile: int = 64, tile_c=None,
                    coarse: int = 8, chunk: int = 16, dtype=torch.float32,
                    bands: int = 1, relax: float = 1.0,
                    unimodal: bool = False, split: int = 0):
    """SDF sphere-march render of the 16-vector ``params`` -> (n, n) f32
    image, differentiable in ``params`` through the analytic backward
    kernel on the forward's ``ts`` residual.

    The parameters are ``render_sdf_pallas``'s, with its defaults.
    ``coarse`` is the cone prepass's block side (``cone_t0``; 0 turns it
    off). ``dtype`` is the march dtype, f32 or bf16; the shade, ``ts`` and
    the gradient stay f32. ``relax > 1`` over-relaxes the march and
    ``unimodal`` adds the convex-scene divergence exit (``march_tile``).
    ``split > 0`` takes the two-pass compacted march (``sdf_split``); it
    composes with ``coarse`` only, needs 0 < split < n_steps and an even
    n_steps - split, and raises ValueError otherwise.

    ``tile``/``tile_c`` must divide ``n`` as in the reference, ``chunk``
    is accepted, and ``bands`` may be any number >= 1; none of them changes
    the result: the CUDA kernels set their own launch geometry and each
    thread leaves its march on its own, which does per lane what the
    chunked exit and the row bands do per tile.
    """
    return _render_sdf(params, n, n_steps, extent, tile, tile_c, coarse,
                       dtype, bands, relax, unimodal, split, "analytic")


class SDFRender(nn.Module):
    """The SDF render as a module whose one parameter is the 16-vector.
    ``forward()`` returns the (n, n) image. The options are
    ``render_sdf_cuda``'s; their defaults are the plain configuration
    (no prepass, f32, plain one-pass march). ``bwd_kernel`` chooses the
    backward's route, "analytic" or "ad" (``sdf_bwd``)."""

    def __init__(self, params=None, n: int = 1024, n_steps: int = 64,
                 extent: float = 1.2, device=None, coarse: int = 0,
                 dtype=torch.float32, bands: int = 1, relax: float = 1.0,
                 unimodal: bool = False, split: int = 0,
                 bwd_kernel: str = "analytic"):
        super().__init__()
        if params is None:
            params = scene_to_vec(SDFScene.reference(device))
        elif device is not None:
            params = params.to(device)
        self.params = nn.Parameter(params.detach().to(torch.float32).clone())
        self.n, self.n_steps, self.extent = n, n_steps, extent
        self.options = dict(coarse=coarse, dtype=dtype, bands=bands,
                            relax=relax, unimodal=unimodal, split=split,
                            bwd_kernel=bwd_kernel)

    def forward(self):
        # one tile of the whole image: the tile only has to divide n
        return _render_sdf(self.params, self.n, self.n_steps, self.extent,
                           self.n, None, **self.options)
