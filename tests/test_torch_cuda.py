"""The port's CUDA kernels against their plain PyTorch versions on a card.

Imports torch and the port only (no JAX), so that it runs where the card
is:  python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
Every test here skips where torch.cuda.is_available() is false. The scene
recipe is shared with the CPU parity tests.
"""

import ctypes

import numpy as np
import pytest
import torch

from enoki_tpu_torch import _build, ops as R
from enoki_tpu_torch.ops import hist_kernels as H, rounding as RD
from enoki_tpu_torch.render import (LAUNCHES, Vec3, generic as G,
                                    reset_launch_counts, sdf_trace,
                                    sdflib as sd)
from enoki_tpu_torch.render.sdf_kernels import (
    SDFRender, _cone_t0, bwd_vector_loads, fwd_kernel_name, render_sdf_cuda,
    sdf_bwd, sdf_bwd_ad_plain, sdf_bwd_plain, sdf_fwd, sdf_fwd_plain,
    sdf_fwd_split, sdf_fwd_split_list, sdf_fwd_split_list_plain,
    sdf_fwd_split_plain, sdf_split, sdf_split_plain, sdf_tail,
    survivor_entries)
from enoki_tpu_torch.render.sphere_kernels import (
    bwd_vector_loads as sphere_bwd_vector_loads, fwd_vector_stores,
    render_sphere_cuda, sphere_bwd, sphere_bwd_plain, sphere_fwd,
    sphere_fwd_plain)

SCENES = {"reference": None, "seed1": 1, "seed2": 2}
N = 256
STEPS = 64


def scene_vec(seed):
    """The reference scene's 16-vector (seed None), or a seeded
    perturbation of it: center +-0.1, radius 0.8-1.1, a random light."""
    v = np.zeros(16, np.float32)
    v[:9] = [0, 0, 0, 1.0, 0.2, 90.0, -1.0, -1.0, 2.0]
    if seed is not None:
        rng = np.random.default_rng(seed)
        v[0:3] = rng.uniform(-0.1, 0.1, 3)
        v[3] = rng.uniform(0.8, 1.1)
        v[6:9] = rng.uniform(-2.0, 2.0, 3)
    return v


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(params=list(SCENES), ids=list(SCENES))
def params(request, cuda):
    return torch.from_numpy(scene_vec(SCENES[request.param])).to(cuda)


@pytest.mark.cuda
def test_sdf_fwd_kernel_matches_plain(params):
    img_k, ts_k = sdf_fwd(params, N, STEPS, 1.2)
    img_p, ts_p = sdf_fwd_plain(params, N, STEPS, 1.2)
    torch.cuda.synchronize()
    # the kernel's march rounds each product and sum as the plain version
    # does, so it walks the same trajectory: no pixel flips between hit
    # and miss, and the image agrees to the reference's atol
    assert torch.equal(ts_k >= 0, ts_p >= 0)
    assert (img_k - img_p).abs().max().item() <= 1e-3
    assert (ts_k - ts_p).abs().max().item() <= 2e-4


# image sizes: one the kernels' warp tiles and blocks divide, and two they
# do not (the start map needs a multiple of its block, 8); the backward
# loads float4s at 256 and 1000 and single floats at 257
EDGE_SIZES = (N, 1000, 257)


def _bwd_inputs(params, n, shift=0.0):
    p = params.clone()
    p[0] += shift
    _, ts = sdf_fwd(p, n, STEPS, 1.2)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (n, n)).astype(np.float32)).to(p.device)
    return p, g, ts


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("shift", [0.0, 10.0], ids=["mixed", "all_miss"])
def test_sdf_bwd_kernel_matches_plain_and_is_deterministic(params, n, shift):
    p, g, ts = _bwd_inputs(params, n, shift)
    assert bwd_vector_loads(g, ts, n) == (n % 4 == 0)
    reset_launch_counts()
    dp1 = sdf_bwd(p, g, ts, n, 1.2)
    assert LAUNCHES == {"sdf_bwd": 1}
    dp2 = sdf_bwd(p, g, ts, n, 1.2)
    ref = sdf_bwd_plain(p, g, ts, n, 1.2)
    torch.cuda.synchronize()
    assert torch.equal(dp1, dp2)
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(dp1, ref, rtol=2e-4, atol=2e-4 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["analytic", "ad"])
def test_sdf_bwd_counter_is_reset_by_every_launch(params, kernel):
    # the last block sets its ticket counter back to 0: after many calls,
    # one more sums as the first did
    p, g, ts = _bwd_inputs(params, 1000)
    first = sdf_bwd(p, g, ts, 1000, 1.2, kernel)
    for _ in range(300):
        sdf_bwd(p, g, ts, 1000, 1.2, kernel)
    last = sdf_bwd(p, g, ts, 1000, 1.2, kernel)
    torch.cuda.synchronize()
    assert torch.equal(first, last)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["analytic", "ad"])
def test_sdf_bwd_takes_single_loads_from_a_misaligned_view(params, kernel):
    p, g, ts = _bwd_inputs(params, N)
    buf = torch.empty(N * N + 1, device=p.device)
    g_off = buf[1:].view(N, N)  # 4 bytes past a 16-byte boundary
    g_off.copy_(g)
    assert bwd_vector_loads(g, ts, N) and not bwd_vector_loads(g_off, ts, N)
    dp = sdf_bwd(p, g_off, ts, N, 1.2, kernel)
    plain = sdf_bwd_plain if kernel == "analytic" else sdf_bwd_ad_plain
    ref = plain(p, g, ts, N, 1.2)
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(dp, ref, rtol=2e-4, atol=2e-4 * scale)
    # a thread adds the same pixels in the same order on both routes
    assert torch.equal(dp, sdf_bwd(p, g, ts, N, 1.2, kernel))


@pytest.mark.cuda
def test_render_sdf_cuda_launches_one_of_each(cuda):
    p = torch.from_numpy(scene_vec(None)).to(cuda).requires_grad_(True)
    reset_launch_counts()
    render_sdf_cuda(p, N, STEPS, coarse=0).mean().backward()
    torch.cuda.synchronize()
    assert LAUNCHES == {"sdf_fwd": 1, "sdf_bwd": 1}
    assert torch.isfinite(p.grad).all()


FWD_OPTIONS = {
    "cone": dict(coarse=8),
    "bf16": dict(dtype=torch.bfloat16),
    "cone_bf16": dict(coarse=8, dtype=torch.bfloat16),
    "relax1.6_unimodal": dict(relax=1.6, unimodal=True),
    "cone_relax1.9": dict(coarse=8, relax=1.9),
    "unimodal": dict(unimodal=True),
    "relax1.6_unimodal_bf16": dict(relax=1.6, unimodal=True,
                                   dtype=torch.bfloat16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", [
    (name, n) for name in FWD_OPTIONS for n in EDGE_SIZES
    if n % 8 == 0 or "coarse" not in FWD_OPTIONS[name]])
def test_sdf_fwd_variants_are_bit_equal_to_plain(params, name, n):
    # every march rounds each op on its own, in the plain version's order
    kw = dict(FWD_OPTIONS[name])
    coarse = kw.pop("coarse", 0)
    t0 = _cone_t0(params, n, STEPS, 1.2, coarse) if coarse else None
    reset_launch_counts()
    img_k, ts_k = sdf_fwd(params, n, STEPS, 1.2, t0, **kw)
    img_p, ts_p = sdf_fwd_plain(params, n, STEPS, 1.2, t0, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES == {fwd_kernel_name(
        kw.get("dtype", torch.float32), kw.get("relax", 1.0),
        kw.get("unimodal", False)): 1}
    assert torch.equal(img_k, img_p) and torch.equal(ts_k, ts_p)


SPLIT_CASES = [(split, coarse, n) for split, coarse in [(16, 0), (32, 0),
                                                         (16, 8)]
               for n in EDGE_SIZES if n % 8 == 0 or not coarse]


@pytest.mark.cuda
@pytest.mark.parametrize("split,coarse,n", SPLIT_CASES)
def test_split_kernels_are_bit_equal_to_one_pass_and_plain(params, split,
                                                           coarse, n):
    t0 = _cone_t0(params, n, STEPS, 1.2, coarse) if coarse else None
    one = sdf_fwd(params, n, STEPS, 1.2, t0)
    reset_launch_counts()
    two = sdf_split(params, n, STEPS, 1.2, split, t0)
    torch.cuda.synchronize()
    assert LAUNCHES == {"sdf_fwd_split": 1, "sdf_tail": 1}
    plain = sdf_split_plain(params, n, STEPS, 1.2, split, t0)
    for a, b, c in zip(one, two, plain):
        assert torch.equal(a, b) and torch.equal(b, c)
    for a, b in zip(sdf_fwd_split(params, n, split, 1.2, t0),
                    sdf_fwd_split_plain(params, n, split, 1.2, t0)):
        assert torch.equal(a, b)
    # two runs bitwise equal, whatever order the list took
    again = sdf_split(params, n, STEPS, 1.2, split, t0)
    assert all(torch.equal(a, b) for a, b in zip(two, again))


@pytest.mark.cuda
@pytest.mark.parametrize("split,coarse,n", SPLIT_CASES)
def test_pass_1s_list_sorted_is_the_plain_list(params, split, coarse, n):
    t0 = _cone_t0(params, n, STEPS, 1.2, coarse) if coarse else None
    got = sdf_fwd_split_list(params, n, split, 1.2, t0)
    want = sdf_fwd_split_list_plain(params, n, split, 1.2, t0)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got[4].tolist() == want[4].tolist()
    idx, z = survivor_entries(got[3], got[4])
    order = torch.argsort(idx)
    w_idx, w_z = survivor_entries(want[3], want[4])
    assert torch.equal(idx[order], w_idx)
    assert torch.equal(z[order], w_z)  # the carries, bit for bit


@pytest.mark.cuda
def test_split_with_no_survivor_launches_the_tail_and_keeps_pass_1(cuda):
    v = scene_vec(None)
    v[0] = 50.0   # off screen: every ray escapes within a few steps
    p = torch.from_numpy(v).to(cuda)
    img, ts, cont, pairs, counters = sdf_fwd_split_list(p, N, 16)
    img1, ts1 = img.clone(), ts.clone()
    reset_launch_counts()
    sdf_tail(p, pairs, counters, img, ts, N, STEPS, 16, 1.2)
    torch.cuda.synchronize()
    assert LAUNCHES == {"sdf_tail": 1}
    assert counters[0].item() == 0
    assert torch.equal(img, img1) and torch.equal(ts, ts1)
    assert (img == v[4]).all() and (ts < 0).all()


@pytest.mark.cuda
def test_the_split_forward_makes_no_host_sync(cuda):
    p = torch.from_numpy(scene_vec(None)).to(cuda)
    sdf_split(p, N, STEPS, 1.2, 16)   # the build and load, outside
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img, ts = sdf_split(p, N, STEPS, 1.2, 16)
        with torch.no_grad():
            img2 = render_sdf_cuda(p, N, STEPS, 1.2, 64, coarse=0, split=16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(img, img2)


@pytest.mark.cuda
def test_c4_functions_on_the_card_match_the_cpu(cuda):
    from enoki_tpu_torch.render import (SDFScene, cross3, render_sdf_grads,
                                        scene_to_vec)
    from enoki_tpu_torch.render.vec import unit_angle, unit_angle_z
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 10_000)).astype(np.float32)
    b = rng.normal(size=(3, 10_000)).astype(np.float32)
    a /= np.linalg.norm(a, axis=0)
    b /= np.linalg.norm(b, axis=0)
    va, vb = (Vec3(*(torch.from_numpy(x) for x in c)) for c in (a, b))
    ca, cb = (Vec3(*(x.to(cuda) for x in (v.x, v.y, v.z))) for v in (va, vb))
    torch.testing.assert_close(unit_angle(ca, cb).cpu(), unit_angle(va, vb),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(unit_angle_z(ca).cpu(), unit_angle_z(va),
                               rtol=1e-5, atol=1e-6)
    c = cross3(ca, cb)
    for g, w in zip((c.x, c.y, c.z), (lambda x: (x.x, x.y, x.z))(
            cross3(va, vb))):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=1e-7)
    assert Vec3.of(1, 2, 3).x.device.type == "cuda"
    assert Vec3.splat(1, 2, 3).z.device.type == "cuda"
    img, g = render_sdf_grads(SDFScene.reference(cuda), 64, 64)
    img_c, g_c = render_sdf_grads(SDFScene.reference("cpu"), 64, 64)
    torch.testing.assert_close(img.cpu(), img_c, rtol=0, atol=1e-3)
    gv, gc = scene_to_vec(g).cpu(), scene_to_vec(g_c)
    torch.testing.assert_close(gv, gc, rtol=1e-2,
                               atol=1e-3 * max(1.0, gc.abs().max().item()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("shift", [0.0, 10.0], ids=["mixed", "all_miss"])
def test_sdf_bwd_ad_kernel_matches_both_routes_and_is_deterministic(params,
                                                                    shift, n):
    p, g, ts = _bwd_inputs(params, n, shift)
    reset_launch_counts()
    dp1 = sdf_bwd(p, g, ts, n, 1.2, kernel="ad")
    assert LAUNCHES == {"sdf_bwd_ad": 1}
    dp2 = sdf_bwd(p, g, ts, n, 1.2, kernel="ad")
    torch.cuda.synchronize()
    assert torch.equal(dp1, dp2)
    for ref in (sdf_bwd(p, g, ts, n, 1.2), sdf_bwd_ad_plain(p, g, ts, n, 1.2)):
        scale = max(1.0, ref.abs().max().item())
        torch.testing.assert_close(dp1, ref, rtol=2e-4, atol=2e-4 * scale)


@pytest.mark.cuda
def test_sdf_render_options_reach_their_kernels(cuda):
    p = torch.from_numpy(scene_vec(None)).to(cuda)
    for kw, want in (
            (dict(coarse=8), {"sdf_fwd": 1, "sdf_bwd": 1}),
            (dict(dtype=torch.bfloat16), {"sdf_fwd_bf16": 1, "sdf_bwd": 1}),
            (dict(relax=1.6, unimodal=True),
             {"sdf_fwd_relax": 1, "sdf_bwd": 1}),
            (dict(split=16), {"sdf_fwd_split": 1, "sdf_tail": 1,
                              "sdf_bwd": 1}),
            (dict(bwd_kernel="ad"), {"sdf_fwd": 1, "sdf_bwd_ad": 1})):
        model = SDFRender(p, n=N, n_steps=STEPS, **kw)
        reset_launch_counts()
        model().mean().backward()
        torch.cuda.synchronize()
        assert LAUNCHES == want, kw
        assert torch.isfinite(model.params.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sphere_fwd_kernel_is_bit_equal_to_plain(params, dtype):
    # the kernel rounds each op as PyTorch's eager ops round it, in the
    # reference's order and dtype policy
    img_k = sphere_fwd(params, N, 1.2, dtype)
    img_p = sphere_fwd_plain(params, N, 1.2, dtype)
    torch.cuda.synchronize()
    assert img_k.dtype == dtype and img_k.shape == (N, N)
    assert torch.equal(img_k, img_p)


@pytest.mark.cuda
def test_sphere_bwd_kernel_matches_plain_and_is_deterministic(params):
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (N, N)).astype(np.float32)).to(params.device)
    dp1 = sphere_bwd(params, g, N, 1.2)
    dp2 = sphere_bwd(params, g, N, 1.2)
    ref = sphere_bwd_plain(params, g, N, 1.2)
    # a bf16 cotangent is upcast: the same gradient as its f32 value
    gb = g.to(torch.bfloat16)
    dpb = sphere_bwd(params, gb, N, 1.2)
    torch.cuda.synchronize()
    assert torch.equal(dp1, dp2)
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(dp1, ref, rtol=2e-4, atol=2e-4 * scale)
    assert torch.equal(dpb, sphere_bwd(params, gb.float(), N, 1.2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_render_sphere_cuda_launches_one_of_each(cuda, dtype):
    p = torch.from_numpy(scene_vec(None)).to(cuda).requires_grad_(True)
    reset_launch_counts()
    render_sphere_cuda(p, N, dtype=dtype).float().mean().backward()
    torch.cuda.synchronize()
    fwd = "sphere_fwd" if dtype == torch.float32 else "sphere_fwd_bf16"
    # the backward is one launch: its last block sums the blocks' rows
    assert LAUNCHES == {fwd: 1, "sphere_bwd": 1}
    assert torch.isfinite(p.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shift", [0.0, 10.0], ids=["mixed", "all_miss"])
def test_sphere_fwd_kernel_at_edge_sizes(params, dtype, n, shift):
    # one vector store a thread where the rows start on 16 bytes (256 and
    # 1000 in both dtypes), single stores at 257: bit-equal either way
    p = params.clone()
    p[0] += shift
    img_k = sphere_fwd(p, n, 1.2, dtype)
    img_p = sphere_fwd_plain(p, n, 1.2, dtype)
    torch.cuda.synchronize()
    assert fwd_vector_stores(img_k, n) == (n != 257)
    assert torch.equal(img_k, img_p)


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_SIZES)
@pytest.mark.parametrize("shift", [0.0, 10.0], ids=["mixed", "all_miss"])
def test_sphere_bwd_kernel_at_edge_sizes(params, n, shift):
    p = params.clone()
    p[0] += shift
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (n, n)).astype(np.float32)).to(p.device)
    assert sphere_bwd_vector_loads(g, n) == (n % 4 == 0)
    reset_launch_counts()
    dp1 = sphere_bwd(p, g, n, 1.2)
    assert LAUNCHES == {"sphere_bwd": 1}
    dp2 = sphere_bwd(p, g, n, 1.2)
    ref = sphere_bwd_plain(p, g, n, 1.2)
    torch.cuda.synchronize()
    assert torch.equal(dp1, dp2)
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(dp1, ref, rtol=2e-4, atol=2e-4 * scale)
    # single-float loads of a view off 16 bytes: the same pixels a thread
    # in the same order, so the same bits
    buf = torch.empty(n * n + 1, device=p.device)
    g_off = buf[1:].view(n, n)
    g_off.copy_(g)
    assert not sphere_bwd_vector_loads(g_off, n)
    dp3 = sphere_bwd(p, g_off, n, 1.2)
    torch.cuda.synchronize()
    assert torch.equal(dp3, dp1)


# -- the bring-your-own-SDF renderer: one kernel pair per scene ---------------

GENERIC_PARAMS = np.asarray(
    [0.15, 40.0, -1.0, -1.0, 2.0, 0.1, -0.2, 0.3, 0.45, 0.55, 0.18, 1.05],
    np.float32)


def composed(p, pv):
    s = sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])
    t = sd.sd_torus(p, Vec3(0.0, 0.0, 1.0), pv[9], pv[10])
    g = sd.sd_plane(p, Vec3(0.0, -1.0, 0.0), pv[11])
    return sd.op_union(sd.op_smooth_union(s, t, 0.1), g)


def sphere_only(p, pv):
    return sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])


GENERIC_CAMERAS = {"ortho": G.ortho_camera,
                   "perspective": G.perspective_camera()}
GENERIC_MARCHES = {"plain": {}, "relax1.6": dict(relax=1.6),
                   "unimodal": dict(unimodal=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("march", list(GENERIC_MARCHES))
@pytest.mark.parametrize("camera", list(GENERIC_CAMERAS))
def test_generic_fwd_kernel_matches_plain(cuda, camera, march):
    # the march rounds each operation on its own, in the plain version's
    # order: ts is the plain version's up to a few grazing pixels; the
    # normal comes from a reverse sweep there and from autograd here
    ray_fn, kw = GENERIC_CAMERAS[camera], GENERIC_MARCHES[march]
    kernels = G.SceneKernels(composed, ray_fn, 12)
    p = torch.from_numpy(GENERIC_PARAMS).to(cuda)
    reset_launch_counts()
    img_k, ts_k = G.generic_fwd(kernels, p, N, STEPS, **kw)
    assert LAUNCHES == {"generic_fwd": 1}
    img_p, ts_p = G.generic_fwd_plain(composed, ray_fn, p, N, STEPS, **kw)
    torch.cuda.synchronize()
    flips = (ts_k >= 0) != (ts_p >= 0)
    assert flips.float().mean().item() < 1e-3
    assert (img_k - img_p).abs()[~flips].max().item() < 1e-3
    assert (ts_k - ts_p).abs()[~flips].max().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("march", ["plain", "unimodal"])
@pytest.mark.parametrize("camera", list(GENERIC_CAMERAS))
@pytest.mark.parametrize("n", [1000, 37])
def test_generic_fwd_covers_an_image_the_warp_tiles_do_not_divide(
        cuda, n, camera, march):
    # a block takes 16 x 8 pixels, a warp an 8 x 4 tile of them: at n =
    # 1000 and 37 the last blocks and tiles hang over the edge, and every
    # pixel inside must still be written, with the plain version's ts bit
    # for bit (the emitted march rounds where PyTorch's kernels round)
    ray_fn, kw = GENERIC_CAMERAS[camera], GENERIC_MARCHES[march]
    kernels = G.SceneKernels(composed, ray_fn, 12)
    p = torch.from_numpy(GENERIC_PARAMS).to(cuda)
    t0 = torch.from_numpy(np.random.default_rng(5).uniform(
        0.0, 0.05, (n, n)).astype(np.float32)).to(cuda)
    for start in (None, t0):
        img_k, ts_k = G.generic_fwd(kernels, p, n, STEPS, t0=start, **kw)
        img_p, ts_p = G.generic_fwd_plain(composed, ray_fn, p, n, STEPS,
                                          t0=start, **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(img_k).all() and torch.isfinite(ts_k).all()
        assert torch.equal(ts_k, ts_p)
        assert (img_k - img_p).abs().max().item() < 1e-3


def wide_sqrt(p, pv):
    """A sphere-like distance whose square roots see arguments from 1e-12
    to ~1e20, all of them in sqrt_pos_'s range (a sum of squares plus a
    constant)."""
    r2 = p.x * p.x * 1e20 + p.y * p.y * 1e-20 + (p.z - pv[5]) * (p.z - pv[5])
    return sdf_trace.sqrt(sdf_trace.sqrt(r2 + 1e-12) + 1e-30) * 1e-5 \
        + sdf_trace.sqrt((p.z - pv[5]) * (p.z - pv[5]) + 1e-12) - pv[6]


# Ops<T>::sqrt_pos of common.cuh over an array, for T = float or bf16: a
# kernel appended to sdf_render.cu's source for the test alone
SQRT_POS_CHECK = """
namespace {
template <typename T>
__global__ void sqrt_pos_check_kernel(const float* x, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = Ops<T>::f32(Ops<T>::sqrt_pos(Ops<T>::of(x[i])));
}
}  // namespace

extern "C" int sqrt_pos_check_launch(const float* x, float* out, int n,
                                     int bf16, cudaStream_t stream) {
  const int blocks = (n + 255) / 256;
  if (bf16)
    sqrt_pos_check_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(x, out,
                                                                      n);
  else
    sqrt_pos_check_kernel<float><<<blocks, 256, 0, stream>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}
"""


def _sqrt_pos_inputs(bf16):
    """Every positive bf16 from 2^-100 up, or 512 f32s of each binade
    from 2^-100 up (its ends and random mantissas), with +inf and NaN."""
    e = np.arange(27, 255, dtype=np.uint32)[:, None]
    if bf16:
        m = np.arange(128, dtype=np.uint32)[None, :]
        bits = (e << 23) | (m << 16)
    else:
        m = np.random.default_rng(5).integers(0, 1 << 23, (1, 512),
                                              dtype=np.uint32)
        m[0, :2] = (0, (1 << 23) - 1)
        bits = (e << 23) | m
    x = bits.reshape(-1).view(np.float32)
    return np.concatenate([x, np.float32([np.inf, np.nan])])


@pytest.mark.cuda
def test_sqrt_pos_is_the_ieee_square_root(cuda):
    # generic_fwd's march takes these square roots by the fast path alone
    # (no range check): ts is bit-equal to the plain version's only if
    # every one of them is the correctly rounded root
    kernels = G.SceneKernels(wide_sqrt, G.ortho_camera, 7)
    assert kernels.traced.source.count("sqrt_pos_(") >= 3
    p = torch.tensor([0.15, 40.0, -1.0, -1.0, 2.0, 0.3, 0.5], device=cuda)
    _, ts_k = G.generic_fwd(kernels, p, N, STEPS)
    _, ts_p = G.generic_fwd_plain(wide_sqrt, G.ortho_camera, p, N, STEPS)
    torch.cuda.synchronize()
    assert torch.equal(ts_k, ts_p)
    assert 0.05 < (ts_k >= 0).float().mean().item() < 0.95
    # ... and Ops<T>::sqrt_pos, the relaxed sdf_fwd march's root, in f32
    # and in bf16 (the root taken in f32 and rounded once) against the
    # correctly rounded root (float64's, rounded to f32: exact for sqrt)
    lib = _build.load_generated(
        "sdf_render", (_build.CSRC_DIR / "sdf_render.cu").read_text()
        + SQRT_POS_CHECK)
    launch = lib.sqrt_pos_check_launch
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    for bf16 in (False, True):
        x = _sqrt_pos_inputs(bf16)
        want = torch.from_numpy(np.sqrt(x.astype(np.float64))
                                .astype(np.float32))
        if bf16:
            want = want.to(torch.bfloat16).float()
        xd = torch.from_numpy(x).to(cuda)
        out = torch.empty_like(xd)
        assert launch(xd.data_ptr(), out.data_ptr(), x.size, int(bf16),
                      torch.cuda.current_stream().cuda_stream) == 0
        torch.cuda.synchronize()
        got = out.cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        fine = ~torch.isnan(want)
        assert torch.equal(got[fine], want[fine])


@pytest.mark.cuda
@pytest.mark.parametrize("camera", list(GENERIC_CAMERAS))
def test_generic_bwd_kernel_matches_plain_and_is_deterministic(cuda, camera):
    ray_fn = GENERIC_CAMERAS[camera]
    kernels = G.SceneKernels(composed, ray_fn, 12)
    p = torch.from_numpy(GENERIC_PARAMS).to(cuda)
    _, ts = G.generic_fwd(kernels, p, N, STEPS)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (N, N)).astype(np.float32)).to(cuda)
    reset_launch_counts()
    dp1 = G.generic_bwd(kernels, p, g, ts, N)
    assert LAUNCHES == {"generic_bwd": 1, "generic_bwd_reduce": 1}
    dp2 = G.generic_bwd(kernels, p, g, ts, N)
    ref = G.generic_bwd_plain(composed, ray_fn, p, g, ts, N)
    torch.cuda.synchronize()
    assert torch.equal(dp1, dp2)
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(dp1, ref, rtol=2e-4, atol=2e-4 * scale)


@pytest.mark.cuda
def test_generic_render_launches_one_of_each_and_misses_exactly(cuda):
    render, _ = G.make_sdf_renderer(composed, 12)
    p = torch.from_numpy(GENERIC_PARAMS).to(cuda).requires_grad_(True)
    reset_launch_counts()
    render(p, N, STEPS).mean().backward()
    torch.cuda.synchronize()
    assert LAUNCHES == {"generic_fwd": 1, "generic_bwd": 1,
                        "generic_bwd_reduce": 1}
    assert torch.isfinite(p.grad).all()
    # a second scene in the same process; every ray escapes: the image is
    # the ambient term bit for bit and the gradient is n*n in its slot
    far, _ = G.make_sdf_renderer(sphere_only, 9)
    q = torch.tensor([0.15, 40.0, -1.0, -1.0, 2.0, 50.0, 0.0, 0.3, 0.45],
                     device=cuda, requires_grad=True)
    img = far(q, N, STEPS)
    img.sum().backward()
    torch.cuda.synchronize()
    assert torch.equal(img.detach(), torch.full((N, N), 0.15, device=cuda))
    assert q.grad[0].item() == N * N and (q.grad[1:] == 0).all()
    assert far.kernels.lib is not render.kernels.lib


def many_spheres(p, pv):
    """Six spheres, a torus and a ground plane: 32 parameters."""
    d = sd.sd_torus(p, Vec3(0.0, 0.0, 1.0), pv[29], pv[30])
    for k in range(5, 29, 4):
        d = sd.op_smooth_union(
            d, sd.sd_sphere(p, Vec3(pv[k], pv[k + 1], pv[k + 2]), pv[k + 3]),
            0.1)
    return sd.op_union(d, sd.sd_plane(p, Vec3(0.0, -1.0, 0.0), pv[31]))


@pytest.mark.cuda
def test_generic_kernels_of_a_32_parameter_scene_match_plain(cuda):
    # the backward's reverse-mode program is several times the composed
    # scene's here: a wider scene must still build and agree
    rng = np.random.default_rng(11)
    v = np.concatenate([
        GENERIC_PARAMS[:5],
        np.column_stack([rng.uniform(-0.8, 0.8, (6, 2)),
                         rng.uniform(0.0, 0.6, (6, 1)),
                         rng.uniform(0.15, 0.3, (6, 1))]).ravel(),
        [0.55, 0.18, 1.05]]).astype(np.float32)
    kernels = G.SceneKernels(many_spheres, G.ortho_camera, 32)
    p = torch.from_numpy(v).to(cuda)
    img_k, ts = G.generic_fwd(kernels, p, N, STEPS)
    img_p, ts_p = G.generic_fwd_plain(many_spheres, G.ortho_camera, p, N,
                                      STEPS)
    flips = (ts >= 0) != (ts_p >= 0)
    assert flips.float().mean().item() < 1e-3
    assert (img_k - img_p).abs()[~flips].max().item() < 1e-3
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (N, N)).astype(np.float32)).to(cuda)
    dp = G.generic_bwd(kernels, p, g, ts, N)
    ref = G.generic_bwd_plain(many_spheres, G.ortho_camera, p, g, ts, N)
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(dp, ref, rtol=2e-4, atol=2e-4 * scale)
    # a sphere's depth moves nothing under parallel rays; the rest is in view
    assert (ref.abs() > 0).sum().item() >= 24


@pytest.mark.cuda
@pytest.mark.parametrize("c", [0.1 + 1e-12, 0.3, 1.2, 3.0, 7.0, 1e-3])
def test_division_by_a_number_is_a_product_with_its_reciprocal(cuda, c):
    # sdf_trace emits x / number as x * f32(1 / number), the reciprocal
    # taken in double, because PyTorch's CUDA division by a Python number
    # computes that (at 1e-3 the f32 reciprocal of the f32 number is one
    # ulp off it); the generated kernels walk the plain version's march
    # only while it does
    x = torch.from_numpy(np.random.default_rng(13).uniform(
        -4.0, 4.0, 1 << 20).astype(np.float32)).to(cuda)
    assert torch.equal(x / c, x * float(np.float32(1.0 / c)))


# -- the histogram and stochastic-rounding kernels ---------------------------


def _hist_inputs(n, bins, seed, dev):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-3, bins + 6, n).astype(np.int32)
    w = rng.standard_normal(n).astype(np.float32)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(w).to(dev)


def _check_hist(idx, bins, w):
    """hist of ``idx`` (and weighted by ``w``) against hist_plain and
    torch.bincount (counts exact) and a float64 sum (weighted within
    1e-6 * sum|w|), two runs bitwise equal."""
    count = H.hist(idx, bins)
    weighted = H.hist(idx, bins, w)
    again = H.hist(idx, bins, w)
    torch.cuda.synchronize()
    assert count.shape == (bins,) and count.dtype == torch.float32
    # counts are sums of ones: exact in any order
    assert torch.equal(count, H.hist_plain(idx, bins))
    ok = (idx >= 0) & (idx < bins)
    assert torch.equal(count, torch.bincount(
        idx[ok].long(), minlength=bins).float())
    # weighted: f32 sums in another order than the plain version's
    exact = torch.zeros(bins, dtype=torch.float64, device=idx.device)
    exact.index_add_(0, idx[ok].long(), w[ok].double())
    scale = max(1.0, w.abs().sum().item())
    assert (weighted.double() - exact).abs().max().item() <= 1e-6 * scale
    assert torch.equal(weighted, again)


# both routes of csrc/hist.cu: a row per thread up to SMALL_BINS, a row
# per warp above
HIST_BINS = [1, 64, H.SMALL_BINS, H.SMALL_BINS + 1, 1000]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 31, 1025, 100_003])
@pytest.mark.parametrize("bins", HIST_BINS)
def test_hist_kernel_matches_plain(cuda, n, bins):
    idx, w = _hist_inputs(n, bins, n + bins, cuda)
    reset_launch_counts()
    _check_hist(idx, bins, w)
    assert dict(LAUNCHES) == ({} if n == 0 else
                              {"hist": 3, "hist_reduce": 3})


@pytest.mark.cuda
@pytest.mark.parametrize("w_off", [0, 1, 2, 3])
@pytest.mark.parametrize("off", [1, 2, 3])
@pytest.mark.parametrize("bins", HIST_BINS)
def test_hist_kernel_takes_views_that_start_anywhere(cuda, bins, off, w_off):
    # a view off a 16-byte boundary: the kernel reads the ragged ends one
    # by one, and weights misaligned otherwise than the indices one by one
    n = 100_003
    idx, w = _hist_inputs(n + off, bins, 5 * bins + off, cuda)
    _, w_base = _hist_inputs(n + w_off, bins, 7, cuda)
    iv, wv = idx[off:], w_base[w_off:]
    assert iv.data_ptr() % 16 == 4 * off
    _check_hist(iv, bins, wv)


@pytest.mark.cuda
@pytest.mark.parametrize("bins", HIST_BINS)
def test_hist_kernel_all_in_one_bin(cuda, bins):
    n = 70_001
    idx = torch.full((n,), bins // 2, dtype=torch.int32, device=cuda)
    w = torch.from_numpy(np.random.default_rng(9).standard_normal(
        n).astype(np.float32)).to(cuda)
    _check_hist(idx, bins, w)
    assert H.hist(idx, bins)[bins // 2].item() == n


@pytest.mark.cuda
def test_hist_kernel_one_bin_conflict_and_limits(cuda):
    n = 70_001
    idx = torch.full((n,), 7, dtype=torch.int32, device=cuda)
    assert torch.equal(H.hist(idx, 64),
                       torch.zeros(64, device=cuda).index_fill_(
                           0, torch.tensor([7], device=cuda), float(n)))
    lib = _build.load("hist")
    assert lib.hist_max_bins() == H.MAX_BINS
    assert lib.hist_small_bins() == H.SMALL_BINS
    big = H.hist(idx, H.MAX_BINS)
    assert big[7].item() == n and big.sum().item() == n
    with pytest.raises(ValueError, match="at most"):
        H.hist(idx, H.MAX_BINS + 1)
    with pytest.raises(ValueError, match="int32"):
        H.hist(idx.long(), 64)
    with pytest.raises(ValueError, match="weights"):
        H.hist(idx, 64, torch.ones(n - 1, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        H.hist(torch.stack([idx, idx], 1)[:, 0], 64)


@pytest.mark.cuda
def test_histogram_op_runs_the_kernel_and_its_vjp(cuda):
    idx, w = _hist_inputs(5000, 64, 3, cuda)
    w.requires_grad_(True)
    reset_launch_counts()
    out = R.histogram(idx, 64, w)
    assert LAUNCHES["hist"] == 1
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        64).astype(np.float32)).to(cuda)
    (gw,) = torch.autograd.grad(out, w, g)
    inr = (idx >= 0) & (idx < 64)
    want = torch.where(inr, g[idx.clamp(0, 63).long()], 0.0)
    assert torch.equal(gw, want)
    # the reference's name for the kernel
    reset_launch_counts()
    assert torch.equal(R.histogram(idx, 64, w.detach(), impl="pallas"),
                       out.detach())
    assert LAUNCHES["hist"] == 1
    # the plain route on the card, and a float index
    fused = R.histogram(idx, 64, w.detach(), impl="fused")
    torch.testing.assert_close(out.detach(), fused, rtol=1e-5, atol=1e-4)
    assert torch.equal(R.histogram(idx.float() + 0.25, 64),
                       R.histogram(torch.where(idx < 0, idx + 1, idx), 64))


def _sr_input(n, dev):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-12, 12, n))).astype(
        np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-41,
                        65504.0, 65519.9, 65520.0, 7e4, -65519.9, 6e-8,
                        5.9e-8, 1e-10, -1e-10, 3.4e38, -3.4e38],
                       np.float32)
    k = min(n, special.size)
    x[:k] = special[:k]
    return torch.from_numpy(x).to(dev)


def _same_bits(a, b):
    """Equal bit patterns, any NaN standing for any NaN."""
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a.view(torch.int16)[~nan],
                            b.view(torch.int16)[~nan]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n", [0, 1, 31, 1025, 100_003])
def test_stochastic_round_kernel_matches_plain(cuda, n, dtype):
    x = _sr_input(n, cuda)
    reset_launch_counts()
    out = RD.stochastic_round_cuda(x, 1234567890123, dtype)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == ({} if n == 0 else {"stochastic_round": 1})
    assert out.dtype == dtype and out.shape == (n,)
    assert _same_bits(out, RD.stochastic_round_plain(x, 1234567890123, dtype))
    assert _same_bits(out, RD.stochastic_round_cuda(x, 1234567890123, dtype))
    if n > 31:
        other = RD.stochastic_round_cuda(x, 1234567890124, dtype)
        assert not _same_bits(out, other)
        # a view that starts off a 16-byte boundary takes the scalar loads
        # and the same words
        shifted = torch.cat([x[:1], x])[1:]
        assert shifted.data_ptr() % 16 != 0
        assert _same_bits(RD.stochastic_round_cuda(shifted, 7, dtype),
                          RD.stochastic_round_cuda(x, 7, dtype))


@pytest.mark.cuda
def test_stochastic_round_kernel_is_unbiased_and_checks_its_input(cuda):
    x = torch.full((1 << 20,), 1.0 + 1.0 / 512.0, device=cuda)
    out = RD.stochastic_round_cuda(x, 42).float()
    lo, hi = 1.0, 1.0 + 2.0 ** -7
    assert bool(((out == lo) | (out == hi)).all())
    # 2^20 draws at p = 1/4: the share's standard deviation is 4.2e-4
    assert abs((out == hi).float().mean().item() - 0.25) < 3e-3
    with pytest.raises(ValueError, match="1-D"):
        RD.stochastic_round_cuda(x.reshape(2, -1), 1)
    with pytest.raises(ValueError, match="float32"):
        RD.stochastic_round_cuda(x.double(), 1)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        RD.stochastic_round_cuda(x, 1, torch.float32)


# -- the ops the port gained last (ops/router.py, ops/horiz.py) -----------------------
# phase 22's table of chip_smoke.py at 2^16 elements: each function on the
# card against the same call on the CPU, with the phase's gates


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
OPS_CASES = {c[0]: c for c in SMOKE.ops_cases(torch, 1 << 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(OPS_CASES))
def test_op_on_the_card_matches_the_cpu(cuda, name):
    _, gate, fn, args, mag = OPS_CASES[name]
    cpu = [torch.from_numpy(x) for x in args]
    got = fn(*(x.to(cuda) for x in cpu))
    ok, err = SMOKE.ops_gate(torch, got, fn(*cpu), gate, mag)
    assert ok, (name, gate, err)


@pytest.mark.cuda
def test_constructors_and_packets_default_to_the_card(cuda):
    for t in (R.zeros(4), R.full(4, 2.0), R.empty(4), R.arange(4),
              next(R.range_packets(10, 4))[0]):
        assert t.device.type == "cuda"
    assert R.arange(4).dtype == torch.int32
    assert bool(torch.isnan(R.empty(4)).all())
    assert R.full(3, 7).dtype == torch.int32


@pytest.mark.cuda
def test_ops_of_python_values_default_to_the_card(cuda):
    for t in (R.popcnt(7), R.sign(-0.0), R.copysign(1.0, -2.0),
              R.fmaddsub(1.0, 2.0, 3.0), R.sqrt(2.0),
              R.binary_search(0, 8, lambda i: i < 3),
              R.hsum([1.0, 2.0]), R.partition([5, 0, 1], 2)[2]):
        assert t.device.type == "cuda"
    assert R.binary_search(0, 8, lambda i: i < 3).item() == 3
    assert R.partition([5, 0, 1], 2)[2].tolist() == [1, 2, 0]


# -- ops/math.py and ops/special.py ------------------------------------------
# phase 23's cases of chip_smoke.py at 2^14 elements: poly on the card
# against the same call on the CPU, both impls against a float64 truth


MATH_CASES = {f"{c[1]} {c[0]}": c for c in SMOKE.math_cases(1 << 14)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MATH_CASES))
def test_math_on_the_card(cuda, name):
    failed, text, _ = SMOKE.math_case(torch, cuda, MATH_CASES[name])
    assert not failed, (failed, text)


@pytest.mark.cuda
def test_math_bf16_is_the_float32_result_rounded_once(cuda):
    from enoki_tpu_torch.ops import math as M
    x = torch.linspace(-3, 3, 1 << 14, device=cuda).to(torch.bfloat16)
    for name in SMOKE.wrapped_math_names():
        for impl in ("poly", "native"):
            a, b = getattr(M, name)(x, impl), getattr(M, name)(x.float(),
                                                               impl)
            for u, v in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                v = v.to(torch.bfloat16)
                assert u.dtype == torch.bfloat16
                assert bool(((u == v) | (u.isnan() & v.isnan())).all()), name


@pytest.mark.cuda
def test_math_of_python_values_defaults_to_the_card(cuda):
    x = torch.ones(4, device=cuda)
    for t in (R.sin(1.0, "poly"), R.pow(2.0, 0.5), R.atan2(1.0, 2.0),
              R.hypot(3.0, 4.0), R.erf(0.5, "poly"), R.dawson(0.5),
              R.carlson_rf(1.0, 2.0, 3.0), R.ellint_3(0.5, 0.5, 0.2),
              R.pow(x, 2.0), R.atan2(x, 0.5)):
        assert t.device.type == "cuda"


@pytest.mark.cuda
def test_special_gradients_on_the_card_are_finite(cuda):
    for fn in (lambda t: R.i0e(t, "poly"), lambda t: R.erf(t, "poly"),
               R.dawson):
        t = torch.tensor(1e20, device=cuda, requires_grad=True)
        fn(t).backward()
        assert torch.isfinite(t.grad)
    t = torch.tensor(0.0, device=cuda, requires_grad=True)
    R.dawson(t).backward()
    assert abs(t.grad.item() - 1.0) < 1e-5


# -- types/ ------------------------------------------------------------------
# phase 24's cases of chip_smoke.py at 2^14 elements: each on the card
# against the same call on the CPU, under the phase's gates


TYPES_CASES = {c[0]: c for c in SMOKE.types_cases(torch, 1 << 14)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TYPES_CASES))
def test_types_on_the_card_match_the_cpu(cuda, name):
    ok, err = SMOKE.types_case(torch, cuda, TYPES_CASES[name])
    assert ok, (name, TYPES_CASES[name][1], err)


@pytest.mark.cuda
def test_types_constructors_default_to_the_card(cuda):
    from enoki_tpu_torch import types as T
    for t in (T.matrix.identity(3), T.Quaternion.identity().w,
              T.Quaternion.of(1, 2, 3, 4).w, T.Complex.of(1.0, 2.0).im,
              T.enum_array.enum_full(1, 3),
              T.enum_array.enum_array([1, 2], None),
              T.transform.perspective(1.0, 0.1, 10.0),
              T.transform.frustum(-1, 1, -1, 1, 0.1, 10.0),
              T.transform.rotate([0, 0, 1], 0.5),
              T.morton_encode([3, 5]), T.DivisorU32(7)(100),
              T.sh.sh_eval_stacked(0.0, 0.0, 1.0, 2)):
        assert t.device.type == "cuda"


# -- struct/, ad/, runtime/ ------------------------------------------------------
# phase 25's (a), (b) and (d) of chip_smoke.py at 2^14 lanes and 128^2:
# each on the card against the same call on the CPU, bit for bit


STRUCT_LANES = 1 << 14


def _struct_args(dev):
    f, k, idx, mask, ids = SMOKE.struct_inputs(torch, STRUCT_LANES)
    return (SMOKE.struct_of(torch, f, k, 0, dev),
            SMOKE.struct_of(torch, f, k, 1, dev),
            torch.from_numpy(idx).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(np.resize(mask, STRUCT_LANES)).to(dev)), ids


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SMOKE.STRUCT_CASES))
def test_struct_helper_on_the_card_matches_the_cpu(cuda, name):
    from enoki_tpu_torch import struct as S
    fn = SMOKE.STRUCT_CASES[name]
    (got_args, _), (want_args, _) = _struct_args(cuda), _struct_args("cpu")
    assert SMOKE.same_tree(torch, fn(S, *got_args), fn(S, *want_args))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 16])
@pytest.mark.parametrize("strategy", ["masked", "partition"])
def test_dispatch_on_the_card_matches_the_cpu(cuda, m, strategy):
    from enoki_tpu_torch import struct as S
    funcs = [SMOKE.struct_callee(i) for i in range(m)]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        (a, b, _, _, _), ids = _struct_args(dev)
        reg = S.InstanceRegistry()
        for i in range(m):
            reg.register(SMOKE.StructInstance(i))
        I = torch.from_numpy(ids[m]).to(dev)
        out[dev.type] = (getattr(S, f"dispatch_{strategy}")(
            funcs, I, a["ray"], a["k"], default=b),
            reg.dispatch("eval", I, a["ray"], a["k"], strategy=strategy),
            reg.getter("c", I))
    assert SMOKE.same_tree(torch, out["cuda"], out["cpu"])


@pytest.mark.cuda
def test_ad_backward_of_the_render_equals_sdfrenders_gradient(cuda):
    from enoki_tpu_torch import ad
    p = torch.from_numpy(scene_vec(1)).to(cuda)
    reset_launch_counts()
    val, (g,) = ad.backward(lambda q: render_sdf_cuda(q, 128, STEPS, 1.2,
                                                      128, coarse=0).mean(), p)
    assert dict(LAUNCHES) == {"sdf_fwd": 1, "sdf_bwd": 1}
    model = SDFRender(p, n=128, n_steps=STEPS)
    model().mean().backward()
    assert torch.equal(g, model.params.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["safe_sqrt", "safe_rsqrt", "safe_asin",
                                  "safe_acos"])
def test_safe_functions_under_forward_and_vmap_on_the_card(cuda, name):
    from enoki_tpu_torch import ad
    rng = np.random.default_rng(28)
    x = rng.uniform(-1.5, 50.0, STRUCT_LANES).astype(np.float32)
    x[:6] = [0.0, -0.0, 1.0, -1.0, -3.0, 0.5]
    t = rng.normal(size=STRUCT_LANES).astype(np.float32)
    fn = getattr(R, name)
    res = []
    for dev in (cuda, "cpu"):
        xd, td = torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)
        v, tan = ad.forward(fn, (xd,), (td,))
        g = torch.func.vmap(torch.func.grad(fn))(xd)
        res.append((v.cpu(), tan.cpu(), g.cpu(),
                    torch.func.vmap(fn)(xd.reshape(-1, 64)).reshape(-1).cpu()))
    (v1, t1, g1, m1), (v0, t0, g0, m0) = res
    assert torch.equal(t1, t0) and torch.equal(g1, g0) and torch.equal(m1, v1)
    # asin / acos values: the float64 libm's last bit (phase 22's gate)
    gate = 1 if name in ("safe_asin", "safe_acos") else 0
    assert SMOKE.ulp_of(v1.numpy(), v0.numpy(), np.float32).max() <= gate


@pytest.mark.cuda
def test_runtime_on_the_card(cuda):
    from enoki_tpu_torch import ad, runtime
    stats = runtime.memory_stats()
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(
        0).total_memory
    keep = torch.empty((321, 77), device=cuda)
    row = [r for r in runtime.whos(False).splitlines() if "(321, 77)" in r]
    assert row and str(321 * 77 * 4) in row[0] and "cuda" in row[0]
    del keep
    p = torch.from_numpy(scene_vec(None)).to(cuda)

    def step(q):
        q = q.detach().requires_grad_(True)
        render_sdf_cuda(q, 128, STEPS, 1.2, 128, coarse=0).mean().backward()
        return q.grad

    rep = runtime.vectorization_report(step, p)
    assert rep["custom_calls"] == 2 and rep["fusions"] >= 2
    runtime.assert_vectorized(lambda x: torch.sin(x) * 2.0 + x, p)
    with pytest.raises(AssertionError, match="transfers to the host"):
        runtime.assert_vectorized(lambda x: x * x[0].item(), p)
    with pytest.raises(RuntimeError, match="make_fx cannot trace sdf_fwd"):
        ad.whos(lambda q: render_sdf_cuda(q, 128, STEPS, 1.2, 128,
                                          coarse=0).mean(), p)


@pytest.mark.cuda
def test_compile_timings_pay_the_build_once(cuda):
    from enoki_tpu_torch import runtime
    render, _ = G.make_sdf_renderer(
        lambda q, pv: sd.sd_sphere(q, Vec3(pv[5], pv[6], pv[7]), pv[8])
        - 0.0375, n_params=9)
    pv = torch.tensor([0.2, 90.0, -1.0, -1.0, 2.0, 0.0, 0.0, 0.0, 0.8],
                      device=cuda)
    t = runtime.compile_timings(lambda v: render(v, 128).mean(), pv)
    assert t["cache_hit_s"] < t["compile_s"] / 10
    assert t["trace_s"] is None and t["lower_s"] is None
    assert t["n_eqns"] >= 2
