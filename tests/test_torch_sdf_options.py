"""The options of the port's SDF render (enoki_tpu_torch.render.sdf_kernels:
the cone prepass, the generic march engine with over-relaxation and the
divergence exit, the bf16 march, bands) against the JAX reference: the
Pallas kernel in interpret mode through ``render_sdf_pallas`` /
``_sdf_vjp_fwd`` / ``_sdf_vjp_bwd``, and ``_march_tile`` / ``_cone_t0``
run eagerly, as tests/test_pallas.py runs them. The CUDA kernels are held
against the plain versions on the card by tests/test_torch_cuda.py.

Gates are the reference's own:
  * a head start (coarse > 0, relax > 1) stops the march at another point
    of the converged band and may flip grazing rays: flips (|d| > 1) under
    1e-3 of the pixels, off-flip max < 0.05 and mean < 5e-3
    (tests/test_pallas.py:94-111), gradients rtol 5e-2 / atol
    2e-3 * max(1, |g|max) (:168-169);
  * bf16 policy (:188-218): band (|d| > 1) share < 0.10, off-band mean
    < 2e-3, significant gradients within 0.5 relative;
  * relaxed against plain (:451-477): flips < 0.01, off-flip mean < 1e-3,
    significant gradients within 0.5 relative;
  * the march engine (:415-448): hits on the surface, flips < 0.025, hit t
    within 5e-4.
"""

import functools
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from enoki_tpu.render.pallas_kernels import (
    _cone_t0 as j_cone_t0, _march_tile as j_march_tile, _sdf_vjp_bwd,
    _sdf_vjp_fwd, render_sdf_pallas, vec_to_scene as j_vec_to_scene)
from enoki_tpu.render.sdf import (SDFScene as JSDFScene,
                                  sdf_ortho_dist as j_sdf_ortho_dist)

from enoki_tpu_torch import _build
from enoki_tpu_torch.render.sdf import SDFScene, sdf_ortho_dist
from enoki_tpu_torch.render.sdf_kernels import (
    _cone_t0, fwd_kernel_name, march_counts, march_eps, march_tile,
    render_sdf_cuda, sdf_bwd, sdf_fwd, sdf_fwd_plain, tile_pixels,
    vec_to_scene)

from test_torch_cuda import SCENES, scene_vec as _scene_vec

N = 128
TILE = 64
STEPS = 48
F32, BF16 = torch.float32, torch.bfloat16
J_DTYPE = {F32: jnp.float32, BF16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(params=list(SCENES), ids=list(SCENES))
def scene_vec(request):
    return _scene_vec(SCENES[request.param])


def _opts(coarse=8, dtype=F32, bands=1, relax=1.0, unimodal=False):
    return coarse, dtype, bands, relax, unimodal


@functools.cache
def _jax_render(seed, opts):
    """(img, dp) of the reference for the mean's cotangent: one forward
    and one backward kernel in interpret mode."""
    coarse, dtype, bands, relax, unimodal = opts
    nd = (N, STEPS, 1.2, TILE, None, coarse, 16, J_DTYPE[dtype], bands,
          relax, unimodal, 0)
    with pltpu.force_tpu_interpret_mode():
        img, res = _sdf_vjp_fwd(jnp.asarray(_scene_vec(seed)), *nd)
        (dp,) = _sdf_vjp_bwd(*nd, res, jnp.full((N, N), 1.0 / (N * N),
                                                jnp.float32))
    return np.array(img), np.array(dp)[:9]


@functools.cache
def _port_render(seed, opts):
    coarse, dtype, bands, relax, unimodal = opts
    p = torch.from_numpy(_scene_vec(seed)).requires_grad_(True)
    img = render_sdf_cuda(p, N, STEPS, 1.2, TILE, None, coarse, 16, dtype,
                          bands, relax, unimodal)
    img.mean().backward()
    return img.detach().numpy(), p.grad.numpy()[:9]


def _head_start_gate(img, ref):
    d = np.abs(img - ref)
    flips = d > 1.0
    assert flips.mean() < 1e-3, flips.mean()
    assert d[~flips].max() < 0.05, d[~flips].max()
    assert d[~flips].mean() < 5e-3


def _significant_within_half(g, ref):
    assert np.isfinite(g).all()
    sig = np.abs(ref) > 1e-3 * np.abs(ref).max()
    rel = np.abs(g - ref)[sig] / np.abs(ref)[sig]
    assert rel.max() < 0.5, (rel, ref, g)


def test_render_sdf_cuda_has_the_reference_signature():
    want = inspect.signature(render_sdf_pallas).parameters
    got = inspect.signature(render_sdf_cuda).parameters
    assert list(got) == list(want) and len(got) == 13
    for name in got:
        if name == "params":
            continue
        w, g = want[name].default, got[name].default
        assert g == (F32 if name == "dtype" else w), name


# -- the cone prepass ------------------------------------------------------


def test_cone_t0_matches_jax(scene_vec):
    want = np.asarray(j_cone_t0(jnp.asarray(scene_vec), N, STEPS, 1.2, 8))
    got = _cone_t0(torch.from_numpy(scene_vec), N, STEPS, 1.2, 8)
    assert got.shape == (N, N) and not got.requires_grad
    # atol 1e-6 near the surface. An escaped cone freezes at t ~ 6-10,
    # where one f32 ulp is up to 9.5e-7 and XLA's fused steps land a few
    # ulp from the eager ones (hence the rtol); and past its tangent point
    # a grazing cone doubles that difference at every step (d' ~ 1), which
    # leaves a coarse ray or two (of 256) up to 2.4e-5 apart
    d = np.abs(got.numpy() - want)
    assert (d <= 1e-6 + 1e-6 * np.abs(want)).mean() > 0.99
    assert d.max() < 1e-4, d.max()


def test_cone_prepass_is_conservative():
    # no fine ray may cross the surface before its start: t0 never exceeds
    # the closed-form first intersection of the unit sphere at the origin
    # (tests/test_pallas.py:130-149)
    n = 128
    t0 = _cone_t0(torch.from_numpy(_scene_vec(None)), n, 64, 1.2, 8).numpy()
    xs = np.arange(n) * (2 * 1.2 / (n - 1)) - 1.2
    px, py = np.meshgrid(xs, xs)
    rxy2 = px ** 2 + py ** 2
    t_hit = np.where(rxy2 < 1.0,
                     1.0 - np.sqrt(np.maximum(1.0 - rxy2, 0.0)), np.inf)
    assert (t0 <= t_hit + 1e-5).all(), (t0 - t_hit)[t0 > t_hit + 1e-5].max()


# -- the generic march engine ----------------------------------------------


def _engines(v):
    """(dist_at, px) of the port and of the reference over the same
    pixels."""
    px, py = tile_pixels(N, 1.2, "cpu")
    dist_t = sdf_ortho_dist(px, py, vec_to_scene(torch.from_numpy(v),
                                                 SDFScene))
    jx, jy = jnp.asarray(px.numpy()), jnp.asarray(py.numpy())
    dist_j = j_sdf_ortho_dist(jx, jy, j_vec_to_scene(jnp.asarray(v),
                                                     JSDFScene))
    return dist_t, px, dist_j, jx


@pytest.mark.parametrize("with_t0", [False, True], ids=["t0_none", "cone"])
@pytest.mark.parametrize("unimodal", [False, True], ids=["", "unimodal"])
@pytest.mark.parametrize("relax", [1.0, 1.2, 1.6, 1.9])
def test_march_tile_matches_jax(relax, unimodal, with_t0):
    v = _scene_vec(None)
    dist_t, px, dist_j, jx = _engines(v)
    t0 = _cone_t0(torch.from_numpy(v), N, STEPS, 1.2, 8) if with_t0 else None
    t_t, h_t = march_tile(dist_t, px, STEPS, chunk=16, t0=t0, relax=relax,
                          unimodal=unimodal)
    t_j, h_j = j_march_tile(dist_j, jx, STEPS, chunk=16,
                            t0=None if t0 is None else jnp.asarray(t0.numpy()),
                            relax=relax, unimodal=unimodal)
    ht, hj = h_t.numpy(), np.asarray(h_j)
    # the two sqrt differ by an ulp here and there, which may move a
    # grazing lane across eps: at most 1 lane in 1000 flips
    assert (ht != hj).mean() < 1e-3, (ht != hj).mean()
    both = ht & hj
    dt = np.abs(t_t.numpy()[both] - np.asarray(t_j)[both])
    assert dt.max() < 5e-4, dt.max()


def test_march_tile_unimodal_at_relax_1_is_bit_exact_on_hits():
    # a hit ray's distance decreases monotonically, so the divergence test
    # never fires on it (tests/test_pallas.py:380-404)
    dist_t, px, _, _ = _engines(_scene_vec(None))
    t0, h0 = march_tile(dist_t, px, STEPS, chunk=16)
    t1, h1 = march_tile(dist_t, px, STEPS, chunk=16, unimodal=True)
    assert torch.equal(h0, h1) and h0.any() and not h0.all()
    assert torch.equal(t0[h0], t1[h0])


@pytest.mark.parametrize("unimodal", [False, True], ids=["", "unimodal"])
@pytest.mark.parametrize("relax", [1.2, 1.6, 1.9])
def test_march_tile_relaxed_hits_stay_on_surface(relax, unimodal):
    # a hit is only ever declared at an evaluated position with d < eps
    # (tests/test_pallas.py:415-448)
    v = _scene_vec(None)
    dist_t, px, _, _ = _engines(v)
    t0 = _cone_t0(torch.from_numpy(v), N, STEPS, 1.2, 8)
    t_p, h_p = march_tile(dist_t, px, STEPS, chunk=16, t0=t0)
    t_w, h_w = march_tile(dist_t, px, STEPS, chunk=16, t0=t0, relax=relax,
                          unimodal=unimodal)
    d_at = dist_t(t_w)
    assert d_at[h_w].max() < 1e-4
    assert d_at[h_w].min() > -1e-6, d_at[h_w].min()
    assert (h_p != h_w).float().mean() < 0.025
    both = h_p & h_w
    assert (t_p[both] - t_w[both]).abs().max() < 5e-4


def test_march_tile_runs_a_bf16_carry_in_bf16():
    px, py = tile_pixels(N, 1.2, "cpu")
    scene = vec_to_scene(torch.from_numpy(_scene_vec(None)).to(BF16),
                         SDFScene)
    dist = sdf_ortho_dist(px.to(BF16), py.to(BF16), scene)
    for kw in (dict(), dict(relax=1.6, unimodal=True)):
        t, hit = march_tile(dist, px.to(BF16), STEPS, eps=march_eps(BF16),
                            **kw)
        assert t.dtype == BF16 and hit.any() and not hit.all()


# -- the forward's options against the reference kernel ---------------------


@pytest.mark.parametrize("seed", list(SCENES.values()), ids=list(SCENES))
def test_coarse_8_matches_jax(seed):
    img, g = _port_render(seed, _opts())
    img_j, g_j = _jax_render(seed, _opts())
    _head_start_gate(img, img_j)
    np.testing.assert_allclose(g, g_j, rtol=5e-2,
                               atol=2e-3 * max(1.0, np.abs(g_j).max()))


@pytest.mark.parametrize("coarse", [0, 8])
def test_bf16_march_meets_the_reference_policy(coarse):
    img, g = _port_render(None, _opts(coarse, BF16))
    img_j, g_j = _jax_render(None, _opts(coarse, BF16))
    img32, g32 = _port_render(None, _opts(coarse))
    # XLA keeps some bf16 chains in f32, so the two bf16 marches are not
    # bit-equal; both sit inside the policy band of the f32 render
    for ref, g_ref in ((img_j, g_j), (img32, g32)):
        d = np.abs(img - ref)
        band = d > 1.0
        assert band.mean() < 0.10, band.mean()
        assert d[~band].mean() < 2e-3, d[~band].mean()
        _significant_within_half(g, g_ref)
    print(f"bf16 coarse={coarse}: {(img == img_j).mean():.4f} of the pixels "
          f"bit-equal to the reference's bf16 kernel")
    assert (img == img_j).mean() > 0.5


@pytest.mark.parametrize("opts", [_opts(8, F32, 8, 1.6, True),
                                  _opts(8, F32, 1, 1.0, True)],
                         ids=["relax1.6_unimodal_bands8", "unimodal"])
def test_relaxed_march_matches_jax(opts):
    img, g = _port_render(None, opts)
    img_j, g_j = _jax_render(None, opts)
    _head_start_gate(img, img_j)
    np.testing.assert_allclose(g, g_j, rtol=5e-2,
                               atol=2e-3 * max(1.0, np.abs(g_j).max()))
    # ... and against the port's own plain march (:451-477, :409-412)
    img0, g0 = _port_render(None, _opts())
    if opts[3] == 1.0:
        np.testing.assert_allclose(img, img0, rtol=1e-2, atol=5e-2)
    else:
        d = np.abs(img - img0)
        flip = d > 1.0
        assert flip.mean() < 0.01, flip.mean()
        assert d[~flip].mean() < 1e-3, d[~flip].mean()
    _significant_within_half(g, g0)


@pytest.mark.parametrize("bands", [4, 7, 8])
def test_bands_is_the_identity(bands):
    # per-lane exit does what the bands do; a bands value that does not
    # divide the tile is accepted as in the reference (:541-542)
    img1, g1 = _port_render(1, _opts())
    imgb, gb = _port_render(1, _opts(bands=bands))
    np.testing.assert_array_equal(imgb, img1)
    np.testing.assert_array_equal(gb, g1)


def test_march_counts_follow_the_options():
    p = torch.from_numpy(_scene_vec(None))
    t0 = _cone_t0(p, N, STEPS, 1.2, 8)
    plain, _ = march_counts(p, N, STEPS)
    cone, _ = march_counts(p, N, STEPS, t0=t0)
    relaxed, steps = march_counts(p, N, STEPS, relax=1.6, unimodal=True)
    assert (cone <= plain).all() and cone.sum() < 0.75 * plain.sum()
    assert (relaxed - steps == 1).all() and steps.max() <= STEPS
    assert relaxed.max() == STEPS + 1  # a crawling lane runs to the cap


def test_wrappers_check_their_arguments():
    p = torch.from_numpy(_scene_vec(None))
    assert fwd_kernel_name(F32) == "sdf_fwd"
    assert fwd_kernel_name(BF16) == "sdf_fwd_bf16"
    assert fwd_kernel_name(F32, 1.6) == "sdf_fwd_relax"
    assert fwd_kernel_name(BF16, 1.0, True) == "sdf_fwd_relax_bf16"
    with pytest.raises(ValueError, match="march dtype"):
        sdf_fwd(p, 64, STEPS, dtype=torch.float16)
    with pytest.raises(ValueError, match="march dtype"):
        render_sdf_cuda(p, 64, STEPS, 1.2, 64, dtype=torch.float64)
    with pytest.raises(ValueError, match="bands"):
        render_sdf_cuda(p, 64, STEPS, 1.2, 64, bands=0)
    with pytest.raises(ValueError, match="cone prepass block"):
        render_sdf_cuda(p, 64, STEPS, 1.2, 64, coarse=5)
    with pytest.raises(ValueError, match="kernel"):
        sdf_bwd(p, torch.zeros(64, 64), torch.zeros(64, 64), 64,
                kernel="tape")
    # a start map that is not what the kernel reads never reaches a launch
    with pytest.raises(ValueError, match="t0"):
        _build.check(torch.zeros(8, 8), "t0", (64, 64), p.device)


def test_sdf_fwd_plain_default_is_the_main_path():
    # t0 = None, f32, relax 1: the arithmetic slice 1 ported, bit for bit
    p = torch.from_numpy(_scene_vec(2))
    a = sdf_fwd_plain(p, N, STEPS)
    b = sdf_fwd_plain(p, N, STEPS, 1.2, torch.zeros(N, N))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
