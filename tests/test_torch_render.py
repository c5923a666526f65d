"""The port's render modules (enoki_tpu_torch.render) against their JAX
counterparts (enoki_tpu.render) on the CPU, on the same seeded inputs.

Tolerances are the reference's own: sdf 3e-7 (tests/test_pallas.py:127),
image atol 1e-3 (tests/test_pallas.py:91), gradients rtol 1e-2 with atol
1e-3 * max(1, |g|max) (the parity gate of bench.py:193-194).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from enoki_tpu.ops.router import safe_sqrt as j_safe_sqrt
from enoki_tpu.render.implicit import implicit_t_vjp as j_implicit_t_vjp
from enoki_tpu.render.pallas_kernels import (scene_to_vec as j_scene_to_vec,
                                             vec_to_scene as j_vec_to_scene)
from enoki_tpu.render.sdf import (SDFScene as JSDFScene, march as j_march,
                                  normal_at as j_normal_at,
                                  render_sdf as j_render_sdf,
                                  render_sdf_grads_implicit as j_grads,
                                  sdf as j_sdf,
                                  sdf_ortho_dist as j_sdf_ortho_dist)
from enoki_tpu.render.sphere import (make_rays as j_make_rays,
                                     pixel_grid as j_pixel_grid)
from enoki_tpu.render.vec import Vec3 as JVec3

from enoki_tpu_torch.interop import scene_from_numpy, scene_to_numpy
from enoki_tpu_torch.ops.router import linspace, safe_sqrt
from enoki_tpu_torch.render.implicit import implicit_t_vjp
from enoki_tpu_torch.render.sdf import (
    march, normal_at, render_sdf, render_sdf_grads_implicit, sdf,
    sdf_ortho_dist)
from enoki_tpu_torch.render.sphere import make_rays, pixel_grid
from enoki_tpu_torch.render.vec import Vec3

from test_torch_cuda import SCENES, scene_vec as _scene_vec

CPU = "cpu"
STEPS = 48


@pytest.fixture(params=list(SCENES), ids=list(SCENES))
def scene_vec(request):
    return _scene_vec(SCENES[request.param])


def test_scene_recipe_starts_from_the_reference():
    np.testing.assert_array_equal(
        _scene_vec(None), np.asarray(j_scene_to_vec(JSDFScene.reference())))


def _jscene(v):
    return j_vec_to_scene(jnp.asarray(v), JSDFScene)


def _ulp_of(x):
    return float(np.spacing(np.float32(abs(x))))


@pytest.mark.parametrize("n", [64, 128, 1024])
def test_linspace_matches_jnp(n):
    # ulp of the endpoint: entries near 0 are sums of two terms of size
    # ~extent that cancel, so their error is measured at that scale
    a = np.asarray(jnp.linspace(-1.2, 1.2, n, dtype=jnp.float32))
    b = linspace(-1.2, 1.2, n, device=CPU).numpy()
    assert np.abs(a - b).max() <= _ulp_of(1.2)
    assert a[-1] == b[-1] == np.float32(1.2)


@pytest.mark.parametrize("n", [64, 128])
def test_pixel_grid_matches_jax(n):
    pj = j_pixel_grid(n)
    pt = pixel_grid(n, device=CPU)
    for a, b in ((pj.x, pt.x), (pj.y, pt.y)):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= _ulp_of(1.2)


def test_sdf_and_ortho_dist_match_jax(scene_vec):
    rng = np.random.default_rng(0)
    px, py = (rng.uniform(-1.2, 1.2, 64).astype(np.float32)
              for _ in range(2))
    t = rng.uniform(0, 3, 64).astype(np.float32)
    js, ts_ = _jscene(scene_vec), scene_from_numpy(scene_vec, CPU)
    a = np.asarray(j_sdf(JVec3(px, py, -1.0 + t), js))
    b = sdf(Vec3(torch.from_numpy(px), torch.from_numpy(py),
                 -1.0 + torch.from_numpy(t)), ts_).numpy()
    np.testing.assert_allclose(b, a, rtol=3e-7, atol=3e-7)
    a = np.asarray(j_sdf_ortho_dist(px, py, js)(t))
    b = sdf_ortho_dist(torch.from_numpy(px), torch.from_numpy(py),
                       ts_)(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(b, a, rtol=3e-7, atol=3e-7)


def test_normal_at_matches_jax(scene_vec):
    rng = np.random.default_rng(3)
    p = [rng.uniform(-1.0, 1.0, 256).astype(np.float32) for _ in range(3)]
    nj = j_normal_at(JVec3(*(jnp.asarray(c) for c in p)), _jscene(scene_vec))
    nt = normal_at(Vec3(*(torch.from_numpy(c) for c in p)),
                   scene_from_numpy(scene_vec, CPU))
    for a, b in ((nj.x, nt.x), (nj.y, nt.y), (nj.z, nt.z)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [64, 128])
def test_march_matches_jax(scene_vec, n):
    tj, hj = j_march(j_make_rays(j_pixel_grid(n)), _jscene(scene_vec), STEPS)
    tt, ht = march(make_rays(pixel_grid(n, device=CPU)),
                   scene_from_numpy(scene_vec, CPU), STEPS)
    hj = np.asarray(hj)
    np.testing.assert_array_equal(ht.numpy(), hj)
    # a hit t freezes once d < eps; where rounding puts one side's last d
    # just above eps, that side takes one more step of ~eps
    np.testing.assert_allclose(tt.numpy()[hj], np.asarray(tj)[hj],
                               rtol=0, atol=2e-4)


@pytest.mark.parametrize("n", [64, 128])
def test_render_sdf_matches_jax(scene_vec, n):
    js, ts_ = _jscene(scene_vec), scene_from_numpy(scene_vec, CPU)
    a = np.asarray(j_render_sdf(js, n, STEPS))
    b = render_sdf(ts_, n, STEPS).detach().numpy()
    # XLA contracts the step's products into FMAs and torch does not. On
    # about 1 pixel in 16k at 128^2 (none at 64^2, none in the reference
    # scene) the last distance then lands on the other side of eps and one
    # side takes one more ~eps step. Those lanes get the reference's
    # gate for a within-eps stopping point (tests/test_pallas.py:94-111);
    # every other pixel is held to atol 1e-3.
    tj, hj = j_march(j_make_rays(j_pixel_grid(n)), js, STEPS)
    tt, _ = march(make_rays(pixel_grid(n, device=CPU)), ts_, STEPS)
    hj = np.asarray(hj)
    band = hj & (np.abs(np.asarray(tj) - tt.numpy()) > 1e-5)
    d = np.abs(a - b)
    assert d[~band].max() <= 1e-3, d[~band].max()
    assert band.mean() < 1e-3, band.mean()
    assert not band.any() or d[band].max() < 0.05, d[band].max()


def test_render_sdf_grads_implicit_matches_jax(scene_vec):
    n = 64
    img_j, g_j = j_grads(_jscene(scene_vec), n, STEPS)
    img_t, g_t = render_sdf_grads_implicit(scene_from_numpy(scene_vec, CPU),
                                           n, STEPS)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=0,
                               atol=1e-3)
    ref = np.asarray(j_scene_to_vec(g_j))[:9]
    got = scene_to_numpy(g_t)[:9]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-2,
                               atol=1e-3 * max(1.0, np.abs(ref).max()))


def test_implicit_grazing_clamp_preserves_slope_sign():
    # f(a, t) = -1e-8 * t + a: the slope -1e-8 is under the guard and
    # must be clamped to -1, not +1, so dt/da stays positive
    def f_t(a, tv):
        return -1e-8 * tv + a[0]

    t = torch.zeros(4)
    (d,) = implicit_t_vjp(f_t, (torch.zeros(4),), t, torch.ones(4),
                          torch.ones(4, dtype=torch.bool))
    dj = j_implicit_t_vjp(lambda a, tv: -1e-8 * tv + a, jnp.zeros(4),
                          jnp.zeros(4), jnp.ones(4), jnp.ones(4, bool))
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
    np.testing.assert_allclose(d.numpy(), 1.0)


def test_implicit_t_vjp_misses_get_zero():
    def f_t(a, tv):
        return a[0] * tv - 1.0

    hit = torch.tensor([True, False, True])
    (d,) = implicit_t_vjp(f_t, (torch.full((3,), 2.0),),
                          torch.full((3,), 0.5), torch.ones(3), hit)
    # w = -t_bar / (d f/dt) = -1/2 on hits; d f/d a = t = 0.5
    np.testing.assert_allclose(d.numpy(), [-0.25, 0.0, -0.25])


def test_safe_sqrt_matches_jax():
    x = np.array([-1.0, 0.0, 1e-30, 4.0], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    safe_sqrt(xt).sum().backward()
    gj = jax.grad(lambda v: jnp.sum(j_safe_sqrt(v)))(jnp.asarray(x))
    np.testing.assert_array_equal(safe_sqrt(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_safe_sqrt(jnp.asarray(x))))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=1e-6)
    assert xt.grad[0] == 0.0 and xt.grad[1] == 0.0


def test_zero_rxy2_gives_no_nan():
    # n = 65 puts a pixel exactly at (0, 0) in both the linspace grid and
    # the kernels' iota grid, so rxy2 = 0 + the 1e-12 guard there
    from enoki_tpu_torch.render.sdf_kernels import (render_sdf_cuda,
                                                    tile_pixels)
    n = 65
    v = _scene_vec(None)
    assert pixel_grid(n, device=CPU).x[n // 2].item() == 0.0
    assert tile_pixels(n, 1.2, CPU)[0][0, n // 2].item() == 0.0
    img, g = render_sdf_grads_implicit(scene_from_numpy(v, CPU), n, STEPS)
    assert torch.isfinite(img).all()
    assert np.isfinite(scene_to_numpy(g)).all()
    p = torch.from_numpy(v).requires_grad_(True)
    # coarse=0: the plain configuration (65 has no cone-prepass block)
    img = render_sdf_cuda(p, n, STEPS, 1.2, tile=5, coarse=0)
    img.mean().backward()
    assert torch.isfinite(img).all() and torch.isfinite(p.grad).all()
    _, gj = j_grads(_jscene(v), n, STEPS)
    assert np.isfinite(np.asarray(j_scene_to_vec(gj))).all()
