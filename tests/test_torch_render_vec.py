"""The functions of enoki_tpu.render that the port gained last: ``cross3``,
``unit_angle``, ``unit_angle_z``, ``Vec3.of``, ``Vec3.splat`` (render/vec.py)
and ``sdf_loss``, ``render_sdf_grads`` (render/sdf.py), against the JAX
reference on the CPU, on the same numpy inputs.

Gates are the reference's own: ``unit_angle`` / ``unit_angle_z`` within
rtol 1e-4 / atol 1e-5 of arccos and rtol 1e-3 at an angle of 1e-4
(tests/test_nested_memory.py:144-167), and within rtol 1e-5 / atol 1e-6 of
the JAX functions (two f32 evaluations of one formula, asin's last ulps
apart); ``render_sdf_grads`` finite, the ambient gradient 1.0 within 1e-4
and the radius gradient within rtol 0.10 of a finite difference
(tests/test_sdf.py:37-66), within rtol 1e-2 / atol 1e-3 * max(1, |g|max)
of the JAX gradient (the parity gate of bench.py:193-194) and within rtol
2e-2 / atol 2e-3 of the implicit backward (tests/test_pallas.py:173-185).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from enoki_tpu.render import cross3 as j_cross3
from enoki_tpu.render.pallas_kernels import vec_to_scene as j_vec_to_scene
from enoki_tpu.render.sdf import (SDFScene as JSDFScene, march as j_march,
                                  render_sdf_grads as j_render_sdf_grads,
                                  sdf_loss as j_sdf_loss)
from enoki_tpu.render.sphere import (make_rays as j_make_rays,
                                     pixel_grid as j_pixel_grid)
from enoki_tpu.render.vec import (Vec3 as JVec3, normalize3 as j_normalize3,
                                  unit_angle as j_unit_angle,
                                  unit_angle_z as j_unit_angle_z)

import enoki_tpu_torch.render as R
from enoki_tpu_torch.interop import scene_from_numpy, scene_to_numpy
from enoki_tpu_torch.render import (SDFScene, Vec3, cross3, make_rays,
                                    march, normalize3, pixel_grid,
                                    render_sdf_grads,
                                    render_sdf_grads_implicit, sdf_loss,
                                    shade)
from enoki_tpu_torch.render.sdf import _shade_at
from enoki_tpu_torch.render.sphere import scene_from_leaves
from enoki_tpu_torch.render.vec import unit_angle, unit_angle_z

from test_torch_cuda import SCENES, scene_vec as _scene_vec
from test_torch_render import assert_within_eps_band

CPU = "cpu"


def _unit_pairs():
    """64 pairs of unit vectors, normalised in float64 and cast: the same
    f32 inputs for both packages. The last pair is orthogonal with a dot
    product of exactly -0.0, the next-to-last exactly parallel."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 64))
    b = rng.normal(size=(3, 64))
    a /= np.linalg.norm(a, axis=0)
    b /= np.linalg.norm(b, axis=0)
    a, b = a.astype(np.float32), b.astype(np.float32)
    a[:, -1], b[:, -1] = (1.0, -0.0, -0.0), (-0.0, 1.0, 0.0)
    a[:, -2] = b[:, -2] = (0.0, 0.6, 0.8)
    return a, b


def _tv(c):
    return Vec3(*(torch.from_numpy(np.ascontiguousarray(x)) for x in c))


def _jv(c):
    return JVec3(*(jnp.asarray(x) for x in c))


def test_cross3_is_bit_equal_to_the_reference():
    a, b = _unit_pairs()
    a = a * np.float32(3.7)
    got = cross3(_tv(a), _tv(b))
    want = j_cross3(_jv(a), _jv(b))
    for g, w in zip((got.x, got.y, got.z), (want.x, want.y, want.z)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_render_exports_what_the_reference_exports():
    import enoki_tpu.render as JR
    for name in ("cross3", "render_sdf_grads"):
        assert hasattr(JR, name) and hasattr(R, name), name
    missing = [k for k in dir(JR) if not k.startswith("_")
               and k != "pallas_kernels"    # the port's is sdf_kernels
               and not hasattr(R, k)]
    assert missing == [], missing
    assert R.sdf_loss(R.SDFScene.reference(CPU), 8, 4).shape == ()


def test_unit_angle_gates_of_the_reference():
    a, b = _unit_pairs()
    va, vb = normalize3(_tv(a)), normalize3(_tv(b))
    an = np.stack([va.x.numpy(), va.y.numpy(), va.z.numpy()])
    bn = np.stack([vb.x.numpy(), vb.y.numpy(), vb.z.numpy()])
    want = np.arccos(np.clip((an * bn).sum(0), -1, 1))
    np.testing.assert_allclose(unit_angle(va, vb).numpy(), want, rtol=1e-4,
                               atol=1e-5)
    # near-parallel accuracy, where acos(dot) is catastrophically wrong
    eps = np.float32(1e-4)
    v1 = normalize3(_tv(np.array([[1.0], [0.0], [0.0]], np.float32)))
    v2 = normalize3(_tv(np.array([[1.0], [eps], [0.0]], np.float32)))
    np.testing.assert_allclose(unit_angle(v1, v2).item(), eps, rtol=1e-3)
    wz = np.arccos(np.clip(an[2], -1, 1))
    np.testing.assert_allclose(unit_angle_z(va).numpy(), wz, rtol=1e-4,
                               atol=1e-5)


def test_unit_angle_matches_jax_on_the_same_inputs():
    a, b = _unit_pairs()
    x, y = a[:, -1], b[:, -1]
    assert np.signbit(x[0] * y[0] + x[1] * y[1] + x[2] * y[2])  # -0.0
    got = unit_angle(_tv(a), _tv(b)).numpy()
    want = np.asarray(j_unit_angle(_jv(a), _jv(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # -0.0 flips the sign as the reference's sign-bit XOR does: the
    # orthogonal pair's angle is pi/2 either way, through the pi - temp
    # branch of the select
    np.testing.assert_allclose(got[-1], np.pi / 2, rtol=1e-6)
    assert got[-2] == 0.0
    gz = unit_angle_z(_tv(a)).numpy()
    wz = np.asarray(j_unit_angle_z(_jv(a)))
    np.testing.assert_allclose(gz, wz, rtol=1e-5, atol=1e-6)
    # -0.0 in z: copysign takes its sign, the angle is pi/2
    z = np.array([[1.0, 0.0], [0.0, 1.0], [-0.0, 0.0]], np.float32)
    np.testing.assert_allclose(unit_angle_z(_tv(z)).numpy(),
                               np.asarray(j_unit_angle_z(_jv(z))),
                               rtol=1e-6)


def test_unit_angle_of_normalised_vectors_matches_jax():
    # both normalise their own f32 inputs, then take the angle
    a, b = _unit_pairs()
    a, b = a * np.float32(2.5), b * np.float32(0.5)
    got = unit_angle(normalize3(_tv(a)), normalize3(_tv(b))).numpy()
    want = np.asarray(j_unit_angle(j_normalize3(_jv(a)), j_normalize3(_jv(b))))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("x,dtype", [
    (1, torch.get_default_dtype()), (1.5, torch.float32),
    (np.float64(2.0), torch.float64)], ids=["int", "float", "f64"])
def test_vec3_of_promotes_like_the_reference(x, dtype):
    v = Vec3.of(x, 2, 3.5, device=CPU)
    j = JVec3.of(x, 2, 3.5)
    assert v.x.dtype == dtype == v.y.dtype == v.z.dtype
    assert v.x.device.type == "cpu"
    if dtype != torch.float64:  # JAX on the CPU runs without x64
        assert str(j.x.dtype) == str(dtype).split(".")[1]
    for g, w in zip((v.x, v.y, v.z), (j.x, j.y, j.z)):
        assert g.item() == float(w)


def test_vec3_of_keeps_a_tensor_where_it_is():
    x = torch.arange(4, dtype=torch.int32)
    y = torch.ones(4, dtype=torch.float64)
    v = Vec3.of(x, y, 0.5)
    assert v.x.dtype == v.y.dtype == v.z.dtype == torch.get_default_dtype()
    assert torch.equal(v.x, x.float()) and v.z.device == x.device
    b = Vec3.of(torch.ones(3, dtype=torch.bfloat16), 1, 2)
    assert b.y.dtype == torch.bfloat16


def test_vec3_splat_takes_like_or_float32():
    like = Vec3(*(torch.zeros(5, dtype=torch.float64) for _ in range(3)))
    v = Vec3.splat(1, 2, 3, like=like)
    assert v.x.dtype == torch.float64 and v.z.item() == 3.0
    assert (like + v).x.shape == (5,)
    w = Vec3.splat(1, 2, 3, device=CPU)
    assert w.x.dtype == torch.float32 and w.y.device.type == "cpu"


def test_vec3_constructors_run_on_the_card_by_default(monkeypatch):
    # device=None means the card; without one the call raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Vec3.of(1.0, 2.0, 3.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Vec3.splat(1.0, 2.0, 3.0)


# -- the gradient through the unrolled march ------------------------------


def test_render_sdf_grads_gates_of_the_reference():
    img, grads = render_sdf_grads(SDFScene.reference(CPU), 64, 64)
    assert torch.isfinite(img).all()
    g = scene_to_numpy(grads)
    assert np.isfinite(g).all()
    # miss lanes contribute 1, hit lanes contribute 1: exactly 1
    assert abs(g[4] - 1.0) <= 1e-4


def test_radius_gradient_through_the_march_matches_fd():
    # tests/test_sdf.py:46-66: interior-restricted, 48^2, 96 steps
    n, steps, eps = 48, 96, 1e-2
    p = pixel_grid(n, device=CPU)
    interior = (p.x * p.x + p.y * p.y) < 0.5
    rays = make_rays(p)
    ref = SDFScene.reference(CPU)

    def masked_loss(r):
        s = SDFScene(ref.center, r, ref.ambient, ref.gain, ref.light)
        img = shade(rays, s, steps)
        return torch.sum(torch.where(interior, img, 0.0)) / interior.sum()

    r = torch.tensor(1.0, requires_grad=True)
    (ad,) = torch.autograd.grad(masked_loss(r), r)
    with torch.no_grad():
        fd = (masked_loss(torch.tensor(1.0 + eps))
              - masked_loss(torch.tensor(1.0 - eps))) / (2 * eps)
    # march quantization makes the FD noisy; the reference's 10%
    assert np.isclose(ad.item(), fd.item(), rtol=0.10), (ad, fd)


@pytest.fixture(params=list(SCENES), ids=list(SCENES))
def scene_vec(request):
    return _scene_vec(SCENES[request.param])


def test_render_sdf_grads_matches_jax(scene_vec):
    n, steps = 32, 48
    img, grads = render_sdf_grads(scene_from_numpy(scene_vec, CPU), n, steps)
    j_img, j_g = j_render_sdf_grads(
        j_vec_to_scene(jnp.asarray(scene_vec), JSDFScene), n, steps)
    tj, hj = j_march(j_make_rays(j_pixel_grid(n)),
                     j_vec_to_scene(jnp.asarray(scene_vec), JSDFScene), steps)
    rays, scene = make_rays(pixel_grid(n, device=CPU)), scene_from_numpy(
        scene_vec, CPU)
    tt, ht = march(rays, scene, steps)
    # the stops come from the same march as the image under test
    np.testing.assert_array_equal(
        _shade_at(rays, scene, tt, ht).detach().numpy().view(np.int32),
        img.numpy().view(np.int32))
    assert_within_eps_band(img.numpy(), j_img, (tt.numpy(), ht.numpy()),
                           (tj, hj))
    want = np.array([float(x) for x in jax.tree_util.tree_leaves(j_g)])
    got = scene_to_numpy(grads)[:9]
    # the reference's leaves are center.xyz, radius, ambient, gain,
    # light.xyz: the port's order
    np.testing.assert_allclose(got, want, rtol=1e-2,
                               atol=1e-3 * max(1.0, np.abs(want).max()))
    loss = sdf_loss(scene_from_numpy(scene_vec, CPU), n, steps)
    j_loss = j_sdf_loss(j_vec_to_scene(jnp.asarray(scene_vec), JSDFScene), n,
                        steps)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)


def test_render_sdf_grads_matches_the_implicit_backward():
    # tests/test_pallas.py:173-185: the unrolled backward against the
    # implicit one, at 64^2 and 64 steps
    scene = SDFScene.reference(CPU)
    _, g_scan = render_sdf_grads(scene, 64, 64)
    _, g_impl = render_sdf_grads_implicit(scene, 64, 64)
    np.testing.assert_allclose(scene_to_numpy(g_scan),
                               scene_to_numpy(g_impl), rtol=2e-2, atol=2e-3)


def test_the_march_is_checkpointed_and_gives_the_same_gradient():
    # one step's graph at a time; the values are those of the plain loop
    import importlib
    S = importlib.import_module("enoki_tpu_torch.render.sdf")
    scene = scene_from_numpy(_scene_vec(1), CPU)
    calls = []
    real = S.checkpoint

    def counting(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)

    S.checkpoint = counting
    try:
        img, g = render_sdf_grads(scene, 16, 12)
    finally:
        S.checkpoint = real
    assert calls == [False] * 12
    leaves = [torch.from_numpy(_scene_vec(1)[k:k + 1]).reshape(())
              .requires_grad_(True) for k in range(9)]
    with torch.no_grad():
        assert torch.equal(S.render_sdf(scene, 16, 12), img)
    s2 = scene_from_leaves(leaves, SDFScene)
    # the same loop unrolled without checkpoints
    ray = make_rays(pixel_grid(16, device=CPU))
    t = torch.zeros_like(ray.o.x)
    active = torch.ones_like(t, dtype=torch.bool)
    hit = torch.zeros_like(active)
    for _ in range(12):
        t, active, hit = S._march_step(ray, s2, 1e-4, 10.0, t, active, hit)
    want = torch.autograd.grad(S._shade_at(ray, s2, t, hit).mean(), leaves)
    assert torch.equal(torch.stack(want), torch.from_numpy(
        scene_to_numpy(g)[:9]))
