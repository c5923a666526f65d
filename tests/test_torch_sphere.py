"""The port's closed-form sphere render (enoki_tpu_torch.render.sphere and
.sphere_kernels) against the JAX package on the CPU, on the same seeded
inputs: the plain PyTorch twin against the jnp path, the kernels' plain
versions against the Pallas kernels in interpret mode (as
tests/test_pallas.py runs them), and the whole path through its entry
points. The CUDA kernels themselves are held against the plain versions
on the card by tests/test_torch_cuda.py.

Tolerances are the reference's own: images max < 5e-3 and mean < 1e-4
against the jnp path (tests/test_pallas.py:44-45), atol 1e-3 against the
Pallas kernel (tests/test_pallas.py:91), gradients of the mean rtol 1e-3 /
atol 1e-5 (tests/test_pallas.py:62). For a unit random cotangent the sums
are ~N^2 times larger than the mean's and atol 1e-5 is below their f32
floor (d cz is 0 analytically and comes out near 1e-2 from JAX's own
VJP), so those take the reference's gate for a closed-form backward
against an autodiff one, rtol 2e-4 / atol 2e-4 * scale
(tests/test_pallas.py:376-377). bf16: interior median relative error
< 0.01 against f32 (tests/test_pallas.py:65-81).
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from enoki_tpu.render import io as j_io
from enoki_tpu.render import sphere as JS
from enoki_tpu.render.pallas_kernels import (render_sphere_pallas,
                                             scene_to_vec as j_scene_to_vec,
                                             vec_to_scene as j_vec_to_scene)
from enoki_tpu.render.vec import Vec3 as JVec3

from enoki_tpu_torch import _build
from enoki_tpu_torch.interop import scene_from_numpy, scene_to_numpy
from enoki_tpu_torch.ops.router import safe_sqrt
from enoki_tpu_torch.render import LAUNCHES, reset_launch_counts
from enoki_tpu_torch.render import io as t_io
from enoki_tpu_torch.render import sphere as TS
from enoki_tpu_torch.render.sdf_kernels import tile_pixels
from enoki_tpu_torch.render.sphere_kernels import (
    SphereRender, fwd_vector_stores, render_sphere_cuda, sphere_bwd_plain,
    sphere_fwd, sphere_fwd_plain)
from enoki_tpu_torch.render.vec import Vec3

from test_torch_cuda import SCENES, scene_vec as _scene_vec

CPU = "cpu"
N = 128
TILE = 64


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(params=list(SCENES), ids=list(SCENES))
def scene_vec(request):
    return _scene_vec(SCENES[request.param])


def _jscene(v):
    return j_vec_to_scene(jnp.asarray(v))


def _tscene(v):
    return scene_from_numpy(v, CPU, TS.SphereScene)


def _image_gate(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    assert d.max() < 5e-3, d.max()
    assert d.mean() < 1e-4, d.mean()


def _pallas_grad(v, g, dtype=jnp.float32):
    _, vjp = jax.vjp(lambda p: render_sphere_pallas(p, N, 1.2, TILE, dtype),
                     jnp.asarray(v))
    return np.asarray(vjp(jnp.asarray(g, dtype))[0])


def _cotangent(kind):
    if kind == "mean":
        return np.full((N, N), 1.0 / (N * N), np.float32)
    return np.random.default_rng(kind).standard_normal((N, N)) \
        .astype(np.float32)


# -- the twin against the jnp path ------------------------------------------


def test_intersect_rays_matches_jax(scene_vec):
    hj = JS.intersect_rays(JS.make_rays(JS.pixel_grid(N)), _jscene(scene_vec))
    ht = TS.intersect_rays(TS.make_rays(TS.pixel_grid(N, device=CPU)),
                           _tscene(scene_vec))
    for a, b in ((hj.x, ht.x), (hj.y, ht.y), (hj.z, ht.z)):
        _image_gate(a, b.detach().numpy())


def test_shade_hits_matches_jax(scene_vec):
    rng = np.random.default_rng(4)
    n = [rng.uniform(-1.0, 1.0, 512).astype(np.float32) for _ in range(3)]
    n[0][:16] = 0.0  # normals of miss lanes
    n[1][:16] = 0.0
    n[2][:16] = 0.0
    a = np.asarray(JS.shade_hits(JVec3(*(jnp.asarray(c) for c in n)),
                                 _jscene(scene_vec)))
    b = TS.shade_hits(Vec3(*(torch.from_numpy(c) for c in n)),
                      _tscene(scene_vec)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-5)
    assert (b[:16] == np.float32(scene_vec[4])).all()


@pytest.mark.parametrize("fn", ["combined", "render_fused", "render_staged"])
def test_sphere_image_matches_jax(scene_vec, fn):
    js, ts_ = _jscene(scene_vec), _tscene(scene_vec)
    if fn == "combined":
        a = JS.combined(JS.pixel_grid(N), js)
        b = TS.combined(TS.pixel_grid(N, device=CPU), ts_)
    else:
        a = getattr(JS, fn)(js, N)
        b = getattr(TS, fn)(ts_, N)
    assert b.shape == (N * N,) and b.dtype == torch.float32
    _image_gate(a, b.numpy())


def test_render_staged_equals_fused(scene_vec):
    ts_ = _tscene(scene_vec)
    assert torch.equal(TS.render_staged(ts_, N), TS.render_fused(ts_, N))


def test_image_loss_and_render_and_grads_match_jax(scene_vec):
    js, ts_ = _jscene(scene_vec), _tscene(scene_vec)
    lj = float(JS.image_loss(js, N))
    lt = TS.image_loss(ts_, N).item()
    assert np.isclose(lt, lj, rtol=1e-5, atol=1e-6)
    img_j, g_j = JS.render_and_grads(js, N)
    img_t, g_t = TS.render_and_grads(ts_, N)
    assert isinstance(g_t, TS.SphereScene)
    _image_gate(img_j, img_t.numpy())
    ref = np.asarray(j_scene_to_vec(g_j))[:9]
    got = scene_to_numpy(g_t)[:9]
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5)
    # every pixel adds ambient: d mean / d ambient = 1
    assert np.isclose(got[4], 1.0, atol=1e-5)


def test_numpy_reference_equals_jax_packages():
    np.testing.assert_array_equal(TS.numpy_reference(96),
                                  JS.numpy_reference(96))


def test_twin_matches_numpy_reference():
    # tests/test_sphere.py's gate, for the port's twin
    img = TS.render_fused(TS.SphereScene.reference(CPU), 256).numpy()
    ref = TS.numpy_reference(256)
    _image_gate(img, ref)
    assert img.reshape(256, 256)[0, 0] == np.float32(0.2)


# -- the kernels' plain versions against the Pallas kernels -----------------


def test_sphere_fwd_plain_matches_pallas(scene_vec):
    img_j = np.asarray(render_sphere_pallas(jnp.asarray(scene_vec), N, 1.2,
                                            TILE))
    img_t = sphere_fwd_plain(torch.from_numpy(scene_vec.copy()), N, 1.2)
    assert img_t.shape == (N, N) and img_t.dtype == torch.float32
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=0, atol=1e-3)
    # and the kernels' iota grid against the twin's linspace grid
    _image_gate(img_t.numpy().ravel(),
                TS.render_fused(_tscene(scene_vec), N).numpy())


@pytest.mark.parametrize("g_kind", ["mean", 3, 4],
                         ids=["mean", "rand3", "rand4"])
def test_sphere_bwd_plain_matches_pallas_vjp(scene_vec, g_kind):
    g = _cotangent(g_kind)
    dp_j = _pallas_grad(scene_vec, g)
    dp_t = sphere_bwd_plain(torch.from_numpy(scene_vec), torch.from_numpy(g),
                            N, 1.2).numpy()
    assert (dp_t[9:] == 0).all() and (dp_j[9:] == 0).all()
    if g_kind == "mean":
        np.testing.assert_allclose(dp_t, dp_j, rtol=1e-3, atol=1e-5)
    else:
        scale = max(1.0, np.abs(dp_j).max())
        np.testing.assert_allclose(dp_t, dp_j, rtol=2e-4, atol=2e-4 * scale)


def test_sphere_bwd_plain_all_miss_scene_is_ambient_only():
    v = _scene_vec(1)
    v[0] += 10.0  # the sphere leaves the frame
    g = _cotangent(3)
    dp_t = sphere_bwd_plain(torch.from_numpy(v), torch.from_numpy(g), N,
                            1.2).numpy()
    dp_j = _pallas_grad(v, g)
    np.testing.assert_allclose(dp_t, dp_j, rtol=2e-4,
                               atol=2e-4 * max(1.0, np.abs(dp_j).max()))
    assert (dp_t[[0, 1, 2, 3, 5, 6, 7, 8]] == 0).all()
    assert np.isclose(dp_t[4], g.sum(dtype=np.float64), rtol=1e-5)


def _interior_median_rel(img_b, img_f):
    img_b = np.asarray(img_b, np.float64)
    img_f = np.asarray(img_f, np.float64)
    interior = np.abs(img_f - 0.2) > 1.0
    return np.median(np.abs(img_b - img_f)[interior]
                     / np.abs(img_f)[interior])


def test_sphere_fwd_plain_bf16_gate(scene_vec):
    v = torch.from_numpy(scene_vec.copy())
    img_b = sphere_fwd_plain(v, N, 1.2, torch.bfloat16)
    assert img_b.dtype == torch.bfloat16 and img_b.shape == (N, N)
    img_b = img_b.float().numpy()
    img_jb = render_sphere_pallas(jnp.asarray(scene_vec), N, 1.2, TILE,
                                  jnp.bfloat16).astype(jnp.float32)
    # XLA may keep a bf16 chain in f32 on the CPU, so the reference's bf16
    # kernel is not bit-comparable; it meets the bf16 gate against the
    # port's bf16 image
    assert _interior_median_rel(img_b, img_jb) < 0.01
    if scene_vec[3] == 1.0 and not scene_vec[:3].any():
        # against f32, the gate holds for the reference scene, where the
        # reference applies it; a seeded light leaves dim lit pixels in
        # which bf16's cancellation in dot(n, L) exceeds 1% for the
        # reference's bf16 kernel as for the port's
        img_f = render_sphere_pallas(jnp.asarray(scene_vec), N, 1.2, TILE)
        assert _interior_median_rel(img_b, img_f) < 0.01


# -- sphere_fwd's per-pixel sequence (csrc/sphere_render.cu) -----------------


def sphere_fwd_hoisted(params, n, extent=1.2, dtype=torch.float32):
    """sphere_fwd's arithmetic over the whole image, op for op as the
    kernel writes it (fwd_row, sphere_pixel): the row's terms once, on an
    (n, 1) column; a = 1 and b = 2 ocz; the halving as a product with 0.5;
    hit_p = (ocx, ocy, (-1 + t) - cz); one selection for the hit mask and
    the relu. Returns (image, discrim in f32)."""
    px, py = tile_pixels(n, extent, params.device)
    px, py = px[:1, :].to(dtype), py[:, :1].to(dtype)  # (1, n), (n, 1)
    cx, cy, cz, rad, amb, gain, lx, ly, lz = (params[k].to(dtype)
                                              for k in range(9))
    # the row's terms
    ocy = py - cy
    ocz = -1.0 - cz
    b = 2.0 * ocz
    ocy2, ocz2, r2, b2, ocy_ly = ocy * ocy, ocz * ocz, rad * rad, b * b, \
        ocy * ly
    nb = -b.to(torch.float32)
    # a pixel
    ocx = px - cx
    c = ((ocx * ocx + ocy2) + ocz2) - r2
    d32 = (b2 - 4.0 * c).to(torch.float32)
    t = ((nb + safe_sqrt(d32)) * 0.5).to(dtype)
    hz = (-1.0 + t) - cz
    s = (ocx * lx + ocy_ly) + hz * lz
    lam = torch.where((d32 >= 0.0) & (s.to(torch.float32) > 0.0), s,
                      torch.zeros_like(s))
    return amb + lam * gain, d32


def _tangent_scene(n, dtype, extent=1.2):
    """A scene in which the ray of one pixel grazes the sphere: the center
    on the pixel coordinates of (row n/2 + 7, col n/2 - 20), cz = -1, the
    radius the distance to col n/2 + 20, all in ``dtype``, so that the
    pixel's discrim is exactly 0."""
    px, py = tile_pixels(n, extent, CPU)
    xs, ys = px[0].to(dtype), py[:, 0].to(dtype)
    cx, cy = xs[n // 2 - 20], ys[n // 2 + 7]
    v = _scene_vec(None)
    v[:4] = [cx.item(), cy.item(), -1.0, (xs[n // 2 + 20] - cx).item()]
    return v


FWD_SCENES = {
    **{f"seed{k}": (lambda k=k: _scene_vec(k)) for k in range(1, 9)},
    "reference": lambda: _scene_vec(None),
    "cz=-1": lambda: np.asarray([0, 0, -1.0, *_scene_vec(None)[3:]],
                                np.float32),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("scene", [*FWD_SCENES, "tangent"])
def test_sphere_fwd_sequence_is_bit_equal_to_plain(scene, dtype):
    # the exact identities sphere_fwd leaves out, checked on whole images:
    # the hoisted, shortened sequence gives the plain version's bits, the
    # silhouette's pixels included
    n = 257
    v = _tangent_scene(n, dtype) if scene == "tangent" \
        else FWD_SCENES[scene]()
    p = torch.from_numpy(v)
    img, d32 = sphere_fwd_hoisted(p, n, 1.2, dtype)
    ref = sphere_fwd_plain(p, n, 1.2, dtype)
    assert img.dtype == dtype and img.shape == (n, n)
    assert torch.equal(img, ref)
    hit = d32 >= 0.0
    # hits and misses side by side along a row: the silhouette is inside
    assert (hit[:, 1:] != hit[:, :-1]).any()
    if scene == "tangent":
        assert (d32 == 0.0).sum() >= 1
    if scene == "cz=-1":
        assert p[2].item() == -1.0


def _fwd_geometry():
    text = (_build.CSRC_DIR / "sphere_render.cu").read_text()
    return tuple(int(re.search(rf"kFwd{what} = (\d+)", text).group(1))
                 for what in ("Threads", "Pixels"))


@pytest.mark.parametrize("n", [1, 64, 257, 1000, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sphere_fwd_layout_covers_the_image_once(n, dtype):
    # sphere_fwd_kernel's map from (row, segment, thread, pixel) to a
    # column with the shipped geometry: blockIdx.x the row, blockIdx.y a
    # segment of threads * pixels columns, thread t the pixels from
    # t * pixels on; a thread whose first pixel is past the row returns
    threads, pixels = _fwd_geometry()
    segment = threads * pixels
    segments = (n + segment - 1) // segment
    seg, t, e = np.meshgrid(np.arange(segments), np.arange(threads),
                            np.arange(pixels), indexing="ij")
    col0 = seg * segment + t * pixels
    col = (col0 + e)[col0 < n]
    # the scalar route: every column < n once in each row
    np.testing.assert_array_equal(np.bincount(col[col < n], minlength=n),
                                  np.ones(n, np.int64))
    img = torch.empty((n, n), dtype=dtype)
    vec = fwd_vector_stores(img, n)
    assert vec == (n % 4 == 0)
    if vec:
        # the vector route: a thread's pixels are wholly inside the row
        # (the launcher's n % pixels guard never changes the route) and
        # start on the bytes they take, at most 16, in every row
        assert n % pixels == 0
        starts = col0[col0 < n]
        assert (starts + pixels <= n).all()
        width = min(16, pixels * img.element_size())
        rows = np.arange(n)[:, None]
        assert ((rows * n + starts[None, :]) * img.element_size() % width
                == 0).all()


# -- the whole path on the CPU ----------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_render_sphere_cuda_on_cpu_matches_jax_grad(scene_vec, dtype):
    p = torch.from_numpy(scene_vec.copy()).requires_grad_(True)
    img = render_sphere_cuda(p, N, 1.2, TILE, dtype)
    assert img.dtype == dtype
    img.float().mean().backward()

    def loss(pv):
        return jnp.mean(render_sphere_pallas(pv, N, 1.2, TILE))

    g_j = np.asarray(jax.grad(loss)(jnp.asarray(scene_vec)))
    # the backward is the f32 render's for either forward dtype
    np.testing.assert_allclose(p.grad.numpy(), g_j, rtol=1e-3, atol=1e-5)
    if dtype == torch.float32:
        np.testing.assert_allclose(
            img.detach().numpy(),
            np.asarray(render_sphere_pallas(jnp.asarray(scene_vec), N, 1.2,
                                            TILE)), rtol=0, atol=1e-3)


def test_sphere_render_module_matches_function_and_jax():
    v = _scene_vec(2)
    m = SphereRender(torch.from_numpy(v), n=N, device=CPU)
    assert m.params.device.type == "cpu"
    m().mean().backward()
    p = torch.from_numpy(v).requires_grad_(True)
    render_sphere_cuda(p, N, 1.2, TILE).mean().backward()
    np.testing.assert_array_equal(m.params.grad.numpy(), p.grad.numpy())
    g_j = jax.grad(lambda pv: jnp.mean(render_sphere_pallas(
        pv, N, 1.2, TILE)))(jnp.asarray(v))
    np.testing.assert_allclose(m.params.grad.numpy(), np.asarray(g_j),
                               rtol=1e-3, atol=1e-5)


def test_bf16_module_step_gets_the_f32_gradient():
    mf = SphereRender(n=N, device=CPU)
    mb = SphereRender(n=N, dtype=torch.bfloat16, device=CPU)
    mf().mean().backward()
    img = mb()
    assert img.dtype == torch.bfloat16
    img.mean().backward()  # a bf16 cotangent, 1/N^2 exactly
    assert torch.isfinite(mb.params.grad).all()
    np.testing.assert_array_equal(mb.params.grad.numpy(),
                                  mf.params.grad.numpy())


def test_render_sphere_cuda_checks_its_arguments():
    p = torch.from_numpy(_scene_vec(None))
    with pytest.raises(ValueError, match="tile"):
        render_sphere_cuda(p, 64, 1.2, 48)
    with pytest.raises(ValueError, match="shape"):
        render_sphere_cuda(p[:9], 64, 1.2, 64)
    with pytest.raises(ValueError, match="dtype"):
        render_sphere_cuda(p, 64, 1.2, 64, torch.float16)
    with pytest.raises(ValueError, match="device"):
        sphere_fwd(torch.zeros(16, device="meta"), 64)


def test_sphere_cpu_path_launches_no_kernel():
    reset_launch_counts()
    p = torch.from_numpy(_scene_vec(None)).requires_grad_(True)
    for dtype in (torch.float32, torch.bfloat16):
        render_sphere_cuda(p, 64, 1.2, 64, dtype).float().sum().backward()
    assert sum(LAUNCHES.values()) == 0


# -- weights and image output -----------------------------------------------


def test_interop_carries_a_sphere_scene(scene_vec):
    s = scene_from_numpy(scene_vec, CPU, TS.SphereScene)
    assert isinstance(s, TS.SphereScene)
    np.testing.assert_array_equal(scene_to_numpy(s), scene_vec)
    # the same values as the JAX package's scene of that vector
    np.testing.assert_array_equal(
        scene_to_numpy(s), np.asarray(j_scene_to_vec(_jscene(scene_vec))))


def test_write_ppm_round_trips_through_the_reference_reader(tmp_path):
    img = TS.render_fused(TS.SphereScene.reference(CPU), 32).reshape(32, 32)
    img = img.numpy()
    path = str(tmp_path / "sphere.ppm")
    t_io.write_ppm(path, img)
    want = np.clip(img, 0, 255).astype(np.int32).astype(np.float32)
    np.testing.assert_array_equal(j_io.read_ppm(path), want)
    np.testing.assert_array_equal(t_io.read_ppm(path), want)
    # byte for byte what the reference writes
    j_io.write_ppm(str(tmp_path / "ref.ppm"), img)
    assert (tmp_path / "ref.ppm").read_bytes() == (tmp_path /
                                                   "sphere.ppm").read_bytes()
    (tmp_path / "bad.ppm").write_text("P6\n1 1\n255\n0 0 0\n")
    with pytest.raises(ValueError, match="P3"):
        t_io.read_ppm(str(tmp_path / "bad.ppm"))
