"""``torch.func.vmap`` of the port's kernel Functions (queue A5a).

Each ``autograd.Function`` that launches a kernel has a looping ``vmap``
rule (``_build.loop_vmap``): one call an item of the batch, forward and,
under ``vmap(grad(...))``, backward, whose kernel call is then a
Function of its own (``_build.kernel_call``: ``_SphereBwdFn``,
``_SDFBwdFn``, ``_GenericBwdFn``). On the CPU
the wrappers take their plain versions, which would batch by themselves;
``_build.VMAP_LOOPS`` shows that the looping rules are what ran, as they
must on the card, where a batched tensor has no ``data_ptr()``.

Gates: bit-equal to the stacked unbatched calls; against ``jax.vmap`` of
the reference's Pallas renders in interpret mode, the gates of the
unbatched parity tests (tests/test_torch_sphere.py,
tests/test_torch_sdf_kernels.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from enoki_tpu.render.pallas_kernels import (_sdf_fwd_call,
                                             render_sdf_pallas,
                                             render_sphere_pallas)

from enoki_tpu_torch import _build, ops
from enoki_tpu_torch.render import generic as G, sdflib as sd, Vec3
from enoki_tpu_torch.render.sdf import SDFScene, march_implicit
from enoki_tpu_torch.render.sdf_kernels import render_sdf_cuda, sdf_fwd_plain
from enoki_tpu_torch.render.sphere import make_rays, pixel_grid
from enoki_tpu_torch.render.sphere import scene_from_leaves
from enoki_tpu_torch.render.sphere_kernels import render_sphere_cuda
from enoki_tpu_torch.struct import vectorize_wrapper

from test_torch_cuda import scene_vec
from test_torch_render import assert_within_eps_band, ts_parts

N = 128
STEPS = 16
BATCH = (None, 1, 2)


def params16():
    return torch.from_numpy(np.stack([scene_vec(s) for s in BATCH]))


def composed(p, pv):
    """examples/composed.py's scene."""
    s = sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])
    t = sd.sd_torus(p, Vec3(0.0, 0.0, 1.0), pv[9], pv[10])
    g = sd.sd_plane(p, Vec3(0.0, -1.0, 0.0), pv[11])
    return sd.op_union(sd.op_smooth_union(s, t, 0.1), g)


COMPOSED = [0.15, 40.0, -1.0, -1.0, 2.0, 0.1, -0.2, 0.3, 0.45, 0.55, 0.18,
            1.05]
_GENERIC = {}


def generic_render():
    if not _GENERIC:
        _GENERIC["render"] = G.make_sdf_renderer(composed, 12)[0]
    return _GENERIC["render"]


def params12():
    v = np.tile(np.float32(COMPOSED), (3, 1))
    v[1, 8], v[2, 5:8] = 0.5, (0.0, 0.1, 0.2)
    return torch.from_numpy(v)


# name -> (the call on one item, the batch, the Functions of its forward
# and backward whose loops run)
CASES = {
    "sphere f32": (lambda p: render_sphere_cuda(p, N, 1.2, 64), params16,
                   "_SphereRenderFn", "_SphereBwdFn"),
    "sphere bf16": (lambda p: render_sphere_cuda(p, N, 1.2, 64,
                                                 torch.bfloat16),
                    params16, "_SphereRenderFn", "_SphereBwdFn"),
    "sdf plain": (lambda p: render_sdf_cuda(p, N, STEPS, coarse=0),
                  params16, "_SDFRenderFn", "_SDFBwdFn"),
    "sdf coarse=8": (lambda p: render_sdf_cuda(p, N, STEPS, coarse=8),
                     params16, "_SDFRenderFn", "_SDFBwdFn"),
    "sdf split=8": (lambda p: render_sdf_cuda(p, N, STEPS, coarse=0,
                                              split=8),
                    params16, "_SDFRenderFn", "_SDFBwdFn"),
    "generic composed": (lambda p: generic_render()(p, N, STEPS, tile=64),
                         params12, "_GenericRenderFn", "_GenericBwdFn"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_vmap_of_a_render_is_the_stacked_calls(name):
    f, batch, fwd, bwd = CASES[name]
    p = batch()
    _build.VMAP_LOOPS.clear()
    got = torch.func.vmap(f)(p)
    assert dict(_build.VMAP_LOOPS) == {fwd: 1}
    want = torch.stack([f(q) for q in p])
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_vmap_of_grad_of_a_render_is_the_stacked_grads(name):
    f, batch, fwd, bwd = CASES[name]
    p = batch()

    def loss(q):
        return f(q).float().mean()

    _build.VMAP_LOOPS.clear()
    got = torch.func.vmap(torch.func.grad(loss))(p)
    # the forward's loop and the backward kernel's loop, once each
    assert dict(_build.VMAP_LOOPS) == {fwd: 1, bwd: 1}
    want = torch.stack([torch.func.grad(loss)(q) for q in p])
    assert torch.equal(got, want)
    # autograd outside the map: each item's own backward, unbatched
    q = p.clone().requires_grad_(True)
    torch.func.vmap(loss)(q).sum().backward()
    assert torch.equal(q.grad, want)


def hist_inputs(seed=11, n=1 << 12, bins=64):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-3, bins + 4, (3, n)).astype(np.int32)
    w = rng.standard_normal((3, n)).astype(np.float32)
    return torch.from_numpy(idx), torch.from_numpy(w), bins


@pytest.mark.parametrize("impl", ["kernel", "fused"])
@pytest.mark.parametrize("weighted", [False, True])
def test_vmap_of_the_histogram_is_the_stacked_calls(weighted, impl):
    idx, w, bins = hist_inputs()

    def h(i, wi):
        return ops.histogram(i, bins, wi if weighted else None, impl=impl)

    _build.VMAP_LOOPS.clear()
    got = torch.func.vmap(h)(idx, w)
    assert dict(_build.VMAP_LOOPS) == {"_HistogramFn": 1}
    assert torch.equal(got, torch.stack([h(i, wi) for i, wi in zip(idx, w)]))
    if weighted:
        # the backward runs no kernel: plain PyTorch, batched as it is
        def loss(wi, i):
            return (h(i, wi) ** 2).sum()

        g = torch.func.vmap(torch.func.grad(loss))(w, idx)
        assert torch.equal(g, torch.stack([torch.func.grad(loss)(wi, i)
                                           for wi, i in zip(w, idx)]))


def test_vmap_with_an_unbatched_argument_and_another_batch_axis():
    # the index shared by the batch, the weights batched along axis 1
    idx, w, bins = hist_inputs(12)
    got = torch.func.vmap(lambda wi: ops.histogram(idx[0], bins, wi),
                          in_dims=1)(w.T.contiguous())
    want = torch.stack([ops.histogram(idx[0], bins, wi) for wi in w])
    assert torch.equal(got, want)


def test_nested_vmap_loops_at_each_level():
    p = params16()
    pp = torch.stack([p, p.flip(0)])

    def f(q):
        return render_sphere_cuda(q, 32, 1.2, 32)

    _build.VMAP_LOOPS.clear()
    got = torch.func.vmap(torch.func.vmap(f))(pp)
    # the inner level's rule once, the outer's once an inner item
    assert _build.VMAP_LOOPS["_SphereRenderFn"] == 1 + 3
    assert torch.equal(got, torch.stack([torch.stack([f(q) for q in b])
                                         for b in pp]))


def test_vectorize_wrapper_of_the_sphere_render():
    p = params16()
    wide = vectorize_wrapper(lambda q: render_sphere_cuda(q, 32, 1.2, 32))
    got = wide(p)
    assert torch.equal(got, torch.stack([render_sphere_cuda(q, 32, 1.2, 32)
                                         for q in p]))


def test_march_implicit_twins_batch_their_forward():
    # the plain _MarchImplicit Functions take generate_vmap_rule: their
    # forward bodies are PyTorch ops that vmap batches
    rays = make_rays(pixel_grid(32, device="cpu"))
    leaves = torch.from_numpy(np.stack([scene_vec(s)[:9] for s in BATCH]))

    def march(v):
        return march_implicit(rays, scene_from_leaves(list(v), SDFScene), 24)

    t, hit = torch.func.vmap(march)(leaves)
    want = [march(v) for v in leaves]
    assert torch.equal(t, torch.stack([w[0] for w in want]))
    assert torch.equal(hit, torch.stack([w[1] for w in want]))
    px, py = (c.reshape(32, 32) for c in (pixel_grid(32, device="cpu").x,
                                          pixel_grid(32, device="cpu").y))

    def generic_march(v):
        return G._MarchImplicit.apply(v, px, py, composed, G.ortho_camera,
                                      24, 1e-4, 10.0)

    t, hit = torch.func.vmap(generic_march)(params12())
    want = [generic_march(v) for v in params12()]
    assert torch.equal(t, torch.stack([w[0] for w in want]))
    assert torch.equal(hit, torch.stack([w[1] for w in want]))


# -- against jax.vmap of the reference's Pallas renders ------------------------------


@pytest.fixture
def interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


def test_vmap_of_the_sphere_render_matches_jax_vmap(interpret):
    n, tile = 64, 64
    p = params16()
    img_t = torch.func.vmap(lambda q: render_sphere_cuda(q, n, 1.2, tile))(p)
    g_t = torch.func.vmap(torch.func.grad(
        lambda q: render_sphere_cuda(q, n, 1.2, tile).mean()))(p)
    pj = jnp.asarray(p.numpy())
    img_j = jax.vmap(lambda q: render_sphere_pallas(q, n, 1.2, tile))(pj)
    g_j = jax.vmap(jax.grad(lambda q: jnp.mean(render_sphere_pallas(
        q, n, 1.2, tile))))(pj)
    # tests/test_torch_sphere.py: image atol 1e-3, the mean's gradient
    # rtol 1e-3 / atol 1e-5
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-3,
                               atol=1e-5)


def test_vmap_of_the_sdf_render_matches_jax_vmap(interpret):
    # tests/test_torch_sdf_kernels.py's gates: the image within the eps
    # band (the stops from each side's unbatched march), the gradient
    # rtol 1e-2, atol 1e-3 * max(1, |g|max). At 64^2 one grazing pixel of
    # the seed-1 scene stops on the other side of eps in the unbatched
    # calls too (XLA's CPU rsqrt against the correctly rounded root,
    # ROADMAP C6) and flips between hit and miss. Flipped pixels take the
    # reference's flip gate, under 1e-3 of the image
    # (tests/test_pallas.py:108), and the gradients compared are those of
    # the mean over the pixels where both marches agree (at a grazing hit
    # one pixel moves the mean's gradient by up to 4%)
    n, tile, steps = 64, 64, 48
    p = params16()
    pj = jnp.asarray(p.numpy())
    img_t = torch.func.vmap(lambda q: render_sdf_cuda(
        q, n, steps, 1.2, tile, coarse=0))(p)
    img_j = jax.vmap(lambda q: render_sdf_pallas(q, n, steps, 1.2, tile,
                                                 None, 0))(pj)
    keep = []
    for b in range(len(BATCH)):
        _, ts_t = sdf_fwd_plain(p[b], n, steps, 1.2)
        _, ts_j = _sdf_fwd_call(pj[b], n, steps, 1.2, tile, None, 0)
        (t_t, hit_t), (t_j, hit_j) = (ts_parts(ts_t.numpy()),
                                      ts_parts(np.asarray(ts_j)))
        k = hit_t == hit_j
        assert (~k).mean() < 1e-3, (~k).mean()
        assert_within_eps_band(img_t[b].numpy()[k],
                               np.asarray(img_j[b])[k], (t_t[k], hit_t[k]),
                               (t_j[k], hit_j[k]))
        keep.append(k.astype(np.float32))
    keep = np.stack(keep)

    def loss_t(q, k):
        return (render_sdf_cuda(q, n, steps, 1.2, tile, coarse=0) * k).mean()

    def loss_j(q, k):
        return jnp.mean(render_sdf_pallas(q, n, steps, 1.2, tile, None, 0)
                        * k)

    g_t = torch.func.vmap(torch.func.grad(loss_t))(p, torch.from_numpy(keep))
    g_j = np.asarray(jax.vmap(jax.grad(loss_j))(pj, jnp.asarray(keep)))
    for b in range(len(BATCH)):
        np.testing.assert_allclose(
            g_t[b].numpy()[:9], g_j[b][:9], rtol=1e-2,
            atol=1e-3 * max(1.0, np.abs(g_j[b][:9]).max()))
