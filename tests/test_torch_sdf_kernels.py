"""The port's SDF render kernels (enoki_tpu_torch.render.sdf_kernels):
their plain versions and the whole slice against the JAX Pallas kernels
(run in interpret mode, as tests/test_pallas.py runs them). The kernels
themselves are held against the plain versions on the card by
tests/test_torch_cuda.py.

Tolerances are the reference's own: image atol 1e-3
(tests/test_pallas.py:91), backward rtol/atol 2e-4 * scale
(tests/test_pallas.py:376-377), slice gradients rtol 1e-2 with atol
1e-3 * max(1, |g|max) (bench.py:193-194).
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from enoki_tpu.render.pallas_kernels import (
    _sdf_fwd_call, _sdf_vjp_bwd, render_sdf_pallas)

from enoki_tpu_torch import _build
from enoki_tpu_torch.render import LAUNCHES, reset_launch_counts
from enoki_tpu_torch.render.sdf_kernels import (
    SDFRender, march_counts, render_sdf_cuda, sdf_bwd_plain, sdf_fwd,
    sdf_fwd_plain, tile_pixels)
from enoki_tpu_torch.ops.router import linspace

from test_torch_cuda import SCENES, scene_vec as _scene_vec

N = 128
TILE = 64
STEPS = 48


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(params=list(SCENES), ids=list(SCENES))
def scene_vec(request):
    return _scene_vec(SCENES[request.param])


def _jax_fwd(v, n=N):
    img, ts = _sdf_fwd_call(jnp.asarray(v), n, STEPS, 1.2, TILE, None, 0)
    return np.array(img), np.array(ts)


def _g(n=N, seed=7):
    return np.random.default_rng(seed).standard_normal((n, n)) \
        .astype(np.float32)


def test_tile_pixels_is_the_iota_formula():
    n, extent = 96, 1.2
    step = np.float32(2.0 * extent / (n - 1))
    want = np.arange(n).astype(np.float32) * step - np.float32(extent)
    px, py = tile_pixels(n, extent, "cpu")
    np.testing.assert_array_equal(px.numpy()[5], want)
    np.testing.assert_array_equal(py.numpy()[:, 7], want)
    # and within a few ulp of the linspace grid (tests/test_pallas.py:41)
    grid = linspace(-extent, extent, n, device="cpu").numpy()
    assert np.abs(want - grid).max() <= 3 * np.spacing(np.float32(extent))


def test_sdf_fwd_plain_matches_jax_kernel(scene_vec):
    img_j, ts_j = _jax_fwd(scene_vec)
    img_t, ts_t = sdf_fwd_plain(torch.from_numpy(scene_vec.copy()), N,
                                STEPS, 1.2)
    hj = ts_j >= 0
    np.testing.assert_array_equal(ts_t.numpy() >= 0, hj)
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ts_t.numpy()[hj], ts_j[hj], rtol=0,
                               atol=2e-4)


@pytest.mark.parametrize("shift", [0.0, 10.0], ids=["mixed", "all_miss"])
def test_sdf_bwd_plain_matches_jax_kernel(scene_vec, shift):
    v = scene_vec.copy()
    v[0] += shift
    _, ts_j = _jax_fwd(v)
    g = _g()
    nd = (N, STEPS, 1.2, TILE, None, 0, 16, jnp.float32, 1, 1.0, False, 0)
    (dp_j,) = _sdf_vjp_bwd(*nd, (jnp.asarray(v), jnp.asarray(ts_j)),
                           jnp.asarray(g))
    dp_j = np.asarray(dp_j)
    dp_t = sdf_bwd_plain(torch.from_numpy(v), torch.from_numpy(g),
                         torch.from_numpy(ts_j), N, 1.2).numpy()
    scale = max(1.0, np.abs(dp_j).max())
    np.testing.assert_allclose(dp_t, dp_j, rtol=2e-4, atol=2e-4 * scale)
    assert (dp_t[9:] == 0).all()


def test_render_sdf_cuda_slice_matches_jax(scene_vec):
    p = torch.from_numpy(scene_vec.copy()).requires_grad_(True)
    img_t = render_sdf_cuda(p, N, STEPS, 1.2, TILE, coarse=0)
    img_t.mean().backward()

    def loss(pv):
        return jnp.mean(render_sdf_pallas(pv, N, STEPS, 1.2, TILE, None, 0))

    l_j, g_j = jax.value_and_grad(loss)(jnp.asarray(scene_vec))
    g_j = np.asarray(g_j)[:9]
    np.testing.assert_allclose(img_t.detach().numpy(),
                               np.asarray(render_sdf_pallas(
                                   jnp.asarray(scene_vec), N, STEPS, 1.2,
                                   TILE, None, 0)), rtol=0, atol=1e-3)
    assert np.isclose(img_t.mean().item(), float(l_j), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(p.grad.numpy()[:9], g_j, rtol=1e-2,
                               atol=1e-3 * max(1.0, np.abs(g_j).max()))


def test_sdf_render_module_matches_function():
    v = _scene_vec(1)
    m = SDFRender(torch.from_numpy(v), n=64, n_steps=STEPS, device="cpu")
    m().mean().backward()
    p = torch.from_numpy(v).requires_grad_(True)
    render_sdf_cuda(p, 64, STEPS, 1.2, 64, coarse=0).mean().backward()
    np.testing.assert_array_equal(m.params.grad.numpy(), p.grad.numpy())
    assert m.params.device.type == "cpu"


def test_render_sdf_cuda_checks_shapes():
    p = torch.from_numpy(_scene_vec(None))
    with pytest.raises(ValueError, match="tile"):
        render_sdf_cuda(p, 64, STEPS, 1.2, 48)
    with pytest.raises(ValueError, match="shape"):
        render_sdf_cuda(p[:9], 64, STEPS, 1.2, 64)
    with pytest.raises(ValueError, match="device"):
        sdf_fwd(torch.zeros(16, device="meta"), 64, STEPS)


def test_cpu_path_launches_no_kernel():
    reset_launch_counts()
    p = torch.from_numpy(_scene_vec(None)).requires_grad_(True)
    render_sdf_cuda(p, 64, STEPS, 1.2, 64).sum().backward()
    assert all(v == 0 for v in LAUNCHES.values())


def test_march_counts_count_the_kernel_loop():
    # a per-lane scalar replay of the kernel's loop, at a few pixels: an
    # evaluation at the top of every iteration, the hit test on the last
    v = _scene_vec(2)
    n = 32
    p = torch.from_numpy(v)
    total = 0
    px, py = tile_pixels(n, 1.2, "cpu")
    f = np.float32
    for r in range(n):
        for c in range(n):
            dx, dy = f(px[r, c]) - f(v[0]), f(py[r, c]) - f(v[1])
            rxy2 = dx * dx + dy * dy + f(1e-12)
            z0 = f(-1.0) - f(v[2])
            z, k = z0, 0
            while True:
                x = rxy2 + z * z
                s = x * (f(1) / np.sqrt(x))
                total += 1
                if k >= STEPS - 1:
                    break
                if not (s >= v[3] + f(1e-4) and z + s <= f(10) + z0 + v[3]):
                    break
                z = z + (s - v[3])
                k += 1
    # the scalar replay rounds 1/sqrt differently from torch.rsqrt; a lane
    # may take a step more or less
    evals, adv = march_counts(p, n, STEPS)
    assert abs(evals.sum().item() - total) <= 0.01 * total
    assert (evals - adv == 1).all()


def _relaxed_replay(v, n, n_steps, relax=1.6):
    """A per-lane scalar replay of the kernel's unimodal relaxed march in
    f32 -> (evaluations, how the lane left), each (n, n): "converged"
    (frozen, not diverged), "diverged", "cap" (ran every step, the last
    one not moving it) or "cap_reverting" (its last step reverted)."""
    f = np.float32
    px, py = (c.numpy() for c in tile_pixels(n, 1.2, "cpu"))
    w, back = f(relax), f(1.0 - 1.0 / relax)
    z0, rad = f(-1.0) - f(v[2]), f(v[3])
    evals = np.zeros((n, n), np.int64)
    how = np.full((n, n), "converged", dtype=object)
    for r in range(n):
        for c in range(n):
            dx, dy = f(px[r, c]) - f(v[0]), f(py[r, c]) - f(v[1])
            rxy2 = dx * dx + dy * dy + f(1e-12)

            def dist(t):
                return np.sqrt(rxy2 + (z0 + t) * (z0 + t)) - rad

            pos, stp = f(0), f(0)
            for k in range(n_steps):
                d = dist(pos)
                evals[r, c] += 1
                back_stp = back * stp
                over = d < back_stp
                far = d >= f(1e-4)
                diverged = not over and stp > 0 and far and d * w > stp
                alive = far and pos + d <= f(10) and not diverged
                adv = alive and not over and k < n_steps - 1
                new_stp = w * d if adv else f(0)
                pos = f(10) if diverged else (
                    pos - back_stp if over else pos + new_stp)
                stp = new_stp
                if diverged:
                    how[r, c] = "diverged"
                elif k == n_steps - 1:
                    how[r, c] = "cap_reverting" if over else "cap"
                if not (alive or over):
                    break
            evals[r, c] += 1  # the hit test's
    return evals, how


@pytest.mark.parametrize("case", ["converged", "diverged", "cap",
                                  "cap_reverting", "no_step"])
def test_relaxed_march_counts_count_the_kernel_loop(case):
    # the relaxed march runs its steps up to the one that freezes the lane
    # or to the cap, and its hit test evaluates anew, however it left
    v = _scene_vec(None)
    n, n_steps = 32, 0 if case == "no_step" else 8
    evals, steps = march_counts(torch.from_numpy(v), n, n_steps, relax=1.6,
                                unimodal=True)
    if case == "no_step":
        assert (evals == 1).all() and (steps == 0).all()
        return
    want, how = _relaxed_replay(v, n, n_steps)
    lanes = torch.from_numpy(how == case)
    assert lanes.sum() >= 8
    assert torch.equal(evals[lanes], torch.from_numpy(want)[lanes])
    assert (evals[lanes] - steps[lanes] == 1).all()
    if case.startswith("cap"):
        assert (steps[lanes] == n_steps).all()
    elif case == "converged":
        assert (steps[lanes] < n_steps).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_relaxed_root_argument_is_in_the_fast_roots_range(scene_vec, dtype,
                                                          monkeypatch):
    # the kernel takes the relaxed march's root without the IEEE range
    # check (sqrt_pos_), exact for arguments of at least 2^-100: the
    # plain version's arguments, with and without the start map
    from enoki_tpu_torch.render import sdf_kernels as K
    seen = []
    root = K._sqrt

    def recording(x):
        seen.append(x.float().min().item())
        return root(x)

    monkeypatch.setattr(K, "_sqrt", recording)
    p = torch.from_numpy(scene_vec)
    for t0 in (None, K._cone_t0(p, 64, STEPS, 1.2, 8)):
        sdf_fwd_plain(p, 64, STEPS, 1.2, t0, dtype, 1.6, True)
    assert len(seen) >= 2 * STEPS
    assert min(seen) >= 2.0 ** -100


def test_cuda_sources_match_their_ctypes_signatures():
    # the argtypes ctypes declares must have the arity of the C function,
    # for every library; the generic renderer's entry points are in its
    # skeleton header, before the loops that a host compiler takes instead
    skeleton = (_build.CSRC_DIR / "generic_render.cuh").read_text()
    card, _ = skeleton.split("#else  // a host compiler")
    sources = {"sdf_render": None, "sdf_bwd_ad": None, "sphere_render": None,
               "generic_render": card, "hist": None,
               "stochastic_round": None}
    assert set(_build.SIGNATURES) == set(sources)
    for lib, signatures in _build.SIGNATURES.items():
        src = sources[lib] or (_build.CSRC_DIR / f"{lib}.cu").read_text()
        extern = src[src.index('extern "C" {'):]
        for name, argtypes in signatures.items():
            m = re.search(rf"int {name}\(([^)]*)\)", extern)
            assert m, name
            args = [a for a in m.group(1).split(",") if a.strip()]
            assert len(args) == len(argtypes), name
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
