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

import ctypes
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from enoki_tpu.render.pallas_kernels import (
    _sdf_bwd_kernel_ad, _sdf_fwd_call, _sdf_vjp_bwd, render_sdf_pallas)

from enoki_tpu_torch import _build
from enoki_tpu_torch.render import LAUNCHES, reset_launch_counts
from enoki_tpu_torch.render.sdf_kernels import (
    DENSE_MIN_N, SDFRender, float4_rows, fwd_route, march_counts,
    render_sdf_cuda, sdf_bwd_ad_plain, sdf_bwd_plain, sdf_fwd, sdf_fwd_plain,
    tile_pixels)
from enoki_tpu_torch.ops.router import linspace

from test_torch_cuda import SCENES, scene_vec as _scene_vec
from test_torch_render import assert_within_eps_band, ts_parts

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
    # the kernel's |p-c| is x * rsqrt(x) in interpret mode: XLA's CPU
    # rsqrt, whose bits depend on the host, decides a grazing stop
    assert_within_eps_band(img_t.numpy(), img_j, ts_parts(ts_t.numpy()),
                           ts_parts(ts_j))


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
    img_j = render_sdf_pallas(jnp.asarray(scene_vec), N, STEPS, 1.2, TILE,
                              None, 0)
    img_s, ts_t = sdf_fwd_plain(torch.from_numpy(scene_vec.copy()), N, STEPS,
                                1.2)
    # the stops come from the same march as the image under test
    np.testing.assert_array_equal(img_s.numpy().view(np.int32),
                                  img_t.detach().numpy().view(np.int32))
    _, ts_j = _jax_fwd(scene_vec)
    assert_within_eps_band(img_t.detach().numpy(), img_j,
                           ts_parts(ts_t.numpy()), ts_parts(ts_j))
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


def test_fwd_route_takes_the_dense_kernel_from_its_threshold():
    for n in (DENSE_MIN_N, DENSE_MIN_N + 4, 2 * DENSE_MIN_N, 16384):
        assert fwd_route(n) == "dense"
    for n in (1, 64, DENSE_MIN_N // 2, DENSE_MIN_N - 1):
        assert fwd_route(n) == "pixel"
    # the relaxed march has the one-pixel route at every size
    assert fwd_route(16384, 1.6) == "pixel"
    assert fwd_route(16384, 1.0, True) == "pixel"


def test_float4_rows_fall_back_on_a_ragged_row_or_a_misaligned_view():
    buf = torch.zeros(64 * 64 + 4)
    assert buf.data_ptr() % 16 == 0
    whole = buf[:64 * 64].view(64, 64)
    off = buf[1:64 * 64 + 1].view(64, 64)  # 4 bytes past 16
    assert float4_rows(64, whole, whole)
    assert float4_rows(64, whole, whole, None)  # no start map
    assert not float4_rows(62, whole, whole)  # rows not whole float4s
    assert not float4_rows(64, off, whole)
    assert not float4_rows(64, whole, off)
    assert not float4_rows(64, whole, whole, off)


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


_CTYPES = {"*": ctypes.c_void_p, "cudaStream_t": ctypes.c_void_p,
           "int": ctypes.c_int, "int64_t": ctypes.c_int64,
           "uint64_t": ctypes.c_uint64, "float": ctypes.c_float}


def test_cuda_sources_match_their_ctypes_signatures():
    # the argtypes ctypes declares must have the arity of the C function,
    # for every library; the generic renderer's entry points are in its
    # skeleton header, before the loops that a host compiler takes instead
    skeleton = (_build.CSRC_DIR / "generic_render.cuh").read_text()
    card, _ = skeleton.split("#else  // a host compiler")
    sources = {"sdf_render": None, "sdf_bwd_ad": None, "sphere_render": None,
               "generic_render": card, "hist": None,
               "stochastic_round": None, "pcg32": None}
    assert set(_build.SIGNATURES) == set(sources)
    for lib, signatures in _build.SIGNATURES.items():
        src = sources[lib] or (_build.CSRC_DIR / f"{lib}.cu").read_text()
        extern = src[src.index('extern "C" {'):]
        for name, argtypes in signatures.items():
            m = re.search(rf"int {name}\(([^)]*)\)", extern)
            assert m, name
            args = [a for a in m.group(1).split(",") if a.strip()]
            assert len(args) == len(argtypes), name
            # and each argument the type ctypes passes: a pointer or the
            # stream as c_void_p, never cut to an int
            for arg, argtype in zip(args, argtypes):
                ctype = "*" if "*" in arg else " ".join(arg.split()[:-1])
                assert _CTYPES[ctype] is argtype, (name, arg)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# -- sdf_bwd_ad's reverse mode and the backward's pixel layout --------------


def reverse_sweep(params, g, ts, n, extent=1.2, tie_slope=0.5):
    """sdf_bwd_ad's per-pixel reverse mode (csrc/sdf_bwd_ad.cu), written
    op for op in the kernel's order over the whole image, each term summed
    over the pixels: the forward sweep of the shade, its adjoint sweep
    seeded with g, the SDF's adjoint sweep seeded with 1, the implicit
    term. Returns dp[16]. ``tie_slope``: max(y, 0)'s subgradient at y = 0
    (the kernel's is 0.5)."""
    cx, cy, cz, gain, lx, ly, lz = (params[k] for k in (0, 1, 2, 5, 6, 7, 8))
    px, py = tile_pixels(n, extent, params.device)
    hit = ts >= 0.0
    # forward sweep
    dx = px - cx
    dy = py - cy
    dz = (-1.0 + ts) - cz
    x = dx * dx + dy * dy + dz * dz + 1e-12
    q = torch.rsqrt(x)
    nx, ny, nz = dx * q, dy * q, dz * q
    m = nx * nx + ny * ny + nz * nz + 1e-12
    inv = torch.rsqrt(m)
    s = nx * lx + ny * ly + nz * lz
    y = s * inv
    r = torch.clamp_min(y, 0.0)
    r_slope = torch.where(y > 0.0, 1.0,
                          torch.where(y == 0.0, tie_slope, 0.0))
    # adjoint sweep of img = amb + r * gain, seeded with g
    y_bar = g * gain * r_slope
    s_bar = y_bar * inv
    inv_bar = y_bar * s
    m_bar = inv_bar * (-0.5 * inv * inv * inv)
    nx_bar = s_bar * lx + 2.0 * m_bar * nx
    ny_bar = s_bar * ly + 2.0 * m_bar * ny
    nz_bar = s_bar * lz + 2.0 * m_bar * nz
    q_bar = nx_bar * dx + ny_bar * dy + nz_bar * dz
    x_bar = q_bar * (-0.5 * q * q * q)
    dx_bar = nx_bar * q + 2.0 * x_bar * dx
    dy_bar = ny_bar * q + 2.0 * x_bar * dy
    dz_bar = nz_bar * q + 2.0 * x_bar * dz
    # adjoint sweep of sdf = x * q - radius, seeded with 1
    xs_bar = q + x * (-0.5 * q * q * q)
    dxs, dys, dzs = 2.0 * xs_bar * dx, 2.0 * xs_bar * dy, 2.0 * xs_bar * dz
    # the implicit term
    sgn = torch.where(dzs == 0.0, -1.0, torch.where(dzs > 0.0, 1.0, -1.0))
    slope = torch.where(torch.abs(dzs) > 1e-6, dzs, sgn)
    w = -dz_bar / slope
    terms = (-dx_bar - w * dxs, -dy_bar - w * dys, -dz_bar - w * dzs, -w,
             None, g * r, s_bar * nx, s_bar * ny, s_bar * nz)
    dp = torch.zeros(16, dtype=torch.float32)
    for k, term in enumerate(terms):
        dp[k] = g.sum() if term is None else torch.where(hit, term, 0.0).sum()
    return dp


def _jax_bwd_ad(v, ts, g, n):
    """The reference's _sdf_bwd_kernel_ad over the whole image in one
    tile, in interpret mode."""
    nd = (n, STEPS, 1.2, n, None, 0, 16, jnp.float32, 1, 1.0, False, 0)
    (dp,) = _sdf_vjp_bwd(*nd, (jnp.asarray(v), jnp.asarray(ts)),
                         jnp.asarray(g), kernel=_sdf_bwd_kernel_ad)
    return np.asarray(dp)


def _assert_three_routes_agree(v, ts, g, n):
    # the reference's gate for the two backward routes
    # (tests/test_pallas.py:376-377): rtol 2e-4, atol 2e-4 * scale
    dp_j = _jax_bwd_ad(v, ts, g, n)
    args = (torch.from_numpy(v), torch.from_numpy(g), torch.from_numpy(ts), n)
    dp_r = reverse_sweep(*args).numpy()
    dp_p = sdf_bwd_ad_plain(*args).numpy()
    scale = max(1.0, np.abs(dp_j).max())
    np.testing.assert_allclose(dp_r, dp_j, rtol=2e-4, atol=2e-4 * scale)
    np.testing.assert_allclose(dp_r, dp_p, rtol=2e-4, atol=2e-4 * scale)
    assert (dp_r[9:] == 0).all()
    return dp_r


@pytest.mark.parametrize("n", [64, 65])
@pytest.mark.parametrize("shift", [0.0, 10.0], ids=["mixed", "all_miss"])
def test_reverse_sweep_matches_jax_kernel_and_plain(scene_vec, shift, n):
    v = scene_vec.copy()
    v[0] += shift
    ts = sdf_fwd_plain(torch.from_numpy(v), n, STEPS, 1.2)[1].numpy()
    assert shift == 0.0 or (ts < 0).all()
    dp = _assert_three_routes_agree(v, ts, _g(n), n)
    if shift:
        # every pixel a miss: only d ambient, the sum of g
        assert (dp[:4] == 0).all() and (dp[5:] == 0).all()


def _special_pixels(case, v, n):
    """(params, ts, g) where g is 1 on a few hit pixels and 0 elsewhere:
    "grazing" pixels at which d sdf / dt is exactly 0 (dz = 0), or a few
    1e-7 either side of it, so that the implicit term's guard decides the
    slope; a "tie" pixel at which the lambert term is exactly 0, max(y,
    0)'s subgradient 0.5 (the light along x and px == cx exactly)."""
    v = v.copy()
    px = tile_pixels(n, 1.2, "cpu")[0][0].numpy()
    ts = np.full((n, n), -1.5, np.float32)
    g = np.zeros((n, n), np.float32)
    col, row = (3 * n) // 4, (2 * n) // 3
    if case == "grazing":
        one = np.float32(1.0) + np.float32(v[2])  # -1 + t - cz == 0
        for k, t in enumerate((one, one + np.float32(2.0 ** -22),
                               one - np.float32(2.0 ** -22))):
            ts[row, col + k] = t
            g[row, col + k] = 1.0
    else:
        # a power-of-two column: col * step is exact, so the reference,
        # whose compiler may fuse col * step - extent, has the same px
        col = 32
        v[0] = px[col]
        v[6:9] = [1.0, 0.0, 0.0]
        ts[row, col] = 0.5
        g[row, col] = 1.0
    return v, ts, g


@pytest.mark.parametrize("n", [64, 65])
@pytest.mark.parametrize("case", ["grazing", "tie"])
def test_reverse_sweep_at_the_guard_and_the_relu_tie(scene_vec, case, n):
    v, ts, g = _special_pixels(case, scene_vec, n)
    args = (torch.from_numpy(v), torch.from_numpy(g), torch.from_numpy(ts), n)
    dp = _assert_three_routes_agree(v, ts, g, n)
    if case == "tie":
        # the 0.5 subgradient itself: either side of it is far off
        for slope in (0.0, 1.0):
            other = reverse_sweep(*args, tie_slope=slope).numpy()
            assert not np.allclose(other, dp, rtol=2e-4, atol=2e-4)
    else:
        # the three pixels' slopes are all inside the guard
        pv = args[0]
        dz = (-1.0 + args[2]) - pv[2]
        assert (dz[g > 0].abs() < 1e-6).all()


def _header_constant(name, source="pixel_sum.cuh"):
    text = (_build.CSRC_DIR / source).read_text()
    return int(re.search(rf"{name} = (\d+)", text).group(1))


@pytest.mark.parametrize("n", [1, 64, 257, 1000, 1024])
@pytest.mark.parametrize("threads,pixels", [
    ("shipped", "shipped"), ("sphere", "sphere"), (128, 2), (128, 4),
    (128, 8), (256, 2), (256, 8)])
def test_pixel_sum_layout_covers_the_image_once(n, threads, pixels):
    # pixel_sum.cuh's map from (row, segment, thread, chunk, element) to a
    # column, with the SDF pair's and sphere_bwd's shipped geometries and
    # others that the header's formula must cover as well
    if threads == "shipped":
        threads = _header_constant("kPixelSumThreads")
        pixels = _header_constant("kPixelSumPixels")
    elif threads == "sphere":
        threads = _header_constant("kSphereSumThreads", "sphere_render.cu")
        pixels = _header_constant("kSphereSumPixels", "sphere_render.cu")
    vec = min(pixels, 4)
    segment = threads * pixels
    segments = (n + segment - 1) // segment
    seg, t, j, e = np.meshgrid(np.arange(segments), np.arange(threads),
                               np.arange(pixels // vec), np.arange(vec),
                               indexing="ij")
    chunk0 = seg * segment + (j * threads + t) * vec
    col = chunk0 + e
    # the scalar route: every column < n once in each row
    np.testing.assert_array_equal(np.bincount(col[col < n], minlength=n),
                                  np.ones(n, np.int64))
    if n % 4 == 0:
        # the vector route: a chunk is wholly inside the row or past it
        inside = chunk0 < n
        assert (col[inside] < n).all() and (col[~inside] >= n).all()
        assert (chunk0 % vec == 0).all()
    # the blocks' rows are one per (row, segment); the grid is n x segments
    assert segments * n == n * (-(-n // segment))
