"""The two-pass split march and the autodiff-route backward of the port
(enoki_tpu_torch.render.sdf_kernels: ``sdf_split_plain``,
``sdf_bwd_ad_plain``) and the slice as a whole (``SDFRender`` with
options, trained for a few SGD steps) against the JAX reference, the
Pallas kernels in interpret mode as tests/test_pallas.py runs them. The
CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.

Tolerances are the reference's own: the split render against
``render_sdf_pallas(..., split)`` d.max < 2e-4 and no flip
(tests/test_pallas.py:498-507), and, tighter than the reference reaches,
bit-equal to the port's own one-pass render; the backward rtol 2e-4 /
atol 2e-4 * scale (:376-377); trained steps under the head-start gates
(:94-111, :168-169).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from enoki_tpu.render.pallas_kernels import (
    _sdf_bwd_kernel_ad, _sdf_fwd_call, _sdf_vjp_bwd, render_sdf_pallas)

from enoki_tpu_torch.render import LAUNCHES, reset_launch_counts
from enoki_tpu_torch.render.sdf_kernels import (
    CONT_FROZEN, SDFRender, _cone_t0, march_counts, render_sdf_cuda, sdf_bwd,
    sdf_bwd_ad_plain, sdf_bwd_plain, sdf_fwd_plain, sdf_fwd_split_plain,
    sdf_split, sdf_split_plain, sdf_tail_plain, survivors)

from test_torch_cuda import SCENES, scene_vec as _scene_vec

N = 128
TILE = 64
STEPS = 48
SPLITS = [(16, 0), (32, 0), (16, 8)]


@pytest.fixture(autouse=True)
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(params=list(SCENES), ids=list(SCENES))
def scene_vec(request):
    return _scene_vec(SCENES[request.param])


def _t0(p, coarse):
    return _cone_t0(p, N, STEPS, 1.2, coarse) if coarse else None


# -- the two-pass split march ----------------------------------------------


@pytest.mark.parametrize("split,coarse", SPLITS)
def test_split_plain_is_bit_equal_to_one_pass(scene_vec, split, coarse):
    p = torch.from_numpy(scene_vec)
    t0 = _t0(p, coarse)
    img1, ts1 = sdf_fwd_plain(p, N, STEPS, 1.2, t0)
    img2, ts2 = sdf_split_plain(p, N, STEPS, 1.2, split, t0)
    assert torch.equal(img1, img2) and torch.equal(ts1, ts2)
    # the wrapper takes the plain versions on the CPU
    img3, ts3 = sdf_split(p, N, STEPS, 1.2, split, t0)
    assert torch.equal(img1, img3) and torch.equal(ts1, ts3)


@pytest.mark.parametrize("split,coarse", SPLITS)
def test_split_matches_jax(split, coarse):
    v = _scene_vec(None)
    want = np.asarray(render_sdf_pallas(jnp.asarray(v), N, STEPS, 1.2, TILE,
                                        None, coarse, 16, jnp.float32, 1,
                                        1.0, False, split))
    got = render_sdf_cuda(torch.from_numpy(v), N, STEPS, 1.2, TILE, None,
                          coarse, 16, torch.float32, 1, 1.0, False,
                          split).numpy()
    d = np.abs(got - want)
    assert not (d > 1.0).any(), (d > 1.0).sum()
    assert d.max() < 2e-4, d.max()


def test_pass_1_flags_exactly_the_lanes_still_alive():
    p = torch.from_numpy(_scene_vec(None))
    img, ts, cont = sdf_fwd_split_plain(p, N, 16, 1.2)
    idx = survivors(cont)
    live = cont > 0.1 * CONT_FROZEN
    assert idx.dtype == torch.int64 and idx.numel() == live.sum()
    assert 0.05 < live.float().mean() < 0.5
    assert (cont[~live] == CONT_FROZEN).all()
    # a frozen lane already holds the one-pass render's values
    img1, ts1 = sdf_fwd_plain(p, N, STEPS, 1.2)
    assert torch.equal(img[~live], img1[~live])
    assert torch.equal(ts[~live], ts1[~live])
    # ... and the tail writes the survivors only, each at most
    # n_steps - 16 advances further (the replayed one included)
    sdf_tail_plain(p, idx, cont, img, ts, N, STEPS, 16, 1.2)
    adv = (march_counts(p, N, STEPS)[1] - march_counts(p, N, 16)[1])[live]
    assert adv.min() >= 1 and adv.max() <= STEPS - 16
    assert torch.equal(img, img1) and torch.equal(ts, ts1)


def test_split_renders_past_the_reference_worklist_capacity():
    # a frame zoomed onto the silhouette (extent 0.1, the sphere's edge
    # through its middle): at split=32 more lanes survive than the
    # reference's worklist holds (n*n/16), where it truncates silently;
    # the exact survivor list renders the one-pass image
    v = _scene_vec(None)
    v[0] = 1.0
    p = torch.from_numpy(v)
    cont = sdf_fwd_split_plain(p, N, 32, 0.1)[2]
    assert survivors(cont).numel() > N * N // 16
    img1, ts1 = sdf_fwd_plain(p, N, STEPS, 0.1)
    img2, ts2 = sdf_split_plain(p, N, STEPS, 0.1, 32)
    assert (ts1 >= 0).any() and (ts1 < 0).any()
    assert torch.equal(img1, img2) and torch.equal(ts1, ts2)


def test_split_with_no_survivor_skips_the_tail():
    v = _scene_vec(None)
    v[0] = 50.0   # off screen: every ray escapes within a few steps
    p = torch.from_numpy(v)
    assert survivors(sdf_fwd_split_plain(p, 64, 16, 1.2)[2]).numel() == 0
    img, ts = sdf_split(p, 64, STEPS, 1.2, 16)
    assert (img == v[4]).all() and (ts < 0).all()


@pytest.mark.parametrize("kw", [
    dict(dtype=torch.bfloat16), dict(bands=8), dict(relax=1.6),
    dict(unimodal=True), dict(split=STEPS), dict(split=STEPS + 4),
    dict(split=-2), dict(split=15)],
    ids=["bf16", "bands", "relax", "unimodal", "split_eq_steps",
         "split_gt_steps", "split_negative", "odd_tail"])
def test_split_rejects_what_the_reference_rejects(kw):
    # tests/test_pallas.py:522-530 and the assertion of :961
    p = torch.from_numpy(_scene_vec(None))
    kw = {"split": 16, **kw}
    with pytest.raises(ValueError, match="split"):
        render_sdf_cuda(p, N, STEPS, 1.2, TILE, None, 0, 16, **kw)


def test_split_checks_the_tile_as_the_one_pass_render_does():
    # the reference's split branch skips this check (:962)
    p = torch.from_numpy(_scene_vec(None))
    with pytest.raises(ValueError, match="tile"):
        render_sdf_cuda(p, N, STEPS, 1.2, 48, split=16)


# -- the autodiff-route backward -------------------------------------------


def _g(seed=7):
    return np.random.default_rng(seed).standard_normal((N, N)) \
        .astype(np.float32)


@pytest.mark.parametrize("shift", [0.0, 10.0], ids=["mixed", "all_miss"])
def test_sdf_bwd_ad_plain_matches_jax_and_the_analytic_route(scene_vec,
                                                             shift):
    v = scene_vec.copy()
    v[0] += shift
    _, ts = _sdf_fwd_call(jnp.asarray(v), N, STEPS, 1.2, TILE)
    g = _g()
    nd = (N, STEPS, 1.2, TILE, None, 8, 16, jnp.float32, 1, 1.0, False, 0)
    (dp_j,) = _sdf_vjp_bwd(*nd, (jnp.asarray(v), ts), jnp.asarray(g),
                           kernel=_sdf_bwd_kernel_ad)
    dp_j = np.asarray(dp_j)
    args = (torch.from_numpy(v), torch.from_numpy(g),
            torch.from_numpy(np.array(ts)), N, 1.2)
    dp_ad = sdf_bwd_ad_plain(*args).numpy()
    dp_an = sdf_bwd_plain(*args).numpy()
    scale = max(1.0, np.abs(dp_j).max())
    np.testing.assert_allclose(dp_ad, dp_j, rtol=2e-4, atol=2e-4 * scale)
    np.testing.assert_allclose(dp_ad, dp_an, rtol=2e-4, atol=2e-4 * scale)
    assert dp_ad.shape == (16,) and (dp_ad[9:] == 0).all()
    # the wrapper's choice of route, on the CPU
    np.testing.assert_array_equal(sdf_bwd(*args, kernel="ad").numpy(), dp_ad)
    np.testing.assert_array_equal(sdf_bwd(*args).numpy(), dp_an)


# -- the slice as a whole ---------------------------------------------------


OPTIONS = {
    "coarse8": dict(coarse=8),
    "coarse8_split16": dict(coarse=8, split=16),
    "relax1.6_unimodal_ad": dict(coarse=8, relax=1.6, unimodal=True,
                                 bwd_kernel="ad"),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_sdf_render_with_options_trains_like_jax(name):
    kw = dict(OPTIONS[name])
    bwd_kernel = kw.pop("bwd_kernel", "analytic")
    lr, steps = 1e-3, 3

    def loss(pv):
        return jnp.mean(render_sdf_pallas(
            pv, N, STEPS, 1.2, TILE, None, kw.get("coarse", 0), 16,
            jnp.float32, 1, kw.get("relax", 1.0), kw.get("unimodal", False),
            kw.get("split", 0)))

    vg = jax.value_and_grad(loss)
    model = SDFRender(torch.from_numpy(_scene_vec(1)), n=N, n_steps=STEPS,
                      device="cpu", bwd_kernel=bwd_kernel, **kw)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    reset_launch_counts()
    for _ in range(steps):
        # both sides take the step from the port's parameters
        l_j, g_j = vg(jnp.asarray(model.params.detach().numpy()))
        g_j = np.asarray(g_j)[:9]
        opt.zero_grad()
        img = model()
        img.mean().backward()
        g = model.params.grad.numpy()[:9]
        # the head-start gates: the loss moves by at most the flips' share
        # of the image range, the gradients agree to rtol 5e-2
        assert abs(img.mean().item() - float(l_j)) < 1e-3 * 100 + 5e-3
        np.testing.assert_allclose(g, g_j, rtol=5e-2,
                                   atol=2e-3 * max(1.0, np.abs(g_j).max()))
        opt.step()
    assert (model.params.detach().numpy() != _scene_vec(1)).any()
    assert all(v == 0 for v in LAUNCHES.values())  # the CPU launches none


def test_sdf_render_default_options_are_the_plain_configuration():
    v = _scene_vec(2)
    m = SDFRender(torch.from_numpy(v), n=64, n_steps=STEPS, device="cpu")
    assert m.options == dict(coarse=0, dtype=torch.float32, bands=1,
                             relax=1.0, unimodal=False, split=0,
                             bwd_kernel="analytic")
    with pytest.raises(ValueError, match="bwd_kernel"):
        SDFRender(torch.from_numpy(v), n=64, device="cpu",
                  bwd_kernel="tape")()
