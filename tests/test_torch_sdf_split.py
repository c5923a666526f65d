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
    CONT_FROZEN, EPS, T_MAX, SDFRender, _cone_t0, _const, _dist_len,
    _march_parts, _shade, march_counts, render_sdf_cuda, sdf_bwd,
    sdf_bwd_ad_plain, sdf_bwd_plain, sdf_fwd_plain, sdf_fwd_split_list,
    sdf_fwd_split_list_plain, sdf_fwd_split_plain, sdf_split,
    sdf_split_plain, sdf_tail, sdf_tail_plain, survivor_entries, survivors,
    tile_pixels)

from test_torch_cuda import SCENES, scene_vec as _scene_vec
from test_torch_render import assert_within_eps_band, ts_parts

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
    want, ts_j = _sdf_fwd_call(jnp.asarray(v), N, STEPS, 1.2, TILE, None,
                               coarse, 16, jnp.float32, 1, 1.0, False, split)
    got = render_sdf_cuda(torch.from_numpy(v), N, STEPS, 1.2, TILE, None,
                          coarse, 16, torch.float32, 1, 1.0, False,
                          split).numpy()
    p = torch.from_numpy(v)
    img_s, ts_t = sdf_split_plain(p, N, STEPS, 1.2, split, _t0(p, coarse))
    # the stops come from the same march as the image under test
    np.testing.assert_array_equal(img_s.numpy().view(np.int32),
                                  got.view(np.int32))
    # no flip, and 2e-4 (tests/test_pallas.py:498-507) off the band of
    # stops within eps that XLA's CPU rsqrt moves
    assert_within_eps_band(got, want, ts_parts(ts_t.numpy()),
                           ts_parts(ts_j), atol=2e-4)


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


# -- the survivor list of pass 1 and the tail over it ----------------------


@pytest.mark.parametrize("split,coarse", SPLITS)
def test_the_list_form_holds_exactly_the_survivors(scene_vec, split,
                                                   coarse):
    p = torch.from_numpy(scene_vec)
    t0 = _t0(p, coarse)
    img, ts, cont, pairs, counters = sdf_fwd_split_list_plain(p, N, split,
                                                              1.2, t0)
    for a, b in zip((img, ts, cont), sdf_fwd_split_plain(p, N, split, 1.2,
                                                         t0)):
        assert torch.equal(a, b)
    idx, z = survivor_entries(pairs, counters)
    want = survivors(cont)
    assert idx.dtype == torch.int32 and torch.equal(idx.long(), want)
    assert torch.equal(z, cont.reshape(-1)[want]) and (z > -1e8).all()
    assert counters.tolist() == [want.numel(), 0]
    assert pairs.shape == (N * N, 2) and (pairs[want.numel():] == 0).all()
    # the wrapper on the CPU takes the plain list, and the tail over it
    # finishes the one-pass render
    got = sdf_fwd_split_list(p, N, split, 1.2, t0)
    assert all(torch.equal(a, b) for a, b in zip(got, (img, ts, cont,
                                                       pairs, counters)))
    sdf_tail(p, pairs, counters, img, ts, N, STEPS, split, 1.2)
    one = sdf_fwd_plain(p, N, STEPS, 1.2, t0)
    assert torch.equal(img, one[0]) and torch.equal(ts, one[1])


def test_the_tail_over_an_empty_list_leaves_pass_1s_image():
    v = _scene_vec(None)
    v[0] = 50.0   # off screen: every ray escapes within a few steps
    p = torch.from_numpy(v)
    img, ts, cont, pairs, counters = sdf_fwd_split_list_plain(p, 64, 16)
    assert counters.tolist() == [0, 0]
    img1, ts1 = img.clone(), ts.clone()
    sdf_tail(p, pairs, counters, img, ts, 64, STEPS, 16, 1.2)
    assert torch.equal(img, img1) and torch.equal(ts, ts1)


def _tail_schedule(p, pairs, counters, img, ts, n, n_steps, split, extent,
                   n_warps, refill_below, steps_per_trip, order):
    """A model of the sdf_tail kernels' loops on ``n_warps`` warps of 32
    lanes: lane j of the grid first takes list slot j. With
    ``refill_below`` None (the shipped kernel) each lane marches to the end
    and takes the slot a grid's lanes further on. Else (the refill
    schedules chip_smoke.py times beside it) each
    outer trip of a warp marches (with ``refill_below`` 1, every busy lane
    to its end; else ``steps_per_trip`` steps at a time while all lanes, at
    least ``refill_below`` of them, or once the list is drained any of
    them, are busy), writes the pixels of the marches that ended, and
    refills its idle lanes from the work counter, whose slots start past
    the grid's lanes. The warps take their trips in the order ``order``
    returns. Returns how many times each pixel was written."""
    count, work, lanes = int(counters[0]), 0, 32 * n_warps
    coords = tile_pixels(n, extent, "cpu")[0][0]
    n_tail = n_steps - split
    writes = torch.zeros(n * n, dtype=torch.int64)
    f = dict(dtype=torch.float32)
    warps = [dict(busy=torch.zeros(32, dtype=torch.bool),
                  ended=torch.zeros(32, dtype=torch.bool),
                  i=torch.zeros(32, dtype=torch.int64),
                  z=torch.zeros(32, **f), s=torch.zeros(32, **f),
                  k=torch.zeros(32, dtype=torch.int64),
                  rxy2=torch.ones(32, **f), px=torch.zeros(32, **f),
                  py=torch.zeros(32, **f), drained=lanes >= count,
                  done=False)
             for _ in range(n_warps)]
    _, z0, rad = _march_parts(p, coords[:1], coords[:1], torch.float32)
    eps = _const(EPS, z0)
    s_hit, esc = rad + eps, _const(T_MAX, z0) + z0 + rad

    def take(w, lanes_of, slots):
        new = lanes_of[slots < count]
        ent = pairs[slots[slots < count]]
        i = ent[:, 0].long()
        row = torch.div(i, n, rounding_mode="floor")
        w["i"][new] = i
        w["z"][new] = ent[:, 1].view(torch.float32)
        w["px"][new], w["py"][new] = coords[i - row * n], coords[row]
        w["rxy2"][new] = _march_parts(p, w["px"][new], w["py"][new],
                                      torch.float32)[0]
        w["k"][new] = -1
        w["busy"][new] = True

    all_lanes = torch.arange(32)
    for g, w in enumerate(warps):
        w["slot"] = 32 * g + all_lanes
        take(w, all_lanes, w["slot"])

    def step(w):
        b = w["busy"]
        s = _dist_len(w["rxy2"][b], w["z"][b])
        alive = (s >= s_hit) & (w["z"][b] + s <= esc)
        stop = (w["k"][b] >= n_tail - 1) | ~alive
        w["s"][b] = s
        z = w["z"][b]
        w["z"][b] = torch.where(stop, z, z + (s - rad))
        w["k"][b] += (~stop).long()
        lanes_b = b.nonzero().reshape(-1)
        w["busy"][lanes_b[stop]] = False
        w["ended"][lanes_b[stop]] = True

    def going(w):
        busy = int(w["busy"].sum())
        if w["drained"] or refill_below in (None, 1):
            return busy > 0
        return busy >= refill_below

    while not all(w["done"] for w in warps):
        for w in order(warps):
            if w["done"]:
                continue
            if not w["busy"].any():
                w["done"] = True
                continue
            while True:
                for _ in range(steps_per_trip if refill_below else 1):
                    step(w)
                if not going(w):
                    break
            e = w["ended"]
            hit = (w["s"][e] - rad) < eps
            im, t = _shade(p, w["px"][e], w["py"][e], w["z"][e] - z0, hit)
            img.view(-1)[w["i"][e]] = im
            ts.view(-1)[w["i"][e]] = t
            writes[w["i"][e]] += 1
            w["ended"] = torch.zeros_like(e)
            idle = (~w["busy"]).nonzero().reshape(-1)
            if refill_below is None:
                w["slot"] = w["slot"] + lanes
                take(w, idle, w["slot"][idle])
                w["drained"] = not w["busy"].any()
            elif idle.numel() and not w["drained"]:
                base = lanes + work
                work += idle.numel()
                w["drained"] = base + idle.numel() >= count
                take(w, idle, base + torch.arange(idle.numel()))
    return writes


@pytest.mark.parametrize("refill_below,steps_per_trip", [
    (None, 1), (32, 2), (32, 4), (16, 2), (1, 1)],
    ids=["strided", "any_idle_2", "any_idle_4", "half_idle_2", "whole_warp"])
@pytest.mark.parametrize("n_warps", [3, 64])
def test_the_tail_schedule_marches_each_survivor_once(refill_below,
                                                      steps_per_trip,
                                                      n_warps):
    # a small grid refills many times; a large one holds every survivor
    # in its first, static round. The warps take turns in a seeded order,
    # as the card's run in none; every order must give the one-pass render
    n = 64
    p = torch.from_numpy(_scene_vec(2))
    img, ts, cont, pairs, counters = sdf_fwd_split_list_plain(p, n, 16)
    k = int(counters[0])
    assert 32 * 3 < k < 32 * 64
    # the card's list comes in the order of its blocks' atomics
    perm = torch.from_numpy(np.random.default_rng(5).permutation(k))
    pairs[:k] = pairs[:k][perm]
    rng = np.random.default_rng(n_warps + (refill_below or 0)
                                + steps_per_trip)

    def order(ws):
        return [ws[j] for j in rng.permutation(len(ws))]

    writes = _tail_schedule(p, pairs, counters, img, ts, n, STEPS, 16, 1.2,
                            n_warps, refill_below, steps_per_trip, order)
    live = torch.zeros(n * n, dtype=torch.int64)
    live[survivors(cont)] = 1
    assert torch.equal(writes, live)
    one = sdf_fwd_plain(p, n, STEPS, 1.2)
    assert torch.equal(img, one[0]) and torch.equal(ts, one[1])


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
