"""The port's dense histogram (enoki_tpu_torch.ops.histogram) and the
histogram mini-app against the reference, on the same seeded numpy inputs,
on the CPU (where the wrapper takes the kernel's plain version).

Tolerances: a counting histogram is exact; a weighted one rtol 1e-5 /
atol 1e-4 (the reference's own gate, tests/test_histogram.py: f32 sums in
another order); the weights' gradient is exact. The mini-app's indices
agree on all but <= 1e-4 of the samples (the two packages' polynomial
``erfinv`` differ by an ulp on a few samples, which moves one that lies
within an ulp of a bin edge), and each count by at most that many."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from enoki_tpu import ops as JO
from enoki_tpu.ops import pallas_hist as JH
from enoki_tpu.types import PCG32 as JPCG32
from enoki_tpu_torch import _build, ops as TO
from enoki_tpu_torch.ops import hist_kernels as TH
from enoki_tpu_torch.types import PCG32

# the mini-app, loaded from its file (examples/ is no package)
_spec = importlib.util.spec_from_file_location(
    "histogram_torch", pathlib.Path(__file__).resolve().parent.parent
    / "examples" / "histogram_torch.py")
app = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(app)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _hist_pallas_interpret(index, bins, weights=None, rows=8):
    """The reference's ``_hist_kernel`` as ``_hist_impl`` runs it on its
    device (padding to whole tiles, bins to whole lanes), through
    ``pallas_call`` in interpret mode: the reference's own entry takes its
    fused route on a CPU backend."""
    index = jnp.asarray(index, jnp.int32).reshape(-1)
    n = index.shape[0]
    w = (jnp.ones((n,), jnp.float32) if weights is None
         else jnp.asarray(weights, jnp.float32).reshape(-1))
    pb = -(-max(bins, 128) // 128) * 128
    tile = rows * 128
    pad = tile if n == 0 else (-n) % tile
    if pad:
        index = jnp.concatenate([index, jnp.full(pad, -1, jnp.int32)])
        w = jnp.concatenate([w, jnp.zeros(pad, jnp.float32)])
    idx2d, w2d = index.reshape(-1, 128), w.reshape(-1, 128)
    spec = pl.BlockSpec((rows, 128), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(JH._hist_kernel, bins=pb),
        grid=(idx2d.shape[0] // rows,), in_specs=[spec, spec],
        out_specs=pl.BlockSpec((1, pb), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, pb), jnp.float32),
        interpret=True)(idx2d, w2d)[0]
    return np.asarray(out[:bins])


def _case(bins, n=20000, seed=7):
    rng = np.random.default_rng(seed + bins)
    idx = rng.integers(-3, bins + 6, size=n).astype(np.int32)
    w = rng.normal(size=n).astype(np.float32)
    return idx, w, (idx >= 0) & (idx < bins)


@pytest.mark.parametrize("impl", ["kernel", "fused"])
@pytest.mark.parametrize("bins", [1, 64, 129, 1000])
def test_histogram_against_the_reference(bins, impl):
    idx, w, keep = _case(bins)
    h = TO.histogram(_t(idx), bins, impl=impl)
    assert h.dtype == torch.float32 and h.shape == (bins,)
    want = np.asarray(JO.histogram(idx, bins, impl="fused"))
    assert np.array_equal(h.numpy(), want)
    assert np.array_equal(h.numpy(), np.bincount(idx[keep], minlength=bins))
    hw = TO.histogram(_t(idx), bins, _t(w), impl=impl)
    want = np.asarray(JO.histogram(idx, bins, w, impl="fused"))
    np.testing.assert_allclose(hw.numpy(), want, rtol=1e-5, atol=1e-4)
    exact = np.zeros(bins)
    np.add.at(exact, idx[keep], w[keep])
    np.testing.assert_allclose(hw.numpy(), exact, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("bins", [1, 64, 129, 1000])
def test_histogram_against_the_reference_kernel(bins):
    # the Pallas kernel itself, in interpret mode (a few tiles: the
    # interpreter walks the sequential grid step by step)
    idx, w, _ = _case(bins, n=3000)
    assert np.array_equal(TH.hist(_t(idx), bins).numpy(),
                          _hist_pallas_interpret(idx, bins))
    np.testing.assert_allclose(
        TH.hist(_t(idx), bins, _t(w)).numpy(),
        _hist_pallas_interpret(idx, bins, w), rtol=1e-5, atol=1e-4)


def test_hist_wrapper_takes_the_plain_version_on_the_cpu():
    idx, w, _ = _case(64)
    _build.reset_launch_counts()
    a = TH.hist(_t(idx), 64, _t(w))
    assert torch.equal(a, TH.hist_plain(_t(idx), 64, _t(w)))
    assert torch.equal(TH.hist(_t(idx), 64), TH.hist_plain(_t(idx), 64))
    assert not _build.LAUNCHES  # no kernel was launched
    with pytest.raises(ValueError, match="bins"):
        TH.hist(_t(idx), 0)
    with pytest.raises(ValueError, match="impl"):
        TO.histogram(_t(idx), 64, impl="xla")
    assert TH.MAX_BINS * TH.HIST_WARPS * 4 <= 232448
    # the row-per-thread route: two blocks of 256 rows fit an SM
    assert 2 * (TH.SMALL_BINS * 256 * 4 + 1024) <= 233472
    assert 64 <= TH.SMALL_BINS < TH.MAX_BINS
    assert TO.histogram is TH.histogram


@pytest.mark.parametrize("weighted", [False, True])
def test_histogram_takes_the_reference_kernel_name(weighted):
    """``impl="pallas"``, the reference's name for its kernel, is the
    kernel route here; every other unknown name raises."""
    idx, w, _ = _case(64)
    wt = _t(w) if weighted else None
    _build.reset_launch_counts()
    got = TO.histogram(_t(idx), 64, wt, impl="pallas")
    assert torch.equal(got, TO.histogram(_t(idx), 64, wt, impl="kernel"))
    assert torch.equal(got, TH.hist_plain(_t(idx), 64, wt))
    want = np.asarray(JO.histogram(idx, 64, None if wt is None else w,
                                   impl="pallas"))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    for bad in ("Pallas", "cuda", ""):
        with pytest.raises(ValueError, match="impl"):
            TO.histogram(_t(idx), 64, wt, impl=bad)


def test_histogram_weight_gradients():
    idx = np.array([0, 3, 3, 5, 63, -1, 64], np.int32)
    for impl in ("kernel", "fused"):
        w = torch.ones(7, requires_grad=True)
        TO.histogram(_t(idx), 64, w, impl=impl)[3].backward()
        g = jax.grad(lambda ww: JO.histogram(idx, 64, ww)[3])(
            jnp.ones(7, jnp.float32))
        assert np.array_equal(w.grad.numpy(), np.asarray(g))
        assert np.array_equal(w.grad.numpy(), (idx == 3).astype(np.float32))
        # dropped lanes get zero gradient
        w = torch.ones(7, requires_grad=True)
        TO.histogram(_t(idx), 64, w, impl=impl).sum().backward()
        g0 = jax.grad(lambda ww: jnp.sum(JO.histogram(idx, 64, ww)))(
            jnp.ones(7, jnp.float32))
        assert np.array_equal(w.grad.numpy(), np.asarray(g0))


def test_histogram_weight_gradient_for_a_seeded_cotangent():
    idx, w, keep = _case(64, n=5000)
    g = np.random.default_rng(1).normal(size=64).astype(np.float32)
    wt = _t(w).reshape(50, 100).requires_grad_(True)
    out = TO.histogram(_t(idx).reshape(50, 100), 64, wt)
    (gw,) = torch.autograd.grad(out, wt, _t(g))
    _, vjp = jax.vjp(lambda ww: JO.histogram(idx.reshape(50, 100), 64, ww),
                     jnp.asarray(w).reshape(50, 100))
    (want,) = vjp(jnp.asarray(g))
    assert gw.shape == (50, 100)
    assert np.array_equal(gw.numpy(), np.asarray(want))
    # a counting histogram has no gradient to give
    assert not TO.histogram(_t(idx), 64).requires_grad


def test_histogram_float_indices_are_cast():
    v = np.array([0.0, 1.0, 2.0, 1.0, 1.9, -0.5, -1.5, 3.99, 4.0],
                 np.float32)
    got = TO.histogram(_t(v), 4)
    assert np.array_equal(got.numpy(), np.asarray(JO.histogram(v, 4)))
    assert got.tolist() == [2, 3, 1, 1]
    # int64 and 2-D indices too
    idx, _, keep = _case(64, n=600)
    assert np.array_equal(
        TO.histogram(_t(idx.astype(np.int64)).reshape(20, 30), 64).numpy(),
        np.bincount(idx[keep], minlength=64))


@pytest.mark.parametrize("impl", ["kernel", "fused"])
def test_histogram_of_nothing_is_zeros(impl):
    out = TO.histogram(torch.zeros(0, dtype=torch.int32), 64, impl=impl)
    assert out.tolist() == [0.0] * 64
    assert np.array_equal(out.numpy(), _hist_pallas_interpret(
        np.zeros(0, np.int32), 64))
    out = TO.histogram(torch.zeros(0, dtype=torch.int32), 64,
                       torch.zeros(0), impl=impl)
    assert out.tolist() == [0.0] * 64


def test_histogram_all_in_one_bin():
    n = 50_000
    idx = np.full(n, 5, np.int32)
    assert TO.histogram(_t(idx), 8).tolist() == [0, 0, 0, 0, 0, n, 0, 0]
    assert np.array_equal(TO.histogram(_t(idx), 8).numpy(),
                          np.asarray(JO.histogram(idx, 8)))


# -- the mini-app ------------------------------------------------------------------


def _reference_app(gen, impl):
    u, gen = gen.next_float32()
    g = JO.erfinv(2.0 * u - 1.0, impl) * np.sqrt(2.0)
    bins = jnp.floor((g - app.LO) * (app.BINS / (app.HI - app.LO))
                     ).astype(jnp.int32)
    return bins, JO.histogram(bins, app.BINS), gen


def test_mini_app_against_the_reference():
    n = 1 << 16
    gen, jgen = PCG32.create(n, device="cpu"), JPCG32.create(n)
    budget = int(1e-4 * n)
    for _ in range(3):  # chained, as the mini-app chains its iterations
        u, _ = gen.next_float32()
        g = TO.erfinv(2.0 * u - 1.0, "poly") * np.sqrt(2.0)
        bins = app.bin_index(g)
        hist, gen = app.build_histogram(gen, "poly")
        jbins, jhist, jgen = _reference_app(jgen, "poly")
        jbins, jhist = np.asarray(jbins), np.asarray(jhist)
        assert bins.dtype == torch.int32
        # the same bin, or dropped on both sides (the port clamps a
        # dropped index to -1 or BINS)
        b = bins.numpy()
        inr, jinr = (b >= 0) & (b < 64), (jbins >= 0) & (jbins < 64)
        differ = (inr != jinr) | (inr & (b != jbins))
        assert differ.sum() <= budget
        assert np.abs(hist.numpy() - jhist).max() <= budget
        assert np.array_equal(hist.numpy(),
                              np.bincount(b[inr], minlength=64))
        assert n * 0.999 < hist.sum().item() <= n
    assert torch.equal(gen.state.v, PCG32.create(n, device="cpu")
                       .advance(3).state.v)


def test_mini_app_follows_the_normal_distribution():
    from scipy.stats import norm
    n = 1 << 18
    hist, _ = app.build_histogram(PCG32.create(n, device="cpu"))
    edges = np.linspace(-4, 4, 65)
    expect = (norm.cdf(edges[1:]) - norm.cdf(edges[:-1])) * n
    big = expect > 100
    rel = np.abs(hist.numpy()[big] - expect[big]) / expect[big]
    assert rel.max() < 0.15  # the reference's gate at this size


def test_bin_index_drops_what_lies_outside():
    g = torch.tensor([-np.inf, -4.0001, -4.0, 0.0, 3.9999, 4.0, 1e30,
                      np.inf])
    assert app.bin_index(g).tolist() == [-1, -1, 0, 32, 63, 64, 64, 64]
    # u = 0 maps to erfinv(-1) = -inf: dropped, not bin 0
    u = torch.tensor([0.0])
    g = TO.erfinv(2.0 * u - 1.0, "poly") * np.sqrt(2.0)
    assert TO.histogram(app.bin_index(g), 64).sum().item() == 0
