"""The port's lazy histogram and lazy fit examples against the reference's
(examples/lazy_histogram_torch.py against examples/lazy_histogram.py,
examples/lazy_fit_torch.py against examples/lazy_fit.py) on the CPU.

Each pair runs the same program on the same inputs: the port's through
its plain interpreter, the reference's through ``enoki_tpu.trace``. The
histogram's counts are equal at 4096 samples and each probit value agrees
under the reference's erfinv gate; the fit's first loss and gradients at
the initial guess agree, and at 64^2, where the two examples take the
same step, so do its first steps and where its 40 steps end. The lazy
sphere's twin is in tests/test_torch_lazy_struct.py.
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import enoki_tpu.trace as J
import enoki_tpu_torch.trace as P
from enoki_tpu.ops.special import erfinv as j_erfinv
from enoki_tpu.types.random import PCG32 as JPCG32

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _fresh():
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()


def _reference_histogram(n, H):
    """examples/lazy_histogram.py's program (its main, less the printing):
    the probit values and the counts."""
    u, _ = JPCG32.create_lazy(n).next_float32()
    g = j_erfinv(2.0 * u - 1.0) * float(np.sqrt(2.0))
    idx = ((g - H.LO) * (H.BINS / (H.HI - H.LO))).cast(np.int32)
    hist = J.LazyArray(np.zeros(H.BINS, np.float32))
    hist.scatter_add(J.clamp(idx, 0, H.BINS - 1), J.LazyArray.full(1.0, n))
    return g.numpy(), hist.numpy()


def test_lazy_histogram_example_matches_the_reference_example():
    """At 4096 samples, as tests/test_examples.py runs the reference's:
    each probit value within the reference's erfinv gate (rtol 1e-6,
    atol 1e-7, tests/test_lazy_ops.py's ``_agree``), and the counts
    equal but for samples within 1 ulp of a bin edge on either side
    (none at this size)."""
    H = _example("lazy_histogram_torch")
    n = 4096
    ref_g, ref_counts = _reference_histogram(n, H)
    g = H.probit(n, "cpu").numpy()
    np.testing.assert_allclose(g, ref_g, rtol=1e-6, atol=1e-7)

    counts = H.histogram(n, "cpu").numpy()
    assert counts.dtype == ref_counts.dtype and float(counts.sum()) == n
    scale = np.float32(H.BINS / (H.HI - H.LO))
    edges = (np.arange(1, H.BINS, dtype=np.float32) / scale
             + np.float32(H.LO))
    near = np.zeros(n, bool)
    for v in (g, ref_g):
        gap = np.abs(v[:, None] - edges[None, :]).min(axis=1)
        near |= gap <= np.spacing(np.abs(v))
    assert int(near.sum()) == 0
    np.testing.assert_array_equal(counts, ref_counts)


def _reference_fit(R, n, steps):
    """examples/lazy_fit.py's loop (its main, less the printing) for
    ``steps`` steps: each step's loss and gradients, and the parameters
    after the last step."""
    true = (0.12, -0.08, 0.85)
    target = R._render(*(J.LazyArray.full(v, 1) for v in true), n).eval()
    p = np.array([0.0, 0.0, 1.0], np.float32)
    lr = np.array([4e-6, 4e-6, 2e-6], np.float32)
    losses, grads = [], []
    for _ in range(steps):
        J.clear_gradients()
        params = [J.requires_grad(J.LazyArray(p[i:i + 1])) for i in range(3)]
        diff = R._render(*params, n) - target
        loss = (diff * diff).hsum() * (1.0 / (n * n))
        J.backward(loss)
        g = np.array([J.gradient(q).numpy()[0] for q in params], np.float32)
        p = p - lr * g * n * n / 4096.0
        losses.append(float(loss.numpy()[0]))
        grads.append(g)
    return losses, grads, p


def _port_fit(F, n, steps):
    grads = []

    def hook(k, loss, params):
        return lambda gs: grads.append(np.array([float(v[0]) for v in gs],
                                                np.float32))

    out = F.fit(n, steps, "cpu", hook=hook)
    return out["losses"], grads, out["params"]


@pytest.mark.parametrize("n", [64, 128])
def test_lazy_fit_first_step_matches_the_reference_example(n):
    """The loss and the gradients at the initial guess, before the two
    examples' steps can differ: the loss within rtol 1e-6, each gradient
    within 2e-5 of the largest (a few pixels at the silhouette, where the
    square root's slope is steep, carry the differences of order)."""
    R, F = _example("lazy_fit"), _example("lazy_fit_torch")
    assert tuple(F.INIT) == (0.0, 0.0, 1.0)
    assert tuple(F.TRUE) == (0.12, -0.08, 0.85)
    ref_losses, ref_grads, _ = _reference_fit(R, n, 1)
    losses, grads, _ = _port_fit(F, n, 1)
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-6)
    g, want = grads[0], ref_grads[0]
    assert np.all(np.abs(g - want) <= 2e-5 * np.abs(want).max()), (g, want)


def test_lazy_fit_follows_the_reference_trajectory_at_64():
    """At 64^2 the port's step is the reference's (n^2 / 4096 = 1, under
    the cap), so the two fits follow one path. The first five losses agree
    within rtol 1e-3; later a silhouette pixel that one side counts as
    covered and the other not moves a loss by a whole pixel's share
    (about 1 % from the seventh step on), so the paths are held by where
    they end: after the example's 40 steps, the parameters within 1e-4 of
    the reference's. Both losses fall at every step of the first ten."""
    R, F = _example("lazy_fit"), _example("lazy_fit_torch")
    ref_losses, _, ref_p = _reference_fit(R, 64, 40)
    losses, _, p = _port_fit(F, 64, 40)
    np.testing.assert_allclose(losses[:5], ref_losses[:5], rtol=1e-3)
    np.testing.assert_allclose(p, ref_p, atol=1e-4)
    for ls in (losses, ref_losses):
        assert all(b < a for a, b in zip(ls[:10], ls[1:10])), ls
        assert ls[-1] < 0.2 * ls[0]


@pytest.mark.parametrize("n", [64, 256])
def test_lazy_fit_falls_at_every_step(n):
    """The capped rate: the loss falls at every step of ten at 64^2 and
    256^2 (above 64^2 the reference's uncapped step oscillates), and ends
    below 0.2 of the first."""
    F = _example("lazy_fit_torch")
    losses = F.fit(n, 10, "cpu")["losses"]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < 0.2 * losses[0]
