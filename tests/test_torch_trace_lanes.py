"""The trace's ops that read other lanes, where the plain interpreter
(enoki_tpu_torch/trace/plain.py) met a dtype or a sign of zero that
PyTorch handles apart from the reference, held against enoki_tpu.trace
and enoki_tpu.ops on the CPU (chip_smoke.py phase 28 (b)'s lane sweep
holds every storage code through every such op card against CPU):

* a uint64 PSUM and COMPRESS (PyTorch has no uint64 cumsum or index_put_;
  the bits go through int64, and the reference runs under x64);
* a prefix sum whose leading lanes are -0.0 gives +0.0 there, as XLA's
  scan from +0.0 does (the card's scan started from the first lane);
* a 16-bit float SCATTER_ADD keeps -0.0 in a slot whose base is -0.0 and
  which nothing but -0.0 reaches (PyTorch's CUDA index_add_ adds two
  16-bit slots at a time, +0.0 into the neighbour);
* a SCATTER_ADD into a bool target is refused (TypeError), as JAX refuses
  ``x.at[i].add`` of a bool array.

Gates: exact, dtype and the sign of zero included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enoki_tpu.ops as JO
import enoki_tpu.trace as J
import enoki_tpu_torch.trace as P
from enoki_tpu_torch.ops import horiz

U64 = np.array([1, 2 ** 63, 5, 2 ** 64 - 1, 7, 0, 2 ** 62 + 3], np.uint64)
MASK = np.array([True, False, True, True, False, True, False])


@pytest.fixture(autouse=True)
def _fresh():
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()


def bits(a):
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.dtype.itemsize])


@pytest.mark.parametrize("op", ["psum", "compress", "reverse", "hsum",
                                "hprod", "hmin", "hmax"])
def test_uint64_lane_ops_match_the_reference(op):
    def run(mod, **kw):
        x = mod.LazyArray(U64, **kw)
        if op == "compress":
            return x.compress(mod.LazyArray(MASK, **kw))[0].numpy()
        return getattr(x, op)().numpy()

    with jax.enable_x64():
        want = np.asarray(run(J))
    got = run(P, device="cpu")
    assert got.dtype == np.uint64 and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16",
                                   "bfloat16"])
def test_a_leading_negative_zero_sums_to_positive_zero(dtype):
    x = np.array([-0.0, -0.0, 1.5, -1.5, -0.0, 2.0], np.float32)
    with jax.enable_x64(dtype == "float64"):
        jt = jnp.asarray(x).astype(dtype)
        want = np.asarray(JO.psum(jt),
                          np.float32 if dtype == "bfloat16" else None)
        lazy_want = np.asarray(J.LazyArray(jt).psum().numpy())
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    got = horiz.psum(t).float().numpy() if dtype == "bfloat16" \
        else horiz.psum(t).numpy()
    lazy = P.LazyArray(t).psum().torch()
    lazy = lazy.float().numpy() if dtype == "bfloat16" else lazy.numpy()
    want = want.astype(got.dtype)
    assert np.array_equal(bits(got), bits(want))
    assert np.array_equal(bits(lazy), bits(lazy_want.astype(got.dtype)))
    assert not np.signbit(got[:2]).any()


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_a_16_bit_scatter_add_keeps_negative_zero(dtype):
    # slots 0-3 have the bases -0.0, -0.0, +0.0, -0.0; slot 0 gets -0.0
    # alone (it stays -0.0), slot 1 gets +0.0 (+0.0), slot 2 gets -0.0
    # (+0.0), slot 3 nothing (-0.0); slots 4-5 get numbers
    base = np.array([-0.0, -0.0, 0.0, -0.0, 1.0, -2.0], np.float32)
    idx = np.array([0, 1, 2, 4, 5, 0, 5], np.int32)
    val = np.array([-0.0, 0.0, -0.0, 0.25, 3.0, -0.0, -0.5], np.float32)
    want = np.array([-0.0, 0.0, 0.0, -0.0, 1.25, 0.5], np.float32)
    t = P.LazyArray(torch.from_numpy(base).to(getattr(torch, dtype)))
    t.scatter_add(P.LazyArray(idx, device="cpu"),
                  P.LazyArray(torch.from_numpy(val).to(getattr(torch,
                                                               dtype))))
    got = t.torch().float().numpy()
    r = J.LazyArray(jnp.asarray(base).astype(dtype))
    r.scatter_add(J.LazyArray(idx), J.LazyArray(jnp.asarray(val).astype(
        dtype)))
    ref = np.asarray(r.numpy(), np.float32)
    assert np.array_equal(bits(got), bits(want))
    assert np.array_equal(bits(ref), bits(want))


def test_a_bool_scatter_add_is_refused_as_the_reference_refuses_it():
    t = J.LazyArray(np.zeros(4, bool))
    t.scatter_add(J.LazyArray(np.array([1], np.int32)),
                  J.LazyArray(np.array([True])))
    with pytest.raises(TypeError, match="bool"):
        t.numpy()
    J.reset()
    p = P.LazyArray(np.zeros(4, bool), device="cpu")
    with pytest.raises(TypeError, match="bool"):
        p.scatter_add(P.LazyArray(np.array([1], np.int32), device="cpu"),
                      P.LazyArray(np.array([True]), device="cpu"))
    # an overwrite SCATTER of a bool target is JAX's too
    p.scatter(P.LazyArray(np.array([1], np.int32), device="cpu"),
              P.LazyArray(np.array([True]), device="cpu"))
    assert p.numpy().tolist() == [False, True, False, False]
