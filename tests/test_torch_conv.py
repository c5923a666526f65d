"""The type-conversion matrix of the port (twin of tests/test_conv.py,
which mirrors the reference's tests/conv.cpp) on the CPU.

Each dtype converts to every other and back, exactly on values that both
hold (conv.cpp:25), with mask and bool conversions (conv.cpp:50-58): the
eager route is ``Tensor.to``, the lazy one the trace's CAST opcode on a
CPU ``trace.LazyArray``, and both are held to ``enoki_tpu``'s eager
``astype`` and its lazy CAST. The dtypes are the reference's 32-bit lane
set with float16; uint32 is ``torch.uint32`` (PyTorch converts it, and
the port's ops take it, docs/port.md).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enoki_tpu.trace as J
import enoki_tpu_torch.trace as P
from enoki_tpu.ops.router import reinterpret as jreinterpret
from enoki_tpu_torch.ops.router import reinterpret

# (torch dtype, jnp dtype)
DTYPES = [(torch.float32, jnp.float32), (torch.int32, jnp.int32),
          (torch.uint32, jnp.uint32), (torch.bfloat16, jnp.bfloat16),
          (torch.float16, jnp.float16)]
IDS = ["float32", "int32", "uint32", "bfloat16", "float16"]

# values exactly representable in every dtype above
SMALL = np.array([0, 1, 2, 3, 100, 255], np.float64)


@pytest.fixture(autouse=True)
def _fresh():
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()


def _f64(t):
    return t.to(torch.float64).numpy()


@pytest.mark.parametrize("d1,d2", list(itertools.product(DTYPES, DTYPES)),
                         ids=[f"{a}-{b}" for a, b in
                              itertools.product(IDS, IDS)])
def test_conv_roundtrip(d1, d2):
    (t1, j1), (t2, j2) = d1, d2
    x = torch.from_numpy(SMALL).to(t1)
    rt = x.to(t2).to(t1)
    assert rt.dtype == t1
    np.testing.assert_array_equal(_f64(rt), SMALL)
    # the lazy CAST agrees with the eager conversion and the reference's
    lrt = P.LazyArray(x).cast(t2).cast(t1)
    assert lrt.dtype == t1
    np.testing.assert_array_equal(_f64(lrt.torch()), SMALL)
    jrt = J.LazyArray(jnp.asarray(SMALL, j1)).cast(j2).cast(j1)
    np.testing.assert_array_equal(np.asarray(jrt.numpy(), np.float64),
                                  SMALL)
    one_way = P.LazyArray(x).cast(t2).torch()
    assert torch.equal(one_way, x.to(t2))


@pytest.mark.parametrize("d", DTYPES, ids=IDS)
def test_mask_select_per_dtype(d):
    # conv.cpp:30-38: a one-hot mask selects one of n, eager and lazy
    t, j = d
    x = torch.from_numpy(SMALL).to(t)
    lx = P.LazyArray(x)
    for i in range(len(SMALL)):
        want = (np.arange(len(SMALL)) == i).astype(np.float64)
        m = torch.arange(len(SMALL)) == i
        out = torch.where(m, torch.ones_like(x), torch.zeros_like(x))
        np.testing.assert_array_equal(_f64(out), want)
        lm = P.LazyArray.arange(len(SMALL), device="cpu") == i
        lout = P.select(lm, lx * 0 + 1, lx * 0)
        assert lout.dtype == t
        np.testing.assert_array_equal(_f64(lout.torch()), want)


def test_bool_conv():
    # bool -> numeric -> bool (conv.cpp:58-66), eager and lazy
    m = np.array([True, False, True, True])
    x = torch.from_numpy(m)
    np.testing.assert_array_equal(x.to(torch.int32).numpy(),
                                  m.astype(np.int32))
    np.testing.assert_array_equal(x.to(torch.float32).to(torch.bool).numpy(),
                                  m)
    lm = P.LazyArray(m, device="cpu")
    li = lm.cast(torch.int32)
    np.testing.assert_array_equal(li.numpy(), m.astype(np.int32))
    np.testing.assert_array_equal(li.cast(torch.bool).numpy(), m)
    np.testing.assert_array_equal(lm.cast(torch.uint32).bool().numpy(), m)
    np.testing.assert_array_equal(
        li.numpy(), J.LazyArray(m).cast(jnp.int32).numpy())


def test_float_to_int_truncates():
    # C++ conversion semantics: float -> int truncates toward zero
    v = np.array([1.9, -1.9, 0.5, -0.5], np.float32)
    x = torch.from_numpy(v)
    np.testing.assert_array_equal(x.to(torch.int32).numpy(), [1, -1, 0, 0])
    lx = P.LazyArray(v, device="cpu")
    np.testing.assert_array_equal(lx.cast(torch.int32).numpy(),
                                  [1, -1, 0, 0])
    np.testing.assert_array_equal(lx.to(torch.int32).numpy(),
                                  J.LazyArray(v).cast(jnp.int32).numpy())


def test_reinterpret_roundtrip():
    # memcpy_cast: f32 <-> u32 bit roundtrip, eager and lazy
    v = np.array([1.0, -2.5, 0.0, np.inf], np.float32)
    bits = reinterpret(torch.from_numpy(v), torch.uint32)
    back = reinterpret(bits, torch.float32)
    np.testing.assert_array_equal(back.numpy(), v)
    np.testing.assert_array_equal(
        bits.view(torch.int32).numpy().view(np.uint32),
        np.asarray(jreinterpret(jnp.asarray(v), jnp.uint32)))

    lv = P.LazyArray(v, device="cpu")
    lbits = reinterpret(lv, torch.uint32)
    np.testing.assert_array_equal(lbits.numpy(), v.view(np.uint32))
    np.testing.assert_array_equal(lbits.bitcast(torch.float32).numpy(), v)
    np.testing.assert_array_equal(lv.view(torch.uint32).numpy(),
                                  lbits.numpy())
    with pytest.raises(TypeError):
        lv.bitcast(torch.bfloat16)  # a narrowing bitcast is refused


def test_f16_lazy_roundtrip_and_bitcast():
    """float16 on the trace (half.h:29 over the lazy backend): literal,
    cast, math and same-itemsize bitcast f16 <-> bf16."""
    v = np.array([0.5, 1.0, -2.0, 100.0], np.float16)
    lx = P.LazyArray(v, device="cpu")
    assert lx.dtype == torch.float16
    y = lx * 2.0 + 1.0
    assert y.dtype == torch.float16
    np.testing.assert_array_equal(y.numpy(), v * np.float16(2) + np.float16(1))
    lz = P.LazyArray.literal(-0.0, 3, torch.float16, device="cpu")
    assert lz.torch().view(torch.int16).numpy().view(np.uint16).tolist() \
        == [0x8000] * 3
    lb = lx.bitcast(torch.bfloat16)
    assert lb.dtype == torch.bfloat16
    np.testing.assert_array_equal(lb.bitcast(torch.float16).numpy(), v)
    s = P.sqrt(P.LazyArray(np.array([4.0, 9.0], np.float16), device="cpu"))
    assert s.dtype == torch.float16
    np.testing.assert_array_equal(s.numpy(),
                                  np.sqrt(np.array([4, 9], np.float16)))


def test_lazy_to_refuses_a_device():
    lx = P.LazyArray(np.ones(2, np.float32), device="cpu")
    with pytest.raises(TypeError, match="device"):
        lx.to("cpu")
