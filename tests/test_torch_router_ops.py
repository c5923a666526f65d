"""The rest of the port's ops/router.py against the reference's, on the
same seeded numpy inputs: constructors, fused arithmetic, bit operations,
sign and range helpers, predicates, safe math, layout and the packet
helpers.

Gates: exact (values and dtype, uint32 <-> torch.uint32) for integer,
bit, sign, select, layout and mask results, and for ``sqrt`` and ``rcp``
(both correctly rounded); within 1 ulp where XLA may contract ``a*b+c``
into an FMA (the fmadd family, ``lerp``, ``cross``); within 2 ulp for the
reciprocal square root of ``safe_rsqrt`` and for ``safe_asin`` /
``safe_acos`` (the reference's CPU rsqrt, asin and acos are up to 2 ulp
from the correctly rounded value, which the port gives). The ``safe_*``
gradients equal ``jax.grad`` at the listed points and are finite
everywhere. ``isdenormal`` gives the IEEE answer where the reference's
CPU backend flushes f32 subnormals (a deliberate difference).
"""

import ast
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enoki_tpu import ops as J
from enoki_tpu.ops import horiz as JH, router as JR
from enoki_tpu_torch import ops as T
from enoki_tpu_torch.ops import horiz as TH, router as TR

REPO = pathlib.Path(__file__).resolve().parents[1]
WIDTHS = [1, 3, 31, 32, 127, 1000]
INT_DTYPES = [np.int8, np.int16, np.int32, np.uint8, np.uint16, np.uint32]
# the edge-value table of tests/test_op_validation.py
SAMPLES = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -2.0,
                    1e-3, -1e-3, 1e20, -1e20, 3.14159, -2.71828,
                    np.inf, -np.inf, np.nan, 65504.0, 2e-38], np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    """A tensor, a JAX array or a number as numpy, with its dtype."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.detach().numpy()
    return np.asarray(x)


def _dtype(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def _ulps(a, b):
    """Distance in units in the last place of float32 (or float16)."""
    a, b = np.asarray(a), np.asarray(b)
    it = {2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize]

    def ordered(v):
        i = v.view(it).astype(np.int64)
        return np.where(i < 0, np.iinfo(it).min - i, i)
    return np.abs(ordered(a) - ordered(b))


def same(got, want, ulp=0, ftz=False):
    """Equal dtype and shape, and values bit-equal (NaN to NaN, the sign
    of zero kept) or, for ``ulp`` > 0, within ``ulp`` units in the last
    place. ``ftz``: a result of the port below ``ftz`` in magnitude is
    compared as a zero of its sign, since the reference's CPU backend
    flushes f32 subnormals to zero (deliberate difference (i))."""
    assert _dtype(got) == _dtype(want), (_dtype(got), _dtype(want))
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if g.dtype.kind != "f":
        np.testing.assert_array_equal(g, w)
        return
    if ftz:
        g = np.where(np.abs(g) < ftz, np.copysign(np.zeros_like(g), g), g)
    both_nan = np.isnan(g) & np.isnan(w)
    assert (np.isnan(g) == np.isnan(w)).all()
    if ulp == 0:
        ok = (g == w) & (np.signbit(g) == np.signbit(w))
    else:
        ok = (g == w) | (_ulps(g, w) <= ulp)
    bad = ~(ok | both_nan)
    assert not bad.any(), (g[bad][:5], w[bad][:5])


def _floats(n, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)


def _ints(dtype, n=1000, seed=0):
    info = np.iinfo(dtype)
    edge = [0, 1, info.max, info.min, info.max - 1, 2, 3, 8, 255, 256]
    edge += [-1, -2, info.min + 1] if info.min < 0 else []
    edge = [v for v in edge if info.min <= v <= info.max]
    rng = np.random.default_rng(seed)
    body = rng.integers(info.min, int(info.max) + 1, n, dtype=np.int64)
    small = rng.integers(0, 40, n) if info.max > 40 else rng.integers(0, 2, n)
    return np.concatenate([np.array(edge), body, small]).astype(dtype)


# -- signatures --------------------------------------------------------------------


def _public(path):
    tree = ast.parse(path.read_text())
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and not n.name.startswith("_")]


def _default(v):
    """A default dtype by name (jnp.float32 and torch.float32 alike)."""
    if isinstance(v, torch.dtype):
        return str(v).replace("torch.", "")
    if isinstance(v, type) and v is not inspect.Parameter.empty:
        return np.dtype(v).name
    return v


@pytest.mark.parametrize("module,ref,path,count", [
    (TR, JR, "enoki_tpu/ops/router.py", 64),
    (TH, JH, "enoki_tpu/ops/horiz.py", 27)], ids=["router", "horiz"])
def test_every_public_function_has_the_references_signature(module, ref,
                                                             path, count):
    names = _public(REPO / path)
    assert len(names) == count
    for name in names:
        want = [(k, _default(p.default)) for k, p in
                inspect.signature(getattr(ref, name)).parameters.items()]
        got = [(k, _default(p.default)) for k, p in
               inspect.signature(getattr(module, name)).parameters.items()]
        extra = got[len(want):]
        assert got[:len(want)] == want, name
        assert extra in ([], [("device", None)]), name


def test_ops_exports_every_router_and_horiz_name_of_the_reference():
    ref = REPO / "enoki_tpu" / "ops" / "__init__.py"
    tree = ast.parse(ref.read_text())
    names = [a.name for node in tree.body if isinstance(node, ast.ImportFrom)
             and node.module in ("router", "horiz") for a in node.names]
    assert len(names) == 90
    for name in names:
        assert hasattr(T, name), name
        src = TH if hasattr(JH, name) and not hasattr(JR, name) else TR
        assert getattr(T, name) is getattr(src, name), name
    assert T.reverse is TR.reverse and T.horiz.reverse is TH.reverse


# -- constructors ------------------------------------------------------------------


@pytest.mark.parametrize("call", [
    ("zeros", (5,), {}), ("zeros", ((2, 3),), {}),
    ("zeros", (4,), {"dtype": "int32"}), ("full", (3, 7.0), {}),
    ("full", (3, 7), {}), ("full", (3, True), {}),
    ("full", ((2, 2), 1.5), {"dtype": "int32"}),
    ("full", (4, 2**32 - 1), {"dtype": "uint32"}),
    ("empty", (5,), {}), ("empty", (5,), {"dtype": "int32"}),
    ("empty", (3,), {"dtype": "float16"}), ("arange", (7,), {}),
    ("arange", (0,), {}), ("arange", (6,), {"dtype": "float32"}),
    ("arange", (6,), {"dtype": "uint32"}),
], ids=lambda c: f"{c[0]}{c[1]}{c[2].get('dtype', '')}")
def test_constructors(call):
    name, args, kw = call
    jkw = {k: jnp.dtype(v) for k, v in kw.items()}
    tkw = {k: getattr(torch, v) for k, v in kw.items()}
    same(getattr(T, name)(*args, **tkw, device="cpu"),
         getattr(J, name)(*args, **jkw))


def test_full_broadcasts_a_tensor_value():
    v = np.array([1, 2, 3], np.int16)
    same(T.full((2, 3), _t(v), device="cpu"), J.full((2, 3), jnp.asarray(v)))


# -- fused arithmetic and rcp --------------------------------------------------------

FUSED = ["fmadd", "fmsub", "fnmadd", "fnmsub", "fmaddsub", "fmsubadd"]


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("name", FUSED)
def test_fused_ops(name, n):
    a, b, c = (_floats(n, s) for s in (1, 2, 3))
    same(getattr(T, name)(_t(a), _t(b), _t(c)),
         getattr(J, name)(*map(jnp.asarray, (a, b, c))), ulp=1)


@pytest.mark.parametrize("name", ["fmaddsub", "fmsubadd"])
def test_fmaddsub_alternates_over_the_broadcast_last_axis(name):
    a = _floats(8, 4).reshape(2, 4)
    b = _floats(4, 5)
    same(getattr(T, name)(_t(a), _t(b), 1.5),
         getattr(J, name)(jnp.asarray(a), jnp.asarray(b), 1.5), ulp=1)
    # a 0-d input is one even lane, of shape (1,) as in the reference
    s = np.float32(2)
    same(getattr(T, name)(torch.tensor(s), torch.tensor(s), 2.0),
         getattr(J, name)(jnp.float32(s), jnp.float32(s), 2.0))


def test_fused_ops_gates_of_the_reference():
    a, b, c = (torch.tensor(v, dtype=torch.float32) for v in (2, 3, 4))
    assert [T.fmadd(a, b, c), T.fmsub(a, b, c), T.fnmadd(a, b, c),
            T.fnmsub(a, b, c)] == [10, 2, -2, -10]
    a, b, c = _t(np.float32([1, 1, 2, 2])), torch.full((4,), 3.0), \
        torch.ones(4)
    assert T.fmaddsub(a, b, c).tolist() == [2, 4, 5, 7]
    assert T.fmsubadd(a, b, c).tolist() == [4, 2, 7, 5]


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_rcp(dtype):
    x = np.concatenate([SAMPLES, _floats(1000, 6)]).astype(dtype)
    same(T.rcp(_t(x)), J.rcp(jnp.asarray(x)))


# -- bit operations ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", INT_DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", ["popcnt", "lzcnt", "tzcnt", "log2i"])
def test_bit_counts(name, dtype):
    x = _ints(dtype)
    same(getattr(T, name)(_t(x)), getattr(J, name)(jnp.asarray(x)))


def test_bit_counts_gates_of_the_reference():
    x = _t(np.array([0, 1, 2, 255, 2**31 - 1], np.uint32))
    assert T.popcnt(x).tolist() == [0, 1, 1, 8, 31]
    assert T.lzcnt(x).tolist() == [32, 31, 30, 24, 1]
    assert T.tzcnt(x).tolist() == [32, 0, 1, 0, 0]
    assert T.log2i(_t(np.array(8, np.uint32))).item() == 3
    assert T.popcnt(x).dtype == torch.uint32
    assert T.lzcnt(torch.tensor([1], dtype=torch.int32)).dtype == torch.int32


def test_bit_counts_of_int64_take_both_halves():
    x = torch.tensor([0, 1, -1, 2**40, -(2**63), 2**63 - 1, 3 << 50])
    v = [int(i) & (2**64 - 1) for i in x.tolist()]
    assert T.popcnt(x).tolist() == [bin(i).count("1") for i in v]
    assert T.lzcnt(x).tolist() == [64 - i.bit_length() for i in v]
    assert T.tzcnt(x).tolist() == [
        64 if i == 0 else (i & -i).bit_length() - 1 for i in v]
    assert T.log2i(x).tolist() == [i.bit_length() - 1 for i in v]
    assert T.popcnt(x).dtype == torch.int64


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int16, np.uint8,
                                   np.int8, np.uint16],
                         ids=lambda d: d.__name__)
def test_mulhi(dtype):
    a, b = _ints(dtype, seed=1), _ints(dtype, seed=2)[::-1].copy()
    same(T.mulhi(_t(a), _t(b)), J.mulhi(jnp.asarray(a), jnp.asarray(b)))


def test_mulhi_gates_of_the_reference():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    b = rng.integers(0, 2**32, 1000, dtype=np.uint32)
    want = ((a.astype(np.uint64) * b.astype(np.uint64)) >> 32).astype(
        np.uint32)
    np.testing.assert_array_equal(T.mulhi(_t(a), _t(b)).numpy(), want)
    sa = rng.integers(-2**31, 2**31, 1000).astype(np.int32)
    sb = rng.integers(-2**31, 2**31, 1000).astype(np.int32)
    want = ((sa.astype(np.int64) * sb.astype(np.int64)) >> 32).astype(
        np.int32)
    np.testing.assert_array_equal(T.mulhi(_t(sa), _t(sb)).numpy(), want)
    # a Python int takes a's dtype; 64 bits raise, as in the reference
    same(T.mulhi(_t(a[:5]), 3), J.mulhi(jnp.asarray(a[:5]), 3))
    with pytest.raises(NotImplementedError):
        T.mulhi(torch.tensor([1]), torch.tensor([2]))


@pytest.mark.parametrize("dtype", INT_DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", ["ror", "rol"])
def test_rotate(name, dtype):
    x = _ints(dtype)
    k = np.random.default_rng(3).integers(-40, 70, x.size).astype(dtype)
    same(getattr(T, name)(_t(x), _t(k)),
         getattr(J, name)(jnp.asarray(x), jnp.asarray(k)))
    # a negative Python k does not fit an unsigned dtype in the reference
    for s in (0, 1, 5, 31, 33) + ((-3,) if np.iinfo(dtype).min else ()):
        same(getattr(T, name)(_t(x), s), getattr(J, name)(jnp.asarray(x), s))


def test_rotate_gates_of_the_reference_and_the_signed_caveat():
    x = _t(np.array([0x80000001], np.uint32))
    assert T.ror(x, 1).tolist() == [0xC0000000]
    assert T.rol(x, 1).tolist() == [0x00000003]
    # the reference shifts a signed value arithmetically: no rotation
    m2 = np.array([-2], np.int32)
    assert T.ror(_t(m2), 1).tolist() == [-1]
    same(T.ror(_t(m2), 1), J.ror(jnp.asarray(m2), 1))
    same(T.rol(_t(m2), 31), J.rol(jnp.asarray(m2), 31))
    # int64, the reference's formula at 64 bits
    v = torch.tensor([1, -2, 2**62 + 5])
    assert T.rol(v, 1).tolist() == [2, -1, -(2**63) + 10]
    assert T.ror(torch.tensor([3]), 1).tolist() == [-(2**63) + 1]


# -- sign and range helpers ------------------------------------------------------------


def _pairs():
    a, b = np.meshgrid(SAMPLES, SAMPLES)
    return a.reshape(-1), b.reshape(-1)


@pytest.mark.parametrize("name", ["sign", "abs_", "sqr"])
def test_unary_sign_helpers_on_the_edge_values(name):
    same(getattr(T, name)(_t(SAMPLES)), getattr(J, name)(jnp.asarray(SAMPLES)))


def test_sign_is_copysign_of_one():
    x = _t(np.float32([-0.0, 0.0, -np.nan, np.nan, -3.0, 2.0]))
    assert T.sign(x).tolist() == [-1, 1, -1, 1, -1, 1]
    assert torch.sign(x)[0] == 0  # hence not torch.sign


@pytest.mark.parametrize("name", ["copysign", "mulsign", "copysign_neg",
                                  "mulsign_neg"])
def test_binary_sign_helpers_on_the_edge_values(name):
    a, b = _pairs()
    same(getattr(T, name)(_t(a), _t(b)),
         getattr(J, name)(jnp.asarray(a), jnp.asarray(b)))
    # a Python float operand, and float16
    same(getattr(T, name)(1.5, _t(b)), getattr(J, name)(1.5, jnp.asarray(b)))
    h = a.astype(np.float16)
    same(getattr(T, name)(_t(h), _t(b.astype(np.float16))),
         getattr(J, name)(jnp.asarray(h), jnp.asarray(b.astype(np.float16))))


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.uint8, np.uint32],
                         ids=lambda d: d.__name__)
@pytest.mark.parametrize("name", ["sign", "abs_", "sqr", "copysign",
                                  "mulsign", "copysign_neg", "mulsign_neg"])
def test_sign_helpers_on_integers(name, dtype):
    a = _ints(dtype, 200, 4)
    b = _ints(dtype, 200, 5)[::-1].copy()
    args = (a,) if name in ("sign", "abs_", "sqr") else (a, b)
    same(getattr(T, name)(*map(_t, args)),
         getattr(J, name)(*map(jnp.asarray, args)))


def test_sign_helpers_gates_of_the_reference():
    x = _t(np.float32([-2.0, 3.0, -0.0, 0.0]))
    assert T.sign(x).tolist() == [-1, 1, -1, 1]
    assert T.copysign(torch.full((4,), 5.0), x).tolist() == [-5, 5, -5, 5]
    assert T.mulsign(_t(np.float32([1, 2, 3, 4])), x).tolist() == [
        -1, 2, -3, 4]
    s = torch.tensor([2.0, 2.0])
    assert T.copysign_neg(torch.tensor([3.0, -3.0]), s).tolist() == [-3, -3]
    assert T.mulsign_neg(torch.tensor([3.0, -3.0]), s).tolist() == [-3, 3]


@pytest.mark.parametrize("bounds", [(0.0, 2.0), (-1.5, 0.25), (2.0, -2.0),
                                    ("tensor", "tensor"), (0.5, "tensor")],
                         ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.int32],
                         ids=lambda d: d.__name__)
def test_clamp(dtype, bounds):
    x = np.concatenate([SAMPLES if dtype == np.float32 else [0, 5, -7],
                        _floats(500, 7)]).astype(dtype)
    lo_np, hi_np = -_floats(x.size, 8) ** 2, _floats(x.size, 9) ** 2
    lo, hi = bounds
    tlo = _t(lo_np) if lo == "tensor" else lo
    thi = _t(hi_np) if hi == "tensor" else hi
    jlo = jnp.asarray(lo_np) if lo == "tensor" else lo
    jhi = jnp.asarray(hi_np) if hi == "tensor" else hi
    same(T.clamp(_t(x), tlo, thi), J.clamp(jnp.asarray(x), jlo, jhi))


@pytest.mark.parametrize("n", WIDTHS)
def test_lerp(n):
    a, b = _floats(n, 10), _floats(n, 11)
    t = np.random.default_rng(n).random(n).astype(np.float32)
    t[:2] = [0.0, 1.0][:n] if n >= 2 else [0.0]
    same(T.lerp(_t(a), _t(b), _t(t)),
         J.lerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)), ulp=1)
    # exact at the endpoints
    assert T.lerp(torch.tensor(1.0), torch.tensor(3.0), 1.0) == 3.0
    assert T.lerp(torch.tensor(1.0), torch.tensor(3.0), 0.5) == 2.0


@pytest.mark.parametrize("axis,shape", [(-1, (200, 3)), (0, (3, 200)),
                                        (1, (4, 3, 5))])
def test_cross(axis, shape):
    rng = np.random.default_rng(12)
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    got = T.cross(_t(a), _t(b), axis)
    want = np.asarray(J.cross(jnp.asarray(a), jnp.asarray(b), axis))
    assert got.dtype == torch.float32 and got.shape == want.shape
    # XLA contracts one product of each a_i*b_j - a_j*b_i into an FMA: the
    # two differ by the rounding of one product, then of the difference
    pa, pb = np.moveaxis(a, axis, -1), np.moveaxis(b, axis, -1)
    mag = np.stack([np.abs(pa[..., i] * pb[..., j]) + np.abs(
        pa[..., j] * pb[..., i]) for i, j in ((1, 2), (2, 0), (0, 1))], -1)
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 2.0**-23 * np.moveaxis(mag, -1, axis)
                                 + 1e-45)


def test_cross_takes_vec3_to_cross3():
    from enoki_tpu_torch.render.vec import Vec3
    v1 = Vec3(torch.tensor([1.0]), torch.tensor([0.0]), torch.tensor([0.0]))
    v2 = Vec3(torch.tensor([0.0]), torch.tensor([1.0]), torch.tensor([0.0]))
    assert T.cross(v1, v2).z.tolist() == [1.0]
    a = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    b = torch.tensor([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    assert T.cross(a, b).tolist() == [[0, 0, 1], [1, 0, 0]]


# -- predicates --------------------------------------------------------------------


def test_isdenormal_normal_values_as_the_reference():
    x = np.concatenate([SAMPLES, _floats(100, 13)])
    same(T.isdenormal(_t(x)), J.isdenormal(jnp.asarray(x)))


def test_isdenormal_is_the_ieee_answer():
    # deliberate difference (i): XLA's CPU backend flushes f32 subnormals,
    # so the reference answers False; PyTorch and the card keep them
    x = np.float32([1e-40, -1e-45, 1e-39, 1.2e-38, 0.0])
    assert T.isdenormal(_t(x)).tolist() == [True, True, True, False, False]
    assert not bool(J.isdenormal(jnp.asarray(x)).any())
    assert T.isdenormal(torch.tensor([1e-310, 1e-300],
                                     dtype=torch.float64)).tolist() == [
        True, False]


@pytest.mark.parametrize("case", [
    ([1.0, 2.0], [1.0, 2.0 + 1e-6], {}), ([1.0], [1.1], {}),
    ([1.0, 2.0], [1.0005, 2.0], {}), ([1.0, 2.0], [1.0005, 2.0],
                                      {"rtol": 1e-5}),
    ([0.0], [2e-5], {}), ([0.0], [2e-5], {"atol": 1e-4}),
    ([np.nan], [np.nan], {}), ([np.nan], [np.nan], {"equal_nan": True}),
    ([np.inf, 1.0], [np.inf, 1.0], {}), ([1, 2], [1, 2], {}),
    ([1, 2], [1, 3], {}),
], ids=str)
def test_allclose(case):
    a, b, kw = case
    got = T.allclose(_t(np.asarray(a, np.float32 if isinstance(a[0], float)
                                   else np.int32)),
                     _t(np.asarray(b, np.float32 if isinstance(b[0], float)
                                   else np.int32)), **kw)
    want = J.allclose(jnp.asarray(a), jnp.asarray(b), **kw)
    assert type(got) is bool and got == want


def test_allclose_defaults_follow_the_dtype():
    a = torch.tensor([1.0], dtype=torch.float64)
    assert T.allclose(a, a + 1e-6)         # f64: rtol 1e-5
    assert not T.allclose(a, a + 1e-4)
    assert T.allclose(a.float(), a.float() + 1e-4)  # f32: rtol 1e-3


# -- safe math ---------------------------------------------------------------------

POINTS = [-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0]


@pytest.mark.parametrize("name", ["safe_rsqrt", "safe_asin", "safe_acos"])
def test_safe_values(name):
    x = np.concatenate([SAMPLES, _floats(2000, 14, 0.7),
                        np.float32(POINTS)])
    # the reference's asin flushes results below ~2**-125 (2e-38 -> 0)
    same(getattr(T, name)(_t(x)), getattr(J, name)(jnp.asarray(x)), ulp=2,
         ftz=2.0**-125)


@pytest.mark.parametrize("name", ["safe_rsqrt", "safe_asin", "safe_acos",
                                  "safe_sqrt"])
def test_safe_gradients_equal_jax_grad(name):
    for p in POINTS:
        x = torch.tensor(p, requires_grad=True)
        getattr(T, name)(x).backward()
        want = jax.grad(getattr(J, name))(jnp.float32(p))
        same(x.grad, want)


@pytest.mark.parametrize("name", ["safe_rsqrt", "safe_asin", "safe_acos",
                                  "safe_sqrt"])
def test_safe_gradients_are_finite_everywhere(name):
    # the edge table and the domain's edges, NaN and +-inf included
    x = np.concatenate([SAMPLES, np.float32([1e-20, -1e-30, 1 - 2**-24,
                                             -1 + 2**-24, 1.0 + 2**-23])])
    t = _t(x).requires_grad_()
    y = getattr(T, name)(t)
    y.sum().backward()
    want = jax.vmap(jax.grad(getattr(J, name)))(jnp.asarray(x))
    # safe_rsqrt's -y*y*y/2 takes y's 2 ulp three times
    same(t.grad, want, ulp=8 if name == "safe_rsqrt" else 2)
    # finite everywhere, but where the derivative itself is past float32's
    # range, as in the reference: -x**-1.5 / 2 of safe_rsqrt below ~1e-26
    beyond = ((x > 0) & (x < 1e-25) if name == "safe_rsqrt"
              else np.zeros(x.shape, bool))
    assert torch.isfinite(t.grad[~_t(beyond)]).all()
    assert not np.isfinite(np.asarray(want)[beyond]).any()
    assert torch.isfinite(y[_t(np.isfinite(x))]).all()


def test_safe_math_gates_of_the_reference():
    assert T.safe_sqrt(torch.tensor(-1.0)) == 0.0
    assert T.safe_asin(torch.tensor(2.0)).item() == pytest.approx(np.pi / 2)
    assert T.safe_acos(torch.tensor(-2.0)).item() == pytest.approx(np.pi)
    # an integer input is taken as float32, as result_type(x, 1.0) is
    same(T.safe_rsqrt(torch.tensor([4, 0], dtype=torch.int32)),
         J.safe_rsqrt(jnp.asarray([4, 0], jnp.int32)))


@pytest.mark.parametrize("dtype", [np.float32, np.float16, np.int32],
                         ids=lambda d: d.__name__)
def test_sqrt_is_correctly_rounded(dtype):
    x = np.concatenate([np.abs(_floats(20_000, 15, 100.0)), SAMPLES,
                        [2.0, 3.0, 1e-3]]).astype(dtype)
    same(T.sqrt(_t(x)), J.sqrt(jnp.asarray(x)))


def test_sqrt_and_normalize_keep_their_gradients():
    # the CPU's float64 root goes through numpy, with sqrt's own backward
    x = np.abs(_floats(1000, 18)) + 0.1
    tx = _t(x).requires_grad_(True)
    T.sqrt(tx).sum().backward()
    same(tx.grad, jax.grad(lambda v: J.sqrt(v).sum())(jnp.asarray(x)),
         ulp=1)
    v = _floats(999, 19).reshape(-1, 3)
    tv = _t(v).requires_grad_(True)
    (T.normalize(tv) * _t(v[::-1].copy())).sum().backward()
    want = jax.grad(lambda a: (J.normalize(a) * jnp.asarray(v[::-1].copy()))
                    .sum())(jnp.asarray(v))
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


# -- layout and the rest -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint32],
                         ids=lambda d: d.__name__)
@pytest.mark.parametrize("n", WIDTHS)
def test_layout(n, dtype):
    x = (_floats(n, 16) * 100).astype(dtype)
    y = (_floats(7, 17) * 100).astype(dtype)
    tx, jx = _t(x), jnp.asarray(x)
    same(T.tile(tx, 3), J.tile(jx, 3))
    same(T.repeat(tx, 2), J.repeat(jx, 2))
    same(T.reverse(tx), J.reverse(jx))
    for k in (0, 1, n // 2, n):
        same(T.head(tx, k), J.head(jx, k))
        same(T.tail(tx, k), J.tail(jx, k))
    same(T.concat(tx, _t(y), tx), J.concat(jx, jnp.asarray(y), jx))


def test_layout_on_two_axes_and_gates_of_the_reference():
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    same(T.tile(_t(x), (2, 1)), J.tile(jnp.asarray(x), (2, 1)))
    same(T.repeat(_t(x), 2), J.repeat(jnp.asarray(x), 2))
    same(T.reverse(_t(x)), J.reverse(jnp.asarray(x)))
    assert T.reverse(torch.tensor(5.0)) == 5.0
    assert T.reverse(torch.tensor([1, 2, 3])).tolist() == [3, 2, 1]
    assert T.tile(torch.tensor([1, 2]), 2).tolist() == [1, 2, 1, 2]
    assert T.repeat(torch.tensor([1, 2]), 2).tolist() == [1, 1, 2, 2]


@pytest.mark.parametrize("name", ["deg_to_rad", "rad_to_deg"])
def test_angle_conversions(name):
    x = np.concatenate([SAMPLES, _floats(1000, 18, 200.0)])
    same(getattr(T, name)(_t(x)), getattr(J, name)(jnp.asarray(x)),
         ftz=np.finfo(np.float32).tiny)


@pytest.mark.parametrize("n,width", [(0, 8), (1, 8), (23, 8), (32, 8),
                                     (100, 32)])
def test_range_packets_1d(n, width):
    got = list(T.range_packets(n, width, device="cpu"))
    want = list(J.range_packets(n, width))
    assert len(got) == len(want)
    for (gi, gm), (wi, wm) in zip(got, want):
        same(gi, wi)
        same(gm, wm)
    acc = sum(int(T.hsum(T.select(m, i, 0))) for i, m in got)
    assert acc == n * (n - 1) // 2


@pytest.mark.parametrize("n,width", [((5, 3), 4), ((1, 1), 4),
                                     ((7, 9), 16)])
def test_range_packets_2d(n, width):
    got = list(T.range_packets(n, width, dim=2, device="cpu"))
    want = list(J.range_packets(n, width, dim=2))
    assert len(got) == len(want)
    seen = np.zeros((n[1], n[0]), bool)
    for ((gx, gy), gm), ((wx, wy), wm) in zip(got, want):
        same(gx, wx)
        same(gy, wy)
        same(gm, wm)
        for a, b, keep in zip(gx.tolist(), gy.tolist(), gm.tolist()):
            if keep:
                assert not seen[b, a]
                seen[b, a] = True
    assert seen.all()
    with pytest.raises(ValueError):
        next(T.range_packets(4, 2, dim=3, device="cpu"))


@pytest.mark.parametrize("n", WIDTHS)
def test_extract(n):
    rng = np.random.default_rng(n)
    x = _floats(n, 19)
    for mask in (rng.random(n) < 0.3, np.zeros(n, bool), np.ones(n, bool)):
        same(T.extract(_t(x), _t(mask)),
             J.extract(jnp.asarray(x), jnp.asarray(mask)))
    x = np.float32([1, 2, 3, 4, 5])
    m = np.array([False, True, False, True, True])
    assert T.extract(_t(x), _t(m)).tolist() == [2.0]


def test_prefetch_is_a_no_op():
    assert T.prefetch(torch.ones(3), torch.tensor([0, 1])) is None


@pytest.mark.parametrize("n", [1, 2, 6, 100, 1000])
def test_binary_search(n):
    rng = np.random.default_rng(n)
    table = np.sort(rng.standard_normal(n)).astype(np.float32)
    q = np.concatenate([rng.standard_normal(50), [-10.0, 10.0],
                        table[:3]]).astype(np.float32)
    tt, tq = _t(table), _t(q)
    # the last trips may probe index n: the reference's indexing clamps it,
    # and so must the predicate here
    got = T.binary_search(0, n, lambda i: tt[i.long().clamp(max=n - 1)] < tq,
                          device="cpu")
    want = J.binary_search(0, n, lambda i: jnp.asarray(table)[i]
                           < jnp.asarray(q))
    same(got, want)
    np.testing.assert_array_equal(got.numpy(), np.searchsorted(table, q))


def test_binary_search_gates_of_the_reference():
    table = torch.tensor([1., 3., 5., 7., 9., 11.])
    queries = torch.tensor([0., 4., 9., 20.])
    idx = T.binary_search(0, len(table),
                          lambda i: table[i.long().clamp(max=5)] < queries,
                          device="cpu")
    assert idx.tolist() == [0, 2, 4, 6]
    # int32 indices, an empty range gives start
    seen = []
    T.binary_search(3, 20, lambda i: seen.append(i.dtype) or i < 9,
                    device="cpu")
    assert set(seen) == {torch.int32}
    same(T.binary_search(5, 5, lambda i: i < 0, device="cpu"),
         J.binary_search(5, 5, lambda i: i < 0))
