"""The port's struct layer (enoki_tpu_torch.struct) against the reference's
gates (tests/test_struct.py, all but the enum-array test, which
tests/test_torch_types.py covers) and against enoki_tpu.struct on the same
seeded numpy inputs; and fault C7: the render structs are pytrees with the
reference's leaves.

Tolerances: none. Every helper and dispatcher is data movement or IEEE
arithmetic on the same values, so results are compared exactly, dtype
included. The calls example's materials are exact too: ``glossy`` writes
``s ** 8`` as jnp's integer_pow computes it (three squarings), and XLA's
flush of a subnormal s^8 to 0 vanishes in 0.1 + s^8 * base * 1.5.
``scene_rays``' material ids are exact at 256^2; its n . l within 1e-4
(XLA contracts px*px + py*py into an FMA, and sqrt(1 - r2) amplifies that
near the silhouette).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import enoki_tpu.struct as JS
from enoki_tpu_torch.struct import (
    InstanceRegistry, concat_structs, detach, dispatch_masked,
    dispatch_partition, dispatch_switch, enoki_struct,
    gather_struct, masked, scatter_struct, select_struct, set_slice_struct,
    slice_struct, vectorize, vectorize_wrapper, width, zeros_like)
import enoki_tpu_torch.struct as S

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


def t(x, dtype=None):
    return torch.tensor(x, dtype=dtype)


@enoki_struct
class Pt:
    x: torch.Tensor
    y: torch.Tensor


# -- the reference's gates (tests/test_struct.py) ----------------------------


def test_struct_basics():
    p = Pt(torch.arange(4.0), torch.arange(4.0) * 10)
    assert width(p) == 4
    z = zeros_like(p)
    assert torch.equal(z.x, torch.zeros(4))
    s = slice_struct(p, 2)
    assert float(s.x) == 2 and float(s.y) == 20
    # a pytree: tree_map and vmap work
    moved = pytree.tree_map(lambda l: l + 1, p)
    assert torch.equal(moved.x, t([1.0, 2, 3, 4]))
    v = torch.func.vmap(lambda q: Pt(q.x + 1, q.y * 2))(p)
    assert isinstance(v, Pt) and torch.equal(v.y, p.y * 2)


def test_struct_gather_scatter():
    p = Pt(torch.arange(4.0), torch.arange(4.0) * 10)
    g = gather_struct(p, t([2, 0]))
    assert g.x.tolist() == [2, 0] and g.y.tolist() == [20, 0]
    dst = zeros_like(p)
    out = scatter_struct(dst, g, t([1, 3]))
    assert out.x.tolist() == [0, 2, 0, 0]
    m = t([True, False])
    out = scatter_struct(dst, g, t([1, 3]), mask=m)
    assert out.x.tolist() == [0, 2, 0, 0]
    assert out.y.tolist() == [0, 20, 0, 0]


def test_select_and_concat():
    a = Pt(torch.zeros(3), torch.zeros(3))
    b = Pt(torch.ones(3), torch.ones(3))
    m = t([True, False, True])
    s = select_struct(m, b, a)
    assert s.x.tolist() == [1, 0, 1]
    c = concat_structs(a, b)
    assert width(c) == 6


def test_masked_idioms():
    x = t([1.0, 2.0, 3.0])
    m = t([True, False, True])
    assert masked(x, m).assign(9.0).tolist() == [9, 2, 9]
    assert masked(x, m).add(1.0).tolist() == [2, 2, 4]
    assert masked(x, m).mul(2.0).tolist() == [2, 2, 6]


def test_detach_stops_gradient():
    x = torch.ones(3, requires_grad=True)
    torch.sum(detach(x * 2.0) * x).backward()
    assert x.grad.tolist() == [2, 2, 2]  # only the second factor


def test_vectorize():
    def f(a, b):
        return a * b + 1.0

    out = vectorize(f, torch.arange(4.0), torch.arange(4.0))
    assert out.tolist() == [1, 2, 5, 10]
    with pytest.raises(ValueError):
        vectorize(f, torch.arange(4.0), torch.arange(5.0))
    out = vectorize(f, torch.arange(4.0), torch.ones(1))  # size 1 broadcasts
    assert out.tolist() == [1, 2, 3, 4]
    # jit is accepted and the call is eager
    assert vectorize(f, torch.arange(4.0), torch.ones(1), jit=False).tolist() \
        == [1, 2, 3, 4]
    assert S.vectorize_safe(f, torch.arange(2.0), torch.ones(2)).tolist() == \
        [1, 2]


def test_vectorize_wrapper():
    wide = vectorize_wrapper(lambda a, b: a + b)
    assert wide(torch.arange(3.0), torch.arange(3.0)).tolist() == [0, 2, 4]


def _f_double(mask, x):
    return x * 2.0


def _f_square(mask, x):
    return x * x


def _f_neg(mask, x):
    return -x


FUNCS = [_f_double, _f_square, _f_neg]


def test_dispatch_masked():
    ids = t([0, 1, 2, 0, 1], torch.int32)
    x = t([1.0, 2.0, 3.0, 4.0, 5.0])
    assert dispatch_masked(FUNCS, ids, x).tolist() == [2, 4, -3, 8, 25]


def test_dispatch_partition_matches_masked():
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 3, 257).astype(np.int32))
    x = torch.from_numpy(rng.normal(size=257).astype(np.float32))
    a = dispatch_masked(FUNCS, ids, x)
    b = dispatch_partition(FUNCS, ids, x)
    assert torch.equal(a, b)  # the reference asks allclose; it is exact


def test_dispatch_switch():
    x = t([1.0, 2.0])
    out = dispatch_switch([lambda m, v: v * 2, lambda m, v: v * v],
                          t(1, torch.int32), x)
    assert out.tolist() == [1, 4]
    got = dispatch_switch([lambda m, v: torch.where(m, v, -1.0)],
                          t(0, torch.int32), x)
    assert torch.equal(got, x)  # the mask is all-true and broadcasts
    # lax.switch clamps the index into range
    assert dispatch_switch([lambda m, v: v, lambda m, v: -v], 7, x).tolist() \
        == [-1, -2]


class Shape:
    def __init__(self, scale):
        self.scale = scale

    def eval(self, mask, x):
        return x * self.scale


def test_instance_registry():
    reg = InstanceRegistry()
    reg.register(Shape(2.0))
    reg.register(Shape(-1.0))
    ids = t([0, 1, 0], torch.int32)
    x = t([1.0, 2.0, 3.0])
    assert reg.dispatch("eval", ids, x).tolist() == [2, -2, 6]
    assert reg.dispatch("eval", ids, x, strategy="partition").tolist() == \
        [2, -2, 6]
    scales = reg.getter("scale", ids)
    assert scales.tolist() == [2, -1, 2] and scales.dtype == torch.float32
    with pytest.raises(ValueError):
        reg.dispatch("eval", ids, x, strategy="sorted")


def test_dispatch_inside_grad():
    # the reference runs it under jit and grad; the port is eager, on the
    # tape
    ids = t([0, 1, 1, 0], torch.int32)
    x = t([1.0, 2.0, 3.0, 4.0]).requires_grad_(True)
    out = torch.sum(dispatch_masked([_f_double, _f_square], ids, x))
    assert out.item() == 2 + 4 + 9 + 8
    out.backward()
    assert x.grad.tolist() == [2, 4, 6, 2]


def test_dispatch_partition_default_not_scrambled():
    funcs = [lambda m, x: x + 10.0, lambda m, x: x + 20.0]
    ids = t([2, -1, 0], torch.int32)  # 2 and -1 match no func
    x = t([1.0, 2.0, 3.0])
    default = t([100.0, 200.0, 300.0])
    a = dispatch_masked(funcs, ids, x, default=default)
    b = dispatch_partition(funcs, ids, x, default=default)
    assert a.tolist() == [100.0, 200.0, 13.0]
    assert torch.equal(a, b)


def test_registry_getter_null_ids():
    class Mat:
        def __init__(self, s):
            self.scale = t(s)

    reg = InstanceRegistry()
    reg.register(Mat(5.0))
    reg.register(Mat(7.0))
    assert reg.getter("scale", t([1, -1, 0])).tolist() == [7.0, 0.0, 5.0]


def test_dispatch_auto_picks_by_instance_count(monkeypatch):
    from enoki_tpu_torch.struct import call as C

    picked = []
    orig_m, orig_p = C.dispatch_masked, C.dispatch_partition
    monkeypatch.setattr(C, "dispatch_masked", lambda *a, **k:
                        picked.append("masked") or orig_m(*a, **k))
    monkeypatch.setattr(C, "dispatch_partition", lambda *a, **k:
                        picked.append("partition") or orig_p(*a, **k))

    class Inst:
        def __init__(self, c):
            self.c = float(c)

        def eval(self, m, x):
            return x * self.c

    x = torch.arange(12, dtype=torch.float32)
    small = C.InstanceRegistry()
    for i in range(3):
        small.register(Inst(i + 1))
    ids = torch.from_numpy((np.arange(12) % 3).astype(np.int32))
    out = small.dispatch("eval", ids, x)
    np.testing.assert_array_equal(out.numpy(),
                                  np.arange(12) * (np.arange(12) % 3 + 1))
    assert picked[-1] == "masked"

    big = C.InstanceRegistry()
    k = C._AUTO_PARTITION_MIN_K
    assert k == 16  # the reference's value
    for i in range(k):
        big.register(Inst(i + 1))
    ids = torch.from_numpy((np.arange(12) % k).astype(np.int32))
    out = big.dispatch("eval", ids, x)
    np.testing.assert_array_equal(out.numpy(),
                                  np.arange(12) * (np.arange(12) % k + 1))
    assert picked[-1] == "partition"
    small.dispatch("eval", torch.zeros(4, dtype=torch.int32), x[:4],
                   strategy="partition")
    assert picked[-1] == "partition"


def test_vectorize_wrapper_mixed_scalar_args():
    wide = vectorize_wrapper(lambda a, b: a + b)
    assert wide(torch.arange(3.0), 2.0).tolist() == [2.0, 3.0, 4.0]
    # size 1 broadcasts as a scalar (not a (1,)-shaped packet)
    assert wide(torch.arange(3.0), torch.ones(1)).tolist() == [1.0, 2.0, 3.0]
    # an all-scalar call is a plain call
    assert float(wide(1.0, 2.0)) == 3.0


# -- parity with enoki_tpu.struct on seeded inputs -------------------------


@JS.enoki_struct
class JPt:
    x: jnp.ndarray
    k: jnp.ndarray


@enoki_struct
class TPt:
    x: torch.Tensor
    k: torch.Tensor


def pts(seed, n=1 << 10, dtype=np.float32):
    """The same struct on both sides: (port, reference), a float leaf with
    signed zeros and NaN and an int32 leaf."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(dtype)
    x[:4] = [0.0, -0.0, np.nan, np.inf]
    k = rng.integers(-100, 100, n).astype(np.int32)
    return (TPt(torch.from_numpy(x.copy()), torch.from_numpy(k.copy())),
            JPt(jnp.asarray(x), jnp.asarray(k)))


def same(port, ref, ulp=0):
    """Leaves equal bit for bit, dtype and signed zeros included (within
    ``ulp`` units in the last place, where given); a NaN equals a NaN
    whatever its payload (XLA makes 0x7FC00000, PyTorch's CPU keeps the
    sign and payload it computed)."""
    lp, lr = pytree.tree_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(lp) == len(lr)
    for a, b in zip(lp, lr):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
        if a.dtype.kind == "f":
            nan = np.isnan(a)
            np.testing.assert_array_equal(nan, np.isnan(b))
            a, b = (np.where(nan, 0, v).view(f"i{v.itemsize}") for v in (a, b))
            if ulp:  # same sign: the bit patterns' distance in ulp
                assert np.abs(a.astype(np.int64) - b).max() <= ulp
                continue
        np.testing.assert_array_equal(a, b)


def rng_index(seed, n, m, lo=0):
    return np.random.default_rng(seed).integers(lo, m, n).astype(np.int32)


def rng_mask(seed, n):
    return np.random.default_rng(seed).random(n) < 0.5


HELPERS = {
    "zeros_like": lambda M, a, b, i, m: M.zeros_like(a),
    "full_like float": lambda M, a, b, i, m: M.full_like(a, 2.5),
    "full_like int": lambda M, a, b, i, m: M.full_like(a, -3),
    "select_struct": lambda M, a, b, i, m: M.select_struct(m, a, b),
    "gather_struct": lambda M, a, b, i, m: M.gather_struct(a, i),
    "gather_struct masked": lambda M, a, b, i, m: M.gather_struct(a, i, m),
    "scatter_struct": lambda M, a, b, i, m: M.scatter_struct(
        M.zeros_like(a), M.gather_struct(b, i), i),
    "scatter_struct masked": lambda M, a, b, i, m: M.scatter_struct(
        M.zeros_like(a), M.gather_struct(b, i), i, m),
    "slice_struct": lambda M, a, b, i, m: M.slice_struct(a, 5),
    "slice_struct negative": lambda M, a, b, i, m: M.slice_struct(a, -1),
    "set_slice_struct": lambda M, a, b, i, m: M.set_slice_struct(
        a, 7, M.slice_struct(b, 3)),
    "concat_structs": lambda M, a, b, i, m: M.concat_structs(a, b, a),
    "detach": lambda M, a, b, i, m: M.detach(a),
}


@pytest.mark.parametrize("name", list(HELPERS))
def test_helper_matches_the_reference(name):
    n = 1 << 10
    (a, ja), (b, jb) = pts(1, n), pts(2, n)
    # unique indices, so that which lane a scatter keeps is defined
    idx = np.random.default_rng(3).permutation(n).astype(np.int32)[:n // 2]
    m = rng_mask(4, n // 2) if "masked" in name else rng_mask(4, n)
    got = HELPERS[name](S, a, b, torch.from_numpy(idx), torch.from_numpy(m))
    want = HELPERS[name](JS, ja, jb, jnp.asarray(idx), jnp.asarray(m))
    same(got, want)


def test_width_matches_the_reference():
    (a, ja) = pts(1, 37)
    assert width(a) == JS.width(ja) == 37
    assert width(slice_struct(a, 0)) == JS.width(JS.slice_struct(ja, 0)) == 1
    assert width(()) == JS.width(()) == 0


@pytest.mark.parametrize("dtypes", [("int32", "float32"), ("bool", "int32"),
                                    ("float16", "float32"),
                                    ("int8", "uint8"), ("bfloat16", "float32")])
def test_concat_structs_promotes_as_jnp_concatenate(dtypes):
    pieces = [np.arange(3).astype(d if d != "bfloat16" else np.float32)
              for d in dtypes]
    tp = [torch.from_numpy(p).to(getattr(torch, d)) for p, d in
          zip(pieces, dtypes)]
    jp = [jnp.asarray(p).astype(getattr(jnp, d)) for p, d in
          zip(pieces, dtypes)]
    got = concat_structs(*(TPt(x, x) for x in tp))
    want = JS.concat_structs(*(JPt(x, x) for x in jp))
    assert str(got.x.dtype).replace("torch.", "") == str(want.x.dtype)
    np.testing.assert_array_equal(got.x.float().numpy(),
                                  np.asarray(want.x).astype(np.float32))


def test_set_slice_struct_leaves_its_input_unchanged():
    a, _ = pts(5, 16)
    before = pytree.tree_map(torch.clone, a)
    b = set_slice_struct(a, 3, slice_struct(zeros_like(a), 0))
    assert float(b.x[3]) == 0 and int(b.k[3]) == 0
    assert all(torch.equal(u, v, ) or (u.isnan() == v.isnan()).all()
               for u, v in zip(pytree.tree_leaves(a),
                               pytree.tree_leaves(before)))
    assert torch.equal(a.k, before.k)


MASKED = ["assign", "add", "sub", "mul", "div", "min", "max"]


@pytest.mark.parametrize("op", MASKED)
def test_masked_matches_the_reference(op):
    rng = np.random.default_rng(6)
    x = rng.normal(size=1 << 10).astype(np.float32)
    v = rng.normal(size=1 << 10).astype(np.float32)
    x[:6] = [0.0, -0.0, np.nan, 1.0, 0.0, -0.0]
    v[:6] = [-0.0, 0.0, 1.0, np.nan, 0.0, -0.0]
    m = rng.random(1 << 10) < 0.7
    got = getattr(masked(torch.from_numpy(x), torch.from_numpy(m)), op)(
        torch.from_numpy(v))
    want = getattr(JS.masked(jnp.asarray(x), jnp.asarray(m)), op)(
        jnp.asarray(v))
    same(got, want)
    # a Python operand takes the tensor's dtype, as a weak type does
    got = getattr(masked(torch.from_numpy(x), torch.from_numpy(m)), op)(0.5)
    want = getattr(JS.masked(jnp.asarray(x), jnp.asarray(m)), op)(0.5)
    same(got, want)


NUMBER_DTYPES = {"float32": (torch.float32, jnp.float32),
                 "float16": (torch.float16, jnp.float16),
                 "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", list(NUMBER_DTYPES))
@pytest.mark.parametrize("v", [3.0, 0.1])
@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "min", "max"])
def test_masked_by_a_python_number_matches_the_reference(op, v, dtype):
    # C11: the reference's eager x / 3.0 is an IEEE division; 1/3 and 0.1
    # have no exact reciprocal or float32 value, so a product with the
    # reciprocal, or a 16-bit op on the float32 number, shows
    tdt, jdt = NUMBER_DTYPES[dtype]
    rng = np.random.default_rng(16)
    x = rng.normal(size=1 << 16).astype(np.float32)
    m = rng.random(1 << 16) < 0.7
    got = getattr(masked(torch.from_numpy(x).to(tdt), torch.from_numpy(m)),
                  op)(v)
    want = getattr(JS.masked(jnp.asarray(x).astype(jdt), jnp.asarray(m)),
                   op)(v)
    assert str(got.dtype) == f"torch.{want.dtype}"
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    assert np.array_equal(g.view(np.int32), w.view(np.int32)), \
        int((g != w).sum())


def _ids_and_args(seed, n=1 << 12, k=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, k + 1, n).astype(np.int32)  # nulls and past k
    x = rng.normal(size=n).astype(np.float32)
    y = rng.integers(-50, 50, n).astype(np.int32)
    default = rng.normal(size=n).astype(np.float32)
    return ids, x, y, default


def _funcs(mod):
    """Callees of a struct result over a float and an int32 argument."""
    where = torch.where if mod is S else jnp.where

    def pair(P, f, g):
        return lambda m, x, y: P(f(x, y), g(x, y))

    P = TPt if mod is S else JPt
    return [pair(P, lambda x, y: x * 2.0, lambda x, y: y + 1),
            pair(P, lambda x, y: x * x - 1.0, lambda x, y: y * y),
            lambda m, x, y: P(where(m, x, -x), y - 7)]


@pytest.mark.parametrize("dispatcher", ["dispatch_masked",
                                        "dispatch_partition"])
@pytest.mark.parametrize("with_default", [False, True])
def test_dispatcher_matches_the_reference(dispatcher, with_default):
    ids, x, y, d = _ids_and_args(7)
    kw_t = dict(default=TPt(torch.from_numpy(d),
                            torch.from_numpy(-np.abs(ids)))) \
        if with_default else {}
    kw_j = dict(default=JPt(jnp.asarray(d), jnp.asarray(-np.abs(ids)))) \
        if with_default else {}
    got = getattr(S, dispatcher)(_funcs(S), torch.from_numpy(ids),
                                 torch.from_numpy(x), torch.from_numpy(y),
                                 **kw_t)
    want = getattr(JS, dispatcher)(_funcs(JS), jnp.asarray(ids),
                                   jnp.asarray(x), jnp.asarray(y), **kw_j)
    same(got, want)


@pytest.mark.parametrize("uid", [0, 1, 2, -3, 9])
def test_dispatch_switch_matches_the_reference(uid):
    # lax.switch compiles its branches, and XLA contracts callee 1's
    # x * x - 1.0 into an FMA: within the roundings of the product and the
    # difference, 2^-23 * (x^2 + 1), there; the eager callee exactly
    _, x, y, _ = _ids_and_args(8, 64)
    got = dispatch_switch(_funcs(S), torch.tensor(uid, dtype=torch.int32),
                          torch.from_numpy(x), torch.from_numpy(y))
    want = JS.dispatch_switch(_funcs(JS), jnp.int32(uid), jnp.asarray(x),
                              jnp.asarray(y))
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    d = np.abs(got.x.numpy().astype(np.float64) - np.asarray(want.x))
    assert (d <= 2.0 ** -23 * (x.astype(np.float64) ** 2 + 1)).all()
    eager = _funcs(JS)[min(max(uid, 0), 2)](jnp.bool_(True), jnp.asarray(x),
                                            jnp.asarray(y))
    same(got, eager)


@pytest.mark.parametrize("k", [3, 16])
def test_registry_matches_the_reference(k):
    class Inst:
        def __init__(self, c, lib):
            self.c = float(c)
            self.w = lib(c - 2.5)

        def eval(self, m, x):
            return x * self.c + 1.0

    treg, jreg = S.InstanceRegistry(), JS.InstanceRegistry()
    for i in range(k):
        treg.register(Inst(i + 1, lambda v: torch.tensor(v,
                                                         dtype=torch.float32)))
        jreg.register(Inst(i + 1, jnp.float32))
    ids, x, _, _ = _ids_and_args(9, 1 << 11, k)
    ti, ji = torch.from_numpy(ids), jnp.asarray(ids)
    same(treg.getter("w", ti), jreg.getter("w", ji))
    same(treg.getter("c", ti), jreg.getter("c", ji))
    same(treg.stack("c", CPU), jreg.stack("c"))
    for strategy in ("auto", "masked", "partition"):
        same(treg.dispatch("eval", ti, torch.from_numpy(x),
                           strategy=strategy),
             jreg.dispatch("eval", ji, jnp.asarray(x), strategy=strategy))


def test_vectorize_wrapper_matches_jax_vmap():
    rng = np.random.default_rng(10)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = rng.normal(size=3).astype(np.float32)

    def lane_t(u, v):
        return torch.sum(u * v) + torch.sqrt(torch.abs(u[0]))

    def lane_j(u, v):
        return jnp.sum(u * v) + jnp.sqrt(jnp.abs(u[0]))

    got = vectorize_wrapper(lane_t)(torch.from_numpy(a),
                                    torch.from_numpy(b[None]))
    want = JS.vectorize_wrapper(lane_j)(jnp.asarray(a), jnp.asarray(b[None]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7,
                               atol=1e-7)


# -- examples/calls_torch.py -------------------------------------------------


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  REPO / "examples" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def calls():
    return _load("calls_torch"), _load("calls")


def test_calls_materials_match_the_reference(calls):
    CT, CJ = calls
    rng = np.random.default_rng(11)
    s = rng.uniform(-0.2, 1.0, 1 << 14).astype(np.float32)
    s[:5] = [0.0, -0.0, 1.0, 1e-6, 0.999999]  # s^8 of 1e-6 is subnormal
    base = rng.uniform(0.0, 100.0, 1 << 14).astype(np.float32)
    for mt, mj in zip(CT.MATERIALS, CJ.MATERIALS):
        same(mt(None, torch.from_numpy(s), torch.from_numpy(base)),
             mj(None, jnp.asarray(s), jnp.asarray(base)))


def test_calls_scene_and_dispatch_match_the_reference(calls):
    CT, CJ = calls
    n = 256
    ids_t, ndl_t, base_t = CT.scene_rays(n, CPU)
    ids_j, ndl_j, base_j = CJ.scene_rays(n)
    same(ids_t, ids_j)
    same(base_t, base_j)
    np.testing.assert_allclose(ndl_t.numpy(), np.asarray(ndl_j), rtol=0,
                               atol=1e-4)
    # on the reference's own inputs, both dispatchers bit for bit against
    # the reference's eager dispatch; its jitted shade_masked contracts
    # glossy's product and sum into an FMA (1 ulp)
    args = [torch.from_numpy(np.array(v)) for v in (ids_j, ndl_j, base_j)]
    want = JS.dispatch_masked(CJ.MATERIALS, ids_j, ndl_j, base_j)
    same(CT.shade_masked(*args), want)
    same(CT.shade_partition(*args), want)
    same(CT.shade_masked(*args), CJ.shade_masked(ids_j, ndl_j, base_j),
         ulp=1)


def test_calls_example_runs_small_on_the_cpu(calls, capsys):
    CT, _ = calls
    t_m, t_p = CT.main(64, CPU, iters=2, windows=1)
    assert t_m > 0 and t_p > 0
    assert "masked == partition (bit for bit): True" in capsys.readouterr().out


# -- fault C7: the render structs are pytrees ---------------------------------


def _render_structs():
    """(name, port value, reference value) of each render struct, from
    one seeded numpy draw."""
    import enoki_tpu.render as JR
    import enoki_tpu_torch.render as TR
    v = np.random.default_rng(12).normal(size=(12, 4)).astype(np.float32)

    def tv(*rows):
        return TR.Vec3(*(torch.from_numpy(v[r]) for r in rows))

    def jv(*rows):
        return JR.Vec3(*(jnp.asarray(v[r]) for r in rows))

    sc = [np.float32(s) for s in v[:, 0]]
    out = {
        "Vec2": (TR.Vec2(torch.from_numpy(v[0]), torch.from_numpy(v[1])),
                 JR.Vec2(jnp.asarray(v[0]), jnp.asarray(v[1]))),
        "Vec3": (tv(0, 1, 2), jv(0, 1, 2)),
        "Ray": (TR.Ray(tv(0, 1, 2), tv(3, 4, 5)),
                JR.Ray(jv(0, 1, 2), jv(3, 4, 5))),
    }
    for name in ("SphereScene", "SDFScene"):
        def scene(mod, f, V):
            return getattr(mod, name)(
                center=V(f(sc[0]), f(sc[1]), f(sc[2])), radius=f(sc[3]),
                ambient=f(sc[4]), gain=f(sc[5]),
                light=V(f(sc[6]), f(sc[7]), f(sc[8])))
        out[name] = (scene(TR, torch.tensor, TR.Vec3),
                     scene(JR, jnp.float32, JR.Vec3))
    return out


@pytest.mark.parametrize("name", ["Vec2", "Vec3", "Ray", "SphereScene",
                                  "SDFScene"])
def test_render_structs_flatten_as_the_reference(name):
    port, ref = _render_structs()[name]
    same(port, ref)  # count, order and values of the leaves
    leaves, spec = pytree.tree_flatten(port)
    assert len(leaves) == {"Vec2": 2, "Vec3": 3, "Ray": 6,
                           "SphereScene": 9, "SDFScene": 9}[name]
    back = pytree.tree_unflatten(leaves, spec)
    assert type(back) is type(port)
    # the treespec can be written to disk and read back
    assert pytree.treespec_loads(pytree.treespec_dumps(spec)) == spec


def test_render_structs_map_through_the_helpers():
    from enoki_tpu_torch.render import SphereScene, Vec3
    s = SphereScene.reference(CPU)
    z = zeros_like(s)
    assert isinstance(z, SphereScene) and isinstance(z.light, Vec3)
    assert all(float(l) == 0 for l in pytree.tree_leaves(z))
    assert len(pytree.tree_leaves(SphereScene.reference(CPU))) == len(
        jax.tree_util.tree_leaves(
            __import__("enoki_tpu.render", fromlist=["x"]).SphereScene
            .reference()))
