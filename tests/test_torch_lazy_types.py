"""The port's composite types over ``trace.LazyArray`` (twin of
tests/test_lazy_types.py) on the CPU.

Complex, Quaternion, Vec3, PCG32, Morton codes, sRGB, the SoA matrices
and transforms and the spherical harmonics instantiate over CPU
LazyArrays from the same source as over tensors: they record into the
trace (nothing runs), fuse into one program at eval, and agree with the
port's eager instantiation and with ``enoki_tpu``'s lazy one under the
reference test's gates. The lazy PCG32 is bit-exact with both. The lazy
``U64`` is one uint64 LazyArray (the eager one an int64 tensor): its bit
operations are held to numpy's uint64 arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import enoki_tpu.trace as J
import enoki_tpu_torch.trace as P
from enoki_tpu.render import vec as JV
from enoki_tpu.types import complex as JC, quaternion as JQ
from enoki_tpu_torch.render.vec import Vec3, cross3, dot3, norm3, normalize3
from enoki_tpu_torch.types import complex_ as C, quaternion as Q


@pytest.fixture(autouse=True)
def _fresh():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()
    torch.set_num_threads(n)


def _lz(a):
    return P.LazyArray(np.asarray(a, np.float32), device="cpu")


def _jz(a):
    return J.LazyArray(np.asarray(a, np.float32))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(lazy, *others, **tol):
    for o in others:
        o = o.numpy() if hasattr(o, "numpy") else np.asarray(o)
        np.testing.assert_allclose(lazy.numpy(), o, **tol)


def test_complex_lazy_matches_eager():
    re = np.linspace(-2.0, 2.0, 64).astype(np.float32)
    im = np.linspace(1.0, 3.0, 64).astype(np.float32)
    zl = C.Complex(_lz(re), _lz(im))
    ze = C.Complex.of(_t(re), _t(im))
    wl = C.exp(C.log(zl * zl + 1.0) * 0.5)
    we = C.exp(C.log(ze * ze + 1.0) * 0.5)
    zj = JC.Complex(_jz(re), _jz(im))
    wj = JC.exp(JC.log(zj * zj + 1.0) * 0.5)
    assert not wl.re.materialized  # the whole chain recorded
    evals = P.stats()["n_evals"]
    P.eval()  # a bare eval: all live variables in one program
    assert P.stats()["n_evals"] == evals + 1
    assert wl.re.materialized and wl.im.materialized
    _close(wl.re, we.re, wj.re, rtol=2e-6, atol=1e-6)
    _close(wl.im, we.im, wj.im, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["sqrt", "sin", "cos", "sinh", "cosh",
                                  "asin", "atan", "rcp", "conj"])
def test_complex_lazy_full_surface(name):
    re = np.linspace(0.3, 1.4, 32).astype(np.float32)
    im = np.linspace(-0.8, 0.9, 32).astype(np.float32)
    zl = C.Complex(_lz(re), _lz(im))
    ze = C.Complex.of(_t(re), _t(im))
    zj = JC.Complex(_jz(re), _jz(im))
    wl, we, wj = (getattr(m, name)(z) for m, z in ((C, zl), (C, ze),
                                                    (JC, zj)))
    _close(wl.re, we.re, wj.re, rtol=3e-5, atol=3e-6, err_msg=name)
    _close(wl.im, we.im, wj.im, rtol=3e-5, atol=3e-6, err_msg=name)
    if name == "sqrt":
        _close(C.abs_(zl), C.abs_(ze), JC.abs_(zj), rtol=1e-5)
        _close(C.arg(zl), C.arg(ze), JC.arg(zj), rtol=1e-5)


def test_complex_lazy_gradient():
    re = np.array([0.25, 0.5], np.float32)
    im = np.array([0.1, 0.2], np.float32)
    re_l = P.requires_grad(_lz(re))
    w = C.exp(C.Complex(re_l, _lz(im)))
    P.backward((w.re * w.re + w.im * w.im).hsum())  # = exp(2 re)
    np.testing.assert_allclose(P.gradient(re_l).numpy(),
                               2.0 * np.exp(2.0 * re), rtol=1e-5)


def test_complex_division_by_a_number_is_one_division():
    """``z / 3.0`` is one IEEE division on both routes (a literal of the
    parts' dtype lazily, a 0-d tensor eagerly), bit for bit."""
    re = np.linspace(-2.0, 2.0, 64).astype(np.float32)
    zl = C.Complex(_lz(re), _lz(re * 0.5)) / 3.0
    ze = C.Complex.of(_t(re), _t(re * 0.5)) / 3.0
    np.testing.assert_array_equal(zl.re.numpy(), ze.re.numpy())
    np.testing.assert_array_equal(zl.re.numpy(), re / np.float32(3.0))


def test_quaternion_lazy_matches_eager():
    rng = np.random.default_rng(3)
    comps = rng.normal(size=(4, 16)).astype(np.float32)
    ql = Q.Quaternion(*[_lz(c) for c in comps])
    qe = Q.Quaternion(*[_t(c) for c in comps])
    qj = JQ.Quaternion(*[_jz(c) for c in comps])
    for name in ("normalize", "exp", "sqrt", "rcp", "conj"):
        wl, we, wj = (getattr(m, name)(q) for m, q in ((Q, ql), (Q, qe),
                                                        (JQ, qj)))
        for comp in "xyzw":
            _close(getattr(wl, comp), getattr(we, comp), getattr(wj, comp),
                   rtol=3e-5, atol=3e-6, err_msg=f"{name}.{comp}")
    _close(Q.abs_(ql), Q.abs_(qe), JQ.abs_(qj), rtol=1e-5)
    wl, we = Q.log(Q.normalize(ql)), Q.log(Q.normalize(qe))
    wj = JQ.log(JQ.normalize(qj))
    for comp in "xyzw":
        _close(getattr(wl, comp), getattr(we, comp), getattr(wj, comp),
               rtol=1e-4, atol=1e-5, err_msg=f"log.{comp}")
    # to_matrix over LazyArrays is the SoA form, its entries lazy
    m = Q.to_matrix(Q.normalize(ql))
    assert isinstance(m, tuple) and isinstance(m[0][0], P.LazyArray)
    dense = Q.to_matrix(Q.normalize(qe))
    for i in range(3):
        for j in range(3):
            np.testing.assert_allclose(m[i][j].numpy(), dense[:, i, j],
                                       rtol=1e-5, atol=1e-6)
    back = Q.from_matrix(m)
    assert isinstance(back.w, P.LazyArray)
    _close(abs(back.w), abs(Q.from_matrix(dense).w), rtol=1e-5, atol=1e-6)


def test_vec3_lazy_is_vector3fc():
    a = Vec3.of(_lz([1.0, 2.0]), _lz([0.0, 1.0]), _lz([2.0, -1.0]))
    b = Vec3.of(_lz([0.5, 0.5]), _lz([1.0, 0.0]), _lz([0.0, 3.0]))
    c = cross3(a, b)
    n = normalize3(a + b * 2.0)
    d = dot3(a, b)
    assert not d.materialized
    np.testing.assert_allclose(d.numpy(), [0.5, 1.0 - 3.0])
    np.testing.assert_allclose(
        c.x.numpy(), np.cross([[1, 0, 2], [2, 1, -1]],
                              [[0.5, 1, 0], [0.5, 0, 3]])[:, 0])
    nn = np.asarray([n.x.numpy(), n.y.numpy(), n.z.numpy()])
    np.testing.assert_allclose((nn ** 2).sum(0), [1.0, 1.0], rtol=1e-6)
    np.testing.assert_allclose(norm3(a).numpy(), [np.sqrt(5.0),
                                                  np.sqrt(6.0)], rtol=1e-6)
    s = Vec3.of(_lz([1.0, 1.0]), 2.0, 3.0)
    assert isinstance(s.z, P.LazyArray)
    np.testing.assert_allclose(s.z.numpy(), [3.0, 3.0])
    js = JV.Vec3.of(_jz([1.0, 1.0]), 2.0, 3.0)
    np.testing.assert_array_equal(s.y.numpy(), js.y.numpy())


def _gens(n=8):
    from enoki_tpu.types.random import PCG32 as JPCG32
    from enoki_tpu_torch.types.random import PCG32
    return (PCG32.create_lazy(n, device="cpu"), PCG32.create(n, device="cpu"),
            JPCG32.create_lazy(n))


def _same(lazy, eager, ref):
    np.testing.assert_array_equal(lazy.numpy(), eager.numpy())
    ref = ref.numpy() if isinstance(ref, J.LazyArray) else np.asarray(ref)
    np.testing.assert_array_equal(lazy.numpy(), ref)


def test_pcg32_lazy_bit_exact():
    gl, ge, gj = _gens()
    ul, gl = gl.next_uint32()
    ue, ge = ge.next_uint32()
    uj, gj = gj.next_uint32()
    fl, gl = gl.next_float32()
    fe, ge = ge.next_float32()
    fj, gj = gj.next_float32()
    u64l, gl = gl.next_uint64()
    u64e, ge = ge.next_uint64()
    u64j, gj = gj.next_uint64()
    assert not ul.materialized  # all of the above: one lazy program
    assert ul.dtype == torch.uint32
    _same(ul, ue, uj)
    _same(fl, fe, fj)
    _same(u64l.hi, u64e.hi, u64j.hi)
    _same(u64l.lo, u64e.lo, u64j.lo)
    ul2, _ = gl.next_uint32()
    ue2, _ = ge.next_uint32()
    uj2, _ = gj.next_uint32()
    _same(ul2, ue2, uj2)


@pytest.mark.parametrize("delta", [100, -100, 12345678901234, 1 << 63],
                         ids=["100", "-100", "12345678901234", "2^63"])
def test_pcg32_lazy_advance_bit_exact(delta):
    """The advanced state against both of the reference's generators, and
    the draw after it against its eager one (the reference's lazy
    program of a long squaring chain and a draw takes XLA tens of seconds
    to compile; its own tests/test_lazy_types.py holds that draw equal to
    the eager one)."""
    from enoki_tpu.types.random import PCG32 as JPCG32
    gl, ge, gj = (g.advance(delta) for g in _gens())
    je = JPCG32.create(8).advance(delta)
    assert not gl.state.lo.materialized
    J.eval(gj.state.hi, gj.state.lo)  # one program to compile
    _same(gl.state.hi, ge.state.hi, gj.state.hi)
    _same(gl.state.lo, ge.state.lo, gj.state.lo)
    _same(gl.state.lo, ge.state.lo, je.state.lo)
    ul, _ = gl.next_uint32()
    ue, _ = ge.next_uint32()
    uj, _ = je.next_uint32()
    _same(ul, ue, uj)


def test_pcg32_lazy_feeds_pipeline():
    from enoki_tpu_torch.types.random import PCG32

    g = PCG32.create_lazy(64, device="cpu")
    f, g = g.next_float32()
    y = P.sqrt(f * 2.0 + 0.5)
    evals = P.stats()["n_evals"]
    v = y.numpy()
    assert P.stats()["n_evals"] == evals + 1  # seed + draw + math: one
    assert (v >= np.sqrt(0.5)).all() and (v < np.sqrt(2.5)).all()
    # the lazy generator's eager-only methods say so
    with pytest.raises(NotImplementedError, match="eager only"):
        g.next_uint32_bounded(10)


def test_u64_lazy_bit_ops():
    """The lazy U64 (one uint64 LazyArray): arithmetic, shifts (logical)
    and compares (unsigned) against numpy's uint64, the 64-bit leg."""
    from enoki_tpu_torch.types import u64 as U

    rng = np.random.default_rng(5)
    a = rng.integers(0, 2 ** 64, 32, dtype=np.uint64)
    b = rng.integers(0, 2 ** 64, 32, dtype=np.uint64)
    b[:4] = a[:4]
    la = U.U64(P.LazyArray(a, device="cpu"))
    lb = U.U64(P.LazyArray(b, device="cpu"))
    with np.errstate(over="ignore"):
        cases = [
            (U.add(la, lb), a + b), (U.sub(la, lb), a - b),
            (U.mul(la, lb), a * b), (U.xor(la, lb), a ^ b),
            (U.shr(la, 37), a >> np.uint64(37)),
            (U.shl(la, 13), a << np.uint64(13)),
            (U.shr_dyn(la, P.LazyArray((b & np.uint64(63)).astype(np.uint32),
                                       device="cpu")),
             a >> (b & np.uint64(63))),
            (U.from_py(0xDA3E39CB94B95BDB, like=la.v),
             np.full(32, 0xDA3E39CB94B95BDB, np.uint64)),
        ]
    for got, want in cases:
        np.testing.assert_array_equal(U.to_py(got), want)
    np.testing.assert_array_equal(U.lt(la, lb).numpy(), a < b)
    np.testing.assert_array_equal(U.ge(la, lb).numpy(), a >= b)
    np.testing.assert_array_equal(U.eq(la, lb).numpy(), a == b)
    np.testing.assert_array_equal(la.hi.numpy(), a >> np.uint64(32))
    np.testing.assert_array_equal(la.lo.numpy(), a & np.uint64(0xFFFFFFFF))
    assert la.hi.dtype == torch.uint32


def test_morton_color_lazy():
    from enoki_tpu.types.morton import morton_encode as jenc
    from enoki_tpu_torch.types.color import linear_to_srgb, srgb_to_linear
    from enoki_tpu_torch.types.morton import morton_decode, morton_encode

    xs = np.array([3, 5, 1000], np.uint32)
    ys = np.array([7, 2, 999], np.uint32)
    ml = morton_encode([P.LazyArray(xs, device="cpu"),
                        P.LazyArray(ys, device="cpu")])
    me = morton_encode([torch.from_numpy(xs), torch.from_numpy(ys)])
    np.testing.assert_array_equal(ml.numpy(), me.numpy())
    np.testing.assert_array_equal(ml.numpy(), np.asarray(jenc([xs, ys])))
    dx, dy = morton_decode(ml, 2)
    np.testing.assert_array_equal(dx.numpy(), xs)
    np.testing.assert_array_equal(dy.numpy(), ys)

    v = np.linspace(0.0, 1.0, 32).astype(np.float32)
    sl = linear_to_srgb(_lz(v))
    se = linear_to_srgb(_t(v))
    np.testing.assert_allclose(sl.numpy(), se.numpy(), rtol=1e-6)
    rl = srgb_to_linear(sl)
    np.testing.assert_allclose(rl.numpy(), v, rtol=1e-5, atol=1e-7)


def test_matrix_soa_lazy_and_dense_agree():
    from enoki_tpu_torch.types import matrix as MD, matrix_soa as MS

    rng = np.random.default_rng(9)
    for n in (1, 2, 3, 4):
        a = rng.normal(size=(5, n, n)).astype(np.float32)
        a += np.eye(n, dtype=np.float32) * 3.0
        lazy = tuple(tuple(_lz(a[:, i, j]) for j in range(n))
                     for i in range(n))
        inv_l = MS.inverse(lazy)
        det_l = MS.det(lazy)
        inv_d = MD.inverse(torch.from_numpy(a)).numpy()
        det_d = MD.det(torch.from_numpy(a)).numpy()
        np.testing.assert_allclose(det_l.numpy(), det_d, rtol=2e-5,
                                   atol=1e-6)
        for i in range(n):
            for j in range(n):
                np.testing.assert_allclose(inv_l[i][j].numpy(),
                                           inv_d[:, i, j], rtol=4e-4,
                                           atol=2e-5, err_msg=f"n={n}")
        prod = MS.matmul(lazy, inv_l)
        evals = P.stats()["n_evals"]
        P.eval()
        assert P.stats()["n_evals"] == evals + 1
        for i in range(n):
            for j in range(n):
                np.testing.assert_allclose(
                    prod[i][j].numpy(), np.full(5, 1.0 if i == j else 0.0),
                    atol=2e-4)


def test_matrix_soa_dense_roundtrip_and_ops():
    from enoki_tpu_torch.types import matrix_soa as MS

    a = torch.arange(12, dtype=torch.float32).reshape(3, 2, 2) + 1
    m = MS.from_dense(a)
    assert torch.equal(MS.to_dense(m), a)
    assert torch.equal(MS.to_dense(MS.transpose(m)), a.transpose(-1, -2))
    np.testing.assert_allclose(MS.trace(m).numpy(),
                               np.trace(a.numpy(), axis1=-2, axis2=-1))
    np.testing.assert_allclose(MS.frob(m).numpy(), (a * a).sum((-2, -1)))
    # the same ops over lazy entries
    lm = tuple(tuple(P.LazyArray(e, device="cpu") for e in r) for r in m)
    np.testing.assert_array_equal(MS.trace(lm).numpy(), MS.trace(m).numpy())
    np.testing.assert_array_equal(MS.frob(lm).numpy(), MS.frob(m).numpy())


def test_morton_lazy_int32_coerced():
    from enoki_tpu_torch.types.morton import morton_decode, morton_encode

    x = np.array([40000, 1], np.uint32)  # encode sets bit 31 of the code
    y = np.array([60000, 2], np.uint32)
    code = morton_encode([P.LazyArray(x.astype(np.int32),
                                      device="cpu").cast(torch.int32),
                          y])  # mixed: lazy int32 + numpy
    assert code.device.type == "cpu"
    dx, dy = morton_decode(code.cast(torch.int32), 2)
    np.testing.assert_array_equal(dx.numpy(), x)
    np.testing.assert_array_equal(dy.numpy(), y)


def test_sh_lazy_matches_eager():
    from enoki_tpu.types.sh import sh_eval as jsh
    from enoki_tpu_torch.types.sh import sh_eval

    rng = np.random.default_rng(2)
    v = rng.normal(size=(3, 16)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0)
    lazy = sh_eval(_lz(v[0]), _lz(v[1]), _lz(v[2]), 4)
    eager = sh_eval(_t(v[0]), _t(v[1]), _t(v[2]), 4)
    ref = jsh(_jz(v[0]), _jz(v[1]), _jz(v[2]), 4)
    evals = P.stats()["n_evals"]
    P.eval()  # all 25 coefficients in one fused program
    assert P.stats()["n_evals"] == evals + 1
    for a, b, c in zip(lazy, eager, ref):
        # the recurrence is IEEE arithmetic, its divisions by l - m one
        # division on both routes: bit for bit
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-5,
                                   atol=1e-6)


def test_erfinv_lazy_matches_eager():
    from enoki_tpu.ops.special import erfinv as jerfinv
    from enoki_tpu_torch.ops.special import erfinv

    x = np.linspace(-0.995, 0.995, 256).astype(np.float32)
    lazy = erfinv(_lz(x))
    np.testing.assert_allclose(lazy.numpy(), erfinv(_t(x), "poly").numpy(),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(lazy.numpy(),
                               np.asarray(jerfinv(jnp.asarray(x), "poly")),
                               rtol=2e-5, atol=2e-6)


def test_transform_soa_lazy():
    from enoki_tpu_torch.types import matrix_soa as MS, transform as T

    ang = np.float32(0.7)
    a = _lz(np.array([0.7, -0.3], np.float32))
    axn = 1.0 / np.sqrt(3.0)
    rot_l = MS.rotate(axn, axn, axn, a)
    m_l = MS.matmul(MS.translate(*(_lz(np.full(2, v, np.float32))
                                   for v in (1.0, 2.0, 3.0))), rot_l)
    px, py, pz = MS.transform_point(m_l, *(_lz(np.full(2, v, np.float32))
                                           for v in (0.5, -0.5, 1.0)))
    assert isinstance(px, P.LazyArray) and px.device.type == "cpu"
    m_e = (T.translate(torch.tensor([1.0, 2.0, 3.0]))
           @ T.rotate(torch.tensor([axn, axn, axn], dtype=torch.float32),
                      float(ang))).numpy()
    p_e = m_e @ np.array([0.5, -0.5, 1.0, 1.0], np.float32)
    np.testing.assert_allclose(
        [px.numpy()[0], py.numpy()[0], pz.numpy()[0]],
        p_e[:3] / p_e[3], rtol=1e-5, atol=1e-6)
