"""types/complex.py and types/quaternion.py of the port against the
reference's (enoki_tpu.types) on the same seeded numpy inputs, and under
the gates of the reference's own test (tests/test_complex_quat.py:24-189).

Tolerances:
  * bit-equal, dtype included, where only IEEE arithmetic and correctly
    rounded roots are inside: the complex and quaternion arithmetic,
    ``abs_``, ``rcp``, ``sqrt``, ``conj``, ``squared_norm``, ``dot``,
    ``rotate_vector``, ``to_matrix``, ``from_matrix`` (its four branches
    and their ties), and with ``impl="poly"`` the complex exp, sin, cos,
    sincos, tan, sinh, cosh, tanh, the quaternion exp, ``from_axis_angle``
    and euler's roll and yaw;
  * ``quaternion.normalize``: bit-equal to numpy's float32 arithmetic
    with the root taken in float64 and rounded once; within 4 ulp of the
    exact unit quaternion (its four roundings: the squared norm's, half
    of it through the root, the root's and the product's; measured 2.06);
    within 8 ulp, both sides' bounds, of the reference's, which takes
    XLA's CPU rsqrt, whose bits depend on the host (ROADMAP §C);
  * where a native function is inside (``impl="native"``; ``arg``, and
    so ``log``, ``pow`` and the inverse trigonometry, through atan2; the
    quaternion log, pow, slerp and euler's pitch through the float64
    asin / acos): within the reference test's gate of the reference's
    result and of numpy complex128 (complex: arithmetic atol 1e-4 to 1e-5,
    transcendentals 1e-3 / 1e-4, pow 1e-2; quaternions: atol 1e-5, the
    round trip's). Measured against the reference: 1 ulp for arg, log,
    asin, atan; exp, sin, cos, sinh, cosh native 3-6 ulp (max|d| 9.5e-7),
    tan and tanh native 7.6e-6 and 3.8e-6 near their poles, the
    quaternion functions 2.4e-7;
  * gradients equal ``jax.grad`` at the reference's points (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enoki_tpu.types import (Complex as JComplex, Quaternion as JQuaternion,
                             complex_ as JC, quaternion as JQ)
from enoki_tpu_torch.types import Complex, Quaternion, complex_ as C
from enoki_tpu_torch.types import quaternion as Q

CPU = "cpu"
N = 4096


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_bits(got, want):
    """Bit-equal, dtype and the sign of zero included (NaN to NaN)."""
    want = np.asarray(want)
    got = got.detach()
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype,
                                                               want.dtype)
    np.testing.assert_array_equal(got.float().numpy().view(np.int32),
                                  want.astype(np.float32).view(np.int32))


def assert_parts(got, want, check=assert_bits, fields="re im"):
    for f in fields.split():
        check(getattr(got, f), getattr(want, f))


def close(atol):
    def check(got, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=atol)
    return check


# -- complex -----------------------------------------------------------------


def _sample(seed, scale=3.0, n=N):
    """tests/test_complex_quat.py's _sample: (port, reference, numpy)."""
    rng = np.random.default_rng(seed)
    re = rng.uniform(-scale, scale, n).astype(np.float32)
    im = rng.uniform(-scale, scale, n).astype(np.float32)
    return (Complex(_t(re), _t(im)), JComplex(jnp.asarray(re), jnp.asarray(im)),
            re.astype(np.complex128) + 1j * im.astype(np.complex128))


def _nc(z):
    return z.re.detach().double().numpy() + 1j * z.im.detach().double().numpy()


def test_complex_arithmetic_is_bit_equal():
    (a, ja, na), (b, jb, nb) = _sample(0), _sample(1)
    for got, want in ((a + b, ja + jb), (a - b, ja - jb), (a * b, ja * jb),
                      (a / b, ja / jb), (-a, -ja), (C.rcp(a), JC.rcp(ja)),
                      (C.conj(a), JC.conj(ja)), (C.sqrt(a), JC.sqrt(ja)),
                      (a * 2.5, ja * 2.5), (a / 3.0, ja / 3.0),
                      (1.0 - a, 1.0 - ja), (2.0 / a, 2.0 / ja),
                      (a + 1.5, ja + 1.5), (a * b.re, ja * jb.re)):
        assert_parts(got, want)
    for got, want in ((C.abs_(a), JC.abs_(ja)),
                      (C.squared_norm(a), JC.squared_norm(ja)),
                      (C.real(a), JC.real(ja)), (C.imag(a), JC.imag(ja))):
        assert_bits(got, want)
    np.testing.assert_array_equal((a == a).numpy(), np.asarray(ja == ja))
    np.testing.assert_array_equal((a != b).numpy(), np.asarray(ja != jb))
    np.testing.assert_array_equal((a == 0.0).numpy(), np.asarray(ja == 0.0))
    # tests/test_complex_quat.py:24-32
    assert np.allclose(_nc(a * b), na * nb, atol=1e-4)
    assert np.allclose(_nc(a + b), na + nb, atol=1e-5)
    assert np.allclose(_nc(a / b), na / nb, atol=1e-3)
    assert np.allclose(_nc(C.rcp(a)), 1 / na, atol=1e-4)
    assert np.allclose(C.abs_(a).numpy(), np.abs(na), atol=1e-4)


def test_complex_arg_within_the_reference_gate():
    a, ja, na = _sample(0)
    close(1e-5)(C.arg(a), JC.arg(ja))
    assert np.allclose(C.arg(a).numpy(), np.angle(na), atol=1e-5)


# (name, numpy truth, the reference test's scale and atol)
TRANSCENDENTAL = {
    "exp": (np.exp, 2.0, 1e-3), "log": (np.log, 2.0, 1e-4),
    "sin": (np.sin, 2.0, 1e-3), "cos": (np.cos, 2.0, 1e-3),
    "tan": (np.tan, 2.0, 1e-3), "sinh": (np.sinh, 2.0, 1e-3),
    "cosh": (np.cosh, 2.0, 1e-3), "tanh": (np.tanh, 2.0, 1e-3),
    "asin": (np.arcsin, 0.8, 1e-3), "acos": (np.arccos, 0.8, 1e-3),
    "atan": (np.arctan, 0.8, 1e-3)}
# no native function inside with impl="poly"
POLY_BIT_EQUAL = ("exp", "sin", "cos", "tan", "sinh", "cosh", "tanh")


@pytest.mark.parametrize("impl", ["native", "poly"])
@pytest.mark.parametrize("name", list(TRANSCENDENTAL))
def test_complex_transcendentals_match_the_reference(name, impl):
    truth, scale, atol = TRANSCENDENTAL[name]
    z, jz, nz = _sample(2 if scale == 2.0 else 3, scale)
    got = getattr(C, name)(z, impl)
    want = getattr(JC, name)(jz, impl)
    if impl == "poly" and name in POLY_BIT_EQUAL:
        assert_parts(got, want)
    else:
        assert_parts(got, want, close(atol))
    assert np.allclose(_nc(got), truth(nz), atol=atol)


@pytest.mark.parametrize("impl", ["native", "poly"])
def test_complex_sincos_and_pow_match_the_reference(impl):
    z, jz, nz = _sample(2, 2.0)
    for got, want in zip(C.sincos(z, impl), JC.sincos(jz, impl)):
        if impl == "poly":
            assert_parts(got, want)
        else:
            assert_parts(got, want, close(1e-3))
    # tests/test_complex_quat.py:52-56: the principal branch at w = 2
    a, ja, na = _sample(4, 1.5)
    w = Complex.of(torch.tensor(2.0), torch.tensor(0.0))
    p = C.pow(a, w, impl)
    assert_parts(p, JC.pow(ja, JComplex.of(jnp.float32(2.0),
                                           jnp.float32(0.0)), impl),
                 close(1e-2))
    assert np.allclose(_nc(p), na ** 2, atol=1e-2)
    b, jb, nb = _sample(5, 1.0)
    assert_parts(C.pow(a, b, impl), JC.pow(ja, jb, impl), close(1e-2))
    assert_parts(C.pow(a, 0.5, impl), JC.pow(ja, 0.5, impl), close(1e-2))


def test_complex_of_and_the_torch_complex_bridge():
    re = np.linspace(-2, 2, 7, dtype=np.float32)
    z = Complex.of(_t(re))
    assert_parts(z, JComplex.of(jnp.asarray(re)))
    assert_parts(Complex.of(_t(re), torch.tensor(1.5)),
                 JComplex.of(jnp.asarray(re), jnp.float32(1.5)))
    assert_parts(Complex.of(_t(re), 0.5), JComplex.of(jnp.asarray(re), 0.5))
    k = Complex.of(torch.arange(3, dtype=torch.int32))
    assert k.re.dtype == torch.float32 and k.im.dtype == torch.float32
    a, ja, _ = _sample(6)
    tc = C.to_torch_complex(a)
    assert tc.dtype == torch.complex64
    np.testing.assert_array_equal(tc.numpy(), np.asarray(JC.to_jnp_complex(ja)))
    assert_parts(C.from_torch_complex(tc), JC.from_jnp_complex(
        JC.to_jnp_complex(ja)))
    tree, spec = torch.utils._pytree.tree_flatten(a)
    assert len(tree) == 2
    back = torch.utils._pytree.tree_unflatten(tree, spec)
    assert isinstance(back, Complex) and bool((back == a).all())


def test_complex_python_operands_take_the_dtype_beside_them():
    # a weakly typed scalar: bfloat16 stays bfloat16, rounded as JAX rounds
    rng = np.random.default_rng(7)
    re, im = rng.uniform(-3, 3, (2, 512)).astype(np.float32)
    z = Complex(_t(re).bfloat16(), _t(im).bfloat16())
    jz = JComplex(jnp.asarray(re, jnp.bfloat16), jnp.asarray(im, jnp.bfloat16))
    for got, want in ((z * 1.1, jz * 1.1), (z / 3.0, jz / 3.0),
                      (z + 0.3, jz + 0.3), (0.7 - z, 0.7 - jz),
                      (C.acos(z, "poly"), JC.acos(jz, "poly"))):
        assert got.re.dtype == got.im.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.re.float().numpy(),
                                      np.asarray(want.re, np.float32))
        np.testing.assert_array_equal(got.im.float().numpy(),
                                      np.asarray(want.im, np.float32))


def test_complex_sqrt_real_axis_grad():
    # tests/test_matrix_transform.py:112-122: zero slope on the real axis
    for x, part in ((4.0, "re"), (-4.0, "im"), (0.0, "re"), (2.5, "im")):
        xt = torch.tensor(x, requires_grad=True)
        getattr(C.sqrt(Complex(xt, xt * 0.0)), part).backward()
        gj = jax.grad(lambda v: getattr(JC.sqrt(JComplex(v, v * 0.0)),
                                        part))(jnp.float32(x))
        assert np.isfinite(xt.grad.item())
        np.testing.assert_allclose(xt.grad.item(), float(gj), rtol=1e-6)
    xt = torch.tensor(4.0, requires_grad=True)
    C.sqrt(Complex(xt, xt * 0.0)).re.backward()
    np.testing.assert_allclose(xt.grad.item(), 0.25, rtol=1e-6)


def test_complex_lazy_parts_wait_for_trace(monkeypatch):
    from enoki_tpu_torch.ops import backend
    monkeypatch.setattr(backend, "is_lazy", lambda x: isinstance(x, str))
    with pytest.raises(NotImplementedError):
        Complex.of("lazy")
    with pytest.raises(NotImplementedError):
        C.exp(Complex("lazy", "lazy"))


# -- quaternion --------------------------------------------------------------


def _quats(seed, n=N, unit=False):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(4, n))
    if unit:
        v /= np.linalg.norm(v, axis=0)
    v = v.astype(np.float32)
    return (Quaternion(*map(_t, v)), JQuaternion(*map(jnp.asarray, v)), v)


XYZW = "x y z w"


def test_quaternion_arithmetic_is_bit_equal():
    (a, ja, _), (b, jb, _) = _quats(0), _quats(1)
    for got, want in ((a + b, ja + jb), (a - b, ja - jb), (-a, -ja),
                      (a * b, ja * jb), (a / b, ja / jb),
                      (a * 1.5, ja * 1.5), (2.5 * a, 2.5 * ja),
                      (a / 3.0, ja / 3.0), (Q.rcp(a), JQ.rcp(ja)),
                      (Q.conj(a), JQ.conj(ja)),
                      (Q.sqrt(a), JQ.sqrt(ja)),
                      (Q.sqrt(a, "poly"), JQ.sqrt(ja, "poly")),
                      (Q.exp(a, "poly"), JQ.exp(ja, "poly"))):
        assert_parts(got, want, fields=XYZW)
    for got, want in ((Q.abs_(a), JQ.abs_(ja)), (Q.dot(a, b), JQ.dot(ja, jb)),
                      (Q.squared_norm(a), JQ.squared_norm(ja)),
                      (Q.real(a), JQ.real(ja))):
        assert_bits(got, want)
    for got, want in zip(Q.imag(a), JQ.imag(ja)):
        assert_bits(got, want)
    u = np.random.default_rng(2).normal(size=(3, N)).astype(np.float32)
    for got, want in zip(Q.rotate_vector(a, *map(_t, u)),
                         JQ.rotate_vector(ja, *map(jnp.asarray, u))):
        assert_bits(got, want)


def test_quaternion_normalize_is_correctly_rounded():
    a, ja, v = _quats(3)
    got, want = Q.normalize(a), JQ.normalize(ja)
    x, y, z, w = v
    inv = (1.0 / np.sqrt((x * x + y * y + z * z + w * w).astype(np.float64))
           ).astype(np.float32)
    exact = v.astype(np.float64) / np.linalg.norm(v.astype(np.float64),
                                                  axis=0)
    for i, f in enumerate(XYZW.split()):
        g = getattr(got, f)
        assert_bits(g, v[i] * inv)
        g = g.numpy().astype(np.float64)
        ulp = np.spacing(np.abs(exact[i]).astype(np.float32))
        for other, bound in ((exact[i], 4), (getattr(want, f), 8)):
            d = np.abs(g - np.asarray(other, np.float64)) / ulp
            assert d.max() <= bound, (f, bound, d.max())


def test_quaternion_of_and_identity():
    q = Quaternion.of(torch.tensor([1.0, 2.0]), 0.5, torch.tensor(3), 1)
    jq = JQuaternion.of(jnp.asarray([1.0, 2.0]), 0.5, jnp.int32(3), 1)
    assert_parts(q, jq, fields=XYZW)
    i = Quaternion.identity((2,), device=CPU)
    assert_parts(i, JQuaternion.identity((2,)), fields=XYZW)
    assert i.w.device.type == "cpu"
    tree, _ = torch.utils._pytree.tree_flatten(q)
    assert len(tree) == 4


@pytest.mark.parametrize("impl", ["native", "poly"])
def test_quaternion_transcendentals_match_the_reference(impl):
    a, ja, _ = _quats(6)
    a = Quaternion(a.x * 0.5, a.y * 0.5, a.z * 0.5, torch.abs(a.w) + 1.0)
    ja = JQuaternion(ja.x * 0.5, ja.y * 0.5, ja.z * 0.5, jnp.abs(ja.w) + 1.0)
    exp = (lambda g, w: assert_bits(g, w)) if impl == "poly" else close(1e-5)
    assert_parts(Q.exp(a, impl), JQ.exp(ja, impl), exp, XYZW)
    assert_parts(Q.log(a, impl), JQ.log(ja, impl), close(1e-5), XYZW)
    assert_parts(Q.pow(a, 0.7, impl), JQ.pow(ja, 0.7, impl), close(1e-5),
                 XYZW)
    # tests/test_complex_quat.py:84-91
    r = Q.exp(Q.log(a, impl), impl)
    for f in XYZW.split():
        np.testing.assert_allclose(getattr(r, f).numpy(),
                                   getattr(a, f).numpy(), atol=1e-4)


@pytest.mark.parametrize("impl", ["native", "poly"])
def test_quaternion_rotations_match_the_reference(impl):
    (a, ja, _), (b, jb, _) = _quats(7, unit=True), _quats(8, unit=True)
    exact = impl == "poly"
    for k, (got, want) in enumerate(zip(Q.euler_angles(a, impl),
                                        JQ.euler_angles(ja, impl))):
        # roll and yaw are atan2's; pitch takes the float64 asin
        (assert_bits if exact and k != 1 else close(1e-5))(got, want)
    for t in (0.0, 0.3, 1.0):
        assert_parts(Q.slerp(a, b, torch.tensor(t), impl),
                     JQ.slerp(ja, jb, jnp.float32(t), impl), close(1e-5),
                     XYZW)
    rng = np.random.default_rng(9)
    ax = rng.normal(size=(3, N))
    ax = (ax / np.linalg.norm(ax, axis=0)).astype(np.float32)
    ang = rng.uniform(-4, 4, N).astype(np.float32)
    assert_parts(Q.from_axis_angle(*map(_t, ax), _t(ang), impl),
                 JQ.from_axis_angle(*map(jnp.asarray, ax), jnp.asarray(ang),
                                    impl),
                 assert_bits if exact else close(1e-6), XYZW)


def test_quaternion_matrix_round_trip_is_bit_equal():
    a, ja, v = _quats(5, unit=True)
    m = Q.to_matrix(a)
    assert_bits(m, JQ.to_matrix(ja))
    assert_parts(Q.from_matrix(m), JQ.from_matrix(JQ.to_matrix(ja)),
                 fields=XYZW)
    # tests/test_complex_quat.py:68-81: q and -q are the same rotation
    q2 = Q.from_matrix(m)
    s = np.sign(sum(getattr(q2, f).numpy() * v[i]
                    for i, f in enumerate(XYZW.split())))
    for i, f in enumerate(XYZW.split()):
        np.testing.assert_allclose(s * getattr(q2, f).numpy(), v[i],
                                   atol=1e-5)
    soa = tuple(tuple(m[..., i, j] for j in range(3)) for i in range(3))
    assert_parts(Q.from_matrix(soa), JQ.from_matrix(JQ.to_matrix(ja)),
                 fields=XYZW)


def test_quaternion_from_matrix_branches_at_ties():
    # the four cases of Shepperd's method and the ties between diagonal
    # entries (m00 == m11, m11 == m22, tr == 0)
    ms = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
          np.diag([-1.0, -1.0, 1.0]), np.diag([-1.0, -1.0, -1.0]),
          np.diag([0.0, 0.0, 0.0]), np.diag([0.5, 0.5, -1.0]),
          np.diag([-0.5, 0.25, 0.25]), np.diag([0.2, -0.1, -0.1]),
          np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]),
          np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1.0]])]
    m = np.stack(ms).astype(np.float32)
    assert_parts(Q.from_matrix(_t(m)), JQ.from_matrix(jnp.asarray(m)),
                 fields=XYZW)


def test_quaternion_gates_of_the_reference():
    # tests/test_complex_quat.py:59-65, :94-106
    f32 = torch.float32
    zero, one = torch.tensor(0.0), torch.tensor(1.0)
    q = Q.from_axis_angle(zero, zero, one, torch.tensor(np.pi / 2, dtype=f32))
    r = q * Quaternion.identity(device=CPU)
    assert_parts(r, q, fields=XYZW)
    rx, ry, rz = Q.rotate_vector(q, one, zero, zero)
    assert np.allclose([rx.item(), ry.item(), rz.item()], [0, 1, 0],
                       atol=1e-6)
    a = Quaternion.identity(device=CPU)
    mid = Q.slerp(a, q, torch.tensor(0.5))
    want = Q.from_axis_angle(zero, zero, one,
                             torch.tensor(np.pi / 4, dtype=f32))
    for f in XYZW.split():
        assert abs(getattr(mid, f).item() - getattr(want, f).item()) <= 1e-6
    assert abs(Q.slerp(a, q, torch.tensor(0.0)).w.item() - 1.0) <= 1e-6


def test_quaternion_sqrt_negative_real_is_nan():
    # tests/test_complex_quat.py:174-189
    z = torch.zeros(1)
    r = Q.sqrt(Quaternion(z, z, z, z - 1.0))
    assert torch.isnan(r.x).all()
    rp = Q.sqrt(Quaternion(z, z, z, z + 1.0))
    assert rp.w.item() == 1.0 and rp.x.item() == 0.0


def test_quat_grad_flows():
    # tests/test_complex_quat.py:115-122
    def f(angle, Qm, zero, one):
        q = Qm.from_axis_angle(zero, zero, one, angle)
        return Qm.rotate_vector(q, one, zero, zero)[1]

    for x in (0.3, -1.2, 2.0):
        a = torch.tensor(x, requires_grad=True)
        f(a, Q, torch.tensor(0.0), torch.tensor(1.0)).backward()
        gj = jax.grad(lambda v: f(v, JQ, jnp.float32(0), jnp.float32(1)))(
            jnp.float32(x))
        np.testing.assert_allclose(a.grad.item(), float(gj), rtol=1e-6)
        assert abs(a.grad.item() - np.cos(x)) <= 1e-5
