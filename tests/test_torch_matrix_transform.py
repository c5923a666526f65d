"""types/matrix.py, matrix_soa.py and transform.py of the port against the
reference's (enoki_tpu.types) on the same seeded numpy inputs, and under
the gates of the reference's own test (tests/test_matrix_transform.py:
20-123).

Tolerances:
  * bit-equal, dtype included, where only IEEE arithmetic and correctly
    rounded roots are inside: ``det`` and ``inverse`` for N = 1..4 (the
    closed forms), ``diag``, ``diag_matrix``, ``from_rows`` /
    ``from_cols``, ``transpose``, ``identity``, all of matrix_soa but its
    ``rotate`` (native sincos), and ``translate``, ``scale``, ``frustum``,
    ``ortho``, ``rotate`` with ``impl="poly"``;
  * the products and sums (``matmul``, ``matvec``, ``frob``, ``trace``,
    ``transform_point`` / ``_vector`` / ``_normal``), which add n terms
    one at a time: within their own rounding bound, n * 2^-24 *
    sum|terms| per output, of the sum taken in float64 (n = N for the
    products and the trace, N^2 for ``frob``, 4 for ``transform_point``;
    measured up to 2.74 units for the 4x4 products, 4.45 of 16 for
    ``frob`` at N = 4), and within the sum of both sides' bounds, 2n *
    2^-24 * sum|terms|, of the reference's (its einsum and reduce add in
    other orders, and XLA contracts products into FMAs);
  * where a native function or a library call is inside: the reference
    test's gate against the reference's result (``det`` / ``inverse`` for
    N = 5 through torch.linalg / jnp.linalg: rtol 1e-3, atol 1e-4;
    ``rotate`` native, ``perspective``'s tan, ``look_at``'s cross and
    ``normal_at``'s inverse: atol 1e-6 on unit-scale entries; the polar
    decomposition, ten inverse-transpose averages with matmuls: atol 1e-4,
    the round trip's gate);
  * gradients equal ``jax.grad`` at the reference's points (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enoki_tpu.types import matrix as JM
from enoki_tpu.types import matrix_soa as JS
from enoki_tpu.types import transform as JT
from enoki_tpu_torch.types import matrix as M
from enoki_tpu_torch.types import matrix_soa as S
from enoki_tpu_torch.types import transform as T

from test_torch_complex_quat import XYZW, assert_bits, assert_parts, close

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(n, k, seed):
    """tests/test_matrix_transform.py's _rand: random + 3 I."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, k, k)) + 3 * np.eye(k)).astype(np.float32)


def assert_terms(got, want, truth, mag, n):
    """A sum of n terms added one at a time in float32: within its own
    rounding bound, n * 2^-24 * mag per output, of ``truth``, the sum in
    float64, and within the sum of both sides' bounds of the reference's
    ``want``. ``mag`` is the sum of the magnitudes of the terms that the
    output adds."""
    g = got.detach().double().numpy()
    bound = n * 2.0 ** -24 * np.asarray(mag)
    for other, scale in ((truth, 1), (want, 2)):
        d = np.abs(g - np.asarray(other, np.float64))
        assert (d <= scale * bound).all(), \
            (scale, (d / np.maximum(bound, 1e-30)).max())


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_det_inverse_closed_forms_are_bit_equal(k):
    m = _rand(1000, k, k)
    assert_bits(M.det(_t(m)), JM.det(jnp.asarray(m)))
    assert_bits(M.inverse(_t(m)), JM.inverse(jnp.asarray(m)))
    assert_bits(M.inverse_transpose(_t(m)),
                JM.inverse_transpose(jnp.asarray(m)))
    # tests/test_matrix_transform.py:20-34
    got_det = M.det(_t(m)).numpy()
    assert np.allclose(got_det, np.linalg.det(m.astype(np.float64)),
                       rtol=1e-3)
    got_inv = M.inverse(_t(m)).numpy()
    assert np.allclose(got_inv, np.linalg.inv(m.astype(np.float64)),
                       rtol=1e-3, atol=1e-4)
    prod = M.matmul(_t(m), M.inverse(_t(m))).numpy()
    assert np.allclose(prod, np.eye(k), atol=1e-3)


def test_det_inverse_above_4_take_the_library():
    m = _rand(64, 5, 5)
    close_lib = lambda g, w: np.testing.assert_allclose(  # noqa: E731
        g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-4)
    close_lib(M.det(_t(m)), JM.det(jnp.asarray(m)))
    close_lib(M.inverse(_t(m)), JM.inverse(jnp.asarray(m)))


def test_products_and_sums_within_their_terms():
    for k in (2, 3, 4):
        a, b = _rand(1000, k, 10 + k), _rand(1000, k, 20 + k)
        v = np.random.default_rng(k).normal(size=(1000, k)).astype(np.float32)
        ad, bd, vd = (x.astype(np.float64) for x in (a, b, v))
        assert_terms(M.matmul(_t(a), _t(b)),
                     JM.matmul(jnp.asarray(a), jnp.asarray(b)),
                     ad @ bd, np.abs(ad) @ np.abs(bd), k)
        assert_terms(M.matvec(_t(a), _t(v)),
                     JM.matvec(jnp.asarray(a), jnp.asarray(v)),
                     np.einsum("nij,nj->ni", ad, vd),
                     np.einsum("nij,nj->ni", np.abs(ad), np.abs(vd)), k)
        sq = (ad ** 2).sum((-2, -1))
        assert_terms(M.frob(_t(a)), JM.frob(jnp.asarray(a)), sq, sq, k * k)
        assert_terms(M.trace(_t(a)), JM.trace(jnp.asarray(a)),
                     np.trace(ad, axis1=-2, axis2=-1),
                     np.trace(np.abs(ad), axis1=-2, axis2=-1), k)
        # the SoA form adds in the reference's order: bit-equal
        sa, sb = S.from_dense(_t(a)), S.from_dense(_t(b))
        ja, jb = JS.from_dense(jnp.asarray(a)), JS.from_dense(jnp.asarray(b))
        assert_bits(S.to_dense(S.matmul(sa, sb)),
                    JS.to_dense(JS.matmul(ja, jb)))
        vs = tuple(_t(v[:, i]) for i in range(k))
        jv = tuple(jnp.asarray(v[:, i]) for i in range(k))
        for g, w in zip(S.matvec(sa, vs), JS.matvec(ja, jv)):
            assert_bits(g, w)
        assert_bits(S.trace(sa), JS.trace(ja))
        assert_bits(S.frob(sa), JS.frob(ja))


def test_matrix_helpers():
    m = _rand(5, 3, 0)
    assert_bits(M.transpose(_t(m)), JM.transpose(jnp.asarray(m)))
    assert_bits(M.diag(_t(m)), JM.diag(jnp.asarray(m)))
    d = np.random.default_rng(1).normal(size=(7, 4)).astype(np.float32)
    assert_bits(M.diag_matrix(_t(d)), JM.diag_matrix(jnp.asarray(d)))
    r0, r1 = np.float32([1.0, 2.0]), np.float32([3.0, 4.0])
    assert_bits(M.from_rows(_t(r0), _t(r1)), JM.from_rows(r0, r1))
    assert_bits(M.from_cols(_t(r0), _t(r1)), JM.from_cols(r0, r1))
    assert_bits(M.from_rows([_t(r0[0]), _t(r0[1])], _t(r1)),
                JM.from_rows([r0[0], r0[1]], r1))
    i = M.identity(3, (2,), device=CPU)
    assert_bits(i, JM.identity(3, (2,)))
    assert M.identity(2, dtype=torch.float64, device=CPU).dtype == \
        torch.float64
    # tests/test_matrix_transform.py:37-49
    assert np.allclose(M.trace(_t(m)).numpy(), np.trace(m, axis1=-2, axis2=-1))
    assert np.allclose(M.frob(_t(m)).numpy(), (m ** 2).sum((-2, -1)))
    dm = M.diag_matrix(torch.tensor([1.0, 2.0, 3.0]))
    assert np.allclose(dm.numpy(), np.diag([1, 2, 3]))
    assert np.allclose(M.from_cols(_t(r0), _t(r1)).numpy(), [[1, 3], [2, 4]])


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_matrix_soa_is_bit_equal(k):
    m = _rand(500, k, 30 + k)
    sm, jm = S.from_dense(_t(m)), JS.from_dense(jnp.asarray(m))
    assert S.matrix([[1, 2], [3, 4]]) == JS.matrix([[1, 2], [3, 4]])
    with pytest.raises(ValueError):
        S.matrix([[1, 2], [3]])
    assert_bits(S.det(sm), JS.det(jm))
    for f in ("inverse", "inverse_transpose", "transpose"):
        assert_bits(S.to_dense(getattr(S, f)(sm)),
                    JS.to_dense(getattr(JS, f)(jm)))
    assert_bits(S.to_dense(S.identity_like(k, sm[0][0])),
                JS.to_dense(JS.identity_like(k, jm[0][0])))


def test_matrix_soa_transforms():
    rng = np.random.default_rng(4)
    t3 = rng.normal(size=(3, 300)).astype(np.float32)
    ax = rng.normal(size=(3, 300))
    ax = (ax / np.linalg.norm(ax, axis=0)).astype(np.float32)
    ang = rng.uniform(-3, 3, 300).astype(np.float32)
    p = rng.normal(size=(3, 300)).astype(np.float32)
    tt, jt = [_t(c) for c in t3], [jnp.asarray(c) for c in t3]
    for f in ("translate", "scale"):
        m, jm = getattr(S, f)(*tt), getattr(JS, f)(*jt)
        assert_bits(S.to_dense(m), JS.to_dense(jm))
        for g, w in zip(S.transform_point(m, *map(_t, p)),
                        JS.transform_point(jm, *map(jnp.asarray, p))):
            assert_bits(g, w)
        for g, w in zip(S.transform_vector(m, *map(_t, p)),
                        JS.transform_vector(jm, *map(jnp.asarray, p))):
            assert_bits(g, w)
    r = S.rotate(*map(_t, ax), _t(ang))
    jr = JS.rotate(*map(jnp.asarray, ax), jnp.asarray(ang))
    close(1e-6)(S.to_dense(r), JS.to_dense(jr))
    with pytest.raises(NotImplementedError):
        S.det(S.from_dense(_t(_rand(2, 5, 0))))


def test_translate_scale_frustum_ortho_are_bit_equal():
    v = np.random.default_rng(5).normal(size=(10, 3)).astype(np.float32)
    assert_bits(T.translate(_t(v)), JT.translate(jnp.asarray(v)))
    assert_bits(T.scale(_t(v)), JT.scale(jnp.asarray(v)))
    args = (-1.0, 1.2, -0.7, 0.9, 0.1, 50.0)
    assert_bits(T.frustum(*args, device=CPU), JT.frustum(*args))
    assert_bits(T.ortho(*args, device=CPU), JT.ortho(*args))
    # tests/test_matrix_transform.py:52-63
    p = T.transform_point(T.translate(torch.tensor([1.0, 2.0, 3.0])),
                          torch.zeros(3))
    assert np.allclose(p.numpy(), [1, 2, 3])
    p = T.transform_point(T.scale(torch.tensor([2.0, 3.0, 4.0])),
                          torch.ones(3))
    assert np.allclose(p.numpy(), [2, 3, 4])


@pytest.mark.parametrize("impl", ["native", "poly"])
def test_rotate_matches_the_reference(impl):
    rng = np.random.default_rng(6)
    ax = rng.normal(size=(2000, 3))
    ax = (ax / np.linalg.norm(ax, axis=1, keepdims=True)).astype(np.float32)
    ang = rng.uniform(-4, 4, 2000).astype(np.float32)
    got = T.rotate(_t(ax), _t(ang), impl)
    want = JT.rotate(jnp.asarray(ax), jnp.asarray(ang), impl)
    (assert_bits if impl == "poly" else close(1e-6))(got, want)
    # tests/test_matrix_transform.py:60-63, :100-109
    r = T.rotate(torch.tensor([0.0, 0.0, 1.0]),
                 torch.tensor(np.pi / 2, dtype=torch.float32), impl)
    p = T.transform_point(r, torch.tensor([1.0, 0.0, 0.0]))
    assert np.allclose(p.numpy(), [0, 1, 0], atol=1e-6)
    m = T.rotate(torch.tensor([0, 0, 1]), np.pi / 4, impl)
    assert m.dtype == torch.float32
    np.testing.assert_allclose(m[0, 0].item(), np.cos(np.pi / 4), rtol=1e-6)


def test_perspective_and_look_at_match_the_reference():
    for fov, near, far, aspect in ((np.pi / 2, 0.1, 100.0, 1.0),
                                   (1.1, 0.5, 20.0, 1.3)):
        got = T.perspective(torch.tensor(fov, dtype=torch.float32), near,
                            far, aspect)
        close(1e-6)(got, JT.perspective(jnp.float32(fov), near, far, aspect))
        assert got.dtype == torch.float32
    assert T.perspective(1.0, 0.1, 10.0, device=CPU).device.type == "cpu"
    # tests/test_matrix_transform.py:92-96
    m = T.perspective(torch.tensor(np.pi / 2, dtype=torch.float32), 0.1,
                      100.0)
    p = m.double().numpy() @ np.array([0, 0, -0.1, 1.0])
    assert np.isclose(p[2] / p[3], -1.0, atol=1e-4)
    rng = np.random.default_rng(7)
    o, t, u = (rng.normal(size=(500, 3)).astype(np.float32)
               for _ in range(3))
    close(1e-6)(T.look_at(_t(o), _t(t), _t(u)),
                JT.look_at(jnp.asarray(o), jnp.asarray(t), jnp.asarray(u)))
    # tests/test_matrix_transform.py:66-71
    m = T.look_at(torch.tensor([0.0, 0.0, -5.0]), torch.zeros(3),
                  torch.tensor([0.0, 1.0, 0.0])).numpy()
    assert np.allclose(m[0:3, 3], [0, 0, -5])
    assert np.allclose(m[0:3, 2], [0, 0, 1], atol=1e-6)


def _trs(n, seed):
    """Rotations with a translation and an anisotropic scale, as
    tests/test_matrix_transform.py:74-89 builds them."""
    rng = np.random.default_rng(seed)
    ax = rng.normal(size=(n, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    ang = rng.uniform(0, np.pi, n)
    m4 = np.array(JT.rotate(jnp.asarray(ax, jnp.float32),
                            jnp.asarray(ang, jnp.float32), "poly"))
    m4[:, 0:3, 3] = rng.normal(size=(n, 3))
    m4[:, 0:3, 0:3] *= rng.uniform(0.5, 2.0, (n, 1, 3)).astype(np.float32)
    return m4


def test_decompose_compose_matches_the_reference():
    m4 = _trs(300, 7)
    s, r, t = T.transform_decompose(_t(m4))
    js, jr, jt = JT.transform_decompose(jnp.asarray(m4))
    close(1e-4)(s, js)
    assert_parts(r, jr, close(1e-4), XYZW)
    assert_bits(t, jt)
    back = T.transform_compose(s, r, t)
    close(1e-4)(back, JT.transform_compose(js, jr, jt))
    # tests/test_matrix_transform.py:74-89
    assert np.allclose(back.numpy(), m4, atol=1e-4)
    q, p = T.polar_decompose(_t(m4[:, :3, :3]))
    jq, jp = JT.polar_decompose(jnp.asarray(m4[:, :3, :3]))
    close(1e-4)(q, jq)
    close(1e-4)(p, jp)
    # a reflection flips Q and P together, as in the reference
    m4[:, 0, :3] *= -1
    s, r, t = T.transform_decompose(_t(m4))
    js, jr, jt = JT.transform_decompose(jnp.asarray(m4))
    close(1e-4)(s, js)
    assert_parts(r, jr, close(1e-4), XYZW)


def test_transform_point_vector_normal_within_their_terms():
    m4 = _trs(500, 8)
    p = np.random.default_rng(9).normal(size=(500, 3)).astype(np.float32)
    a, pd = m4[:, :3, :3].astype(np.float64), p.astype(np.float64)
    mag = np.einsum("nij,nj->ni", np.abs(a), np.abs(pd))
    tr = m4[:, :3, 3].astype(np.float64)
    assert_terms(T.transform_point(_t(m4), _t(p)),
                 JT.transform_point(jnp.asarray(m4), jnp.asarray(p)),
                 np.einsum("nij,nj->ni", a, pd) + tr, mag + np.abs(tr), 4)
    assert_terms(T.transform_vector(_t(m4), _t(p)),
                 JT.transform_vector(jnp.asarray(m4), jnp.asarray(p)),
                 np.einsum("nij,nj->ni", a, pd), mag, 3)
    # the normal's matrix is the closed-form inverse-transpose, bit-equal
    # to the reference's; the product is held as the others
    it = M.inverse_transpose(_t(m4[:, :3, :3]))
    assert_bits(it, JM.inverse_transpose(jnp.asarray(m4[:, :3, :3])))
    it = it.double().numpy()
    assert_terms(T.transform_normal(_t(m4), _t(p)),
                 JT.transform_normal(jnp.asarray(m4), jnp.asarray(p)),
                 np.einsum("nij,nj->ni", it, pd),
                 np.einsum("nij,nj->ni", np.abs(it), np.abs(pd)), 3)


def test_matvec_grad():
    # tests/test_matrix_transform.py:92-99
    m = torch.eye(3) * 2.0
    v = torch.ones(3, requires_grad=True)
    M.matvec(m, v).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), [2, 2, 2])
    # and equal to jax.grad through det and inverse at seeded points
    for k in (2, 3, 4):
        a = _rand(4, k, 40 + k)
        x = _t(a).requires_grad_(True)
        (M.det(x).sum() + M.inverse(x).sum()).backward()
        gj = jax.grad(lambda y: JM.det(y).sum() + JM.inverse(y).sum())(
            jnp.asarray(a))
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(gj)).max())
