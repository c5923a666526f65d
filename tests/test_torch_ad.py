"""The port's differentiation helpers (enoki_tpu_torch.ad) against the
reference's gates (tests/test_ad_runtime.py:12-54) and against jax.grad /
jax.jvp / jax.vmap of enoki_tpu on the same seeded inputs; and fault C8:
the safe functions of ops.router work under torch.func's vmap, jvp and
grad.

Tolerances: safe_mul, its JVP and gradient and the custom rules exact
against JAX (IEEE arithmetic on the same values, one operation a lane);
the gradients and JVPs of expressions of several terms within 2^-21
(4 units of 2^-23) of the sum of their terms' magnitudes (the two tapes
add the partial products in their own orders), a gradient that sums n
lanes within 2^-22 * sum|terms|;
safe_sqrt exact (both roots are correctly rounded); safe_rsqrt, safe_asin
and safe_acos within the router's gates (docs/port.md, the op layer's tolerances):
2 ulp for the values and the asin / acos tangents, 8 ulp for safe_rsqrt's
tangent, which cubes its root (XLA's CPU rsqrt and libm asin / acos are
not correctly rounded; the port's are taken in float64 and rounded once).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from enoki_tpu import ad as JA
from enoki_tpu.ops import router as JR
from enoki_tpu_torch import ad
from enoki_tpu_torch.ops import router as R


def t(x, dtype=torch.float32):
    return torch.tensor(x, dtype=dtype)


def ulp(got, want):
    """The distance of two float32 arrays in ulp (same-sign bit patterns;
    equal NaNs and the two zeros are 0 apart)."""
    a = np.asarray(got, np.float32)
    b = np.asarray(want, np.float32)
    both_nan = np.isnan(a) & np.isnan(b)
    a, b = np.where(both_nan, 0, a) + 0.0, np.where(both_nan, 0, b) + 0.0
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(
        np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


# -- the reference's gates (tests/test_ad_runtime.py:12-54) -----------------


def test_backward_forward():
    def f(a, b):
        return torch.sum(a * a * b)

    a, b = torch.arange(3.0), t(2.0)
    val, (ga, gb) = ad.backward(f, a, b)
    assert float(val) == 2 * (0 + 1 + 4)
    assert ga.tolist() == (2 * 2 * np.arange(3.0)).tolist()
    assert float(gb) == 5.0
    out, tangent = ad.forward(f, (a, b), (torch.ones(3), t(0.0)))
    assert float(tangent) == float(torch.sum(2 * a * b))


def test_safe_mul_suppresses_inf():
    assert float(ad.safe_mul(t(0.0), t(np.inf))) == 0.0
    assert float(ad.safe_mul(t(np.inf), t(0.0))) == 0.0
    assert float(ad.safe_mul(t(2.0), t(3.0))) == 6.0
    assert float(ad.safe_fmadd(t(0.0), t(np.nan), t(1.0))) == 1.0
    # the gradient flows where finite
    assert float(ad.gradient(lambda x: ad.safe_mul(x, t(3.0)))(t(2.0))) == 3.0


def test_detach_and_suspend():
    g = ad.gradient(lambda x: torch.sum(ad.detach(x) * x))(torch.ones(3))
    assert g.tolist() == [1, 1, 1]
    tree = {"a": torch.ones(2, requires_grad=True), "b": (torch.zeros(1),)}
    s = ad.suspend_grad(tree)
    assert s["a"].tolist() == [1, 1] and not s["a"].requires_grad
    assert isinstance(s["b"], tuple)


def test_whos_and_graphviz():
    def f(x):
        return torch.sin(x) * 2.0

    table = ad.whos(f, torch.ones(8))
    assert "sin" in table and "mul" in table
    dot = ad.graphviz(f, torch.ones(8))
    assert dot.startswith("digraph") and "sin" in dot and "->" in dot


# -- parity with jax on seeded inputs ------------------------------------------


def _draw(seed, n=257):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n).astype(np.float32)


def test_gradient_and_backward_match_jax_grad():
    a, b, c = _draw(1), _draw(2), np.float32(0.75)

    def ft(x, y, s):
        return torch.sum(x * x * y - s * x + y * y * y)

    def fj(x, y, s):
        return jnp.sum(x * x * y - s * x + y * y * y)

    args_t = (torch.from_numpy(a), torch.from_numpy(b), t(c))
    args_j = (jnp.asarray(a), jnp.asarray(b), jnp.float32(c))
    # d/ds = -sum(x): a sum of 257 lanes
    s_tol = 2.0 ** -22 * np.abs(a).sum()

    def close(g, w, scalar_sum=False):
        g, w = g.numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0 if scalar_sum else 2.0 ** -21,
                                   atol=s_tol if scalar_sum else 0)

    for nums in (0, 1, (0, 2), (0, 1, 2)):
        got = ad.gradient(ft, nums)(*args_t)
        want = jax.grad(fj, nums)(*args_j)
        for i, g, w in zip((nums,) if isinstance(nums, int) else nums,
                           pytree.tree_leaves(got),
                           jax.tree_util.tree_leaves(want)):
            close(g, w, i == 2)
    val, grads = ad.backward(ft, *args_t)
    jval, jgrads = JA.backward(fj, *args_j)
    assert not val.requires_grad
    np.testing.assert_allclose(val.item(), float(jval), rtol=2.0 ** -21)
    for i, (g, w) in enumerate(zip(grads, jgrads)):
        close(g, w, i == 2)


def test_gradient_in_a_structure_and_of_a_gradient():
    from enoki_tpu_torch.render import Vec3
    v = Vec3(t(1.5), t(-2.0), t(0.25))
    g = ad.gradient(lambda p: p.x * p.y * p.z + p.x)(v)
    assert isinstance(g, Vec3)
    assert (g.x.item(), g.y.item(), g.z.item()) == (0.5, 0.375, -3.0)
    x = np.float32(1.25)
    got = ad.gradient(ad.gradient(lambda u: u ** 3 + 2.0 * u * u))(t(x))
    want = jax.grad(jax.grad(lambda u: u ** 3 + 2.0 * u * u))(jnp.float32(x))
    assert got.item() == float(want)
    # an argument that needs no grad: zeros, as jax.grad gives
    assert ad.gradient(lambda u, w: u * 2.0, 1)(t(1.0), t(3.0)).item() == 0.0


def test_forward_matches_jax_jvp():
    a, b = _draw(3), _draw(4)
    ta, tb = _draw(5), _draw(6)

    def ft(x, y):
        return x * y * y - x

    def fj(x, y):
        return x * y * y - x

    out, tan = ad.forward(ft, (torch.from_numpy(a), torch.from_numpy(b)),
                          (torch.from_numpy(ta), torch.from_numpy(tb)))
    jout, jtan = JA.forward(fj, (jnp.asarray(a), jnp.asarray(b)),
                            (jnp.asarray(ta), jnp.asarray(tb)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # tan = ta*y*y + 2*x*y*tb - ta: 4 units of 2^-23 of its terms'
    # magnitudes (the difference cancels)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    mag = np.abs(ta) * b64 * b64 + 2 * np.abs(a64 * b64 * tb) + np.abs(ta)
    assert (np.abs(tan.numpy() - np.asarray(jtan)) <= 2.0 ** -21 * mag).all()


EDGE = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -2.5, 3.0])


def _safe_mul_pairs():
    a, b = np.meshgrid(EDGE, EDGE)
    return a.ravel(), b.ravel()


def test_safe_mul_matches_the_reference():
    a, b = _safe_mul_pairs()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_array_equal(ad.safe_mul(ta, tb).numpy(),
                                  np.asarray(JA.safe_mul(ja, jb)))
    np.testing.assert_array_equal(ad.safe_fmadd(ta, tb, ta).numpy(),
                                  np.asarray(JA.safe_fmadd(ja, jb, ja)))
    # the JVP, per tangent direction
    for da, db in ((1.0, 0.0), (0.0, 1.0), (2.0, -3.0)):
        _, got = ad.forward(ad.safe_mul, (ta, tb),
                            (torch.full_like(ta, da), torch.full_like(tb, db)))
        _, want = jax.jvp(JA.safe_mul, (ja, jb),
                          (jnp.full_like(ja, da), jnp.full_like(jb, db)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # reverse mode: the transpose of the rule, on the tape and under vmap
    for argnum in (0, 1):
        got = ad.gradient(lambda u, v: ad.safe_mul(u, v).sum(),
                          argnum)(ta, tb)
        want = jax.vmap(jax.grad(JA.safe_mul, argnum))(ja, jb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = torch.func.vmap(torch.func.grad(ad.safe_mul, argnum))(ta, tb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = torch.func.vmap(ad.safe_mul)(ta, tb)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.vmap(JA.safe_mul)(ja, jb)))


def test_custom_jvp_matches_jax_custom_jvp():
    # a clipped identity whose derivative is 1 inside and 0.25 outside
    def rule_factory(where, clip):
        def rule(primals, tangents):
            (x,), (dx,) = primals, tangents
            return clip(x), dx * where(abs(x) < 1.0, 1.0, 0.25)
        return rule

    ft = ad.CustomJVP(lambda x: torch.clamp(x, -1.0, 1.0))
    ft.defjvp(rule_factory(torch.where, lambda x: torch.clamp(x, -1.0, 1.0)))
    fj = jax.custom_jvp(lambda x: jnp.clip(x, -1.0, 1.0))
    fj.defjvp(rule_factory(jnp.where, lambda x: jnp.clip(x, -1.0, 1.0)))
    x = _draw(7) * 2
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(ft(tx).numpy(), np.asarray(fj(jx)))
    np.testing.assert_array_equal(
        ad.gradient(lambda u: (ft(u) * u).sum())(tx).numpy(),
        np.asarray(jax.grad(lambda u: (fj(u) * u).sum())(jx)))
    _, got = ad.forward(ft, (tx,), (torch.ones_like(tx),))
    _, want = jax.jvp(fj, (jx,), (jnp.ones_like(jx),))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # without a rule it is the plain function
    assert ad.CustomJVP(torch.sin)(t(0.0)).item() == 0.0


def test_custom_vjp_matches_jax_custom_vjp():
    # gradient clipping: the primal is x * y, the cotangent of x is clipped
    def fwd(x, y):
        return x * y, (x, y)

    def bwd_factory(clip):
        def bwd(res, g):
            x, y = res
            return clip(g * y), g * x
        return bwd

    ft = ad.CustomVJP(lambda x, y: x * y)
    ft.defvjp(fwd, bwd_factory(lambda v: torch.clamp(v, -0.5, 0.5)))
    fj = jax.custom_vjp(lambda x, y: x * y)
    fj.defvjp(fwd, bwd_factory(lambda v: jnp.clip(v, -0.5, 0.5)))
    a, b = _draw(8), _draw(9)
    val, (ga, gb) = ad.backward(lambda x, y: ft(x, y).sum(),
                                torch.from_numpy(a), torch.from_numpy(b))
    jval, (jga, jgb) = jax.value_and_grad(lambda x, y: fj(x, y).sum(),
                                          (0, 1))(jnp.asarray(a),
                                                  jnp.asarray(b))
    np.testing.assert_array_equal(ga.numpy(), np.asarray(jga))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jgb))
    # outside differentiation, fun alone runs
    np.testing.assert_array_equal(ft(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy(), a * b)


def test_checkpoint_keeps_the_gradient():
    x = torch.from_numpy(_draw(10)).requires_grad_(True)

    def f(u):
        return torch.sin(u) * u

    g1 = torch.autograd.grad(ad.checkpoint(f)(x).sum(), x)[0]
    g2 = torch.autograd.grad(f(x).sum(), x)[0]
    assert torch.equal(g1, g2)


def test_whos_lists_each_op_with_its_shape():
    table = ad.whos(lambda x, y: (x * y).sum(0), torch.ones(4, 3),
                    torch.ones(3))
    rows = table.splitlines()[1:]
    assert len(rows) == 2 and "aten.mul" in rows[0] and "12" in rows[0]
    assert "aten.sum" in rows[1] and " 3 " in rows[1]


# -- fault C8: the safe functions under torch.func ---------------------------

SAFE = ("safe_sqrt", "safe_rsqrt", "safe_asin", "safe_acos")
VALUE_ULP = {"safe_sqrt": 0, "safe_rsqrt": 2, "safe_asin": 2, "safe_acos": 2}
TANGENT_ULP = {"safe_sqrt": 0, "safe_rsqrt": 8, "safe_asin": 2,
               "safe_acos": 2}


def _safe_inputs(name):
    rng = np.random.default_rng(15)
    if name in ("safe_asin", "safe_acos"):
        x = rng.uniform(-1.5, 1.5, 4096)
    else:
        x = rng.uniform(-2.0, 50.0, 4096)
    x = x.astype(np.float32)
    x[:9] = [0.0, -0.0, 1.0, -1.0, -3.0, 0.5, -0.5, 2.0, 1e-30]
    return x


@pytest.mark.parametrize("name", SAFE)
def test_safe_functions_under_vmap_and_jvp_match_jax(name):
    x = _safe_inputs(name)
    tan = np.random.default_rng(16).normal(size=x.size).astype(np.float32)
    fp, fj = getattr(R, name), getattr(JR, name)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    vals = torch.func.vmap(fp)(tx).numpy()
    jvals = np.asarray(jax.vmap(fj)(jx))
    assert ulp(vals, jvals).max() <= VALUE_ULP[name]
    # vmap of the lanes as rows of a (64, 64) array: the same values
    np.testing.assert_array_equal(
        torch.func.vmap(fp)(tx.reshape(64, 64)).numpy().ravel(), vals)
    out, tangent = torch.func.jvp(fp, (tx,), (torch.from_numpy(tan),))
    jout, jtangent = jax.jvp(fj, (jx,), (jnp.asarray(tan),))
    np.testing.assert_array_equal(out.numpy(), fp(tx).numpy())
    assert ulp(tangent.numpy(), np.asarray(jtangent)).max() <= \
        TANGENT_ULP[name]
    # the tangent is linear in what it is given: twice the tangent, twice
    # the result
    _, t2 = torch.func.jvp(fp, (tx,), (2 * torch.from_numpy(tan),))
    np.testing.assert_array_equal(t2.numpy(), 2 * tangent.numpy())
    # forward mode of the tape's own dual tensors too
    import torch.autograd.forward_ad as fwd
    with fwd.dual_level():
        dual = fp(fwd.make_dual(tx, torch.from_numpy(tan)))
        np.testing.assert_array_equal(fwd.unpack_dual(dual).tangent.numpy(),
                                      tangent.numpy())
    # torch.func.grad and vmap of it equal the tape's backward
    g = torch.func.vmap(torch.func.grad(fp))(tx)
    y = tx.clone().requires_grad_(True)
    fp(y).backward(torch.ones_like(y))
    np.testing.assert_array_equal(g.numpy(), y.grad.numpy())


@pytest.mark.parametrize("name", SAFE)
def test_safe_gradients_at_the_edges_equal_jax_grad(name):
    x = np.float32([-2, -1, -0.5, 0, 0.5, 1, 2])
    got = torch.func.vmap(torch.func.grad(getattr(R, name)))(
        torch.from_numpy(x)).numpy()
    want = np.asarray(jax.vmap(jax.grad(getattr(JR, name)))(jnp.asarray(x)))
    assert ulp(got, want).max() <= TANGENT_ULP[name]
    # the reference's values at 0 and outside the domain
    assert np.isfinite(got).all()


def test_safe_functions_keep_their_values_and_gradients():
    # the setup_context rewrite left forward and backward as they were:
    # the correctly rounded roots, float64 asin / acos rounded once, and
    # the derivatives of the reference's JVPs
    x = torch.from_numpy(_safe_inputs("safe_sqrt")).double()
    xf = x.float()
    assert torch.equal(R.safe_sqrt(xf),
                       R._sqrt_rn(torch.clamp_min(xf, 0.0)))
    assert torch.equal(R.safe_rsqrt(xf), R._rsqrt_rn(torch.clamp_min(
        xf, torch.finfo(torch.float32).tiny)))
    u = torch.from_numpy(_safe_inputs("safe_asin"))
    assert torch.equal(R.safe_asin(u),
                       torch.asin(torch.clamp(u, -1, 1).double()).float())
    y = xf.clone().requires_grad_(True)
    R.safe_sqrt(y).sum().backward()
    pos = xf > 0
    want = torch.where(pos, 0.5 / torch.where(pos, R.safe_sqrt(xf), 1.0), 0.0)
    assert torch.equal(y.grad, want)
