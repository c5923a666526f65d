"""The port's SDF library (enoki_tpu_torch.render.sdflib) against the
reference's (enoki_tpu.render.sdflib) on seeded numpy points: values,
first derivatives in the point and in each parameter, the second
derivative the shade needs (the derivative of a contraction of the normal
grad_p sdf), and the subgradients at the ties of min / max, clip and abs.

Tolerances: values atol 1e-6 (both sides take a correctly rounded sqrt, so
what is left is the order of a few sums); first derivatives rtol 1e-5 /
atol 1e-5; second derivatives rtol 1e-4 / atol 1e-4 (they divide by the
cube of a distance). The ties are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enoki_tpu.render import sdflib as jsd
from enoki_tpu.render.vec import Vec3 as JVec3
from enoki_tpu_torch.render import sdflib as tsd
from enoki_tpu_torch.render.vec import Vec3 as TVec3

N_POINTS = 96

# name -> (number of parameters, f(sd, Vec3, p, th) -> distance). The same
# function body runs on both libraries: they have the same names.
CASES = {
    "sd_sphere": (4, lambda sd, V, p, th: sd.sd_sphere(
        p, V(th[0], th[1], th[2]), th[3])),
    "sd_plane": (4, lambda sd, V, p, th: sd.sd_plane(
        p, V(th[0], th[1], th[2]), th[3])),
    "sd_box": (6, lambda sd, V, p, th: sd.sd_box(
        p, V(th[0], th[1], th[2]), V(th[3], th[4], th[5]))),
    "sd_torus": (5, lambda sd, V, p, th: sd.sd_torus(
        p, V(th[0], th[1], th[2]), th[3], th[4])),
    "sd_capsule": (7, lambda sd, V, p, th: sd.sd_capsule(
        p, V(th[0], th[1], th[2]), V(th[3], th[4], th[5]), th[6])),
    "op_union": (8, lambda sd, V, p, th: sd.op_union(
        sd.sd_sphere(p, V(th[0], th[1], th[2]), th[3]),
        sd.sd_sphere(p, V(th[4], th[5], th[6]), th[7]),
        sd.sd_plane(p, V(0.0, -1.0, 0.0), 0.9))),
    "op_intersect": (8, lambda sd, V, p, th: sd.op_intersect(
        sd.sd_sphere(p, V(th[0], th[1], th[2]), th[3]),
        sd.sd_sphere(p, V(th[4], th[5], th[6]), th[7]))),
    "op_subtract": (8, lambda sd, V, p, th: sd.op_subtract(
        sd.sd_sphere(p, V(th[0], th[1], th[2]), th[3]),
        sd.sd_sphere(p, V(th[4], th[5], th[6]), th[7]))),
    "op_smooth_union": (6, lambda sd, V, p, th: sd.op_smooth_union(
        sd.sd_sphere(p, V(th[0], th[1], th[2]), th[3]),
        sd.sd_torus(p, V(0.0, 0.0, 0.2), th[4], 0.2), th[5])),
    "op_round": (7, lambda sd, V, p, th: sd.op_round(sd.sd_box(
        p, V(th[0], th[1], th[2]), V(th[3], th[4], th[5])), th[6])),
    "op_shell": (5, lambda sd, V, p, th: sd.op_shell(
        sd.sd_sphere(p, V(th[0], th[1], th[2]), th[3]), th[4])),
}


def inputs(name):
    """Seeded points in [-1.5, 1.5]^3, parameters in [0.2, 0.9] and a
    direction to contract the normal with."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    pts = rng.uniform(-1.5, 1.5, (3, N_POINTS)).astype(np.float32)
    th = rng.uniform(0.2, 0.9, CASES[name][0]).astype(np.float32)
    c = rng.standard_normal((3, N_POINTS)).astype(np.float32)
    return pts, th, c


def jax_all(fn, pts, th, c):
    """(values, grad_p, grad_th of the sum, grad_th and grad_p of the
    contracted normal) through the reference library."""

    def f(pts_, th_):
        return fn(jsd, JVec3, JVec3(pts_[0], pts_[1], pts_[2]), th_)

    def contracted(pts_, th_):
        n = jax.grad(lambda q: jnp.sum(f(q, th_)))(pts_)
        return jnp.sum(n * c)

    val = f(pts, th)
    gp, gth = jax.grad(lambda q, t: jnp.sum(f(q, t)), argnums=(0, 1))(pts, th)
    hp, hth = jax.grad(contracted, argnums=(0, 1))(pts, th)
    return [np.asarray(a) for a in (val, gp, gth, hth, hp)]


def torch_all(fn, pts, th, c):
    pts_t = torch.from_numpy(pts).requires_grad_(True)
    th_t = torch.from_numpy(th).requires_grad_(True)
    val = fn(tsd, TVec3, TVec3(pts_t[0], pts_t[1], pts_t[2]), th_t)
    gp, gth = torch.autograd.grad(val.sum(), (pts_t, th_t),
                                  create_graph=True, allow_unused=True)
    zeros = lambda g, like: torch.zeros_like(like) if g is None else g  # noqa
    contracted = (gp * torch.from_numpy(c)).sum()
    if contracted.requires_grad:
        hp, hth = torch.autograd.grad(contracted, (pts_t, th_t),
                                      allow_unused=True)
    else:  # a function linear in p: its normal is a constant
        hp = hth = None
    return [a.detach().numpy() for a in (
        val, gp, zeros(gth, th_t), zeros(hth, th_t), zeros(hp, pts_t))]


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request):
    fn = CASES[request.param][1]
    pts, th, c = inputs(request.param)
    return jax_all(fn, jnp.asarray(pts), jnp.asarray(th), jnp.asarray(c)), \
        torch_all(fn, pts, th, c)


def test_values(both):
    np.testing.assert_allclose(both[1][0], both[0][0], rtol=0, atol=1e-6)


def test_gradient_in_the_point(both):
    np.testing.assert_allclose(both[1][1], both[0][1], rtol=1e-5, atol=1e-5)


def test_gradient_in_each_parameter(both):
    # a sum over N_POINTS points
    np.testing.assert_allclose(both[1][2], both[0][2], rtol=1e-5,
                               atol=1e-5 * N_POINTS)


def test_second_derivative_of_the_normal_in_each_parameter(both):
    np.testing.assert_allclose(both[1][3], both[0][3], rtol=1e-4,
                               atol=1e-4 * N_POINTS)


def test_second_derivative_of_the_normal_in_the_point(both):
    np.testing.assert_allclose(both[1][4], both[0][4], rtol=1e-4, atol=1e-4)


# -- ties: exact subgradients -------------------------------------------------

# name -> f(sd, a, b) of two scalars, evaluated at a == b or at the kink
TIES = {
    # two equal distances: each operand gets half
    "op_union": (lambda sd, a, b: sd.op_union(a, b), (0.3, 0.3)),
    "op_intersect": (lambda sd, a, b: sd.op_intersect(a, b), (0.3, 0.3)),
    "op_subtract": (lambda sd, a, b: sd.op_subtract(a, b), (0.3, -0.3)),
    # |d| at d = 0 has slope +1, as jnp.abs has it
    "op_shell": (lambda sd, a, b: sd.op_shell(a, b), (0.0, 0.1)),
    # clip at its lower bound (d2 - d1 = -k: h = 0) and at its upper
    # (d2 - d1 = k: h = 1): min of max, half the slope at either
    "smooth_union_h0": (lambda sd, a, b: sd.op_smooth_union(a, b, 0.25),
                        (0.5, 0.25)),
    "smooth_union_h1": (lambda sd, a, b: sd.op_smooth_union(a, b, 0.25),
                        (0.25, 0.5)),
}


@pytest.mark.parametrize("name", sorted(TIES))
def test_subgradient_at_a_tie(name):
    fn, (a, b) = TIES[name]
    ja, jb = jax.grad(lambda x, y: fn(jsd, x, y), argnums=(0, 1))(
        jnp.float32(a), jnp.float32(b))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    ga, gb = torch.autograd.grad(fn(tsd, ta, tb), (ta, tb))
    assert ga.item() == float(ja) and gb.item() == float(jb), \
        (name, ga, gb, ja, jb)


def test_box_and_capsule_kinks_match():
    """sd_box's max(q, 0) and |p - c| at q = 0 and p = c, and sd_capsule's
    clip at h = 0 (p - a orthogonal to b - a): gradients in the point equal
    the reference's at the kink itself."""
    pts = np.array([[0.5, 0.0, 0.2, 0.0], [0.0, 0.5, 0.2, 0.3],
                    [0.0, 0.0, 0.5, -0.4]], np.float32)

    def box(sd, V, p):
        return sd.sd_box(p, V(0.0, 0.0, 0.0), V(0.5, 0.5, 0.5))

    def capsule(sd, V, p):
        return sd.sd_capsule(p, V(0.0, 0.0, 0.0), V(1.0, 0.0, 0.0), 0.1)

    for fn in (box, capsule):
        gj = np.asarray(jax.grad(lambda q: jnp.sum(
            fn(jsd, JVec3, JVec3(q[0], q[1], q[2]))))(jnp.asarray(pts)))
        q = torch.from_numpy(pts).requires_grad_(True)
        (gt,) = torch.autograd.grad(
            fn(tsd, TVec3, TVec3(q[0], q[1], q[2])).sum(), q)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-6, atol=1e-6)


def test_primitives_sanity():
    p = TVec3(torch.tensor([0.0, 2.0]), torch.zeros(2), torch.zeros(2))
    d = tsd.sd_sphere(p, TVec3(0.0, 0.0, 0.0), 1.0)
    np.testing.assert_allclose(d.numpy(), [-1.0, 1.0], atol=1e-5)
    d = tsd.sd_box(p, TVec3(0.0, 0.0, 0.0), TVec3(0.5, 0.5, 0.5))
    np.testing.assert_allclose(d.numpy(), [-0.5, 1.5], atol=1e-5)
    d = tsd.sd_torus(TVec3(torch.tensor([1.0]), torch.zeros(1),
                           torch.zeros(1)),
                     TVec3(0.0, 0.0, 0.0), 1.0, 0.25)
    np.testing.assert_allclose(d.numpy(), [-0.25], atol=1e-4)


def test_smooth_union_differentiable_in_the_blend():
    k = torch.tensor(0.1, requires_grad=True)
    out = tsd.op_smooth_union(torch.tensor([0.1, -0.05]),
                              torch.tensor([0.12, 0.2]), k).sum()
    (g,) = torch.autograd.grad(out, k)
    gj = jax.grad(lambda kk: jnp.sum(jsd.op_smooth_union(
        jnp.asarray([0.1, -0.05]), jnp.asarray([0.12, 0.2]), kk)))(
            jnp.float32(0.1))
    np.testing.assert_allclose(g.item(), float(gj), rtol=1e-5)
