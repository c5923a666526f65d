"""Structs of LazyArrays in the port (twin of tests/test_lazy_struct.py)
on the CPU.

The reference instantiates ENOKI_STRUCT types over every backend, so
``Ray3fC``, a struct of lazy arrays, works with gather / scatter / select
/ zero and goes through vectorised calls with struct arguments and
results. Here the port's struct helpers dispatch per leaf over CPU
``trace.LazyArray``s, a Ray-struct sphere program runs as one eval, and
a dispatch with struct arguments and results stays lazy; each result is
held to ``enoki_tpu``'s on the same numpy inputs (the reference's struct
helpers over its own LazyArrays), and the struct helpers to the port's
eager ones too. The lazy sphere of examples/lazy_sphere_torch.py is held
to examples/lazy_sphere.py's image.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax

import enoki_tpu.struct as JS
import enoki_tpu.trace as J
import enoki_tpu.trace.call as JC
import enoki_tpu_torch.struct as PS
import enoki_tpu_torch.trace as P
import enoki_tpu_torch.trace.call as tc
from enoki_tpu.render import vec as JV
from enoki_tpu.struct import enoki_struct as j_struct
from enoki_tpu.struct.pytree import (concat_structs as j_concat,
                                     set_slice_struct as j_set_slice)
from enoki_tpu_torch.render.vec import Vec3, dot3
from enoki_tpu_torch.struct import (enoki_struct, select_struct,
                                    slice_struct, width)

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
sys.path.insert(0, os.path.join(REPO, "examples"))


@pytest.fixture(autouse=True)
def _fresh():
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()


def L(a):
    return P.LazyArray(np.asarray(a), device="cpu")


def JL(a):
    return J.LazyArray(np.asarray(a))


def _np(x):
    return np.asarray(x.numpy())


@enoki_struct
class Ray:
    o: object  # Vec3 of per-backend arrays
    d: object


@j_struct
class JRay:
    o: object
    d: object


def _ray(mk, n=4, V=Vec3, R=Ray):
    f = np.float32
    o = V(mk(np.arange(n, dtype=f)), mk(np.arange(n, dtype=f) * 10),
          mk(np.full(n, -1.0, f)))
    d = V(mk(np.zeros(n, f)), mk(np.zeros(n, f)), mk(np.ones(n, f)))
    return R(o, d)


def _leaves(r):
    return [r.o.x, r.o.y, r.o.z, r.d.x, r.d.y, r.d.z]


def _same(port, ref):
    """Every leaf of the port's struct equal to the reference's (values
    and dtype)."""
    for a, b in zip(_leaves(port), _leaves(ref)):
        a, b = _np(a), _np(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _helpers(S, mk, r, idx, m, dst_idx):
    """The struct helpers of the reference test on the struct ``r``: zeros,
    full, gather, select, scatter (its result, and its target, which a
    lazy scatter writes in place) and detach."""
    z = S.zeros_like(r)
    f = S.full_like(r, 2.5)
    g = S.gather_struct(r, mk(idx))
    s = S.select_struct(mk(m), r, S.zeros_like(r))
    dst = S.zeros_like(r)
    out = S.scatter_struct(dst, S.gather_struct(r, mk(idx)), mk(dst_idx))
    return [z, f, g, s, out, S.detach(r)], dst


def test_struct_helpers_on_lazy_leaves():
    r = _ray(L)
    e = _ray(torch.from_numpy)
    assert width(r) == 4

    idx = np.array([3, 1], np.int32)
    m = np.array([True, False, True, False])
    dst_idx = np.array([0, 2], np.int32)
    outs, dst = _helpers(PS, L, r, idx, m, dst_idx)
    z, f, g, s, scattered, d = outs
    assert isinstance(z.o.x, P.LazyArray) and z.o.x.device.type == "cpu"
    np.testing.assert_array_equal(z.o.x.numpy(), np.zeros(4))
    np.testing.assert_array_equal(f.d.z.numpy(), np.full(4, 2.5))
    assert isinstance(g.o.y, P.LazyArray)
    np.testing.assert_array_equal(g.o.y.numpy(), [30, 10])
    np.testing.assert_array_equal(s.o.x.numpy(), [0, 0, 2, 0])
    np.testing.assert_array_equal(scattered.o.x.numpy(), [3, 0, 1, 0])
    _same(dst, scattered)
    assert isinstance(d.o.x, P.LazyArray)
    np.testing.assert_array_equal(d.o.x.numpy(), [0, 1, 2, 3])

    # the same helpers on the reference's struct of its own LazyArrays
    refs, ref_dst = _helpers(JS, JL, _ray(JL, V=JV.Vec3, R=JRay), idx, m,
                             dst_idx)
    for port, ref in zip(outs + [dst], refs + [ref_dst]):
        _same(port, ref)
    # and the port's eager helpers on tensors
    for port, want in zip(outs, _helpers(PS, torch.from_numpy, e, idx, m,
                                         dst_idx)[0]):
        _same(port, want)

    s0, j0 = slice_struct(r, 2), JS.slice_struct(_ray(JL, V=JV.Vec3,
                                                      R=JRay), 2)
    assert float(s0.o.y) == float(j0.o.y) == 20.0


def _sphere_program(tr, LA, V, R, select, dot, n, full):
    """The Ray-struct sphere of the reference test, on the trace ``tr``
    (both traces' ``cast`` take numpy dtypes)."""
    idx = LA.arange(n * n, **full)
    col = (idx % n).cast(np.float32)
    row = (idx / n).cast(np.int32).cast(np.float32)
    step = 2.0 * 1.2 / (n - 1)

    def f(v):
        return LA.full(v, 1, **full)

    ray = R(o=V(col * step - 1.2, row * step - 1.2, f(-1.0)),
            d=V(f(0.0), f(0.0), f(1.0)))
    b = 2.0 * dot(ray.o, ray.d)
    c = dot(ray.o, ray.o) - 1.0
    disc = b * b - 4.0 * c
    valid = disc >= 0.0
    t = (-b + tr.sqrt(tr.maximum(disc, 0.0))) * 0.5
    hit = ray.o + ray.d * t
    nrm = select(valid, hit, V(f(0.0), f(0.0), f(0.0)))
    lam = tr.maximum(nrm.x * -1.0 + nrm.y * -1.0 + nrm.z * 2.0, 0.0)
    return lam * 90.0 + 0.2


def sphere_budget(n, cx=0.0, extent=1.2):
    """The float32 error budget of a pixel of the lazy sphere (radius 1,
    L = (-1, -1, 2), 90 * lam + 0.2) evaluated in another order of
    operations: 4 ulp of each shading term, and 16 ulp of the
    discriminant (its terms are of size 4) through the square root's
    slope 1 / (2 sqrt(disc)). It is large only at the silhouette, where
    disc is near 0, and near the terminator, where the shading terms
    cancel. Returns the budget and the float64 discriminant."""
    idx = np.arange(n * n)
    step = 2.0 * extent / (n - 1)
    px = (idx % n) * step - extent - cx
    py = (idx // n) * step - extent
    disc = 4.0 - 4.0 * (px * px + py * py)
    valid = disc >= 0.0
    root = np.sqrt(np.maximum(disc, 0.0))
    nz = np.where(valid, root * 0.5, 0.0)
    mag = np.where(valid, np.abs(px) + np.abs(py), 0.0) + 2.0 * nz
    eps = float(np.finfo(np.float32).eps)
    slope = np.where(valid, 1.0 / np.maximum(root, 1e-30), 0.0)
    return 90.0 * eps * (4.0 * mag + 8.0 * slope), disc


def assert_sphere_close(got, ref, n, cx=0.0):
    """``got`` within the reference test's gate (rtol 1e-5, atol 1e-5) of
    ``ref`` plus the budget of ``sphere_budget``; equal where no ray hits
    (disc < 0 in float64)."""
    budget, disc = sphere_budget(n, cx)
    err = np.abs(got.astype(np.float64) - ref)
    np.testing.assert_array_equal(got[disc < 0], ref[disc < 0])
    assert np.all(err <= 1e-5 + 1e-5 * np.abs(ref) + budget), (
        f"{int(np.sum(err > 1e-5 + 1e-5 * np.abs(ref) + budget))} pixels "
        f"beyond the budget; worst {float(np.max(err / (budget + 1e-5)))}")


def test_ray_struct_sphere_is_one_fused_program():
    n = 64
    img = _sphere_program(P, P.LazyArray, Vec3, Ray, select_struct, dot3,
                          n, {"device": "cpu"})
    n0 = P.stats()["n_evals"]
    out = img.numpy()
    assert P.stats()["n_evals"] == n0 + 1  # one fused program
    assert out.shape == (n * n,)
    assert out.min() >= 0.2 and out.max() > 10.0

    # parity with the hand-scalar render of examples/lazy_sphere_torch.py
    # and its struct form (the reference test's gate)
    from lazy_sphere_torch import render_lazy, render_lazy_struct

    ref = render_lazy(n, device="cpu").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(render_lazy_struct(n, device="cpu").numpy(),
                               ref, rtol=1e-5, atol=1e-5)

    # the same program on enoki_tpu's trace: XLA evaluates it in another
    # order, so that 10 of the 4,096 pixels (the silhouette and the
    # terminator) lie outside rtol / atol 1e-5 of the port's; every pixel
    # lies within the gate plus sphere_budget (the largest error is 0.42
    # of the two together)
    want = _sphere_program(J, J.LazyArray, JV.Vec3, JRay, JS.select_struct,
                           JV.dot3, n, {}).numpy()
    assert_sphere_close(out, want, n)


@pytest.mark.parametrize("form,cx", [("scalar", 0.0), ("scalar", 0.05),
                                     ("struct", 0.0)])
def test_lazy_sphere_example_matches_the_reference_example(form, cx):
    """examples/lazy_sphere_torch.py's render (each frame that its main
    draws) against examples/lazy_sphere.py's at 64^2, as
    tests/test_examples.py sizes the reference's run."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "lazy_sphere", os.path.join(REPO, "examples", "lazy_sphere.py"))
    ref_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_mod)
    from lazy_sphere_torch import render_lazy, render_lazy_struct

    n = 64
    if form == "scalar":
        got = render_lazy(n, cx=cx, device="cpu").numpy()
        want = ref_mod.render_lazy(n, cx=cx).numpy()
    else:
        got = render_lazy_struct(n, cx=cx, device="cpu").numpy()
        want = ref_mod.render_lazy_struct(n, cx=cx).numpy()
    assert got.shape == want.shape == (n * n,)
    assert_sphere_close(got, want, n, cx)


def _ids(vals):
    return L(np.asarray(vals, np.int32))


def test_dispatch_struct_args_and_struct_results():
    n = 6
    f = np.float32

    def program(tr, mk, dispatch, V, struct):
        @struct
        class PointLoad:
            p: object   # Vec3
            w: object   # a weight

        def scale2(mask, pl):
            return PointLoad(V(pl.p.x * 2.0, pl.p.y * 2.0, pl.p.z * 2.0),
                             pl.w * 10.0)

        def negate(mask, pl):
            return PointLoad(V(-pl.p.x, -pl.p.y, -pl.p.z), pl.w - 1.0)

        arg = PointLoad(V(mk(np.arange(n, dtype=f)),
                          mk(np.arange(n, dtype=f) + 10),
                          mk(np.arange(n, dtype=f) + 100)),
                        mk(np.ones(n, f)))
        out = dispatch([scale2, negate],
                       mk(np.array([0, 1, 0, 1, 0, 1], np.int32)), arg)
        assert isinstance(out, PointLoad)
        return out

    out = program(P, L, tc.dispatch, Vec3, enoki_struct)
    assert isinstance(out.p.x, P.LazyArray)
    want_x = np.where(np.arange(n) % 2 == 0, np.arange(n) * 2.0,
                      -np.arange(n, dtype=f))
    np.testing.assert_array_equal(out.p.x.numpy(), want_x)
    want_w = np.where(np.arange(n) % 2 == 0, 10.0, 0.0)
    np.testing.assert_array_equal(out.w.numpy(), want_w)
    ref = program(J, JL, JC.dispatch, JV.Vec3, j_struct)
    for leaf in ("x", "y", "z"):
        np.testing.assert_array_equal(getattr(out.p, leaf).numpy(),
                                      getattr(ref.p, leaf).numpy())
    np.testing.assert_array_equal(out.w.numpy(), ref.w.numpy())
    # the masked free dispatcher takes LazyArray ids and struct arguments
    # too: its select tree records into the trace
    from enoki_tpu_torch.struct import dispatch_masked
    out_m = program(P, L, dispatch_masked, Vec3, enoki_struct)
    np.testing.assert_array_equal(out_m.p.x.numpy(), want_x)
    np.testing.assert_array_equal(out_m.w.numpy(), want_w)


def test_dispatch_struct_fuses_and_differentiates():
    def f0(mask, vv):
        return vv.x + vv.y          # d/dx = 3

    def f1(mask, vv):
        return vv.z * vv.z          # d/dx = 18x

    def grad(tr, mk, V, dispatch):
        x = tr.requires_grad(mk(np.array([1.0, 2.0, 3.0, 4.0], np.float32)))
        v = V(x * 1.0, x * 2.0, x * 3.0)
        out = dispatch([f0, f1], mk(np.array([0, 0, 1, 1], np.int32)), v)
        tr.backward(out.hsum())
        return tr.gradient(x).numpy()

    got = grad(P, L, Vec3, tc.dispatch)
    np.testing.assert_allclose(got, [3.0, 3.0, 18.0 * 3.0, 18.0 * 4.0],
                               rtol=1e-5)
    np.testing.assert_array_equal(got, grad(J, JL, JV.Vec3, JC.dispatch))


def test_dispatch_struct_structure_mismatch_raises():
    def f_struct(mask, v):
        return type(v)(v.x, v.y, v.z)

    def f_flat(mask, v):
        return v.x

    for mk, V, dispatch in ((L, Vec3, tc.dispatch),
                            (JL, JV.Vec3, JC.dispatch)):
        v = V(*(mk(np.ones(2, np.float32)) for _ in range(3)))
        with pytest.raises(ValueError, match="structure"):
            dispatch([f_struct, f_flat], mk(np.array([0, 1], np.int32)), v)


def _masked_ops(masked, mk):
    x = mk(np.array([1., 2., 3., 4.], np.float32))
    m = x > 2.0
    return [masked(x, m).add(10.0), masked(x, m).assign(0.0),
            masked(x, m).min(3.5), masked(x, m).max(3.5),
            masked(x, m).div(4.0), masked(x, m).sub(1.0),
            masked(x, m).mul(3.0)]


def test_masked_proxy_on_lazy():
    from enoki_tpu_torch.struct import masked

    outs = _masked_ops(masked, L)
    assert all(isinstance(o, P.LazyArray) for o in outs)
    for got, want in zip(outs, ([1, 2, 13, 14], [1, 2, 0, 0],
                                [1, 2, 3, 3.5], [1, 2, 3.5, 4],
                                [1, 2, 0.75, 1], [1, 2, 2, 3],
                                [1, 2, 9, 12])):
        np.testing.assert_array_equal(got.numpy(), want)
    for got, ref in zip(outs, _masked_ops(JS.masked, JL)):
        assert got.numpy().dtype == ref.numpy().dtype
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_concat_and_set_slice_struct_lazy():
    from enoki_tpu_torch.struct.pytree import concat_structs, set_slice_struct

    def cat(concat, mk):
        return concat({"v": mk(np.array([1.0, 2.0], np.float32))},
                      {"v": mk(np.array([3.0, 4.0, 5.0], np.float32))})

    c = cat(concat_structs, L)
    assert isinstance(c["v"], P.LazyArray) and c["v"].device.type == "cpu"
    np.testing.assert_array_equal(c["v"].numpy(), [1, 2, 3, 4, 5])
    np.testing.assert_array_equal(c["v"].numpy(),
                                  cat(j_concat, JL)["v"].numpy())

    def put(set_slice, mk, dtype, value):
        s = {"k": mk(np.zeros(2, dtype))}
        s["k"].numpy()
        return set_slice(s, 0, {"k": value})["k"]

    # an int leaf takes no float detour: ints pass through as literals
    s2 = put(set_slice_struct, L, np.int32, 7)
    assert int(s2.numpy()[0]) == 7 and s2.dtype == torch.int32
    r2 = put(j_set_slice, JL, np.int32, 7)
    np.testing.assert_array_equal(s2.numpy(), r2.numpy())
    assert s2.numpy().dtype == r2.numpy().dtype

    # a 64-bit leaf (the trace's 64-bit codes are real): an int past 2^53
    # is set exactly; the reference's needs x64 for it
    big = (1 << 60) + 1
    s2 = put(set_slice_struct, L, np.uint64, big)
    assert int(s2.numpy()[0]) == big
    with jax.enable_x64():
        r2 = put(j_set_slice, JL, np.uint64, big)
        np.testing.assert_array_equal(s2.numpy(), r2.numpy())


def test_concat_structs_lazy_promotes_dtype():
    from enoki_tpu_torch.struct.pytree import concat_structs

    a = np.array([1, 2, 3], np.int32)
    b = np.array([0.5, 1.5], np.float32)
    c = concat_structs({"v": L(a)}, {"v": torch.from_numpy(b)})
    assert c["v"].dtype == torch.float32
    np.testing.assert_array_equal(c["v"].numpy(), [1, 2, 3, 0.5, 1.5])
    import jax.numpy as jnp
    r = j_concat({"v": JL(a)}, {"v": jnp.asarray(b)})
    np.testing.assert_array_equal(c["v"].numpy(), r["v"].numpy())
