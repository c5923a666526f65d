"""Differential fuzzing of the port's lazy trace (counterpart of
tests/test_trace_fuzz.py).

Random op DAGs are built three times from one recipe -- over the
reference's LazyArray, over the port's (on the CPU: its plain
interpreter) and over numpy in float64 -- on the same numpy inputs; the
port must agree with numpy under the reference test's gates (rtol 2e-5,
atol 1e-6; float64 rtol 1e-12, atol 1e-14) and with the reference under
the same gates. Each seed retraces its program with fresh data (a cache
hit), and scatter / gather rounds mix side effects in. The promotion
matrix is held to jnp.promote_types, the values to the reference's.
The same recipes go through the tape: the port's backward() of
hsum(out) against jax.grad of the eager replay and against the
reference tape's, under the reference test's gate (rtol 5e-4, atol
1e-5); and random vectorised calls (trace.call.dispatch) against a
per-lane simulation and against the reference's dispatch.
"""

import numpy as np
import pytest
import torch

import enoki_tpu.trace as J
import enoki_tpu_torch.trace as P
from enoki_tpu_torch.config import config as PCFG


@pytest.fixture(autouse=True)
def _fresh():
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()


def make(tr):
    if tr is P:
        return lambda a: P.LazyArray(np.asarray(a), device="cpu")
    return lambda a: J.LazyArray(np.asarray(a))


# (name, arity, lazy fn over a trace module, numpy reference)
OPS = [
    ("add", 2, lambda t, a, b: a + b, lambda a, b: a + b),
    ("sub", 2, lambda t, a, b: a - b, lambda a, b: a - b),
    ("mul", 2, lambda t, a, b: a * b, lambda a, b: a * b),
    ("min", 2, lambda t, a, b: t.minimum(a, b), np.minimum),
    ("max", 2, lambda t, a, b: t.maximum(a, b), np.maximum),
    ("fma", 3, lambda t, a, b, c: t.fmadd(a, b, c), lambda a, b, c: a * b + c),
    ("neg", 1, lambda t, a: -a, lambda a: -a),
    ("abs", 1, lambda t, a: abs(a), np.abs),
    ("sqrt|x|", 1, lambda t, a: t.sqrt(abs(a) + 0.25),
     lambda a: np.sqrt(np.abs(a) + 0.25)),
    ("tanh", 1, lambda t, a: t.tanh(a), np.tanh),
    ("sin", 1, lambda t, a: t.sin(a), np.sin),
    ("exp/8", 1, lambda t, a: t.exp(a * 0.125), lambda a: np.exp(a * 0.125)),
    ("sel", 2, lambda t, a, b: t.select(a > b, a, b * 0.5),
     lambda a, b: np.where(a > b, a, b * 0.5)),
    ("scal", 1, lambda t, a: a * 1.5 + 0.25, lambda a: a * 1.5 + 0.25),
]


def recipe(rng, n_leaves, depth):
    out, pool = [], n_leaves
    for _ in range(depth):
        k = int(rng.integers(len(OPS)))
        out.append((k, tuple(int(rng.integers(pool))
                             for _ in range(OPS[k][1]))))
        pool += 1
    return out


def replay(rec, leaves, tr=None, dtype=np.float32):
    """The recipe over ``tr``'s LazyArrays (None: numpy)."""
    if tr is None:
        pool = [l.copy() for l in leaves]
    else:
        L = make(tr)
        pool = [L(l.astype(dtype)) for l in leaves]
    for k, slots in rec:
        args = [pool[s] for s in slots]
        pool.append(OPS[k][3](*args) if tr is None else OPS[k][2](tr, *args))
    return pool[-1]


@pytest.mark.parametrize("seed", range(20))
def test_fuzz_random_dag(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 65))
    n_leaves = int(rng.integers(2, 5))
    leaves = [rng.uniform(-2, 2, n) for _ in range(n_leaves)]
    rec = recipe(rng, n_leaves, int(rng.integers(5, 40)))
    want = replay(rec, leaves)
    ref = replay(rec, leaves, J).numpy().astype(np.float64)
    got = replay(rec, leaves, P).numpy().astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)

    h0, m0 = P.cache_stats()
    leaves2 = [rng.uniform(-2, 2, n) for _ in range(n_leaves)]
    got2 = replay(rec, leaves2, P).numpy().astype(np.float64)
    h1, m1 = P.cache_stats()
    assert m1 == m0, "retrace of an identical structure recompiled"
    assert h1 == h0 + 1
    np.testing.assert_allclose(got2, replay(rec, leaves2), rtol=2e-5,
                               atol=1e-6)


def scatter_rounds(tr, seed):
    """The reference test's scatter / gather rounds over ``tr`` (None:
    the float64 numpy reference)."""
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(8, 33))
    base_np = rng.uniform(-1, 1, n).astype(np.float32)
    src_np = rng.uniform(-1, 1, n).astype(np.float32)
    if tr is None:
        base, src = base_np.astype(np.float64), src_np.astype(np.float64)
    else:
        L = make(tr)
        base, src = L(base_np.copy()), L(src_np.copy())
    for _ in range(int(rng.integers(2, 6))):
        k = int(rng.integers(1, n))
        idx = rng.integers(0, n, k).astype(np.int32)
        choice = rng.integers(4)
        if tr is None:
            if choice == 0:
                np.add.at(base, idx, src[idx] * 0.5)
            elif choice == 1:
                src = src + base.sum()
            elif choice == 2:
                base[np.unique(idx)] = 0.25
            else:
                src = src + base[idx].sum()
                np.add.at(base, idx, 0.125)
            continue
        idx_l = L(idx)
        if choice == 0:
            base.scatter_add(idx_l, src.gather(idx_l) * 0.5)
        elif choice == 1:
            src = src + base.hsum()
        elif choice == 2:
            uniq = np.unique(idx)
            base.scatter(L(uniq.astype(np.int32)),
                         L(np.full(len(uniq), 0.25, np.float32)))
        else:
            g = base.gather(idx_l)
            base.scatter_add(idx_l, L(np.full(k, 0.125, np.float32)))
            src = src + g.hsum()
    if tr is None:
        return base, src
    return base.numpy().astype(np.float64), src.numpy().astype(np.float64)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_scatter_gather_rounds(seed):
    want = scatter_rounds(None, seed)
    ref = scatter_rounds(J, seed)
    got = scatter_rounds(P, seed)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5)


PROMOTION_DTYPES = ["float32", "bfloat16", "float16", "int32", "uint32",
                    "bool"]


@pytest.mark.parametrize("da", PROMOTION_DTYPES)
def test_promotion_matrix_matches_jnp(da):
    import jax.numpy as jnp

    for db in PROMOTION_DTYPES:
        a_np = np.array([0, 1, 2, 3]).astype(jnp.dtype(da))
        b_np = np.array([1, 1, 2, 2]).astype(jnp.dtype(db))
        ea = jnp.asarray(a_np) + jnp.asarray(b_np)
        want = jnp.promote_types(jnp.dtype(da), jnp.dtype(db))
        la = P.LazyArray(a_np, device="cpu") + P.LazyArray(b_np, device="cpu")
        assert str(la.dtype).split(".")[1] == want.name == ea.dtype.name, \
            (da, db, la.dtype, want)
        ra = J.LazyArray(a_np) + J.LazyArray(b_np)
        np.testing.assert_array_equal(
            np.asarray(la.numpy(), np.float64),
            np.asarray(ra.numpy(), np.float64), err_msg=f"{da} {db}")
        np.testing.assert_array_equal(
            np.asarray(la.numpy(), np.float64),
            np.asarray(ea.astype(jnp.float32), np.float64))


@pytest.mark.parametrize("seed", (301, 302, 303))
def test_fuzz_random_dag_f64(seed):
    import jax
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 33))
    leaves = [rng.uniform(-2, 2, n) for _ in range(3)]
    rec = recipe(rng, 3, 15)
    out = replay(rec, leaves, P, np.float64)
    assert out.dtype == torch.float64
    got = out.numpy()
    want = replay(rec, leaves)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    with jax.enable_x64():
        ref = replay(rec, leaves, J, np.float64).numpy()
    assert ref.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_random_dag_edge_values(seed):
    rng = np.random.default_rng(10_000 + seed)
    n = int(rng.integers(8, 33))
    n_leaves = int(rng.integers(2, 5))
    edges = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float64)
    leaves = []
    for _ in range(n_leaves):
        l = rng.uniform(-2, 2, n)
        k = int(rng.integers(1, max(2, n // 4)))
        pos = rng.choice(n, size=k, replace=False)
        l[pos] = rng.choice(edges, size=k)
        leaves.append(l)
    rec = recipe(rng, n_leaves, int(rng.integers(5, 30)))
    want = replay(rec, [l.astype(np.float32) for l in leaves])
    got = replay(rec, leaves, P).numpy().astype(np.float64)
    ref = replay(rec, leaves, J).numpy().astype(np.float64)
    np.testing.assert_allclose(got, want.astype(np.float64), rtol=2e-5,
                               atol=1e-6, equal_nan=True)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6,
                               equal_nan=True)
    # the sign of a zero result follows the reference's too
    z = (got == 0) & (ref == 0)
    np.testing.assert_array_equal(np.signbit(got[z]), np.signbit(ref[z]))


@pytest.mark.parametrize("seed", range(4))
def test_max_fused_ops_is_bit_equal(seed):
    # a segmented evaluation (config.max_fused_ops) gives the bits of the
    # whole one
    rng = np.random.default_rng(700 + seed)
    n = int(rng.integers(8, 65))
    leaves = [rng.uniform(-2, 2, n) for _ in range(3)]
    rec = recipe(rng, 3, 60)
    whole = replay(rec, leaves, P).torch()
    P.reset()
    PCFG.max_fused_ops = int(rng.integers(3, 17))
    try:
        seg = replay(rec, leaves, P).torch()
    finally:
        PCFG.max_fused_ops = 0
    assert torch.equal(whole, seg)


def _jnp_recipe(rec):
    """The recipe over jnp arrays, each op as the reference's trace
    lowers it."""
    import jax.numpy as jnp

    impl = {"min": jnp.minimum, "max": jnp.maximum,
            "fma": lambda a, b, c: a * b + c,
            "sqrt|x|": lambda a: jnp.sqrt(jnp.abs(a) + 0.25),
            "tanh": jnp.tanh, "sin": jnp.sin,
            "exp/8": lambda a: jnp.exp(a * 0.125),
            "sel": lambda a, b: jnp.where(a > b, a, b * 0.5),
            "scal": lambda a: a * 1.5 + 0.25, "neg": lambda a: -a,
            "abs": jnp.abs, "add": lambda a, b: a + b,
            "sub": lambda a, b: a - b, "mul": lambda a, b: a * b}

    def f(ls):
        pool = list(ls)
        for k, slots in rec:
            pool.append(impl[OPS[k][0]](*[pool[s] for s in slots]))
        return jnp.sum(pool[-1])
    return f


def _tape_grads(tr, rec, leaves):
    xs = [tr.requires_grad(make(tr)(l)) for l in leaves]
    pool = list(xs)
    for k, slots in rec:
        pool.append(OPS[k][2](tr, *[pool[s] for s in slots]))
    tr.backward(pool[-1].hsum())
    return [tr.gradient(x).numpy().astype(np.float64) for x in xs]


@pytest.mark.parametrize("seed", range(10))
def test_fuzz_backward_matches_jax_grad(seed):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(500 + seed)
    n = int(rng.integers(4, 33))
    n_leaves = int(rng.integers(2, 4))
    leaves = [rng.uniform(-1.5, 1.5, n).astype(np.float32)
              for _ in range(n_leaves)]
    rec = recipe(rng, n_leaves, int(rng.integers(4, 25)))
    got = _tape_grads(P, rec, leaves)
    ref = _tape_grads(J, rec, leaves)
    want = jax.grad(_jnp_recipe(rec))([jnp.asarray(l) for l in leaves])
    for g, r, w in zip(got, ref, want):
        np.testing.assert_allclose(g, np.asarray(w, np.float64),
                                   rtol=5e-4, atol=1e-5)
        np.testing.assert_allclose(g, r, rtol=5e-4, atol=1e-5)


def _vcall(tr, chains, ids, x_np, y_np):
    import importlib
    tc = importlib.import_module(tr.__name__ + ".call")
    L = make(tr)

    def make_callee(chain):
        def f(mask, xx, yy):
            pool = [xx, yy]
            out = pool[0]
            for k, slots in chain:
                out = OPS[k][2](tr, *[pool[s] for s in slots])
                pool[0] = out  # feed forward through slot 0
            return out
        return f

    out = tc.dispatch([make_callee(c) for c in chains], L(ids), L(x_np),
                      L(y_np))
    return out.numpy().astype(np.float64)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_vcall_dispatch(seed):
    rng = np.random.default_rng(900 + seed)
    n = int(rng.integers(6, 40))
    k = int(rng.integers(1, 5))
    ids = rng.integers(-1, k, n).astype(np.int32)  # -1 = null lanes
    x_np = rng.uniform(-2, 2, n).astype(np.float32)
    y_np = rng.uniform(-2, 2, n).astype(np.float32)
    chains = []
    for _ in range(k):
        chain = []
        for _ in range(int(rng.integers(1, 5))):
            op = int(rng.integers(len(OPS)))
            chain.append((op, tuple(int(rng.integers(2))
                                    for _ in range(OPS[op][1]))))
        chains.append(chain)

    want = np.zeros(n)
    for i, chain in enumerate(chains):
        m = ids == i
        if m.any():
            pool = [x_np.astype(np.float64), y_np.astype(np.float64)]
            out = pool[0]
            for op, slots in chain:
                out = OPS[op][3](*[pool[s] for s in slots])
                pool[0] = out
            want[m] = out[m]
    got = _vcall(P, chains, ids, x_np, y_np)
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=1e-6)
    np.testing.assert_allclose(got, _vcall(J, chains, ids, x_np, y_np),
                               rtol=3e-5, atol=1e-6)
