"""The port's vectorized calls on the lazy trace (enoki_tpu_torch.trace.call)
against the reference's (enoki_tpu.trace.call) on the CPU: twins of the
17 tests of tests/test_trace_call.py, each program run through both
packages on the same numpy inputs and held to the reference's result and
to the expected values (exact, or the reference test's tolerance).

The port's partition sorts on the ids' device and reads the instance
list to the host in one transfer; its permutations are int32 tensors on
that device (docs/port.md, the tape and calls).
"""

import importlib

import numpy as np
import pytest
import torch

import enoki_tpu.trace as J
import enoki_tpu.trace.call as JC
import enoki_tpu_torch.trace as P
import enoki_tpu_torch.trace.call as PC
from enoki_tpu.struct.call import InstanceRegistry as JRegistry
from enoki_tpu_torch.struct.call import InstanceRegistry as PRegistry


@pytest.fixture(autouse=True)
def _fresh():
    J.reset()
    P.reset()
    yield
    J.reset()
    P.reset()


class Thing:
    """tests/call.cpp's Test class: func1 adds ``value`` lane by lane."""

    def __init__(self, tr, value):
        self.tr, self.value = tr, value

    def func1(self, mask, i):
        return i + float(self.value)

    def func4(self, mask):
        # a method of two results (std::pair, tests/call.cpp:53)
        n = len(mask)
        kw = {"device": "cpu"} if self.tr is P else {}
        return (self.tr.LazyArray.full(float(self.value), n, **kw),
                self.tr.LazyArray.full(float(self.value + 1), n, **kw))


def both(prog):
    """``prog(tr, tc, L, ids)`` through the reference and the port: ``tc``
    is the package's ``trace.call``, ``L`` makes a LazyArray from numpy,
    ``ids`` from a list of int32 ids."""
    out = []
    for tr, tc in ((J, JC), (P, PC)):
        def L(a, tr=tr):
            if tr is P:
                return P.LazyArray(np.asarray(a), device="cpu")
            return J.LazyArray(np.asarray(a))

        def ids(lst, L=L):
            return L(np.array(lst, np.int32))
        out.append(prog(tr, tc, L, ids))
    return out


def same(ref, port, want=None, **tol):
    ref, port = np.asarray(ref), np.asarray(port)
    if tol:
        np.testing.assert_allclose(port, ref, **tol)
    else:
        np.testing.assert_array_equal(port, ref)
    if want is not None:
        np.testing.assert_allclose(port, want, **tol)


def test_partition_matches_cuda_partition():
    def prog(tr, tc, L, ids):
        parts = tc.partition(ids([2, 0, 2, 1, 0, 2]))
        got = {inst: sorted(np.asarray(perm).tolist())
               for inst, perm in parts}
        assert got == {0: [1, 4], 1: [3], 2: [0, 2, 5]}
        return np.concatenate([np.asarray(p) for _, p in parts])
    ref, port = both(prog)
    # the concatenation is the stable sort permutation (horiz.cu:35-123)
    same(ref, port, np.argsort(np.array([2, 0, 2, 1, 0, 2]), kind="stable"))


def test_partition_cached_on_array():
    def prog(tr, tc, L, ids):
        a = ids([0, 1, 0, 1])
        p1 = tc.partition(a)
        assert tc.partition(a) is p1  # cached like cuda.h:815-842
        a.scatter(L(np.array([0, 2], np.int32)),
                  L(np.array([1, 1], np.int32)))
        p3 = tc.partition(a)  # a scatter dirtied the array: [1, 1, 1, 1]
        assert p3 is not p1
        return sorted(i for i, _ in p3)
    ref, port = both(prog)
    assert ref == port == [1]


def test_dispatch_basic_call_cpp_port():
    def prog(tr, tc, L, ids):
        a, b = Thing(tr, 10), Thing(tr, 20)
        kw = {"device": "cpu"} if tr is P else {}
        idx = tr.LazyArray.arange(4, **kw).cast(np.float32)
        return tc.dispatch([a.func1, b.func1], ids([0, 0, 1, 0]),
                           idx).numpy()
    ref, port = both(prog)
    same(ref, port, [0 + 10, 1 + 10, 2 + 20, 3 + 10])


def test_dispatch_is_one_fused_program():
    def prog(tr, tc, L, ids):
        fs = [Thing(tr, v).func1 for v in (1, 2, 3)]
        x = L(np.arange(8, dtype=np.float32))
        out = tc.dispatch(fs, ids([0, 1, 2, 1, 0, 2, 2, 1]), x)
        before = tr.stats()["n_evals"]
        got = out.numpy()
        # one eval fuses the gathers, the three callees and the scatters
        assert tr.stats()["n_evals"] == before + 1
        return got
    ref, port = both(prog)
    same(ref, port, np.arange(8.0) + np.array([1, 2, 3, 2, 1, 3, 3, 2]))


def test_dispatch_retrace_hits_cache():
    def prog(tr, tc, L, ids):
        fs = [Thing(tr, 5).func1, Thing(tr, 7).func1]

        def step(data):
            return tc.dispatch(fs, ids([0, 1, 1, 0]), L(data)).numpy()
        step(np.zeros(4, np.float32))
        h0, m0 = tr.cache_stats()
        got = step(np.ones(4, np.float32))
        h1, m1 = tr.cache_stats()
        assert m1 == m0 and h1 > h0  # the same structure: a cache hit
        return got
    ref, port = both(prog)
    same(ref, port, [6, 8, 8, 6])


def test_dispatch_single_instance_fast_path():
    def prog(tr, tc, L, ids):
        i = ids([0, 0, 0])
        x = L(np.array([1.0, 2.0, 3.0], np.float32))
        before = tr.stats()["n_appends"]
        out = tc.dispatch([Thing(tr, 100).func1], i, x)
        # no gather or scatter recorded (array_call.h:150-151)
        assert tr.stats()["n_appends"] - before <= 3
        return out.numpy()
    ref, port = both(prog)
    same(ref, port, [101, 102, 103])


def test_dispatch_null_ids_produce_zeros():
    def prog(tr, tc, L, ids):
        fs = [Thing(tr, 10).func1, Thing(tr, 20).func1]
        return tc.dispatch(fs, ids([0, -1, 1, -1]),
                           L(np.ones(4, np.float32))).numpy()
    ref, port = both(prog)
    same(ref, port, [11, 0, 21, 0])


def test_dispatch_all_null_keeps_result_structure():
    def prog(tr, tc, L, ids):
        fs = [Thing(tr, 10).func4, Thing(tr, 20).func4]
        first, second = tc.dispatch(fs, ids([-1, -1, -1]))

        def struct_callee(mask, x):
            return {"y": x * 2.0, "z": (x + 1.0, x.cast(np.int32))}

        x = L(np.array([1.0, 2.0, 3.0], np.float32))
        out = tc.dispatch([struct_callee], ids([-1, -1, -1]), x)
        assert set(out.keys()) == {"y", "z"}
        assert str(out["z"][1].dtype).endswith("int32")
        return [first.numpy(), second.numpy(), out["y"].numpy(),
                out["z"][0].numpy(), out["z"][1].numpy()]
    ref, port = both(prog)
    for r, p in zip(ref, port):
        same(r, p, [0, 0, 0])


def test_dispatch_multi_results():
    def prog(tr, tc, L, ids):
        fs = [Thing(tr, 10).func4, Thing(tr, 20).func4]
        first, second = tc.dispatch(fs, ids([1, 0, 1]))
        return first.numpy(), second.numpy()
    ref, port = both(prog)
    same(ref[0], port[0], [20, 10, 20])
    same(ref[1], port[1], [21, 11, 21])


def test_registry_dispatch_and_getter():
    def prog(tr, tc, L, ids):
        reg = (JRegistry if tr is J else PRegistry)()
        reg.register(Thing(tr, 10))
        reg.register(Thing(tr, 20))
        i = ids([0, 1, -1, 0])
        out = reg.dispatch("func1", i, L(np.zeros(4, np.float32)))
        return out.numpy(), reg.getter("value", i).numpy()
    ref, port = both(prog)
    same(ref[0], port[0], [10, 20, 0, 10])
    same(ref[1], port[1], [10, 20, 0, 10])


def test_gradient_through_dispatch():
    class Scaler:
        def __init__(self, k):
            self.k = k

        def apply(self, mask, x):
            return x * self.k

    def prog(tr, tc, L, ids):
        x = tr.requires_grad(L(np.array([1., 2., 3., 4.], np.float32)))
        out = tc.dispatch([Scaler(2.0).apply, Scaler(5.0).apply],
                          ids([0, 1, 1, 0]), x)
        tr.backward((out * out).hsum())
        return tr.gradient(x).numpy()
    ref, port = both(prog)
    # d/dx (k x)^2 = 2 k^2 x
    same(ref, port, 2 * np.array([4, 25, 25, 4]) * np.array([1, 2, 3, 4]))


def test_scatter_chain_fuses():
    def prog(tr, tc, L, ids):
        tgt = L(np.zeros(6, np.float32))
        tgt.scatter(L(np.array([0, 1], np.int32)),
                    L(np.array([1.0, 2.0], np.float32)))
        tgt.scatter(L(np.array([1, 2], np.int32)),
                    L(np.array([30.0, 40.0], np.float32)))
        tgt.scatter_add(L(np.array([0], np.int32)),
                        L(np.array([0.5], np.float32)))
        before = tr.stats()["n_evals"]
        got = tgt.numpy()
        assert tr.stats()["n_evals"] == before + 1
        return got
    ref, port = both(prog)
    same(ref, port, [1.5, 30, 40, 0, 0, 0])


def test_partition_invalidated_at_scatter_not_dirty_flag():
    def prog(tr, tc, L, ids):
        a = ids([0, 0, 1, 1])
        p1 = tc.partition(a)
        a.scatter(L(np.array([0, 1, 2, 3], np.int32)),
                  L(np.array([1, 1, 1, 1], np.int32)))
        tr.eval()  # flushes the scatter and clears the dirty flag
        p2 = tc.partition(a)
        assert p2 is not p1
        return sorted(i for i, _ in p2)
    ref, port = both(prog)
    assert ref == port == [1]


def test_held_scatter_handle_gradient_not_doubled():
    def prog(tr, tc, L, ids):
        x = tr.requires_grad(L(np.array([1.0, 2.0], np.float32)))
        tgt = L(np.zeros(2, np.float32))
        op = tgt._scatter_op(tr.Op.SCATTER_ADD,
                             L(np.array([0, 1], np.int32)), x * 3.0)
        tr.eval()  # op is live (held) and a side effect: one output slot
        tr.backward((tgt * tgt).hsum())
        del op
        return tr.gradient(x).numpy()
    ref, port = both(prog)
    # d/dx sum((3x)^2) = 18 x; a doubled slot would give 36 x
    same(ref, port, 18.0 * np.array([1.0, 2.0]))


def test_dispatch_dtype_disagreement_raises():
    def prog(tr, tc, L, ids):
        def f_int(mask, x):
            return x.cast(np.int32)

        def f_float(mask, x):
            return x * 0.5

        with pytest.raises(ValueError, match="dtype"):
            tc.dispatch([f_int, f_float], ids([0, 1]),
                        L(np.array([1.0, 2.0], np.float32)))
        return True
    assert both(prog) == [True, True]


def test_partition_cache_lru_keeps_hot_entry():
    def prog(tr, tc, L, ids):
        hot = ids([0, 1, 0, 1])
        p0 = tc.partition(hot)
        for k in range(256):
            tc.partition(ids([k % 3, 1]))
            tc.partition(hot)  # touch: refresh its recency
        assert tc._PARTITION_CACHE.get(hot.index) is not None
        assert tc.partition(hot) is p0  # the same object, never rebuilt
        return len(tc._PARTITION_CACHE)
    ref, port = both(prog)
    assert ref == port == 256


def test_dispatch_all_null_probe_has_no_side_effects(capfd):
    def prog(tr, tc, L, ids):
        target = L(np.zeros(4, np.float32))
        target.numpy()

        def noisy(mask, x):
            y = tr.printf("probe leaked {}", x)
            float(y.hsum().numpy()[0])  # an eval in the middle of the probe
            target.scatter(x.cast(np.int32) * 0, x)
            return x * 2.0

        x = L(np.array([1.0, 2.0, 3.0], np.float32))
        out = tc.dispatch([noisy], ids([-1, -1, -1]), x).numpy()
        assert not tr._PRINT_FMT  # no pending print
        num = tr._lib.et_num_side_effects if tr is J \
            else tr._lib.ett_num_side_effects
        assert num() == 0
        y = (L(np.ones(3, np.float32)) + 1.0).numpy()
        cap = capfd.readouterr()
        assert "probe leaked" not in cap.out + cap.err
        return out, y, target.numpy()
    ref, port = both(prog)
    for r, p, w in zip(ref, port, (0.0, 2.0, 0.0)):
        same(r, p, np.full(np.asarray(r).shape, w))


def test_call_module_exports_the_references_names():
    names = [n for n in vars(JC) if not n.startswith("_")
             and callable(getattr(JC, n))
             and getattr(getattr(JC, n), "__module__", "") == JC.__name__]
    assert set(names) == {"partition", "dispatch", "getter",
                          "registry_dispatch", "registry_getter",
                          "clear_partition_cache"}
    mod = importlib.import_module("enoki_tpu_torch.trace.call")
    for n in names:
        assert callable(getattr(mod, n)), n


def test_partition_stays_on_the_device():
    ids = P.LazyArray(np.array([3, -1, 3, 0, 2], np.int32), device="cpu")
    parts = PC.partition(ids)
    assert [i for i, _ in parts] == [-1, 0, 2, 3]
    assert all(isinstance(p, torch.Tensor) and p.dtype == torch.int32
               for _, p in parts)
    assert PC._CACHE_BYTES == sum(int(p.nbytes) for _, p in parts)
