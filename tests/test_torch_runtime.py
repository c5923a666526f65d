"""The port's runtime layer against the reference's gates: runtime and
checkpoints (tests/test_ad_runtime.py:57-191), the caches
(tests/test_cache.py:27-70, :95-99; the export-write eviction test,
:72-92, needs trace/ and waits for its port), config's functions and
interop's round trips, on the CPU.

Tolerances: none. Checkpoints, interop and the configuration move values
and must give back the same bits; the autograd bridge's gradients are
compared with their closed forms at atol 1e-6, as the reference's test
compares them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

import enoki_tpu_torch as E
from enoki_tpu_torch import _build, cache, runtime
from enoki_tpu_torch.config import config
from enoki_tpu_torch.interop import (from_numpy, from_torch, to_numpy,
                                     to_torch, torch_wrap)
from enoki_tpu_torch.runtime import checkpoint as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


# -- runtime (tests/test_ad_runtime.py:57-106, :170-191) -------------------


def test_runtime_dumps_and_timings():
    def f(x):
        return torch.tanh(x) + 1.0

    x = torch.ones(16)
    assert "tanh" in runtime.dump_jaxpr(f, x)
    hlo = runtime.dump_hlo(f, x)
    assert "tanh" in hlo
    assert "aten::tanh" in runtime.dump_hlo(f, x, stage="optimized")
    t = runtime.compile_timings(f, x)
    assert t["n_eqns"] >= 2
    assert t["compile_s"] > 0 and t["trace_s"] > 0 and t["lower_s"] > 0
    # the cache-hit contract (gpu.rst:268-271), as the reference's test
    # states it
    assert t["cache_hit_s"] < max(t["compile_s"], 1e-3) * 5


def test_whos_live_arrays():
    keep = torch.ones((128, 128))
    out = runtime.whos(print_out=False)
    assert "Total:" in out and "(128, 128)" in out
    row = next(r for r in out.splitlines() if "(128, 128)" in r)
    assert "float32" in row and "65536" in row and "cpu" in row
    st = runtime.cache_stats()
    assert st["live_arrays"] >= 1 and st["live_bytes"] >= 65536
    del keep


def test_memory_stats():
    stats = runtime.memory_stats(CPU)
    assert "bytes_in_use" in stats and stats["bytes_limit"] is None
    keep = torch.ones(1 << 16)
    assert runtime.memory_stats(CPU)["bytes_in_use"] >= 4 << 16
    del keep
    if not torch.cuda.is_available():  # the card by default, or raise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            runtime.memory_stats()


def test_printf_and_label(capsys):
    def f(x):
        with runtime.label("shade"):
            y = x * 2.0
        runtime.printf("y = {} at {where}", y, where="shade")
        return y

    assert f(torch.ones(4)).tolist() == [2, 2, 2, 2]
    assert "y = [2. 2. 2. 2.] at shade" in capsys.readouterr().out


def test_vectorization_report():
    # ENOKI_TRACK_SCALAR analog (fwd.h:208-233): a call that stays on the
    # device passes; one that reads a value to the host is caught
    x = torch.linspace(0, 1, 128)

    def good(v):
        return torch.sin(v) * 2.0 + torch.sqrt(v * v + 1.0)

    rep = runtime.assert_vectorized(good, x)
    assert rep["host_transfers"] == 0 and rep["custom_calls"] == 0

    def bad(v):
        return v * v[0].item()

    rep_bad = runtime.vectorization_report(bad, x)
    assert rep_bad["custom_calls"] > 0 or rep_bad["host_transfers"] > 0
    assert rep_bad["host_transfers"] == 1
    with pytest.raises(AssertionError, match="transfers to the host"):
        runtime.assert_vectorized(bad, x)


def test_vectorization_report_counts_the_ports_launches(monkeypatch):
    def launching(v):
        _build.LAUNCHES["hist"] += 1
        return v + 1

    rep = runtime.vectorization_report(launching, torch.ones(4))
    assert rep["custom_calls"] == 1 and rep["while_loops"] == 0
    with pytest.raises(AssertionError, match="kernel launches"):
        runtime.assert_vectorized(launching, torch.ones(4))
    runtime.assert_vectorized(launching, torch.ones(4), allow_custom_calls=1)


def test_eval_shapes_and_profiler_trace(tmp_path):
    out = runtime.eval_shapes(lambda a, b: (a @ b, a.sum(0)),
                              torch.ones(4, 3), torch.ones(3, 5))
    assert [tuple(o.shape) for o in out] == [(4, 5), (3,)]
    assert all(o.device.type == "meta" for o in out)
    with runtime.profiler_trace(str(tmp_path)):
        torch.ones(8).sum()
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_enable_compile_cache_sets_the_build_directory(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    runtime.enable_compile_cache(str(tmp_path / "kernels"))
    assert _build.BUILD_DIR == (tmp_path / "kernels").resolve()


def test_runtime_exports_the_log_functions():
    runtime.set_log_level(0)
    assert runtime.log_level() == 0 and runtime.config is config
    # the reference's in-kernel print: a print node of the scene emitter
    from enoki_tpu_torch.render import sdf_trace
    assert runtime.kernel_printf is sdf_trace.kernel_printf


# -- checkpoints (tests/test_ad_runtime.py:136-159) ------------------------


def _train_state():
    from enoki_tpu_torch.render import SphereScene, scene_to_vec
    from enoki_tpu_torch.types import PCG32
    scene = SphereScene.reference(CPU)
    p = torch.nn.Parameter(scene_to_vec(scene).clone())
    opt = torch.optim.Adam([p], lr=1e-2)
    (p * p).sum().backward()
    opt.step()
    return {"scene": scene, "opt": opt.state_dict(),
            "rng": PCG32.create(64, device=CPU), "step": 3}


def _assert_equal_trees(a, b):
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    assert sa == sb and len(la) == len(lb)
    for u, v in zip(la, lb):
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v)
        else:
            assert type(u) is type(v) and u == v


def test_checkpoint_roundtrip(tmp_path):
    state = _train_state()
    root = str(tmp_path / "ckpts")
    ck.save_step(root, 3, state)
    ck.save_step(root, 7, state)
    assert ck.latest_step(root) == 7
    restored, step = ck.restore_latest(root, like=state)
    assert step == 7
    _assert_equal_trees(state, restored)
    # a torch.optim state restores into a fresh optimizer
    q = torch.nn.Parameter(torch.zeros(16))
    opt = torch.optim.Adam([q], lr=1.0)
    opt.load_state_dict(restored["opt"])
    assert opt.param_groups[0]["lr"] == 1e-2


def test_checkpoint_without_a_template_rebuilds_the_structure(tmp_path):
    from enoki_tpu_torch.render import SphereScene
    from enoki_tpu_torch.types import PCG32
    state = _train_state()
    ck.save(str(tmp_path / "s"), state)
    back = ck.restore(str(tmp_path / "s"), device=CPU)
    assert isinstance(back["scene"], SphereScene)
    assert isinstance(back["rng"], PCG32)
    _assert_equal_trees(state, back)


def test_checkpoint_checks_the_template_and_refuses_to_overwrite(tmp_path):
    state = _train_state()
    path = str(tmp_path / "s")
    ck.save(path, state)
    with pytest.raises(FileExistsError):
        ck.save(path, state, force=False)
    wrong = pytree.tree_map(
        lambda l: l.double() if isinstance(l, torch.Tensor) and
        l.dtype == torch.float32 else l, state)
    with pytest.raises(ValueError, match="template"):
        ck.restore(path, like=wrong)
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(path, like={"scene": state["scene"]})
    assert ck.restore_latest(str(tmp_path / "none")) == (None, None)
    # only weights and plain containers come back: no temporary files left
    assert sorted(os.listdir(tmp_path)) == ["s"]


def test_checkpoint_rotation_keeps_the_newest(tmp_path):
    state = {"x": torch.arange(4)}
    root = str(tmp_path)
    for s in (1, 2, 5, 10, 11):
        ck.save_step(root, s, state, max_to_keep=2)
    assert sorted(os.listdir(root)) == ["step_10", "step_11"]
    ck.save_step(root, 12, state, max_to_keep=None)
    assert len(os.listdir(root)) == 3


# -- interop (tests/test_ad_runtime.py:109-133, :177-191) ------------------


def test_interop_numpy():
    x = np.arange(5.0, dtype=np.float32)
    t = from_numpy(x, CPU)
    assert t.dtype == torch.float32
    assert np.array_equal(to_numpy(t * 2), x * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            from_numpy(x)


def test_interop_torch():
    t = torch.arange(6, dtype=torch.float32)
    j = from_torch(t)
    assert np.array_equal(to_numpy(j), t.numpy())
    assert torch.equal(to_torch(j * 3), t * 3)
    assert to_torch(t) is t
    # any DLPack producer, zero-copy
    a = np.arange(4.0)
    assert torch.equal(to_torch(a), torch.arange(4.0, dtype=torch.float64))
    v = torch.ones(4, 4, requires_grad=True)[:, 1]
    w = from_torch(v)
    assert w.is_contiguous() and not w.requires_grad


def test_torch_autograd_bridge():
    def f(y, x):
        return torch.sum(torch.atan2(y, x))

    fn = torch_wrap(f)
    y = torch.tensor([1.0, 2.0], requires_grad=True)
    x = torch.tensor([2.0, 1.0], requires_grad=True)
    fn(y, x).backward()
    want_gy = (x / (x * x + y * y)).detach()
    want_gx = (-y / (x * x + y * y)).detach()
    assert torch.allclose(y.grad, want_gy, atol=1e-6)
    assert torch.allclose(x.grad, want_gx, atol=1e-6)


def test_torch_wrap_multi_output():
    fn = torch_wrap(lambda a, b: (a + b, a * b))
    ta = torch.tensor([1.0, 2.0], requires_grad=True)
    tb = torch.tensor([3.0, 4.0], requires_grad=True)
    s, p = fn(ta, tb)
    assert torch.allclose(s, torch.tensor([4.0, 6.0]))
    assert torch.allclose(p, torch.tensor([3.0, 8.0]))
    (s.sum() + p.sum()).backward()
    assert torch.allclose(ta.grad, torch.tensor([4.0, 5.0]))  # 1 + b
    assert torch.allclose(tb.grad, torch.tensor([2.0, 3.0]))  # 1 + a


def test_torch_wrap_takes_one_output_alone():
    fn = torch_wrap(lambda a, b: (a * b, (a * 0.0).detach()))
    ta = torch.tensor([1.0, 2.0], requires_grad=True)
    tb = torch.tensor([3.0, 4.0], requires_grad=True)
    prod, zero = fn(ta, tb)
    prod.sum().backward()
    assert ta.grad.tolist() == [3.0, 4.0] and tb.grad.tolist() == [1.0, 2.0]


def test_interop_round_trips_are_exact():
    rng = np.random.default_rng(13)
    for dtype in (np.float32, np.float64, np.int32, np.int64, np.bool_):
        x = (rng.normal(size=64) * 100).astype(dtype)
        t = from_numpy(x, CPU)
        back = to_numpy(t)
        assert back.dtype == x.dtype and np.array_equal(back, x)
        assert np.array_equal(to_numpy(to_torch(x)), x)


# -- config ----------------------------------------------------------------


def test_config_has_the_references_fields():
    import dataclasses
    names = [f.name for f in dataclasses.fields(config)]
    assert names == ["log_level", "approx", "default_dtype", "debug_bounds",
                     "max_fused_ops", "trace_export_dir", "cache_max_bytes",
                     "eval_callbacks"]


def test_config_reads_the_references_environment():
    code = ("from enoki_tpu_torch.config import config as c; "
            "print(c.log_level, c.approx, c.default_dtype, c.debug_bounds, "
            "c.max_fused_ops, c.trace_export_dir, c.cache_max_bytes)")
    env = dict(os.environ, ENOKI_TPU_LOG_LEVEL="3", ENOKI_TPU_APPROX="0",
               ENOKI_TPU_DTYPE="bfloat16", ENOKI_TPU_DEBUG_BOUNDS="1",
               ENOKI_TPU_MAX_FUSED_OPS="500", ENOKI_TPU_EXPORT_CACHE="off",
               ENOKI_TPU_CACHE_MAX_BYTES="1234")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.split()
    assert out == ["3", "False", "bfloat16", "True", "500", "off", "1234"]


def test_log_level_log_and_callbacks(capsys, monkeypatch):
    monkeypatch.setattr(config, "log_level", config.log_level)
    monkeypatch.setattr(config, "eval_callbacks", [])
    E.set_log_level(2)
    assert E.log_level() == 2
    from enoki_tpu_torch.config import log, register_callback, run_callbacks
    log(2, "kernel %s", "sdf_fwd")
    log(3, "not shown")
    assert capsys.readouterr().out == "[enoki-tpu] kernel sdf_fwd\n"
    with pytest.raises(ValueError):
        E.set_log_level(6)
    seen = []
    register_callback(lambda: seen.append(1))
    run_callbacks()
    run_callbacks()
    assert seen == [1, 1]


# -- caches (tests/test_cache.py:27-70, :95-99) ----------------------------


@pytest.fixture
def restore_cfg():
    d, b = config.trace_export_dir, config.cache_max_bytes
    yield
    config.trace_export_dir = d
    config.cache_max_bytes = b


def test_export_dir_auto_is_version_keyed(restore_cfg, tmp_path,
                                          monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    config.trace_export_dir = "auto"
    d = cache.export_dir()
    assert d.endswith(cache.version_tag())
    assert os.path.join(str(tmp_path), "enoki_tpu_torch", "export") in d
    tag = cache.version_tag()
    assert E.__version__ in tag and torch.__version__.replace("-", "_") in tag
    assert ("cuda" if torch.cuda.is_available() else "cpu") in tag
    # no token holds a dash, so the platform is the second token from the
    # end
    assert tag.split("-")[-2] in ("cuda", "cpu") and len(tag.split("-")) == 4


@pytest.mark.parametrize("word", ["off", "OFF", "none", "0", ""])
def test_export_dir_disable_words(restore_cfg, word):
    config.trace_export_dir = word
    assert cache.export_dir() == ""


def test_export_dir_literal_path(restore_cfg, tmp_path):
    config.trace_export_dir = str(tmp_path)
    assert cache.export_dir() == str(tmp_path)


def test_stale_export_dirs_of_this_platform_are_pruned(tmp_path,
                                                       monkeypatch):
    keep = tmp_path / cache.version_tag()
    plat = cache.version_tag().split("-")[-2]
    other = "cpu" if plat == "cuda" else "cuda"
    stale = tmp_path / f"v0.3.0-torch2.0.0-{plat}-h2"
    live_other = tmp_path / f"v0.4.0-torch2.0.0-{other}-h3"
    for d in (keep, stale, live_other):
        d.mkdir()
    monkeypatch.setattr(cache, "_PRUNED", False)
    cache._prune_stale_exports(str(tmp_path), str(keep))
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [keep.name, live_other.name])


def test_evict_lru_drops_oldest_first(tmp_path):
    for i in range(6):
        p = tmp_path / f"f{i}.so"
        p.write_bytes(b"x" * 100)
        os.utime(p, (i * 10, i * 10))
    cache.evict_lru(str(tmp_path), 300)
    kept = sorted(p.name for p in tmp_path.iterdir())
    assert kept == ["f3.so", "f4.so", "f5.so"]


def test_evict_lru_noop_under_bound(tmp_path):
    (tmp_path / "a").write_bytes(b"x" * 10)
    cache.evict_lru(str(tmp_path), 1 << 20)
    assert (tmp_path / "a").exists()


def test_evict_lru_missing_dir_is_silent(tmp_path):
    cache.evict_lru(str(tmp_path / "nope"), 10)  # must not raise


def test_compile_cache_env_off_respected():
    # conftest sets ENOKI_TPU_COMPILE_CACHE=off for hermeticity: the
    # import-time hook left the build directory where the package keeps it
    assert os.environ.get("ENOKI_TPU_COMPILE_CACHE") == "off"
    assert _build.BUILD_DIR == _build.PKG_DIR / "_build"


def test_compile_cache_env_path_moves_and_bounds_the_build_dir(tmp_path):
    d = tmp_path / "kernels"
    d.mkdir()
    for i in range(4):
        p = d / f"k{i}.so"
        p.write_bytes(b"x" * 100)
        os.utime(p, (i, i))
    code = ("import enoki_tpu_torch._build as B, enoki_tpu_torch; "
            "print(B.BUILD_DIR)")
    env = dict(os.environ, ENOKI_TPU_COMPILE_CACHE=str(d),
               ENOKI_TPU_CACHE_MAX_BYTES="250")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout.strip()
    assert out == str(d.resolve())
    assert sorted(p.name for p in d.iterdir()) == ["k2.so", "k3.so"]
