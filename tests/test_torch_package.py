"""Package hygiene of the port (enoki_tpu_torch): it stands alone beside
the JAX reference, runs on CUDA unless told otherwise, and carries scene
parameters across from numpy exactly."""

import ast
import importlib
import inspect
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import enoki_tpu_torch
from enoki_tpu_torch import resolve_device
from enoki_tpu_torch.interop import (generic_params_from_numpy,
                                     params_from_numpy, pcg32_from_numpy,
                                     scene_from_numpy, scene_to_numpy)
from enoki_tpu_torch import ops
from enoki_tpu_torch.ops.router import linspace
from enoki_tpu_torch.render import generic, sdflib
from enoki_tpu_torch.render.sdf import SDFScene
from enoki_tpu_torch.render.sdf_kernels import SDFRender
from enoki_tpu_torch.render.sphere import SphereScene, pixel_grid
from enoki_tpu_torch.render.sphere_kernels import SphereRender
import enoki_tpu_torch.types as T
from enoki_tpu_torch.types import PCG32, u64

PKG = pathlib.Path(enoki_tpu_torch.__file__).parent
# the modules of enoki_tpu/types/ besides random and u64
TYPES = ("half", "idiv", "morton", "enum_array", "color", "complex",
         "quaternion", "matrix", "matrix_soa", "transform", "sh")
REPO = PKG.parent
# the modules of enoki_tpu/struct/
STRUCT = ("__init__", "pytree", "masked", "vectorize", "call")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted(PKG.rglob("*.py"))
    names = {f.relative_to(PKG).as_posix() for f in files}
    assert {"render/sphere.py", "render/sphere_kernels.py", "render/io.py",
            "render/sdf_kernels.py", "render/generic.py", "render/sdflib.py",
            "render/sdf_trace.py", "interop.py", "config.py",
            "types/u64.py", "types/random.py", "ops/polys.py", "ops/math.py",
            "ops/special.py", "ops/rounding.py", "ops/polys64.py",
            "ops/backend.py", "ops/router.py", "ops/horiz.py",
            "ops/hist_kernels.py", "cache.py", "ad/__init__.py",
            "runtime/__init__.py", "runtime/checkpoint.py",
            "dist/__init__.py", "dist/mesh.py", "dist/render.py",
            "dist/bench_scaling.py", "trace/__init__.py", "trace/build.py",
            "trace/plain.py", "trace/codegen.py", "trace/tape.py",
            "trace/call.py"} | {
            f"types/{m}.py" for m in TYPES} | {
            f"struct/{m}.py" for m in STRUCT} <= names
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "enoki_tpu"), (f, mod)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, enoki_tpu_torch, enoki_tpu_torch.render, "
            "enoki_tpu_torch.render.io, enoki_tpu_torch.interop, "
            "enoki_tpu_torch.types, enoki_tpu_torch.ops.hist_kernels, "
            "enoki_tpu_torch.ops.rounding, enoki_tpu_torch.config, "
            "enoki_tpu_torch.ops.math, enoki_tpu_torch.ops.special, "
            "enoki_tpu_torch.ops.backend, enoki_tpu_torch.ops.polys64, "
            "enoki_tpu_torch.struct, enoki_tpu_torch.ad, "
            "enoki_tpu_torch.runtime, enoki_tpu_torch.runtime.checkpoint, "
            "enoki_tpu_torch.cache; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'enoki_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_the_package_imports_config_and_interop_by_name():
    # as enoki_tpu/__init__.py does; a fresh process, so that no other
    # import made them attributes first
    code = ("import enoki_tpu_torch as E, types; "
            "assert isinstance(E.config, types.ModuleType); "
            "assert isinstance(E.interop, types.ModuleType); "
            "assert E.config.__name__ == 'enoki_tpu_torch.config'; "
            "assert E.interop.__name__ == 'enoki_tpu_torch.interop'; "
            "assert callable(E.interop.pcg32_from_numpy)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


ENTRY_POINTS = {
    "resolve_device": lambda: resolve_device(),
    "SDFScene.reference": lambda: SDFScene.reference().radius,
    "SphereScene.reference": lambda: SphereScene.reference().radius,
    "pixel_grid": lambda: pixel_grid(8).x,
    "linspace": lambda: linspace(-1.0, 1.0, 8),
    "zeros": lambda: ops.zeros(8),
    "full": lambda: ops.full(8, 2.5),
    "empty": lambda: ops.empty(8),
    "arange": lambda: ops.arange(8),
    "range_packets": lambda: next(ops.range_packets(10, 4))[0],
    # ops given Python values alone make their tensors on the card too
    "popcnt(7)": lambda: ops.popcnt(7),
    "mulhi(3, 5)": lambda: ops.mulhi(3, 5),
    "ror(1, 1)": lambda: ops.ror(1, 1),
    "sign(-0.0)": lambda: ops.sign(-0.0),
    "copysign(1.0, -2.0)": lambda: ops.copysign(1.0, -2.0),
    "fmaddsub(1.0, 2.0, 3.0)": lambda: ops.fmaddsub(1.0, 2.0, 3.0),
    "sqrt(2.0)": lambda: ops.sqrt(2.0),
    "safe_rsqrt(4.0)": lambda: ops.safe_rsqrt(4.0),
    "extract": lambda: ops.extract([1.0, 2.0], [False, True]),
    "binary_search": lambda: ops.binary_search(0, 8, lambda i: i < 3),
    "hsum([1., 2.])": lambda: ops.hsum([1.0, 2.0]),
    "compress": lambda: ops.compress([1.0, 2.0], [True, False])[0],
    "partition([5, 0, 1], 2)": lambda: ops.partition([5, 0, 1], 2)[2],
    "sin(1.0)": lambda: ops.sin(1.0, "poly"),
    "atan2(1.0, 2.0)": lambda: ops.atan2(1.0, 2.0, "poly"),
    "pow(2.0, 0.5)": lambda: ops.pow(2.0, 0.5),
    "hypot(3.0, 4.0)": lambda: ops.hypot(3.0, 4.0),
    "erf(0.5)": lambda: ops.erf(0.5, "poly"),
    "dawson(0.5)": lambda: ops.dawson(0.5),
    "carlson_rf(1.0, 2.0, 3.0)": lambda: ops.carlson_rf(1.0, 2.0, 3.0),
    "ellint_3(0.5, 0.5, 0.2)": lambda: ops.ellint_3(0.5, 0.5, 0.2),
    "SDFRender": lambda: SDFRender(n=64).params,
    "SphereRender": lambda: SphereRender(n=64).params,
    "SphereRender_bf16": lambda: SphereRender(n=64,
                                              dtype=torch.bfloat16).params,
    "params_from_numpy": lambda: params_from_numpy(np.zeros(16)),
    "generic_params_from_numpy":
        lambda: generic_params_from_numpy(np.zeros(12)),
    "GenericRender": lambda: generic.GenericRender(
        _sphere_render(), np.zeros(9, np.float32), n=64).params,
    "make_sdf_renderer.render": lambda: _sphere_render()(
        generic_params_from_numpy(np.zeros(9)), 64),
    "PCG32.create": lambda: PCG32.create(8).state.v,
    "u64.from_py": lambda: u64.from_py(7, (4,)).v,
    "u64.zeros": lambda: u64.zeros((4,)).v,
    "pcg32_from_numpy": lambda: pcg32_from_numpy(
        *(np.zeros(4, np.uint32),) * 4).state.v,
    "matrix.identity": lambda: T.matrix.identity(3),
    "Quaternion.identity": lambda: T.Quaternion.identity().w,
    "Quaternion.of(1, 2, 3, 4)": lambda: T.Quaternion.of(1, 2, 3, 4).w,
    "Complex.of(1.0, 2.0)": lambda: T.Complex.of(1.0, 2.0).im,
    "enum_full": lambda: T.enum_array.enum_full(1, 3),
    "enum_array": lambda: T.enum_array.enum_array([1, 2], None),
    "perspective(1.0, ...)": lambda: T.transform.perspective(1.0, 0.1, 10.0),
    "frustum": lambda: T.transform.frustum(-1, 1, -1, 1, 0.1, 10.0),
    "ortho": lambda: T.transform.ortho(-1, 1, -1, 1, 0.1, 10.0),
    "rotate([0, 0, 1], 0.5)": lambda: T.transform.rotate([0, 0, 1], 0.5),
    "morton_encode([3, 5])": lambda: T.morton_encode([3, 5]),
    "DivisorU32(7)(100)": lambda: T.DivisorU32(7)(100),
    "float_to_half(1.0)": lambda: T.half.float_to_half(1.0),
    "linear_to_srgb(0.5)": lambda: T.color.linear_to_srgb(0.5),
    "sh_eval_stacked(0.0, 0.0, 1.0, 2)":
        lambda: T.sh.sh_eval_stacked(0.0, 0.0, 1.0, 2),
}


def _sphere_render():
    return generic.make_sdf_renderer(
        lambda p, pv: sdflib.sd_sphere(p, generic.Vec3(pv[5], pv[6], pv[7]),
                                       pv[8]), n_params=9)[0]


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_cuda(name):
    if torch.cuda.is_available():
        out = ENTRY_POINTS[name]()
        assert getattr(out, "type", None) == "cuda" or out.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ENTRY_POINTS[name]()


def test_interop_round_trip_is_exact():
    rng = np.random.default_rng(5)
    v = rng.standard_normal(16).astype(np.float32)
    v[9:] = 0
    p = params_from_numpy(v, "cpu")
    assert p.dtype == torch.float32 and p.shape == (16,)
    np.testing.assert_array_equal(p.numpy(), v)
    np.testing.assert_array_equal(scene_to_numpy(scene_from_numpy(v, "cpu")),
                                  v)
    # the 9 live entries alone pad to the same vector
    np.testing.assert_array_equal(params_from_numpy(v[:9], "cpu").numpy(), v)
    with pytest.raises(ValueError):
        params_from_numpy(v[:5], "cpu")


def test_generic_interop_round_trip_is_exact():
    v = np.random.default_rng(6).standard_normal(12).astype(np.float32)
    p = generic_params_from_numpy(v, 12, "cpu")
    assert p.dtype == torch.float32 and p.shape == (12,)
    np.testing.assert_array_equal(p.numpy(), v)
    # float64 input is rounded once to float32, as jnp.asarray rounds it
    np.testing.assert_array_equal(
        generic_params_from_numpy(v.astype(np.float64), device="cpu").numpy(),
        v)
    with pytest.raises(ValueError):
        generic_params_from_numpy(v, 9, "cpu")
    with pytest.raises(ValueError):
        generic_params_from_numpy(v[:4], device="cpu")


def test_render_exports_the_generic_entry_points():
    import enoki_tpu_torch.render as R
    for name in ("make_sdf_renderer", "sdflib", "ortho_camera",
                 "perspective_camera", "Vec3", "GenericRender"):
        assert hasattr(R, name), name
    import inspect
    sig = inspect.signature(R.make_sdf_renderer)
    assert [(k, p.default) for k, p in sig.parameters.items()][1:] == [
        ("n_params", inspect.Parameter.empty), ("eps", 1e-4),
        ("t_max", 10.0), ("ray_fn", R.ortho_camera)]
    render, _ = R.make_sdf_renderer(lambda p, pv: p.x, 5)
    got = [(k, p.default) for k, p in
           inspect.signature(render).parameters.items()][1:]
    assert got == [("n", 1024), ("n_steps", 64), ("extent", 1.2),
                   ("tile", 128), ("tile_c", None), ("coarse", 0),
                   ("bands", 1), ("relax", 1.0), ("unimodal", False)]


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    for mod in _imported_modules(REPO / "chip_smoke.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "enoki_tpu"), mod


def test_histogram_example_imports_neither_jax_nor_the_reference():
    for mod in _imported_modules(REPO / "examples" / "histogram_torch.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "enoki_tpu"), mod


def test_sphere_example_imports_neither_jax_nor_the_reference():
    for mod in _imported_modules(REPO / "examples" / "sphere_torch.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "enoki_tpu"), mod


def test_calls_example_imports_neither_jax_nor_the_reference():
    for mod in _imported_modules(REPO / "examples" / "calls_torch.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "enoki_tpu"), mod


def test_haversine_example_imports_neither_jax_nor_the_reference():
    for mod in _imported_modules(REPO / "examples" / "haversine_torch.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "enoki_tpu"), mod


LAZY_EXAMPLES = ("lazy_sphere_torch", "lazy_histogram_torch",
                 "lazy_fit_torch")


@pytest.mark.parametrize("name", LAZY_EXAMPLES)
def test_lazy_example_imports_neither_jax_nor_the_reference(name):
    for mod in _imported_modules(REPO / "examples" / f"{name}.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "enoki_tpu"), mod


def _example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def _fresh_trace():
    import enoki_tpu_torch.trace as tr
    tr.reset()
    yield tr
    tr.reset()


def test_lazy_sphere_example_runs_small_on_the_cpu(_fresh_trace, tmp_path,
                                                   capsys):
    """At 64^2, as tests/test_examples.py runs the reference's: one eval a
    frame, the second frame a cache hit, the struct form equal to the
    scalar one, the image within a few ulp of render_fused."""
    out = _example("lazy_sphere_torch").main(64, device="cpu",
                                             out_dir=tmp_path)
    assert out["second_hit"] and out["struct_err"] == 0.0
    assert out["fused_err"] < 1e-3
    from enoki_tpu_torch.render.io import read_ppm
    img = read_ppm(tmp_path / "sphere_lazy.ppm")
    assert img.shape == (64, 64) and 0 < img.max() <= 255
    assert "wrote sphere_lazy.ppm" in capsys.readouterr().out


def test_lazy_histogram_example_runs_small_on_the_cpu(_fresh_trace, capsys):
    mod = _example("lazy_histogram_torch")
    counts = mod.main(4096, device="cpu")
    assert counts.shape == (mod.BINS,) and float(counts.sum()) == 4096
    # a normal histogram: the middle bins hold the most
    mid = counts[mod.BINS // 2 - 4: mod.BINS // 2 + 4].sum()
    assert float(mid) > 0.6 * 4096
    assert "one eval" in capsys.readouterr().out


def test_lazy_fit_example_runs_small_on_the_cpu(_fresh_trace, capsys):
    """At 64^2 and the example's 40 steps, with the reference's asserts
    (in main): the loss falls below 0.2 of the first, at most 6 misses."""
    out = _example("lazy_fit_torch").main(64, 40, device="cpu")
    assert len(out["losses"]) == 40 and out["misses"] <= 6
    assert "recovered" in capsys.readouterr().out


@pytest.mark.parametrize("impl", ["native", "poly"])
def test_haversine_example_runs_small_on_the_cpu(impl, capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "haversine_torch", REPO / "examples" / "haversine_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t, err = mod.main(n=10_000, impl=impl, iters=2, device="cpu")
    assert t > 0 and err < 1e-5
    assert "max rel err vs f64" in capsys.readouterr().out


def test_sphere_example_runs_small_on_the_cpu(tmp_path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "sphere_torch", REPO / "examples" / "sphere_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    times = mod.main(n=64, iters=2, device="cpu", out_dir=tmp_path)
    assert len(times) == 2 and all(t > 0 for t in times)
    from enoki_tpu_torch.render.io import read_ppm
    staged = read_ppm(tmp_path / "sphere1.ppm")
    fused = read_ppm(tmp_path / "sphere2.ppm")
    assert staged.shape == (64, 64)
    np.testing.assert_array_equal(staged, fused)
    assert staged.min() == 0 and 0 < staged.max() <= 255  # a lit sphere


ROUTER_NAMES = (
    "zeros", "full", "empty", "arange", "linspace", "meshgrid",
    "select", "masked_assign",
    "fmadd", "fmsub", "fnmadd", "fnmsub", "fmaddsub", "fmsubadd",
    "rcp", "rsqrt",
    "popcnt", "lzcnt", "tzcnt", "log2i", "mulhi", "ror", "rol",
    "reinterpret", "ldexp", "frexp",
    "gather", "scatter", "scatter_add", "transform", "prefetch",
    "binary_search", "extract", "range_packets",
    "clamp", "lerp", "sign", "copysign", "mulsign", "abs_", "sqr",
    "cross", "copysign_neg", "mulsign_neg",
    "isnan", "isinf", "isfinite", "isdenormal", "allclose",
    "sqrt", "safe_sqrt", "safe_rsqrt", "safe_asin", "safe_acos",
    "tile", "repeat", "reverse", "head", "tail", "concat",
    "next_float", "prev_float", "deg_to_rad", "rad_to_deg")
HORIZ_NAMES = (
    "hsum", "hprod", "hmax", "hmin", "hmean",
    "hsum_nested", "hprod_nested", "hmax_nested", "hmin_nested",
    "all_nested", "any_nested", "none_nested", "count_nested",
    "psum", "all_", "any_", "none", "count",
    "dot", "abs_dot", "norm", "squared_norm", "normalize",
    "compress", "partition", "segment_offsets")


def _reference_exports(path):
    """The names a reference __init__.py imports, read with ast (the port's
    tests import no JAX for this)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            yield from (a.asname or a.name for a in node.names)


def test_ops_exports_every_name_of_the_reference():
    names = list(_reference_exports(REPO / "enoki_tpu" / "ops" /
                                    "__init__.py"))
    assert len(names) == 149 and {"sincos", "ellint_3", "polys"} <= set(names)
    missing = [n for n in names if not hasattr(ops, n)]
    assert not missing, missing


def test_types_exports_every_name_of_the_reference():
    names = list(_reference_exports(REPO / "enoki_tpu" / "types" /
                                    "__init__.py"))
    assert len(names) == 21 and {"complex_", "Complex", "divisor",
                                 "enum_array", "PCG32"} <= set(names)
    missing = [n for n in names if not hasattr(T, n)]
    assert not missing, missing
    assert T.complex_ is T.complex and T.matrix_soa.__name__.startswith(
        "enoki_tpu_torch.types")


# the reference's from_jnp_complex / to_jnp_complex, renamed (docs/port.md)
RENAMED = {"from_jnp_complex": "from_torch_complex",
           "to_jnp_complex": "to_torch_complex"}


@pytest.mark.parametrize("module", TYPES)
def test_types_modules_have_every_public_function(module):
    tree = ast.parse((REPO / "enoki_tpu" / "types" / f"{module}.py")
                     .read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))
             and not n.name.startswith("_")]
    assert names
    port = importlib.import_module(f"enoki_tpu_torch.types.{module}")
    missing = [n for n in names if not hasattr(port, RENAMED.get(n, n))]
    assert not missing, missing


def test_ops_exports_the_ported_functions():
    from enoki_tpu_torch.ops import horiz, router
    for name in ROUTER_NAMES + HORIZ_NAMES + (
            "log", "erfinv", "histogram", "polys", "rounding", "round_",
            "round_half_away", "floor", "ceil", "trunc",
            "stochastic_round"):
        assert hasattr(ops, name), name
    for name in ROUTER_NAMES:
        assert getattr(ops, name) is getattr(router, name), name
    for name in HORIZ_NAMES:
        assert getattr(ops, name) is getattr(horiz, name), name
    # ops.reverse is the router's (last axis), as in the reference
    assert ops.reverse is router.reverse and ops.horiz.reverse is \
        horiz.reverse
    import inspect
    sig = inspect.signature(ops.histogram)
    assert [(k, p.default) for k, p in sig.parameters.items()][1:] == [
        ("bins", inspect.Parameter.empty), ("weights", None),
        ("impl", "kernel")]


def test_the_kernel_modules_build_nothing_at_import():
    # importing the package, and running the wrappers on CPU tensors,
    # must reach neither nvcc nor a built library
    code = ("import torch, enoki_tpu_torch as E; "
            "from enoki_tpu_torch import _build; "
            "from enoki_tpu_torch.ops import rounding; "
            "E.ops.histogram(torch.tensor([0, 1, 1]), 2); "
            "rounding.stochastic_round_cuda(torch.ones(5), 3); "
            "assert not _build.BUILD_DIR.exists() or not any("
            "p.name.startswith(('hist-', 'stochastic_round-')) "
            "for p in _build.BUILD_DIR.iterdir()); "
            "assert _build.load.cache_info().currsize == 0")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120, env={"PATH": "/nonexistent"})


def _reference_names(path):
    """The public names a reference module defines or imports at its top
    level (functions, classes, assignments, imports), read with ast."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}


# names of the reference's modules that are its own imports of JAX and
# typing, not part of its surface
NOT_SURFACE = {"annotations", "jax", "jnp", "lax", "time", "Any", "Callable",
               "Dict", "Optional", "Sequence"}


def test_struct_exports_every_name_of_the_reference():
    import enoki_tpu_torch.struct as S
    names = list(_reference_exports(REPO / "enoki_tpu" / "struct" /
                                    "__init__.py"))
    assert len(names) == 20 and {"enoki_struct", "InstanceRegistry",
                                 "vectorize_wrapper"} <= set(names)
    missing = [n for n in names if not hasattr(S, n)]
    assert not missing, missing


@pytest.mark.parametrize("module", ["ad", "runtime"])
def test_ad_and_runtime_export_every_name_of_the_reference(module):
    port = importlib.import_module(f"enoki_tpu_torch.{module}")
    names = _reference_names(REPO / "enoki_tpu" / module / "__init__.py") \
        - NOT_SURFACE
    assert {"whos", "checkpoint", "detach" if module == "ad" else "label"} \
        <= names
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing


@pytest.mark.parametrize("module", ["cache", "interop", "config"])
def test_top_level_modules_have_every_function_of_the_reference(module):
    port = importlib.import_module(f"enoki_tpu_torch.{module}")
    tree = ast.parse((REPO / "enoki_tpu" / f"{module}.py").read_text())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert names
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, missing


def test_the_package_exports_the_references_top_level():
    code = ("import enoki_tpu_torch as E, types; "
            "assert E.__version__ == '0.4.0'; "
            "assert callable(E.set_log_level) and callable(E.log_level); "
            "assert all(isinstance(getattr(E, m), types.ModuleType) for m in "
            "('struct', 'ad', 'runtime', 'cache', 'config', 'interop', 'ops', "
            "'types', 'render', 'dist'))")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)



# dist/: the reference's functions that have no counterpart (XLA's HLO
# text parsers; the port records its collectives where it issues them,
# docs/port.md), and the parameters the port adds to the reference's (the
# device of its entry points and the world's rendezvous directory;
# docs/port.md)
DIST_NOT_PORTED = {"_shape_bytes", "_allreduce_shapes",
                   "_parse_hlo_computations"}
DIST_ADDED = {"make_mesh": ["device"], "init_distributed": ["device"],
              "_pixel_block": ["device", "rows", "cols"],
              "collective_stats": ["device"],
              "schedule_overlap_report": ["device"],
              "predicted_efficiency": ["device"],
              "measured_weak_scaling": ["device", "store_dir"],
              "main": ["device"]}


def test_dist_exports_every_name_of_the_reference():
    from enoki_tpu_torch import dist
    names = list(_reference_exports(REPO / "enoki_tpu" / "dist" /
                                    "__init__.py"))
    assert len(names) == 9 and {"make_mesh", "fit_scene"} <= set(names)
    missing = [n for n in names if not hasattr(dist, n)]
    assert not missing, missing
    assert isinstance(dist.bench_scaling, type(dist))


@pytest.mark.parametrize("module", ["mesh", "render", "bench_scaling"])
def test_dist_modules_have_every_function_and_parameter_of_the_reference(
        module):
    import dataclasses
    import inspect
    port = importlib.import_module(f"enoki_tpu_torch.dist.{module}")
    tree = ast.parse((REPO / "enoki_tpu" / "dist" / f"{module}.py")
                     .read_text())
    funcs = [n for n in tree.body if isinstance(n, ast.FunctionDef)
             and n.name not in DIST_NOT_PORTED]
    assert funcs
    for f in funcs:
        assert hasattr(port, f.name), f.name
        want = [a.arg for a in f.args.args] + DIST_ADDED.get(f.name, [])
        got = list(inspect.signature(getattr(port, f.name)).parameters)
        assert got == want, (f.name, got, want)
    for c in (n for n in tree.body if isinstance(n, ast.ClassDef)):
        fields = [s.target.id for s in c.body if isinstance(s, ast.AnnAssign)]
        assert [x.name for x in dataclasses.fields(getattr(port, c.name))] \
            == fields, c.name


# -- trace/ (the lazy runtime) -------------------------------------------------


def test_trace_imports_neither_jax_nor_the_reference():
    # a fresh process: importing trace (which builds the port's own core)
    # loads no module of JAX or of enoki_tpu
    code = ("import sys, enoki_tpu_torch.trace as T, "
            "enoki_tpu_torch.trace.codegen, enoki_tpu_torch.trace.plain, "
            "enoki_tpu_torch.trace.tape, enoki_tpu_torch.trace.call; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'enoki_tpu')]; assert not bad, bad; "
            "assert 'libenoki_trace_torch_' in T._lib._name")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)


def test_trace_native_sources_are_the_ports_own():
    from enoki_tpu_torch.trace import build
    for src in build.SOURCES:
        assert src.parent == PKG / "trace" / "native", src
        text = src.read_text()
        includes = [l for l in text.splitlines()
                    if l.startswith("#include")]
        assert all("<" in l for l in includes), includes  # system headers
        assert "enoki_tpu/" not in text.replace("enoki_tpu_torch/", "")
        assert " et_" not in text and "PyInit__etnative(" not in text
    # the library goes into the port's build directory, under its own name
    from enoki_tpu_torch import _build
    lib = build.build_library()
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("libenoki_trace_torch_")


def test_importing_the_package_builds_no_trace_core():
    code = ("import sys, enoki_tpu_torch as E; "
            "assert 'enoki_tpu_torch.trace' not in sys.modules; "
            "assert callable(E.trace.LazyArray); "
            "assert 'enoki_tpu_torch.trace' in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)


def _reference_all(path):
    """The reference trace's ``__all__``: its list plus _MATH_OPS' keys,
    read with ast."""
    tree = ast.parse(path.read_text())
    names, math_ops = [], []
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "_MATH_OPS"
                for t in node.targets):
            math_ops = [k.value for k in node.value.keys]
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            names = [e.value for e in node.value.left.elts]
    return names + math_ops


def test_trace_exports_every_name_of_the_reference():
    import enoki_tpu_torch.trace as T
    names = _reference_all(REPO / "enoki_tpu" / "trace" / "__init__.py")
    assert len(names) > 60 and {"LazyArray", "select", "eval", "sqrt",
                                "backward", "tape_whos"} <= set(names)
    missing = [n for n in names if not hasattr(T, n)]
    assert not missing, missing
    assert set(names) <= set(T.__all__)
    # the opcode table: the reference's 80 names with their numbers
    tree = ast.parse((REPO / "enoki_tpu" / "trace" / "__init__.py")
                     .read_text())
    (op_class,) = [n for n in tree.body
                   if isinstance(n, ast.ClassDef) and n.name == "Op"]
    (table,) = [n for n in op_class.body if isinstance(n, ast.Assign)]
    ops = [e.id for e in table.targets[0].elts]
    assert len(ops) == 80
    assert [getattr(T.Op, name) for name in ops] == list(range(80))


def test_trace_call_exports_every_function_of_the_reference():
    import enoki_tpu_torch.trace.call as C
    tree = ast.parse((REPO / "enoki_tpu" / "trace" / "call.py").read_text())
    funcs = {n.name: [a.arg for a in n.args.args] for n in tree.body
             if isinstance(n, ast.FunctionDef)
             and not n.name.startswith("_")}
    assert set(funcs) >= {"partition", "dispatch", "getter",
                          "registry_dispatch", "registry_getter"}
    for name, args in funcs.items():
        got = inspect.signature(getattr(C, name))
        assert [p for p in got.parameters
                if got.parameters[p].kind != inspect.Parameter.VAR_POSITIONAL
                ] == args, name


def test_trace_tape_names_are_real_functions():
    import enoki_tpu_torch.trace as T
    from enoki_tpu_torch.trace import tape
    for name in ("requires_grad", "grad_enabled", "gradient",
                 "clear_gradients", "backward", "forward_from", "tape_whos",
                 "tape_graphviz", "clear_tape"):
        f = getattr(T, name)
        assert f is getattr(tape, name) and f.__module__ == tape.__name__
        assert "NotImplementedError" not in inspect.getsource(f), name
    ref = ast.parse((REPO / "enoki_tpu" / "trace" / "__init__.py")
                    .read_text())
    sigs = {n.name: [a.arg for a in n.args.args] for n in ref.body
            if isinstance(n, ast.FunctionDef)}
    for name in ("requires_grad", "gradient", "backward", "forward_from"):
        assert list(inspect.signature(getattr(T, name)).parameters) \
            == sigs[name], name


@pytest.mark.parametrize("make", ["LazyArray(np)", "arange", "zeros",
                                  "full", "literal", "linspace"])
def test_trace_constructors_default_to_cuda(make):
    import enoki_tpu_torch.trace as T
    f = {"LazyArray(np)": lambda: T.LazyArray(np.ones(2, np.float32)),
         "arange": lambda: T.LazyArray.arange(4),
         "zeros": lambda: T.LazyArray.zeros(4),
         "full": lambda: T.LazyArray.full(1.0, 4),
         "literal": lambda: T.LazyArray.literal(1.0),
         "linspace": lambda: T.LazyArray.linspace(0.0, 1.0, 4)}[make]
    if torch.cuda.is_available():
        assert f().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            f()
