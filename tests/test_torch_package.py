"""Package hygiene of the port (enoki_tpu_torch): it stands alone beside
the JAX reference, runs on CUDA unless told otherwise, and carries scene
parameters across from numpy exactly."""

import ast
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
from enoki_tpu_torch.ops.router import linspace
from enoki_tpu_torch.render import generic, sdflib
from enoki_tpu_torch.render.sdf import SDFScene
from enoki_tpu_torch.render.sdf_kernels import SDFRender
from enoki_tpu_torch.render.sphere import SphereScene, pixel_grid
from enoki_tpu_torch.render.sphere_kernels import SphereRender
from enoki_tpu_torch.types import PCG32, u64

PKG = pathlib.Path(enoki_tpu_torch.__file__).parent
REPO = PKG.parent


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
            "ops/special.py", "ops/rounding.py",
            "ops/hist_kernels.py"} <= names
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "enoki_tpu"), (f, mod)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, enoki_tpu_torch, enoki_tpu_torch.render, "
            "enoki_tpu_torch.render.io, enoki_tpu_torch.interop, "
            "enoki_tpu_torch.types, enoki_tpu_torch.ops.hist_kernels, "
            "enoki_tpu_torch.ops.rounding, enoki_tpu_torch.config; "
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


def test_ops_exports_the_ported_functions():
    from enoki_tpu_torch import ops
    for name in ("linspace", "meshgrid", "select", "masked_assign", "rsqrt",
                 "reinterpret", "ldexp", "frexp", "gather", "scatter",
                 "scatter_add", "transform", "isnan", "isinf", "isfinite",
                 "safe_sqrt", "next_float", "prev_float", "log", "erfinv",
                 "histogram", "polys", "rounding", "round_",
                 "round_half_away", "floor", "ceil", "trunc",
                 "stochastic_round"):
        assert hasattr(ops, name), name
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
