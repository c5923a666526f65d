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
from enoki_tpu_torch.interop import (params_from_numpy, scene_from_numpy,
                                     scene_to_numpy)
from enoki_tpu_torch.ops.router import linspace
from enoki_tpu_torch.render.sdf import SDFScene
from enoki_tpu_torch.render.sdf_kernels import SDFRender
from enoki_tpu_torch.render.sphere import SphereScene, pixel_grid
from enoki_tpu_torch.render.sphere_kernels import SphereRender

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
            "render/sdf_kernels.py", "interop.py"} <= names
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "enoki_tpu"), (f, mod)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, enoki_tpu_torch, enoki_tpu_torch.render, "
            "enoki_tpu_torch.render.io, enoki_tpu_torch.interop; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'enoki_tpu')]; "
            "assert not bad, bad")
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
}


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


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    for mod in _imported_modules(REPO / "chip_smoke.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "enoki_tpu"), mod
