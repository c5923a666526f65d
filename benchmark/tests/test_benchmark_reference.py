"""CPU tests of the benchmark's yardstick: the frozen work counts against
the reference's own march, the reference against the program's plain
route, and whole runs of each cell at a small size on the CPU (where the
program takes its plain route): sound runs are correct, and the
lower-precision control and each fault that the cell can have come out
not correct.

Run: python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import controls, harness, loops  # noqa: E402
from benchmark.reference import common  # noqa: E402
from benchmark.reference import composed_sdf as ref_composed  # noqa: E402
from benchmark.reference import sphere_sdf as ref_sphere  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SMALL = dict(samples_side=2, out_n=32, fit_steps=4, fits=2, sequence=4)
CPU = torch.device("cpu")
N = 64


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" /
                       f"{name}.json").read_text())


def work(name):
    return harness.load_module(ROOT / "benchmark" / "work" / f"{name}.py",
                               f"work_test_{name}")


def vec(name):
    import numpy as np
    from benchmark.loops import draw_vectors
    cfg = config(name)
    return torch.from_numpy(draw_vectors(cfg, np.random.default_rng(5),
                                         1)[0])


def program_counts(name, v):
    """(evaluations, advances, hits) per pixel by the program's own plain
    replay of its march, an independent witness."""
    from enoki_tpu_torch.render import generic, sdf_kernels
    if name == "sphere_sdf":
        evals, adv = sdf_kernels.march_counts(v, N, 64, 1.2)
        _, ts = sdf_kernels.sdf_fwd_plain(v, N, 64, 1.2)
        return evals, adv, ts >= 0
    prog = harness.load_module(ROOT / "benchmark" / "configs" /
                               "composed_sdf.py", "composed_prog_test")
    evals = generic.generic_march_counts(prog.scene_sdf,
                                         generic.ortho_camera, v, N, 64, 1.2)
    _, ts = generic.generic_fwd_plain(prog.scene_sdf, generic.ortho_camera,
                                      v, N, 64, 1.2)
    return evals, evals - 1, ts >= 0


@pytest.mark.parametrize("name, scene", [("sphere_sdf", ref_sphere),
                                         ("composed_sdf", ref_composed)])
def test_work_counts_tie_to_the_reference_march(name, scene):
    v = vec(name)
    evals, adv, hits = common.counts(scene, v, N, 64, 1.2)
    rays = N * N
    # per pixel: the reference's march over the whole grid
    (_, px, py), = list(common.blocks(N, 1.2, CPU, rows=N))
    _, hit, a = scene.march(px, py, v, 64)
    assert adv == int(a.sum()) and hits == int(hit.sum())
    assert evals == adv + rays
    # the program's own replay of its march is a second witness; on the
    # CPU its roots round correctly where the reference takes PyTorch's
    # (the card's kernels and the reference both take the card's), so a
    # few lanes may take one step more or fewer here
    p_evals, p_adv, p_hit = program_counts(name, v)
    assert (a != p_adv.to(a.dtype)).sum() <= rays // 1000
    assert (hit != p_hit).sum() <= rays // 1000
    assert abs(evals - int(p_evals.sum())) <= rays // 1000
    w = work(name)
    n_params = scene.N_PARAMS
    fwd_bytes, fwd_flops = w.render_fwd(evals, adv, hits, rays, True)
    frame_bytes, frame_flops = w.render_fwd(evals, adv, hits, rays, False)
    bwd_bytes, bwd_flops = w.render_bwd(evals, adv, hits, rays)
    # inputs read once and outputs written once: the parameters, then the
    # image and, where a backward follows, its root (forward); the
    # parameters, the image's cotangent and the root, then the
    # parameters' cotangent (backward)
    assert fwd_bytes == 4 * n_params + 4 * rays + 4 * rays
    assert frame_bytes == 4 * n_params + 4 * rays
    assert bwd_bytes == 4 * n_params + 8 * rays + 4 * n_params
    assert fwd_flops == frame_flops
    assert fwd_flops > evals and bwd_flops > hits


@pytest.mark.parametrize("name, scene", [("sphere_sdf", ref_sphere),
                                         ("composed_sdf", ref_composed)])
def test_the_reference_renders_and_differentiates_as_the_program(name,
                                                                 scene):
    from enoki_tpu_torch.render import generic, sdf_kernels
    v = vec(name)
    img, t, hit = common.render(scene, v, N, 64, 1.2, keep_root=True)
    g = torch.randn(N, N, generator=torch.Generator().manual_seed(3))
    dp = common.gradient(scene, v, t, hit, g, N, 1.2)
    if name == "sphere_sdf":
        p_img, ts = sdf_kernels.sdf_fwd_plain(v, N, 64, 1.2)
        p_dp = sdf_kernels.sdf_bwd_plain(v, g, ts, N, 1.2)
    else:
        prog = harness.load_module(ROOT / "benchmark" / "configs" /
                                   "composed_sdf.py", "composed_prog_t2")
        p_img, ts = generic.generic_fwd_plain(prog.scene_sdf,
                                              generic.ortho_camera, v, N, 64,
                                              1.2)
        p_dp = generic.generic_bwd_plain(prog.scene_sdf, generic.ortho_camera,
                                         v, g, ts, N, 1.2)
    assert torch.equal(hit, ts >= 0)
    assert (img - p_img).abs().max() <= 1e-4 * p_img.abs().max()
    scale = p_dp.abs().max()
    assert (dp - p_dp).abs().max() <= 1e-4 * scale


def one(name, mode, seed=2 ** 33 + 11):
    cell = harness.Cell(SPEC, name)
    result, _ = controls.one(cell, seed, mode, 0.2, CPU, SMALL)
    return result


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_on_the_cpu_is_correct(name):
    result = one(name, "sound")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_the_lower_precision_control_is_not_correct(name):
    result = one(name, "control")
    assert not result["correct"], result["checks"]


FAULTS = [(c, m) for c in CELLS
          for m in loops.load_kind(harness.Cell(SPEC, c).kind).FAULTS]


@pytest.mark.parametrize("name, mode", FAULTS)
def test_a_planted_fault_is_not_correct(name, mode):
    result = one(name, mode)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
def test_a_run_on_the_card_prints_its_result():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import subprocess
    t = time.time()
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
         "3000000123", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert time.time() - t < 360
