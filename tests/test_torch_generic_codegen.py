"""How a scene function reaches the generic_fwd / generic_bwd kernels
(enoki_tpu_torch.render.sdf_trace and csrc/generic_render.cuh), checked
without a card:

* the traced DAG, evaluated with torch, equals the scene function on
  tensors bit for bit;
* the emitted source and its hash are the same on a second trace and
  differ between scenes; a function that cannot be traced raises;
* the generated source, built by the host's C++ compiler (g++ -O2
  -ffp-contract=off: the skeleton's per-pixel functions in two loops over
  the image), agrees with generic_fwd_plain / generic_bwd_plain at 64^2.
  That holds the emitted code, the march, the dual normal and the
  reverse-mode cotangent (user_cotangent) against the plain versions, and
  the cotangent of a scene whose hits meet the ties of minimum, abs and
  clip against the reference's gradient in JAX; the __global__ wrappers
  around the same functions are held on the card
  (tests/test_torch_cuda.py).

Tolerances: the host march rounds each operation as the plain version
does, except a division by a Python number, which the emitter writes as a
product with the reciprocal (what PyTorch's CUDA kernels compute) where
PyTorch's CPU kernels divide. So ts and the image agree within 1e-3 off
hit/miss flips, which stay under 1e-3 of the pixels; scenes without such a
division are bit-equal in ts. dp agrees within rtol 2e-4 / atol 2e-4 *
max(1, |dp|max): sums of ~4000 terms in another order. Against JAX the
gradient takes the slice-4 gate, rtol 2e-2 / atol 2e-3 * max(1, |g|max)
(tests/test_generic_render.py), the two marches' hit points being each
package's own.
"""

import ctypes
import functools
import hashlib
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from enoki_tpu.render import generic as jgen, sdflib as jsd
from enoki_tpu.render.vec import Vec3 as JVec3
from enoki_tpu_torch import _build
from enoki_tpu_torch.render import generic as G, sdf_trace as T
from enoki_tpu_torch.render import sdflib as sd
from enoki_tpu_torch.render.sdf_kernels import pixel_step, tile_pixels
from enoki_tpu_torch.render.vec import Vec3

N, STEPS = 64, 48

PARAMS = np.asarray(
    [0.15, 40.0, -1.0, -1.0, 2.0, 0.1, -0.2, 0.3, 0.45, 0.55, 0.18, 1.05],
    np.float32)


def composed(p, pv):
    s = sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])
    t = sd.sd_torus(p, Vec3(0.0, 0.0, 1.0), pv[9], pv[10])
    g = sd.sd_plane(p, Vec3(0.0, -1.0, 0.0), pv[11])
    return sd.op_union(sd.op_smooth_union(s, t, 0.1), g)


def sphere_only(p, pv):
    return sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])


def carved(p, pv):
    """Every primitive and combinator the composed scene leaves out: a
    rounded box with a capsule cut out of it, a shell of a sphere, and
    their intersection with a half-space."""
    box = sd.op_round(sd.sd_box(p, Vec3(pv[5], pv[6], pv[7]),
                                Vec3(pv[8], pv[8], pv[9])), 0.05)
    cut = sd.sd_capsule(p, Vec3(-0.6, 0.0, pv[7]), Vec3(0.6, 0.1, pv[7]),
                        pv[10])
    shell = sd.op_shell(sd.sd_sphere(p, Vec3(0.5, 0.5, 0.4), 0.3), 0.02)
    body = sd.op_union(sd.op_subtract(box, cut), shell)
    return sd.op_intersect(body, sd.sd_plane(p, Vec3(0.0, 0.0, 1.0), -1.2))


CARVED_PARAMS = np.asarray(
    [0.15, 40.0, -1.0, -1.0, 2.0, 0.0, -0.1, 0.4, 0.45, 0.3, 0.12],
    np.float32)


def moving_camera(px, py, pv):
    """A pinhole whose position is a scene parameter (pv[11])."""
    dz = T.full_like(px, 1.8)
    inv = T.rsqrt(px * px + py * py + dz * dz)
    o = Vec3(T.zeros_like(px), T.zeros_like(px), -pv[11] - 1.45)
    return o, Vec3(px * inv, py * inv, dz * inv)


SCENES = {
    "composed": (composed, G.ortho_camera, PARAMS),
    "composed_perspective": (composed, G.perspective_camera(), PARAMS),
    "composed_moving_camera": (composed, moving_camera, PARAMS),
    "sphere": (sphere_only, G.ortho_camera, PARAMS[:9]),
    "carved": (carved, G.ortho_camera, CARVED_PARAMS),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    sdf_fn, ray_fn, params = SCENES[request.param]
    return (G.SceneKernels(sdf_fn, ray_fn, len(params)),
            torch.from_numpy(params))


# -- the tracer ---------------------------------------------------------------

TORCH_OPS = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b, "div": lambda a, b: a / b,
    "divn": lambda a, b: a / b,   # b is the Python number itself
    "neg": lambda a: -a, "abs": T.abs, "sqrt": T.sqrt, "rsqrt": T.rsqrt,
    "recip": lambda a: a.reciprocal(), "min": T.minimum, "max": T.maximum,
}


def _t(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _guard(s, guard=1e-6):
    """The slope of implicit_t_vjp: clamped to +-1 where it is within the
    guard, an exact zero taken as negative."""
    sgn = torch.where(s == 0.0, -1.0, torch.sign(s))
    return torch.where(s.abs() > guard, s, sgn)


# the selections of sdf_trace.reverse_sweep (sdf_trace.SELECTIONS), which
# user_cotangent computes on the card
SWEEP_OPS = {
    "signmul": lambda x, b: torch.where(_t(x) >= 0, _t(b), -_t(b)),
    "pick_min": lambda x, y, b: _t(b) * ((_t(x) < _t(y)).float()
                                         + 0.5 * (_t(x) == _t(y)).float()),
    "pick_max": lambda x, y, b: _t(b) * ((_t(x) > _t(y)).float()
                                         + 0.5 * (_t(x) == _t(y)).float()),
    "guard": _guard,
}


def evaluate(program, inputs, pv):
    """Run a traced Program's DAG with torch: ``inputs`` are tensors in
    argument order, ``pv`` the parameter tensor."""
    env = dict(zip(program.inputs, inputs))
    vals = []
    for kind, *args in program.nodes:
        if kind == "in":
            v = env[args[0]]
        elif kind == "pv":
            v = pv[args[0]]
        elif kind == "const":
            v = float(np.uint32(args[0]).view(np.float32))
        elif kind == "number":
            v = float.fromhex(args[0])
        else:
            a = [vals[i] for i in args]
            if not any(isinstance(x, torch.Tensor) for x in a):
                # constants among themselves (full_like(px, c) * c): in
                # f32, as the tensors they stand for
                a = [torch.tensor(x, dtype=torch.float32) for x in a]
                v = {**TORCH_OPS, **SWEEP_OPS}[kind](*a).item()
            else:
                v = {**TORCH_OPS, **SWEEP_OPS}[kind](*a)
        vals.append(v)
    return tuple(vals[o] for o in program.outputs)


def test_dag_equals_the_function_on_tensors_bit_for_bit(scene):
    kernels, pv = scene
    rng = np.random.default_rng(3)
    x, y, z = (torch.from_numpy(rng.uniform(-1.5, 1.5, 4096)
                                .astype(np.float32)) for _ in range(3))
    want = kernels.sdf_fn(Vec3(x, y, z), pv)
    (got,) = evaluate(kernels.traced.sdf, (x, y, z), pv)
    assert torch.equal(got, want)
    o, d = kernels.ray_fn(x, y, pv)
    got = evaluate(kernels.traced.ray, (x, y), pv)
    for g, w in zip(got, (o.x, o.y, o.z, d.x, d.y, d.z)):
        w = torch.as_tensor(w, dtype=torch.float32)
        assert torch.equal(torch.as_tensor(g).expand_as(x), w.expand_as(x))


def test_bound_programs_compute_what_the_kernels_compute(scene):
    """The chip check takes each generic kernel's operation count from a
    program that differentiates the traced scene in reverse mode
    (sdf_trace.generic_hit_programs; the cotangent's is the program
    generic_bwd runs). That program, run with torch over the image, gives
    generic_fwd_plain's shade on the hit pixels (atol 1e-4) and
    generic_bwd_plain's cotangent (rtol 2e-4 / atol 2e-4 * max(1,
    |dp|max), sums in another order): the count is of a program that
    computes the function."""
    kernels, pv = scene
    fwd, bwd = T.generic_hit_programs(kernels.sdf_fn, kernels.ray_fn,
                                      kernels.n_params)
    assert bwd == kernels.traced.cotangent
    assert kernels.traced.sdf.n_ops < fwd.n_ops < bwd.n_ops
    img, ts = G.generic_fwd_plain(kernels.sdf_fn, kernels.ray_fn, pv, N,
                                  STEPS)
    hit = ts >= 0
    t = torch.where(hit, ts, -1.0 - ts)
    px, py = tile_pixels(N, 1.2, "cpu")
    o, d = kernels.ray_fn(px, py, pv)
    rays = [_t(c).expand_as(px) for c in (o.x, o.y, o.z, d.x, d.y, d.z)]
    (shade,) = evaluate(fwd, (*rays, t), pv)
    assert (shade - img)[hit].abs().max().item() < 1e-4
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (N, N)).astype(np.float32))
    ref = G.generic_bwd_plain(kernels.sdf_fn, kernels.ray_fn, pv, g, ts, N)
    dp = torch.stack([_t(c).expand_as(px)[hit].double().sum()
                      for c in evaluate(bwd, (px, py, t, g), pv)])
    dp[G.AMBIENT] += g[~hit].double().sum()
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(dp.float(), ref, rtol=2e-4, atol=2e-4 * scale)


def test_source_and_hash_repeat(scene):
    kernels, _ = scene
    again = T.trace_scene(kernels.sdf_fn, kernels.ray_fn, kernels.n_params)
    assert again.source == kernels.traced.source
    assert _build._digest(again.source.encode()) \
        == _build._digest(kernels.traced.source.encode())
    src = again.source
    assert f"#define GENERIC_N_PARAMS {kernels.n_params}\n" in src
    assert src.index('#include "generic_num.cuh"') < src.index("user_sdf") \
        < src.index("user_ray") < src.index("user_cotangent") \
        < src.index('#include "generic_render.cuh"')


def test_emitted_cotangent_has_the_counted_operations(scene):
    """user_cotangent is the cotangent program of the chip check's count,
    one statement per arithmetic node and one store per parameter."""
    kernels, _ = scene
    body = kernels.traced.source.split("void user_cotangent(")[1]
    body = body.split("\n}\n")[0]
    _, counted = T.generic_hit_programs(kernels.sdf_fn, kernels.ray_fn,
                                        kernels.n_params)
    assert len(re.findall(r"^  const T v\d+ = ", body, re.M)) \
        == counted.n_ops == kernels.traced.cotangent.n_ops
    assert re.findall(r"^  dp\[(\d+)\] = ", body, re.M) \
        == [str(k) for k in range(kernels.n_params)]
    kinds = {n[0] for n in counted.nodes}
    assert "guard" in kinds and kinds <= {
        *T.LEAVES, *T.BINARY, *T.SELECTIONS, "divn", "neg", "recip", "sqrt",
        "rsqrt", "abs", "min", "max"}


def test_two_scenes_give_two_sources():
    sources = {T.trace_scene(s, r, len(p)).source
               for s, r, p in SCENES.values()}
    assert len(sources) == len(SCENES)


def test_operation_count_of_the_composed_scene():
    traced = T.trace_scene(composed, G.ortho_camera, 12)
    # what one distance evaluation costs: 3 square roots among 46
    # arithmetic nodes; the orthographic camera only negates a constant
    assert traced.sdf.n_ops == 46 and traced.ray.n_ops == 1
    assert sum(n[0] == "sqrt" for n in traced.sdf.nodes) == 3


def test_constants_are_f32_and_shared():
    def f(p, pv):
        return (p.x * 0.1 + 0.1) * pv[0:2][1] - 1e-12

    prog = T.trace_function(f, ("x", "y", "z"), 3, lambda s: (Vec3(*s),))
    consts = [n for n in prog.nodes if n[0] == "const"]
    bits = int(np.float32(0.1).view(np.uint32))
    assert consts.count(("const", bits)) == 1 and len(consts) == 2
    assert [n for n in prog.nodes if n[0] == "pv"] == [("pv", 1)]
    # unused inputs (y, z) are dropped
    assert [n for n in prog.nodes if n[0] == "in"] == [("in", "x")]


def test_division_by_a_number_is_emitted_as_its_double_reciprocal():
    """tensor / number is tensor * f32(1 / number) in PyTorch's CUDA
    kernels, the reciprocal taken in double (tests/test_torch_cuda.py
    holds PyTorch to that on the card); f32(1) / f32(0.001) would be one
    ulp under 1000. A division by anything else stays a division."""
    def f(p, pv):
        return p.x / 0.001 + p.y / T.full_like(p.y, 0.001) + p.z / pv[5]

    src = T.trace_scene(f, G.ortho_camera, 6).source
    assert f"x * T({(1000.0).hex()}f)" in src
    assert f"y / T({float(np.float32(0.001)).hex()}f)" in src
    assert "z / pv[5]" in src
    with pytest.raises(T.TraceError, match="not finite"):
        T.trace_scene(lambda p, pv: p.x / 0.0, G.ortho_camera, 6).source


UNTRACEABLE = {
    "branch": lambda p, pv: p.x if p.x > 0 else -p.x,
    "truth": lambda p, pv: p.x * (1.0 if p.y else 2.0),
    "compare": lambda p, pv: p.x * (p.y == p.z),
    "torch_function": lambda p, pv: torch.sqrt(p.x),
    "torch_method": lambda p, pv: torch.clamp(p.x, 0.0, 1.0),
    "tensor_operand": lambda p, pv: p.x + torch.ones(3),
    "param_index": lambda p, pv: p.x + pv[p.y],
    "two_outputs": lambda p, pv: (p.x, p.y),
    "infinite_constant": lambda p, pv: T.minimum(p.x, float("inf")),
}


@pytest.mark.parametrize("name", sorted(UNTRACEABLE))
def test_untraceable_function_raises(name):
    with pytest.raises(T.TraceError):
        T.trace_scene(UNTRACEABLE[name], G.ortho_camera, 6).source


def test_scene_kernels_refuse_a_bad_parameter_count():
    with pytest.raises(ValueError, match="n_params"):
        G.SceneKernels(sphere_only, G.ortho_camera, 4)


def test_cuda_tensor_never_reaches_the_plain_version():
    """The wrappers choose by the tensor's device alone: a tensor that is
    neither on the CPU nor on a card raises, and nothing is caught."""
    kernels = G.SceneKernels(sphere_only, G.ortho_camera, 9)
    meta = torch.empty(9, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        G.generic_fwd(kernels, meta, N, STEPS)
    with pytest.raises(ValueError, match="unsupported device"):
        G.generic_bwd(kernels, meta, meta, meta, N)


# -- the generated code, compiled for the host --------------------------------

HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
              "-x", "c++")
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the entry points of the skeleton's host half
HOST_SIGNATURES = {
    "generic_n_params": (),
    "generic_host_fwd": (_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _I,
                         _I),
    "generic_host_bwd": (_P, _P, _P, _P, _I, _F, _F),
}


def build_host(text, out_dir):
    """Compile a scene's generated source with the host's C++ compiler:
    the per-pixel functions of the skeleton in two loops over the image.
    ``-ffp-contract=off`` keeps each operation rounded on its own."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "no host C++ compiler (g++ or c++) on PATH"
    stem = hashlib.sha256(text.encode()).hexdigest()[:16]
    src, out = out_dir / f"{stem}.cpp", out_dir / f"{stem}.so"
    src.write_text(text)
    proc = subprocess.run([cxx, *HOST_FLAGS, "-I", str(_build.CSRC_DIR),
                           "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed to build {src} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    return out


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """kernels -> the host build of its scene, built once per source."""
    out_dir = tmp_path_factory.mktemp("generic_host")

    @functools.cache
    def load(text):
        lib = ctypes.CDLL(str(build_host(text, out_dir)))
        for fn, argtypes in HOST_SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        return lib

    return lambda kernels: load(kernels.traced.source)


def host_fwd(lib, pv, n, n_steps, extent=1.2, t0=None, relax=1.0,
             unimodal=False, eps=1e-4, t_max=10.0):
    """generic_fwd's per-pixel code in a loop over CPU tensors."""
    img = torch.empty((n, n), dtype=torch.float32)
    ts = torch.empty_like(img)
    lib.generic_host_fwd(
        pv.data_ptr(), 0 if t0 is None else t0.data_ptr(), img.data_ptr(),
        ts.data_ptr(), n, n_steps, pixel_step(n, extent), extent, eps, t_max,
        relax, 1.0 - 1.0 / relax, int(relax != 1.0 or unimodal),
        int(unimodal))
    return img, ts


def host_bwd(lib, pv, g, ts, n, extent=1.2):
    """generic_bwd's per-pixel code in a loop over CPU tensors."""
    dp = torch.empty(len(pv), dtype=torch.float32)
    lib.generic_host_bwd(pv.data_ptr(), g.data_ptr(), ts.data_ptr(),
                         dp.data_ptr(), n, pixel_step(n, extent), extent)
    return dp


def test_host_signatures_match_the_skeleton():
    skeleton = (_build.CSRC_DIR / "generic_render.cuh").read_text()
    host = skeleton.split("#else  // a host compiler")[1]
    for name, argtypes in HOST_SIGNATURES.items():
        m = re.search(rf"int {name}\(([^)]*)\)", host)
        assert m, name
        assert len([a for a in m.group(1).split(",") if a.strip()]) \
            == len(argtypes), name


def flip_gate(img_h, ts_h, img_p, ts_p):
    d = (img_h - img_p).abs()
    flips = (ts_h >= 0) != (ts_p >= 0)
    assert flips.float().mean().item() < 1e-3
    assert d[~flips].max().item() < 1e-3
    assert (ts_h - ts_p).abs()[~flips].max().item() < 1e-3


MARCHES = {"plain": {}, "relax1.6": dict(relax=1.6),
           "unimodal": dict(unimodal=True),
           "relax1.3_unimodal": dict(relax=1.3, unimodal=True)}


@pytest.mark.parametrize("march", sorted(MARCHES))
def test_host_forward_matches_plain(scene, march, host_lib):
    kernels, pv = scene
    kw = MARCHES[march]
    lib = host_lib(kernels)
    assert lib.generic_n_params() == kernels.n_params
    img_p, ts_p = G.generic_fwd_plain(kernels.sdf_fn, kernels.ray_fn, pv, N,
                                      STEPS, **kw)
    img_h, ts_h = host_fwd(lib, pv, N, STEPS, **kw)
    flip_gate(img_h, ts_h, img_p, ts_p)
    assert (ts_p >= 0).float().mean().item() > 0.02  # something is hit


def test_host_forward_takes_a_start_map_and_eps(scene, host_lib):
    kernels, pv = scene
    lib = host_lib(kernels)
    t0 = torch.from_numpy(np.random.default_rng(5).uniform(
        0.0, 0.05, (N, N)).astype(np.float32))
    kw = dict(t0=t0, eps=3e-4, t_max=6.0)
    img_p, ts_p = G.generic_fwd_plain(kernels.sdf_fn, kernels.ray_fn, pv, N,
                                      STEPS, **kw)
    img_h, ts_h = host_fwd(lib, pv, N, STEPS, **kw)
    flip_gate(img_h, ts_h, img_p, ts_p)


def test_host_march_is_bit_equal_where_nothing_divides_by_a_number(host_lib):
    lib = host_lib(G.SceneKernels(sphere_only, G.ortho_camera, 9))
    pv = torch.from_numpy(PARAMS[:9])
    for kw in MARCHES.values():
        _, ts_p = G.generic_fwd_plain(sphere_only, G.ortho_camera, pv, N,
                                      STEPS, **kw)
        _, ts_h = host_fwd(lib, pv, N, STEPS, **kw)
        assert torch.equal(ts_h, ts_p), kw


def test_host_backward_matches_plain(scene, host_lib):
    kernels, pv = scene
    _, ts = G.generic_fwd_plain(kernels.sdf_fn, kernels.ray_fn, pv, N, STEPS)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (N, N)).astype(np.float32))
    ref = G.generic_bwd_plain(kernels.sdf_fn, kernels.ray_fn, pv, g, ts, N)
    dp = host_bwd(host_lib(kernels), pv, g, ts, N)
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(dp, ref, rtol=2e-4, atol=2e-4 * scale)
    assert ref.abs().max().item() > 1.0  # the cotangent is not trivially 0


def many_spheres(p, pv):
    """Six spheres, a torus and a ground plane: 32 parameters."""
    d = sd.sd_torus(p, Vec3(0.0, 0.0, 1.0), pv[29], pv[30])
    for k in range(5, 29, 4):
        d = sd.op_smooth_union(
            d, sd.sd_sphere(p, Vec3(pv[k], pv[k + 1], pv[k + 2]), pv[k + 3]),
            0.1)
    return sd.op_union(d, sd.sd_plane(p, Vec3(0.0, -1.0, 0.0), pv[31]))


def test_host_backward_of_a_32_parameter_scene_matches_plain(host_lib):
    """The widest scene built on the card: its cotangent program is a few
    times the composed scene's, and the host build of it agrees."""
    rng = np.random.default_rng(11)
    v = np.concatenate([
        PARAMS[:5],
        np.column_stack([rng.uniform(-0.8, 0.8, (6, 2)),
                         rng.uniform(0.0, 0.6, (6, 1)),
                         rng.uniform(0.15, 0.3, (6, 1))]).ravel(),
        [0.55, 0.18, 1.05]]).astype(np.float32)
    kernels = G.SceneKernels(many_spheres, G.ortho_camera, 32)
    pv = torch.from_numpy(v)
    _, ts = G.generic_fwd_plain(many_spheres, G.ortho_camera, pv, N, STEPS)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (N, N)).astype(np.float32))
    ref = G.generic_bwd_plain(many_spheres, G.ortho_camera, pv, g, ts, N)
    dp = host_bwd(host_lib(kernels), pv, g, ts, N)
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(dp, ref, rtol=2e-4, atol=2e-4 * scale)
    assert (ref.abs() > 0).sum().item() >= 24
    assert kernels.traced.cotangent.n_ops > 3 * T.trace_scene(
        composed, G.ortho_camera, 12).cotangent.n_ops


def tied(sd_, Vec, ops):
    """A scene whose every hit point meets three ties: two equal spheres
    (pv[8] == pv[9]) under a minimum, abs at 0 (pv[10] = 0) and a clip at
    its lower bound (pv[11] = 0); ``ops`` gives minimum, abs and clip."""
    minimum, abs_, clip = ops

    def sdf(p, pv):
        a = sd_.sd_sphere(p, Vec(pv[5], pv[6], pv[7]), pv[8])
        b = sd_.sd_sphere(p, Vec(pv[5], pv[6], pv[7]), pv[9])
        return (minimum(a, b) + abs_(pv[10] * p.x)
                + clip(pv[11], 0.0, 1.0) * p.y)

    return sdf


TIED_PARAMS = np.asarray(
    [0.15, 40.0, -1.0, -1.0, 2.0, 0.1, -0.2, 0.3, 0.45, 0.45, 0.0, 0.0],
    np.float32)


def test_host_cotangent_meets_the_reference_ties(host_lib):
    """At a minimum tie the gradient splits 0.5 / 0.5, abs has slope +1 at
    0, clip passes 0.5 at a bound: the host build of user_cotangent
    against generic_bwd_plain (same ts, rtol 2e-4) and against the
    gradient of the reference's render_pallas in interpret mode (its own
    march, the slice-4 gate)."""
    sdf = tied(sd, Vec3, (T.minimum, T.abs, T.clip))
    kernels = G.SceneKernels(sdf, G.ortho_camera, 12)
    pv = torch.from_numpy(TIED_PARAMS)
    _, ts = G.generic_fwd_plain(sdf, G.ortho_camera, pv, N, STEPS)
    assert (ts >= 0).float().mean().item() > 0.1
    g = torch.full((N, N), 1.0 / (N * N))
    dp = host_bwd(host_lib(kernels), pv, g, ts, N)
    ref = G.generic_bwd_plain(sdf, G.ortho_camera, pv, g, ts, N)
    torch.testing.assert_close(dp, ref, rtol=2e-4,
                               atol=2e-4 * max(1.0, ref.abs().max().item()))
    # the two radii share the tie's gradient; abs and clip pass theirs
    assert dp[8].item() == pytest.approx(dp[9].item(), rel=1e-5)
    assert abs(dp[8].item()) > 1e-3
    assert abs(dp[10].item()) > 1e-5 and abs(dp[11].item()) > 1e-5
    jsdf = tied(jsd, JVec3, (jnp.minimum, jnp.abs, jnp.clip))
    render_pallas, _ = jgen.make_sdf_renderer(jsdf, 12)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.grad(lambda v: jnp.mean(
            render_pallas(v, N, STEPS, 1.2, N)))(jnp.asarray(TIED_PARAMS)))
    assert np.allclose(dp.numpy(), want, rtol=2e-2,
                       atol=2e-3 * max(1.0, np.abs(want).max())), (dp, want)


def test_host_all_miss_is_exact(host_lib):
    lib = host_lib(G.SceneKernels(sphere_only, G.ortho_camera, 9))
    pv = torch.tensor([0.15, 40.0, -1.0, -1.0, 2.0, 50.0, 0.0, 0.3, 0.45])
    img, ts = host_fwd(lib, pv, N, STEPS)
    assert torch.equal(img, torch.full((N, N), 0.15))
    assert (ts < 0).all()
    dp = host_bwd(lib, pv, torch.ones(N, N), ts, N)
    assert dp[0].item() == N * N and (dp[1:] == 0).all()


def test_host_build_failure_raises_with_the_source_path(tmp_path):
    with pytest.raises(RuntimeError, match=r"failed to build .*\.cpp"):
        build_host("#error not a scene\n", tmp_path)
