"""``runtime.kernel_printf`` of the port (enoki_tpu_torch.render.sdf_trace):
the reference's print inside a Pallas kernel body
(enoki_tpu/runtime/__init__.py:32-40, ``pl.debug_print``), on the body a
user reaches through ``make_sdf_renderer``: the scene functions ``sdf_fn``
and ``ray_fn``.

In a traced scene function a call records a print node, which the emitted
``user_sdf`` / ``user_ray`` run as one device ``printf`` in the thread of
pixel (0, 0); the derived programs (shade, cotangent) carry none. On
tensors it prints the same line from the host, with the first lane's
values, where the kernel prints: once from the ray and once a march step,
not in the shade or the backward. The card's lines are a prefix of the
plain route's, and past a lane's freeze the plain march prints its last
line again (chip_smoke.py phase 31 holds that on the card; here the
count rule at 32^2, 12 steps). The reference's print in interpret mode is
held against the port's plain route value for value.
"""

import re
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from enoki_tpu import runtime as jruntime
from enoki_tpu.render import generic as jgen, sdflib as jsd
from enoki_tpu.render.vec import Vec3 as JVec3
from enoki_tpu_torch import runtime
from enoki_tpu_torch.render import generic as G, sdf_trace as T
from enoki_tpu_torch.render import make_sdf_renderer
from test_torch_generic_codegen import build_host, host_fwd

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "examples"))
import composed_torch as CT  # noqa: E402

N, STEPS = 32, 12
PARAMS = torch.from_numpy(CT.PARAMS)


def printing_sdf(p, pv):
    d = CT.scene_sdf(p, pv)
    runtime.kernel_printf("sdf pv[5]={} d={}", pv[5], d)
    return d


def printing_ray(px, py, pv):
    o, d = G.ortho_camera(px, py, pv)
    runtime.kernel_printf("ray o=({}, {}, {})", o.x, o.y, o.z)
    return o, d


def body(source, fn):
    return source.split(f" {fn}(")[1].split("\n}\n")[0]


def printing_scene():
    return T.trace_scene(printing_sdf, printing_ray, 12)


def test_prints_are_emitted_in_the_scene_functions_alone():
    src = printing_scene().source
    counts = {fn: body(src, fn).count("printf(") for fn in (
        "user_sdf", "user_ray", "user_shade", "user_cotangent")}
    assert counts == {"user_sdf": 1, "user_ray": 1, "user_shade": 0,
                      "user_cotangent": 0}
    assert 'printf("sdf pv[5]=%.9g d=%.9g\\n", print_value(pv[5]), ' \
        'print_value(v' in body(src, "user_sdf")
    assert "if (print_pixel()) printf(" in body(src, "user_ray")


def test_derived_programs_are_those_of_the_scene_without_prints():
    with_prints = printing_scene()
    plain = T.trace_scene(CT.scene_sdf, G.ortho_camera, 12)
    assert with_prints.shade == plain.shade
    assert with_prints.cotangent == plain.cotangent
    assert with_prints.sdf.n_ops == plain.sdf.n_ops
    assert len(with_prints.sdf.prints) == 1 and plain.sdf.prints == ()
    # a print is a root: its argument stays, though no output needs it
    lonely = T.trace_function(
        lambda p, pv: (runtime.kernel_printf("{}", p.x * 3.0), p.y)[1],
        ("x", "y", "z"), 5, lambda s: (T.Vec3(*s),))
    assert [n[0] for n in lonely.nodes] == ["in", "in", "const", "mul",
                                            "print"]


def test_the_source_repeats_and_differs_from_the_scene_without_prints():
    a, b = printing_scene().source, printing_scene().source
    assert a == b
    assert a != T.trace_scene(CT.scene_sdf, printing_ray, 12).source


@pytest.mark.parametrize("fmt,c_text", [
    ("100% of {}", "100%% of %.9g\\n"),
    ('say "{}"', 'say \\"%.9g\\"\\n'),
    ("back\\slash {} ?", "back\\\\slash %.9g \\?\\n"),
    ("tab\t{}", "tab\\011%.9g\\n"),
    ("{} {{braces}}", "%.9g {braces}\\n"),
])
def test_the_format_is_escaped_as_c(fmt, c_text):
    def sdf(p, pv):
        runtime.kernel_printf(fmt, pv[5])
        return p.x - pv[5]

    prog = T.trace_function(sdf, ("x", "y", "z"), 6,
                            lambda s: (T.Vec3(*s),))
    (node,) = [n for n in prog.nodes if n[0] == "print"]
    assert node[1] == c_text


def test_python_numbers_are_written_as_the_host_writes_them(capsys):
    prog = T.trace_function(
        lambda p, pv: (runtime.kernel_printf("{} {}", 0.1, p.x), p.x)[1],
        ("x", "y", "z"), 5, lambda s: (T.Vec3(*s),))
    (node,) = [n for n in prog.nodes if n[0] == "print"]
    assert node[1] == "0.1 %.9g\\n"
    runtime.kernel_printf("{} and {}", 0.1, 3)
    assert capsys.readouterr().out == "0.1 and 3\n"


def test_the_host_build_compiles_the_prints_and_keeps_the_image(tmp_path):
    # the emitted printf builds (on the host no thread prints), and the
    # per-pixel code gives the bits of the scene without prints
    import ctypes
    from test_torch_generic_codegen import HOST_SIGNATURES

    def lib_of(traced):
        lib = ctypes.CDLL(str(build_host(traced.source, tmp_path)))
        for fn, argtypes in HOST_SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        return lib

    got = host_fwd(lib_of(printing_scene()), PARAMS, N, STEPS)
    want = host_fwd(lib_of(T.trace_scene(CT.scene_sdf, G.ortho_camera, 12)),
                    PARAMS, N, STEPS)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def plain_lines(capsys, fn):
    capsys.readouterr()
    fn()
    return capsys.readouterr().out.splitlines()


def test_the_plain_route_prints_where_the_kernel_prints(capsys):
    render, _ = make_sdf_renderer(printing_sdf, 12, ray_fn=printing_ray)
    p = PARAMS.clone().requires_grad_()
    lines = plain_lines(capsys, lambda: render(p, N, STEPS, 1.2, N).mean()
                        .backward())
    # one line from the ray, one a march step; the shade and the backward
    # print nothing
    assert len(lines) == 1 + STEPS
    assert lines[0] == "ray o=(-1.20000005, -1.20000005, -1)"
    assert all(line.startswith("sdf pv[5]=0.100000001 d=")
               for line in lines[1:])
    # the count rule: the kernel's thread of pixel (0, 0) evaluates the
    # distance once an advance and once more; the plain march's lines
    # after those repeat its last
    evals = int(G.generic_march_counts(printing_sdf, printing_ray, PARAMS,
                                       N, STEPS)[0, 0])
    assert 1 <= evals < STEPS
    assert all(line == lines[-1] for line in lines[1 + evals:])
    assert lines[evals] == lines[-1]
    # the value is pixel (0, 0)'s: the plain march's distance there
    img, ts = G.generic_fwd_plain(CT.scene_sdf, G.ortho_camera, PARAMS, N,
                                  STEPS)
    t = float(ts[0, 0]) if ts[0, 0] >= 0 else float(-1.0 - ts[0, 0])
    o = torch.tensor([-1.2, -1.2, -1.0], dtype=torch.float32)
    d = CT.scene_sdf(T.Vec3(o[0], o[1], o[2] + torch.tensor(t)), PARAMS)
    assert lines[-1].endswith(f" d={float(d):.9g}")


def test_the_plain_twin_and_the_prepass_print_from_the_host(capsys):
    # the cone prepass is plain PyTorch on both routes: its coarse rays
    # print from the host alike; the twin marches on tensors
    render, render_plain = make_sdf_renderer(printing_sdf, 12,
                                             ray_fn=G.ortho_camera)
    lines = plain_lines(capsys, lambda: render(PARAMS, N, STEPS, 1.2, N,
                                               coarse=8))
    assert len(lines) > STEPS
    lines = plain_lines(capsys, lambda: render_plain(PARAMS, N, STEPS))
    assert len(lines) == STEPS


def test_the_twin_prints_in_its_march_alone(capsys):
    # render_plain's second ray, its shade and its implicit backward print
    # nothing: one line from the ray and one a march step
    _, render_plain = make_sdf_renderer(printing_sdf, 12,
                                        ray_fn=printing_ray)
    p = PARAMS.clone().requires_grad_()
    lines = plain_lines(capsys, lambda: render_plain(p, N, STEPS).mean()
                        .backward())
    assert len(lines) == 1 + STEPS
    assert lines[0].startswith("ray ")
    assert torch.isfinite(p.grad).all()


def test_a_quiet_print_reads_no_value(capsys):
    # a meta tensor has no value to read: inside _no_prints nothing asks
    # for one (on the card, no copy to the host)
    meta = torch.empty(4, device="meta")
    with T._no_prints():
        runtime.kernel_printf("{}", meta)
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="meta"):
        runtime.kernel_printf("{}", meta)


def test_quieting_is_each_threads_own(capsys):
    inside, done = threading.Event(), threading.Event()

    def quiet():
        with T._no_prints():
            inside.set()
            assert done.wait(10)

    with ThreadPoolExecutor(1) as pool:
        held = pool.submit(quiet)
        assert inside.wait(10)
        try:
            runtime.kernel_printf("loud {}", torch.tensor([2.5]))
        finally:
            done.set()
        held.result()
    assert capsys.readouterr().out == "loud 2.5\n"


def numbers_sdf(p, pv):
    runtime.kernel_printf("step {}", 7)
    return printing_sdf(p, pv)


def test_two_threads_trace_their_own_scenes():
    # a scene that prints, a Python number alone among its prints, traced
    # while another thread traces a scene without prints, whose trace
    # opens after the first's and stays open across its prints: each
    # scene's source is the one it has traced alone
    want = [T.trace_scene(numbers_sdf, printing_ray, 12).source,
            T.trace_scene(CT.scene_sdf, G.ortho_camera, 12).source]
    a_in, b_in, a_printed = (threading.Event() for _ in range(3))

    def sdf_a(p, pv):
        if a_in.is_set():
            return numbers_sdf(p, pv)
        a_in.set()
        assert b_in.wait(10)
        d = numbers_sdf(p, pv)
        a_printed.set()
        return d

    def sdf_b(p, pv):
        if not b_in.is_set():
            assert a_in.wait(10)
            b_in.set()
            assert a_printed.wait(10)
        return CT.scene_sdf(p, pv)

    with ThreadPoolExecutor(2) as pool:
        got = [f.result() for f in (
            pool.submit(T.trace_scene, sdf_a, printing_ray, 12),
            pool.submit(T.trace_scene, sdf_b, G.ortho_camera, 12))]
    assert [g.source for g in got] == want
    assert "step 7" in want[0]
    assert "printf" not in body(want[1], "user_sdf")


@pytest.mark.parametrize("case", ["tensor", "other trace", "string",
                                  "escaped value"])
def test_an_invalid_argument_raises_a_trace_error(case):
    held = {}

    def sdf(p, pv):
        if case == "tensor":
            runtime.kernel_printf("{} {}", p.x, torch.ones(1))
        elif case == "other trace":
            held.setdefault("sym", p.x)
            runtime.kernel_printf("{}", held["sym"])
        elif case == "string":
            runtime.kernel_printf("{}", "text")
        return p.x

    if case == "escaped value":
        T.trace_function(lambda p, pv: held.setdefault("sym", p.x),
                         ("x", "y", "z"), 5, lambda s: (T.Vec3(*s),))
        with pytest.raises(T.TraceError, match="left the call"):
            runtime.kernel_printf("{}", held["sym"])
        return
    if case == "other trace":  # the first trace keeps the value
        T.trace_function(sdf, ("x", "y", "z"), 5, lambda s: (T.Vec3(*s),))
    with pytest.raises(T.TraceError):
        T.trace_function(sdf, ("x", "y", "z"), 5, lambda s: (T.Vec3(*s),))


def test_a_bad_format_raises_on_both_routes():
    for fmt, args in (("{} {}", (1.0,)), ("{0}", (1.0,)), ("{:f}", (1.0,))):
        with pytest.raises(ValueError):
            runtime.kernel_printf(fmt, *args)
        with pytest.raises(ValueError):
            T.trace_function(
                lambda p, pv: (runtime.kernel_printf(fmt, *args), p.x)[1],
                ("x", "y", "z"), 5, lambda s: (T.Vec3(*s),))


def test_the_reference_prints_the_same_parameter(capfd):
    # the reference's kernel_printf in its Pallas body, interpret mode,
    # prints there (pl.debug_print); its parameter's value is the port's
    def j_sdf(p, pv):
        jruntime.kernel_printf("pv5 {}", pv[5])
        return jsd.sd_sphere(p, JVec3(pv[5], pv[6], pv[7]), pv[8])

    pv = np.asarray([0.15, 40.0, -1.0, -1.0, 2.0, 0.1, -0.2, 0.3, 0.45],
                    np.float32)
    rp, _ = jgen.make_sdf_renderer(j_sdf, 9)
    capfd.readouterr()
    with pltpu.force_tpu_interpret_mode():
        np.asarray(rp(jnp.asarray(pv), 16, 4, 1.2, 16))
    ref = [float(m) for m in re.findall(r"^pv5 (\S+)$",
                                        capfd.readouterr().out, re.M)]
    assert ref

    from enoki_tpu_torch.render import sdflib as tsd

    def t_sdf(p, pv):
        runtime.kernel_printf("pv5 {}", pv[5])
        return tsd.sd_sphere(p, T.Vec3(pv[5], pv[6], pv[7]), pv[8])

    render, _ = make_sdf_renderer(t_sdf, 9)
    render(torch.from_numpy(pv), 16, 4, 1.2, 16)
    port = [float(m) for m in re.findall(r"^pv5 (\S+)$",
                                         capfd.readouterr().out, re.M)]
    assert len(port) == 4  # one line a march step
    assert {np.float32(v) for v in ref} == {np.float32(v) for v in port} \
        == {pv[5]}
