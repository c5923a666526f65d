#!/usr/bin/env python3
"""The main path's fwd+bwd steps of chip_smoke.py phases 4, 8 and 16,
timed for this checkout and another in one process on one CUDA card.

  python step_ab.py OTHER_ROOT

OTHER_ROOT is a checkout of another commit. Its enoki_tpu_torch is loaded
beside this one under the name ``enoki_tpu_torch_other`` (the package
imports itself relatively), and each builds its own kernels. The steps
are those of the phases: the SDF render (``render_sdf_cuda`` at 1024^2,
64 steps) with ``autograd.grad`` of its mean (phase 4), the closed-form
sphere through ``SphereRender`` with ``loss.backward()`` (phase 8), and
the composed generic scene with ``autograd.grad`` (phase 16). A window
times ITERS data-chained steps with CUDA events, as ``chip_smoke.chain_ms``
does. The two checkouts' windows alternate, and so does the side that
runs first, so that both see the same state of the host: the steps are
host-bound, and a shared host's load moves a step's time by tens of
percent from one minute to the next.

Needs a CUDA card; prints the card's name and power limit, and for each
step both sides' medians over their windows and their quartiles, the
ratio this / other of the medians, and the pairs of windows in which
this checkout was the faster.
"""

import argparse
import importlib
import importlib.util
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ITERS, PAIRS = 100, 40


def load_other(root):
    """The enoki_tpu_torch of the checkout at ``root``, imported as
    ``enoki_tpu_torch_other``."""
    pkg = os.path.join(os.path.abspath(root), "enoki_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "enoki_tpu_torch_other", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def steps_of(name, torch, C):
    """The three steps through the package imported as ``name``: step
    name -> (step, initial parameters)."""
    def sub(path):
        return importlib.import_module(f"{name}.{path}")

    K, S = sub("render.sdf_kernels"), sub("render.sphere_kernels")
    G, sd = sub("render.generic"), sub("render.sdflib")
    Vec3 = sub("render").Vec3
    dev = torch.device("cuda")
    N, STEPS, EXTENT = C.N, C.STEPS, C.EXTENT
    p_sdf = torch.from_numpy(C.scene_vec(None)).to(dev)
    p_gen = torch.tensor(C.GENERIC_PARAMS, dtype=torch.float32, device=dev)
    model = S.SphereRender(p_sdf.clone(), n=N, extent=EXTENT)

    def scene_sdf(p, pv):          # chip_smoke.generic_scenes' "composed"
        s = sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])
        t = sd.sd_torus(p, Vec3(0.0, 0.0, 1.0), pv[9], pv[10])
        g = sd.sd_plane(p, Vec3(0.0, -1.0, 0.0), pv[11])
        return sd.op_union(sd.op_smooth_union(s, t, 0.1), g)

    render = G.make_sdf_renderer(scene_sdf, 12)[0]

    def sdf_step(p0, p, k):                        # chip_smoke.py phase 4
        p = p.detach().requires_grad_(True)
        loss = K.render_sdf_cuda(p, N, STEPS, EXTENT, min(128, N),
                                 coarse=0).mean()
        (g,) = torch.autograd.grad(loss, p)
        return p0 + (loss.detach() + 1e-12 * g.sum()) * 1e-12 + 1e-6 * k

    def sphere_step(p0, p, k):                     # chip_smoke.py phase 8
        with torch.no_grad():
            model.params.copy_(p)
        model.params.grad = None
        loss = model().mean()
        loss.backward()
        g = model.params.grad
        return p0 + (loss.detach() + 1e-12 * g.sum()) * 1e-12 + 1e-6 * k

    def generic_step(p0, p, k):                    # chip_smoke.py phase 16
        p = p.detach().requires_grad_(True)
        loss = render(p, N, STEPS, EXTENT, min(128, N)).mean()
        (g,) = torch.autograd.grad(loss, p)
        return p0 + (loss.detach() + 1e-12 * g.sum()) * 1e-12 + 1e-6 * k

    return {"phase 4 sdf": (sdf_step, p_sdf),
            "phase 8 sphere": (sphere_step, p_sdf),
            "phase 16 generic": (generic_step, p_gen)}


def window_ms(torch, step, p0):
    """ms a step over ITERS data-chained steps (CUDA events)."""
    ev = torch.cuda.Event
    s, e = ev(enable_timing=True), ev(enable_timing=True)
    p = p0
    s.record()
    for k in range(ITERS):
        p = step(p0, p, k)
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / ITERS


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", metavar="OTHER_ROOT", help="the other checkout")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as C
    if not torch.cuda.is_available():
        sys.exit("step_ab: needs a CUDA card")
    print(C.nvidia_smi("name,power.limit"))
    load_other(args.other)
    sides = {"this": steps_of("enoki_tpu_torch", torch, C),
             "other": steps_of("enoki_tpu_torch_other", torch, C)}
    for name in sides["this"]:
        for steps in sides.values():              # builds, warm-up
            step, p0 = steps[name]
            step(p0, p0, 0)
        torch.cuda.synchronize()
        ms = {"this": [], "other": []}
        for pair in range(PAIRS):
            for side in ("this", "other")[::1 if pair % 2 == 0 else -1]:
                ms[side].append(window_ms(torch, *sides[side][name]))
        med = {side: statistics.median(v) for side, v in ms.items()}
        quart = {side: statistics.quantiles(v, n=4)[::2]
                 for side, v in ms.items()}
        wins = sum(t < o for t, o in zip(ms["this"], ms["other"]))
        print(f"{name}: this {med['this']:.4f} ms (quartiles "
              f"{quart['this'][0]:.4f}-{quart['this'][1]:.4f}), other "
              f"{med['other']:.4f} ms (quartiles {quart['other'][0]:.4f}-"
              f"{quart['other'][1]:.4f}), this / other "
              f"{med['this'] / med['other']:.4f}; this faster in {wins} "
              f"of {PAIRS} pairs of windows", flush=True)


if __name__ == "__main__":
    main()
