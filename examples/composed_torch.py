"""Composed-scene differentiable render through the PyTorch/CUDA port: the
bring-your-own-SDF demo of examples/composed.py on an NVIDIA GPU.

Sphere smoothly blended with a torus over a ground plane, rendered by the
two CUDA kernels that make_sdf_renderer generates for this scene (traced
from scene_sdf, built with nvcc at the first render), gradients w.r.t. all
12 parameters, PPM out.

Run: python examples/composed_torch.py [n] [cpu]
On the card by default; "cpu" takes the kernels' plain PyTorch versions.
"""

import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np

from enoki_tpu_torch.interop import generic_params_from_numpy
from enoki_tpu_torch.render import make_sdf_renderer, sdflib as sd, Vec3
from enoki_tpu_torch.render.io import write_ppm


def scene_sdf(p, pv):
    sphere = sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])
    torus = sd.sd_torus(p, Vec3(0.0, 0.0, 1.0), pv[9], pv[10])
    ground = sd.sd_plane(p, Vec3(0.0, -1.0, 0.0), pv[11])
    return sd.op_union(sd.op_smooth_union(sphere, torus, 0.1), ground)


PARAMS = np.asarray(
    # ambient gain light(x,y,z)    sphere(cx,cy,cz,r)     torus(R,r) plane
    [0.15, 40.0, -1.0, -1.0, 2.0, 0.1, -0.2, 0.3, 0.45, 0.55, 0.18, 1.05],
    np.float32)


def main():
    args = sys.argv[1:]
    device = "cpu" if "cpu" in args else None   # None: the card
    sizes = [int(a) for a in args if a.isdigit()]
    n = sizes[0] if sizes else 1024
    render, _ = make_sdf_renderer(scene_sdf, n_params=12)
    params = generic_params_from_numpy(PARAMS, 12, device).requires_grad_()

    img = render(params, n)
    write_ppm("composed.ppm", img.detach().cpu().numpy())
    print(f"wrote composed.ppm ({n}x{n}), mean {img.mean().item():.3f}")

    img.mean().backward()
    names = ["ambient", "gain", "lx", "ly", "lz", "cx", "cy", "cz",
             "radius", "torus_R", "torus_r", "plane"]
    print("d mean(image) / d theta:")
    for name, gi in zip(names, params.grad.cpu().numpy()):
        print(f"  {name:8s} {gi:+.5f}")


if __name__ == "__main__":
    main()
