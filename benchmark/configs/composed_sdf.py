"""The ``composed_sdf`` configuration as the program runs it: the scene
written with the port's SDF library, as a user writes it, and the
``GenericRender`` module of ``make_sdf_renderer`` (the ``generic_fwd``
and ``generic_bwd`` kernels generated for this scene)."""

from __future__ import annotations


def scene_sdf(p, pv):
    from enoki_tpu_torch.render import Vec3, sdflib as sd
    sphere = sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])
    torus = sd.sd_torus(p, Vec3(0.0, 0.0, 1.0), pv[9], pv[10])
    ground = sd.sd_plane(p, Vec3(0.0, -1.0, 0.0), pv[11])
    return sd.op_union(sd.op_smooth_union(sphere, torus, 0.1), ground)


class Program:
    def __init__(self, cfg: dict, device):
        from enoki_tpu_torch.render import make_sdf_renderer
        self.cfg, self.device = cfg, device
        self.render, _ = make_sdf_renderer(scene_sdf, cfg["n_params"])

    def load(self):
        """The first call into the scene's kernels: trace the scene and
        compile its source (in a fresh checkout), or find and load the
        library built for it."""
        self.render.kernels.lib

    def model(self, vec, n: int, dtype: str | None = None):
        """The render as a module whose one parameter is ``vec``, at
        ``n`` x ``n`` samples. The program marches in f32 only."""
        from enoki_tpu_torch.render.generic import GenericRender
        if (dtype or self.cfg["dtype"]) != "float32":
            raise ValueError("the generated kernels march in float32 only")
        return GenericRender(self.render, vec, n=n,
                             n_steps=self.cfg["n_steps"],
                             extent=self.cfg["extent"], device=self.device,
                             **self.cfg["options"])
