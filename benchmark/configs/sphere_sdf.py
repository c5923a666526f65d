"""The ``sphere_sdf`` configuration as the program runs it: the port's
``SDFRender`` module (the ``sdf_fwd`` and ``sdf_bwd`` kernels of
``csrc/sdf_render.cu`` under one autograd Function)."""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Program:
    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, device

    def load(self):
        """The first call into the program's build: compile (in a fresh
        checkout) or find and load the kernels' library."""
        from enoki_tpu_torch import _build
        _build.load("sdf_render")

    def model(self, vec, n: int, dtype: str | None = None):
        """The render as a module whose one parameter is ``vec``, at
        ``n`` x ``n`` samples; ``dtype`` the march's, the configuration's
        unless given."""
        from enoki_tpu_torch.render.sdf_kernels import SDFRender
        opts = dict(self.cfg["options"])
        return SDFRender(vec, n=n, n_steps=self.cfg["n_steps"],
                         extent=self.cfg["extent"], device=self.device,
                         dtype=DTYPES[dtype or self.cfg["dtype"]], **opts)
