"""enoki_tpu_torch.ops -- the subset of enoki_tpu.ops the render uses."""

from .router import linspace, meshgrid, safe_sqrt, rsqrt  # noqa: F401
