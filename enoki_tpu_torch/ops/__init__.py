"""enoki_tpu_torch.ops -- the flat functional op set (counterpart of
enoki_tpu/ops), as far as it is ported: ``from enoki_tpu_torch import
ops`` and call ``ops.select`` / ``ops.erfinv`` / ``ops.histogram`` as with
the reference.
"""

from .router import (  # noqa: F401
    linspace, meshgrid,
    select, masked_assign,
    rsqrt, reinterpret,
    ldexp, frexp,
    gather, scatter, scatter_add, transform,
    isnan, isinf, isfinite,
    safe_sqrt,
    next_float, prev_float,
)

from .math import log  # noqa: F401

from .special import erfinv  # noqa: F401

from .hist_kernels import histogram  # noqa: F401

from . import polys  # noqa: F401
from . import rounding  # noqa: F401
from .rounding import (  # noqa: F401
    round_, round_half_away, floor, ceil, trunc, stochastic_round,
)
