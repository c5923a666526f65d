"""enoki_tpu_torch.ops -- the flat functional op set (counterpart of
enoki_tpu/ops), as far as it is ported: ``from enoki_tpu_torch import
ops`` and call ``ops.select`` / ``ops.hsum`` / ``ops.erfinv`` /
``ops.histogram`` as with the reference. ``ops/router.py`` and
``ops/horiz.py`` are ported whole; ``ops.reverse`` is the router's (last
axis), ``ops.horiz.reverse`` the horizontal one (first axis).
"""

from .router import (  # noqa: F401
    zeros, full, empty, arange, linspace, meshgrid,
    select, masked_assign,
    fmadd, fmsub, fnmadd, fnmsub, fmaddsub, fmsubadd,
    rcp, rsqrt,
    popcnt, lzcnt, tzcnt, log2i, mulhi, ror, rol, reinterpret,
    ldexp, frexp,
    gather, scatter, scatter_add, transform, prefetch, binary_search,
    extract, range_packets,
    clamp, lerp, sign, copysign, mulsign, abs_, sqr,
    cross, copysign_neg, mulsign_neg,
    isnan, isinf, isfinite, isdenormal, allclose,
    sqrt, safe_sqrt, safe_rsqrt, safe_asin, safe_acos,
    tile, repeat, reverse, head, tail, concat,
    next_float, prev_float, deg_to_rad, rad_to_deg,
)

from .horiz import (  # noqa: F401
    hsum, hprod, hmax, hmin, hmean,
    hsum_nested, hprod_nested, hmax_nested, hmin_nested,
    all_nested, any_nested, none_nested, count_nested,
    psum, all_, any_, none, count,
    dot, abs_dot, norm, squared_norm, normalize,
    compress, partition, segment_offsets,
)

from .math import log  # noqa: F401

from .special import erfinv  # noqa: F401

from .hist_kernels import histogram  # noqa: F401

from . import polys  # noqa: F401
from . import rounding  # noqa: F401
from .rounding import (  # noqa: F401
    round_, round_half_away, floor, ceil, trunc, stochastic_round,
)
