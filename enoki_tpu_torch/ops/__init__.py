"""enoki_tpu_torch.ops -- the flat functional op set (counterpart of
enoki_tpu/ops), ported whole but for the lazy (``LazyArray``) halves that
wait for the port of ``trace/``: ``from enoki_tpu_torch import ops`` and
call ``ops.select`` / ``ops.sincos`` / ``ops.carlson_rf`` /
``ops.histogram`` as with the reference. ``ops.reverse`` is the router's
(last axis), ``ops.horiz.reverse`` the horizontal one (first axis).
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

from .math import (  # noqa: F401
    sin, cos, sincos, tan, cot,
    asin, acos, atan, atan2,
    exp, exp2, log, log2, log1p, expm1, cbrt, pow,
    sinh, cosh, sincosh, tanh, csc, sec, csch, sech, coth,
    asinh, acosh, atanh,
    fmod, hypot,
)

from .special import (  # noqa: F401
    erf, erfc, erfinv, i0e, dawson, erfi,
    lgamma, tgamma, gamma,
    carlson_rf, carlson_rd, carlson_rc, carlson_rj,
    comp_ellint_1, ellint_1, comp_ellint_2, ellint_2,
    comp_ellint_3, ellint_3,
)

from .hist_kernels import histogram  # noqa: F401

from . import polys  # noqa: F401
from . import rounding  # noqa: F401
from .rounding import (  # noqa: F401
    round_, round_half_away, floor, ceil, trunc, stochastic_round,
)
