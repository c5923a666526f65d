"""enoki_tpu_torch.types -- composite math types (counterpart of
enoki_tpu/types, ported whole, lazy halves included: each type also
instantiates over ``trace.LazyArray`` elements).

Complex, Quaternion, Matrix (trailing axes and SoA), homogeneous
transforms, sRGB color, spherical harmonics, Morton codes, the PCG32
generator with its 64-bit integers, magic-multiplier integer division,
half-precision storage and enum arrays.
"""

from . import u64  # noqa: F401
from .complex import Complex  # noqa: F401
from . import complex as complex_  # noqa: F401
from .quaternion import Quaternion  # noqa: F401
from . import quaternion  # noqa: F401
from . import matrix  # noqa: F401
from . import matrix_soa  # noqa: F401
from . import transform  # noqa: F401
from . import color  # noqa: F401
from . import sh  # noqa: F401
from .morton import morton_encode, morton_decode  # noqa: F401
from .random import (PCG32, PCG32_DEFAULT_STATE, PCG32_DEFAULT_STREAM,  # noqa: F401
                     PCG32_MULT, uniform)
from .idiv import DivisorU32, DivisorI32, divisor  # noqa: F401
from . import half  # noqa: F401
from . import enum_array  # noqa: F401
