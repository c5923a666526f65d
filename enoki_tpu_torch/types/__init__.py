"""enoki_tpu_torch.types -- composite types (counterpart of
enoki_tpu/types): so far the PCG32 generator and its 64-bit integers.
"""

from . import u64  # noqa: F401
from .random import (PCG32, PCG32_DEFAULT_STATE, PCG32_DEFAULT_STREAM,  # noqa: F401
                     PCG32_MULT, uniform)
