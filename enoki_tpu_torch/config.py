"""Run-time switches of the port (counterpart of enoki_tpu/config.py, of
which only ``debug_bounds`` is ported so far).

    from enoki_tpu_torch.config import config
    config.debug_bounds = True
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass
class Config:
    # scatter / scatter_add without a mask: an out-of-range index is
    # undefined by default (as in the reference); with this switch it is
    # dropped, deterministically
    debug_bounds: bool = os.environ.get("ENOKI_TPU_DEBUG_BOUNDS", "0") == "1"


config = Config()
