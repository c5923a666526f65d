"""Run-time switches of the port (counterpart of enoki_tpu/config.py), with
the reference's fields and environment variables:

* ``log_level``        0..5 (``ENOKI_TPU_LOG_LEVEL``): 0 silent ... 5
                       everything, as ``cuda_set_log_level``
* ``approx``           fast polynomial transcendentals where there is a
                       choice (``ENOKI_TPU_APPROX``)
* ``default_dtype``    ``ENOKI_TPU_DTYPE``, float32 by default
* ``debug_bounds``     scatter / scatter_add without a mask: an
                       out-of-range index is undefined by default (as in
                       the reference); with this switch it is dropped,
                       deterministically (``ENOKI_TPU_DEBUG_BOUNDS``)
* ``max_fused_ops``    the lazy trace's segment length: the plain
                       interpreter's segments and the most entries of one
                       fused kernel (``ENOKI_TPU_MAX_FUSED_OPS``; 0: no cap)
* ``trace_export_dir`` ``auto``, a disable word or a directory
                       (``ENOKI_TPU_EXPORT_CACHE``; ``cache.export_dir``)
* ``cache_max_bytes``  LRU bound of each cache directory
                       (``ENOKI_TPU_CACHE_MAX_BYTES``, 2 GiB)
* ``eval_callbacks``   hooks run by ``run_callbacks``

    from enoki_tpu_torch.config import config
    config.debug_bounds = True
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List


@dataclasses.dataclass
class Config:
    log_level: int = int(os.environ.get("ENOKI_TPU_LOG_LEVEL", "0"))
    approx: bool = os.environ.get("ENOKI_TPU_APPROX", "1") == "1"
    default_dtype: str = os.environ.get("ENOKI_TPU_DTYPE", "float32")
    debug_bounds: bool = os.environ.get("ENOKI_TPU_DEBUG_BOUNDS", "0") == "1"
    max_fused_ops: int = int(os.environ.get("ENOKI_TPU_MAX_FUSED_OPS", "0"))
    trace_export_dir: str = os.environ.get("ENOKI_TPU_EXPORT_CACHE", "auto")
    cache_max_bytes: int = int(os.environ.get(
        "ENOKI_TPU_CACHE_MAX_BYTES", str(2 << 30)))
    eval_callbacks: List[Callable[[], None]] = dataclasses.field(
        default_factory=list)


config = Config()


def set_log_level(level: int) -> None:
    """Analog of cuda_set_log_level (cuda.h:195, jit.cu:1540)."""
    if not 0 <= level <= 5:
        raise ValueError("log level must be in 0..5")
    config.log_level = level


def log_level() -> int:
    return config.log_level


def log(level: int, msg: str, *args) -> None:
    if config.log_level >= level:
        print("[enoki-tpu] " + (msg % args if args else msg))


def register_callback(fn: Callable[[], None]) -> None:
    """Analog of cuda_register_callback (jit.cu:1552)."""
    config.eval_callbacks.append(fn)


def run_callbacks() -> None:
    for fn in config.eval_callbacks:
        fn()
