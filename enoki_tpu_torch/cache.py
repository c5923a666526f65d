"""Zero-config persistent caches (counterpart of enoki_tpu/cache.py).

The port compiles its CUDA sources with nvcc on first use into one
directory, ``_build.BUILD_DIR`` (``enoki_tpu_torch/_build/`` by default),
keyed by a hash of the source, the shared headers and the flags: an
unchanged source is loaded as it is. This module chooses that directory
and bounds it, and resolves the trace export directory of the lazy
runtime (trace/, which waits for its port) under a version-keyed user
cache directory:

    ~/.cache/enoki_tpu_torch/export/<version-tag>/   trace export artifacts

The version tag is ``v<version>-torch<torch>-<cuda|cpu>-<trace format>``,
so a new release of either package, or a move between the card and the
CPU, never replays a stale artifact.

Opt-outs and overrides:

* ``ENOKI_TPU_EXPORT_CACHE``  = path | ``auto`` (default) | ``off``
* ``ENOKI_TPU_COMPILE_CACHE`` = path | ``auto`` (default) | ``off``:
  ``off`` leaves ``_build`` as it is, a path becomes its directory, and
  ``auto`` keeps ``enoki_tpu_torch/_build/``
* ``ENOKI_TPU_CACHE_MAX_BYTES`` bounds each cache directory (LRU by
  mtime; default 2 GiB): the build directory once a process, at import.
"""

from __future__ import annotations

import os

_DISABLE = ("0", "off", "none", "false", "disabled")


def cache_root() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "enoki_tpu_torch")


# revision of the lazy trace's on-disk artifacts (the reference's scheme,
# whose h3 is the clamping GATHER lowering); bumped with any change to the
# structural hash or to an opcode's lowering
_TRACE_FORMAT = "h3"


def version_tag() -> str:
    """Cache-invalidation key: the port's and torch's versions, the
    platform and the trace format; no token holds a dash."""
    import torch

    from . import __version__

    plat = "cuda" if torch.cuda.is_available() else "cpu"
    torch_version = torch.__version__.replace("-", "_")
    return f"v{__version__}-torch{torch_version}-{plat}-{_TRACE_FORMAT}"


def export_dir() -> str:
    """``config.trace_export_dir`` as a directory: ``auto`` (the default)
    is the version-keyed user cache directory, a disable word is "" (off),
    anything else is used as it is."""
    from .config import config

    d = config.trace_export_dir
    if not d or d.lower() in _DISABLE:
        return ""
    if d != "auto":
        return d
    resolved = os.path.join(cache_root(), "export", version_tag())
    _prune_stale_exports(os.path.dirname(resolved), resolved)
    return resolved


_PRUNED = False


def _prune_stale_exports(parent: str, keep: str) -> None:
    """Remove the export directories of stale version tags of the same
    platform, once a process. Other platforms' directories are live caches
    of the card/CPU workflow and stay."""
    global _PRUNED
    if _PRUNED:
        return
    _PRUNED = True
    import shutil

    # tag: v<ver>-torch<ver>-<platform>-<fmt>; no token holds a dash
    plat = os.path.basename(keep).split("-")[-2:-1]
    try:
        for name in os.listdir(parent):
            p = os.path.join(parent, name)
            if (p != keep and os.path.isdir(p)
                    and name.split("-")[-2:-1] == plat):
                shutil.rmtree(p, ignore_errors=True)
    except OSError:
        pass


def max_bytes() -> int:
    from .config import config

    return config.cache_max_bytes


def evict_lru(d: str, bound: int | None = None) -> None:
    """Bound a cache directory: delete the oldest files (by mtime) until
    the total size fits. Best-effort: a race with another process is a
    cold entry, and a missing directory is silent."""
    if bound is None:
        bound = max_bytes()
    if bound <= 0:
        return
    try:
        entries = []
        for name in os.listdir(d):
            p = os.path.join(d, name)
            try:
                st = os.stat(p)
            except OSError:
                continue
            if os.path.isfile(p):
                entries.append((st.st_mtime, st.st_size, p))
        total = sum(s for _, s, _ in entries)
        if total <= bound:
            return
        entries.sort()
        for _, s, p in entries:
            if total <= bound:
                break
            try:
                os.remove(p)
                total -= s
            except OSError:
                pass
    except OSError:
        pass


_COMPILE_CACHE_SET = False


def enable_default_compile_cache() -> None:
    """Choose ``_build``'s directory from ``ENOKI_TPU_COMPILE_CACHE`` and
    bound it with ``evict_lru``, once a process. Called at package import;
    builds nothing (``_build`` compiles on a kernel's first launch)."""
    global _COMPILE_CACHE_SET
    env = os.environ.get("ENOKI_TPU_COMPILE_CACHE", "auto")
    if env.lower() in _DISABLE or _COMPILE_CACHE_SET:
        return
    _COMPILE_CACHE_SET = True
    from . import _build

    if env and env.lower() != "auto":
        _build.set_build_dir(env)
    evict_lru(str(_build.BUILD_DIR))
