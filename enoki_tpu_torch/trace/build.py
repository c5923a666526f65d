"""Build the port's native trace core (g++ -> shared library, ctypes ABI).

The core (``native/trace.cpp``) exposes a plain C ABI that the Python
side binds with ctypes, and ``native/pymod.cpp`` adds the CPython
fastcall module ``_etnative_torch`` (the append hot path) to the same
library. It is built on first use of ``enoki_tpu_torch.trace``, never at
package import, into the port's build directory (``_build.BUILD_DIR``,
``enoki_tpu_torch/_build/`` by default) as
``libenoki_trace_torch_<sha16 of the sources and flags>.so``, and rebuilt
only when the sources change. The name is the port's own and every
exported symbol carries the prefix ``ett_`` (the rest is hidden), so a
process that also loads the JAX package's core keeps two trace states.

    g++ -std=c++17 -O2 -fPIC -shared -fvisibility=hidden \\
        -I <python include> native/trace.cpp native/pymod.cpp -o <lib>
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
from pathlib import Path

from .. import _build

NATIVE_DIR = Path(__file__).resolve().parent / "native"
SOURCES = (NATIVE_DIR / "trace.cpp", NATIVE_DIR / "pymod.cpp")
FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared", "-fvisibility=hidden")
MODULE = "_etnative_torch"


def build_library() -> Path:
    """Compile the native core unless a library for these sources and
    flags exists; returns its path. Raises with g++'s stderr."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    d = _build.BUILD_DIR
    d.mkdir(parents=True, exist_ok=True)
    out = d / f"libenoki_trace_torch_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    # a temporary name of this process and thread, renamed when whole: a
    # concurrent build never publishes a half-written library
    tmp = out.with_name(f"{out.stem}.{_build._unique()}.tmp.so")
    cmd = ["g++", *FLAGS, f"-I{sysconfig.get_paths()['include']}",
           *map(str, SOURCES), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("native trace core build failed:\n  "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_pymod():
    """Import the fastcall extension from the built library."""
    path = str(build_library())
    loader = importlib.machinery.ExtensionFileLoader(MODULE, path)
    spec = importlib.util.spec_from_loader(MODULE, loader, origin=path)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def load_library() -> ctypes.CDLL:
    """The core's C ABI, with every entry point's argument types."""
    lib = ctypes.CDLL(str(build_library()))
    u32, u64, i32 = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int32
    P = ctypes.POINTER
    sigs = {
        "ett_append": (u32, [i32, i32, u64, u32, u32, u32, u32]),
        "ett_append_raw": (u32, [i32, i32, u64, u32, u32, u32, u32]),
        "ett_literal": (u32, [i32, u64, u64]),
        "ett_data": (u32, [i32, u64]),
        "ett_inc_ref_ext": (None, [u32]),
        "ett_dec_ref_ext": (None, [u32]),
        "ett_var_size": (u64, [u32]),
        "ett_var_dtype": (i32, [u32]),
        "ett_var_opcode": (i32, [u32]),
        "ett_var_materialized": (i32, [u32]),
        "ett_var_int_ref": (i32, [u32]),
        "ett_var_exists": (i32, [u32]),
        "ett_num_vars": (u32, []),
        "ett_set_label": (None, [u32, ctypes.c_char_p]),
        "ett_get_label": (i32, [u32, ctypes.c_char_p, i32]),
        "ett_mark_side_effect": (None, [u32, u32]),
        "ett_unmark_side_effect": (None, [u32]),
        "ett_is_dirty": (i32, [u32]),
        "ett_num_side_effects": (i32, []),
        "ett_schedule": (u32, [P(u32), u32]),
        "ett_schedule_hash": (u64, []),
        "ett_live_vars": (u32, [P(u32), u32]),
        "ett_schedule_data_ids": (u32, [P(u32), u32]),
        "ett_schedule_ids": (u32, [P(u32), u32]),
        "ett_schedule_literals": (u32, [P(u64), P(i32), u32]),
        "ett_schedule_output_ids": (u32, [P(u32), u32]),
        "ett_schedule_num_outputs": (u32, []),
        "ett_schedule_output": (u32, [u32]),
        "ett_schedule_read": (u32, [P(u32), P(i32), P(i32), P(u64), P(u32),
                                    P(u64), P(ctypes.c_uint8), u32]),
        "ett_set_materialized": (None, [u32]),
        "ett_set_data": (None, [u32]),
        "ett_clear_side_effects": (None, []),
        "ett_set_log_level": (None, [i32]),
        "ett_log_level": (i32, []),
        "ett_stats": (None, [P(u64)] * 5),
        "ett_whos": (i32, [ctypes.c_char_p, i32]),
        "ett_reset": (None, []),
    }
    for name, (restype, argtypes) in sigs.items():
        f = getattr(lib, name)
        f.restype = restype
        f.argtypes = argtypes
    return lib
