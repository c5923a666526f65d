"""Build the port's CUDA sources with nvcc, load them with ctypes, and
keep the bookkeeping every kernel wrapper shares.

Each ``csrc/*.cu`` file, and each source generated for a scene of
``render.generic`` (the scene's functions between two ``#include``s of
the skeleton in ``csrc/``), has a plain C interface (no PyTorch headers, so
nvcc takes seconds, not minutes). On first use it is compiled for Hopper
into a shared library under ``enoki_tpu_torch/_build/``, named by a hash
of the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
Nothing is built when a module is imported: the CPU, which has no nvcc,
never reaches ``build``.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -I csrc -o _build/<name>-<hash>.so \
         csrc/<name>.cu

``--use_fast_math`` is deliberately absent: it would swap sqrt, division
and denormal handling for approximations and break parity with the
reference. ``-Xptxas -v`` makes ptxas report each kernel's registers and
spills; the report is kept beside the library, ``_build/<name>-<hash>.log``
(``build_log``).

Spans and counters: ``span`` opens a ``torch.profiler`` annotation
``enoki.<name>`` while the profiler records, and costs one check of the
profiler's state otherwise; ``launch`` makes every kernel launch of the
port, in its span ``enoki.launch.<kernel>``, and counts it in
``LAUNCHES`` (and its route in ``ROUTES``); ``timed`` counts each build
phase and its seconds in ``BUILDS`` / ``BUILD_SECONDS``.
docs/torch/render.md lists them.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME, else the toolkit's default
    install prefix."""
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def _unique() -> str:
    """A suffix no other process or thread uses for its temporary files."""
    return f"{os.getpid()}.{threading.get_ident()}"


def _compile(src: Path, digest: str, name: str) -> Path:
    """Compile ``src`` into ``_build/<name>-<digest>.so`` unless it is
    there; returns the library's path. Raises with nvcc's stderr and the
    source's path if the build fails."""
    out = BUILD_DIR / f"{name}-{digest[:16]}.so"
    if out.exists():
        return out
    # build beside the target and rename, so that a concurrent process or
    # thread never loads a half-written library
    tmp = out.with_name(f"{out.stem}.{_unique()}.tmp.so")
    with timed("compile"):
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR),
                               "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    _write_source(out.with_suffix(".log"), proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log(lib: Path) -> str:
    """What nvcc printed when it built the library ``lib`` (ptxas's report
    of each kernel's registers and spills); "" if that was not kept."""
    log = lib.with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _digest(source: bytes) -> str:
    """Hash of a source, the shared headers ``csrc/*.cuh`` and the flags."""
    with timed("digest"):
        h = hashlib.sha256(source)
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()


def set_build_dir(path) -> Path:
    """Build into and load from ``path`` from now on (``cache`` sets it
    from ``ENOKI_TPU_COMPILE_CACHE``, ``runtime.enable_compile_cache``
    from the caller)."""
    global BUILD_DIR
    BUILD_DIR = Path(path).expanduser().resolve()
    return BUILD_DIR


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source
    and these flags exists; returns the library's path."""
    src = CSRC_DIR / f"{name}.cu"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return _compile(src, _digest(src.read_bytes()), name)


def _write_source(src: Path, text: str):
    """Write generated source (or a build's log) to ``src`` unless it is
    there, whole or not at all."""
    if not src.exists():
        tmp = src.with_name(f"{src.stem}.{_unique()}.tmp{src.suffix}")
        tmp.write_text(text)
        os.replace(tmp, src)


def build_generated(name: str, text: str) -> Path:
    """Compile generated source ``text`` (which includes its skeleton from
    ``csrc/``) unless a library for this exact text, these headers and
    these flags exists. The text is kept beside the library, as
    ``_build/<name>-<hash>.cu``."""
    digest = _digest(text.encode())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{name}-{digest[:16]}.cu"
    _write_source(src, text)
    return _compile(src, digest, name)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float
_U = ctypes.c_uint64

# argument types of every C entry point, by library; pointers and the
# stream are c_void_p (a bare Python int would be cut to 32 bits)
SIGNATURES = {
    "sdf_render": {
        "sdf_fwd_launch": (_P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _I, _P),
        "sdf_fwd_relax_launch": (_P, _P, _P, _P, _I, _I, _F, _F, _I, _F, _F,
                                 _I, _P),
        "sdf_fwd_split_launch": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F,
                                 _P),
        "sdf_tail_launch": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _P),
        "sdf_bwd_num_blocks": (_I,),
        "sdf_bwd_launch": (_P, _P, _P, _P, _P, _P, _I, _F, _F, _I, _P),
    },
    "sdf_bwd_ad": {
        "sdf_bwd_ad_num_blocks": (_I,),
        "sdf_bwd_ad_launch": (_P, _P, _P, _P, _P, _P, _I, _F, _F, _I, _P),
    },
    # one library per scene of render.generic.make_sdf_renderer
    "generic_render": {
        "generic_n_params": (),
        "generic_fwd_launch": (_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F,
                               _I, _I, _P),
        "generic_bwd_num_blocks": (_I,),
        "generic_bwd_partial_launch": (_P, _P, _P, _P, _I, _F, _F, _P),
        "generic_bwd_reduce_launch": (_P, _I, _P, _P),
    },
    "sphere_render": {
        "sphere_fwd_launch": (_P, _P, _I, _F, _F, _I, _P),
        "sphere_fwd_bf16_launch": (_P, _P, _I, _F, _F, _I, _P),
        "sphere_bwd_num_blocks": (_I,),
        "sphere_bwd_launch": (_P, _P, _P, _P, _P, _I, _F, _F, _I, _P),
    },
    "hist": {
        "hist_num_blocks": (_L, _I),
        "hist_max_bins": (),
        "hist_small_bins": (),
        "hist_partial_launch": (_P, _P, _L, _I, _P, _P),
        "hist_reduce_launch": (_P, _I, _I, _P, _P),
    },
    "stochastic_round": {
        "stochastic_round_launch": (_P, _P, _L, _U, _I, _P),
    },
    "pcg32": {
        "pcg32_next_launch": (_P, _P, _P, _L, _P, _I, _P, _P),
    },
}


def _bind(path: Path, name: str) -> ctypes.CDLL:
    """Load a built library; every entry point returns an int (a
    cudaError_t for the launches)."""
    with timed("bind"):
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return _bind(build(name), name)


@functools.cache
def load_generated(name: str, text: str) -> ctypes.CDLL:
    """Build (if needed) and load the generated source ``text``, with the
    entry points of ``SIGNATURES[name]``."""
    return _bind(build_generated(name, text), name)


# ---------------------------------------------------------------------------
# What every kernel wrapper shares
# ---------------------------------------------------------------------------

# the port's spans that closed while the profiler recorded, the newest
# SPANS.maxlen of them: (name, start, end, thread), start and end in ns of
# the Unix time that the profiler's events carry (its clock), so that a
# reader sets them beside the device operations of the same trace
SPANS: collections.deque = collections.deque(maxlen=1 << 16)
_OFF = contextlib.nullcontext()


class _Span:
    """``torch.profiler.record_function(name)``, kept in ``SPANS`` as it
    closes. The kept interval lies inside the annotation's, so that it
    leaves out the annotation's own cost."""

    __slots__ = ("name", "record", "start")

    def __init__(self, name: str):
        self.name = name
        self.record = torch.profiler.record_function(name)

    def __enter__(self):
        self.record.__enter__()
        self.start = time.time_ns()

    def __exit__(self, *exc):
        end = time.time_ns()
        self.record.__exit__(*exc)
        SPANS.append((self.name, self.start, end, threading.get_ident()))


def span(name: str):
    """The span ``enoki.<name>`` while ``torch.profiler`` records (whoever
    turned it on: ``runtime.profiler_trace``, a user's own ``profile``, a
    traced benchmark run); otherwise one shared null context, so that a
    span off the profiler costs one check of its state."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span("enoki." + name)


# kernel launches since the last reset_launch_counts(), by kernel name;
# ``launch`` adds one after each launch that returned no error, and
# nothing else does
LAUNCHES: collections.Counter = collections.Counter()
# the same launches of a kernel that has more than one route, by
# "<kernel>.<route>" (sdf_fwd's "sdf_fwd.dense" and "sdf_fwd.pixel", ...)
ROUTES: collections.Counter = collections.Counter()


def reset_launch_counts():
    LAUNCHES.clear()
    ROUTES.clear()


def launch(kernel: str, entry, *args, route: str | None = None):
    """Launch ``kernel`` through its C entry point ``entry`` (a bound
    ctypes function that returns a cudaError_t) with ``args``, in the span
    ``enoki.launch.<kernel>`` (the arguments' conversion and the
    launch); raise if the launch returned an error, else count it, and
    its ``route`` where the kernel has routes."""
    with span("launch." + kernel):
        err = entry(*args)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
    if route is not None:
        ROUTES[f"{kernel}.{route}"] += 1


# the build's phases since the process started, by phase: calls and host
# seconds. "trace" (a scene's trace), "compile" (nvcc: a real build
# only), "bind" (dlopen and the signatures), "digest" (the hash of a
# source and the headers)
BUILDS: collections.Counter = collections.Counter()
BUILD_SECONDS: collections.Counter = collections.Counter()
_BUILDS_LOCK = threading.Lock()   # builds run in thread pools too


class timed:
    """``with timed(phase) as t``: the block in the span
    ``enoki.build.<phase>``, counted in ``BUILDS[phase]`` and its host
    seconds added to ``BUILD_SECONDS[phase]`` and kept in ``t.seconds``,
    whether the profiler records or not."""

    def __init__(self, phase: str):
        self.phase, self.seconds = phase, None

    def __enter__(self):
        self._span = span("build." + self.phase)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        with _BUILDS_LOCK:
            BUILDS[self.phase] += 1
            BUILD_SECONDS[self.phase] += self.seconds
        self._span.__exit__(*exc)


# calls of the looping vmap rules (``loop_vmap``), by Function name: one a
# batched call, whatever the batch size
VMAP_LOOPS: collections.Counter = collections.Counter()


def loop_vmap(name: str, apply):
    """The ``vmap`` staticmethod of an ``autograd.Function`` that launches
    a kernel through ``data_ptr()``, which a batched tensor does not have:
    ``apply`` (the Function's own ``apply``, so that an outer transform
    still sees it) once an item of the batch, each item's tensors made
    contiguous, and the outputs stacked on a new dimension 0. One launch
    an item; a batch dimension in the kernel's grid would take its place."""

    def rule(info, in_dims, *args):
        VMAP_LOOPS[name] += 1

        def item(b):
            return [a if d is None else a.select(d, b).contiguous()
                    for a, d in zip(args, in_dims)]

        outs = [apply(*item(b)) for b in range(info.batch_size)]
        if isinstance(outs[0], tuple):
            return (tuple(torch.stack(o) for o in zip(*outs)),
                    (0,) * len(outs[0]))
        return torch.stack(outs), 0

    return staticmethod(rule)


class KernelFunction(torch.autograd.Function):
    """Base of the ``autograd.Function``s that launch a kernel. They are
    in the ``setup_context`` style, which ``torch.func`` needs, and
    ``Function.apply`` binds a call's arguments to the signature of
    ``forward`` for that style, a host cost on every step of the main
    path. Where no ``torch.func`` transform is active this ``apply`` goes
    straight to autograd's own, which runs ``forward`` and
    ``setup_context`` as well: the wrappers pass every argument
    positionally, so there are no defaults to bind."""

    @classmethod
    def apply(cls, *args):
        if torch._C._are_functorch_transforms_active():
            return super().apply(*args)
        return super(torch.autograd.Function, cls).apply(*args)


def kernel_call(name: str, fn):
    """``fn``, a kernel's wrapper, as a Function's backward calls it:
    directly where no ``torch.func`` transform is active (the main path
    pays nothing), else through an ``autograd.Function`` named ``name``
    with a looping ``vmap`` rule, since ``vmap(grad(...))`` hands the
    backward batched tensors, which have no ``data_ptr()``. Not
    differentiable."""

    def forward(*args):
        return fn(*args)

    def backward(ctx, *grads):
        raise NotImplementedError(f"{name} is not differentiable")

    fn_class = type(name, (torch.autograd.Function,), {
        "forward": staticmethod(forward),
        "setup_context": staticmethod(lambda ctx, inputs, output: None),
        "backward": staticmethod(backward),
        "vmap": loop_vmap(name, lambda *a: fn_class.apply(*a))})

    def call(*args):
        if torch._C._are_functorch_transforms_active():
            return fn_class.apply(*args)
        return fn(*args)

    return call


# the counters of the kernels whose last block sums the others' rows
# (csrc/pixel_sum.cuh), one per (device, stream): zeroed once here, set
# back to 0 by every launch that used them
_TICKETS: dict = {}


def ticket(device, stream: int) -> torch.Tensor:
    """The int32 counter of ``stream`` (a cudaStream_t) on ``device``, 0
    between launches."""
    key = (device.index, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


def is_cuda(x) -> bool:
    """Whether a wrapper launches its kernel (a CUDA tensor) or takes its
    plain version (a CPU tensor); any other device raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}: cuda, or cpu for the "
                     "plain version")


def check(x, name, shape, device, dtype=torch.float32):
    """Raise unless ``x`` is what a kernel reads: a contiguous tensor of
    ``dtype`` (float32 unless given) and ``shape`` on ``device``."""
    if (x.dtype != dtype or tuple(x.shape) != shape
            or not x.is_contiguous() or x.device != device):
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                         f"shape {shape} on {device}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
