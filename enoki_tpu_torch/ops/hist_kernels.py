"""Dense histogram op (counterpart of enoki_tpu/ops/pallas_hist.py): the
hot path of the histogram mini-app, 16M samples accumulated conflict-safe
into a small dense target, with a weights VJP.

``histogram(index, bins, weights)`` computes ``hist[b] = sum_i (index_i ==
b) * weights_i``. Out-of-range and negative indices match no bin (they are
dropped), exactly the masked ``scatter_add`` semantics.

The kernel is CUDA C++ in ``enoki_tpu_torch/csrc/hist.cu``, built with
nvcc on first use (``enoki_tpu_torch._build``); ``hist`` is its wrapper
and ``hist_plain`` its plain PyTorch version. The wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises. ``_build.LAUNCHES`` counts the launches. The kernel's
result is bitwise the same from run to run, weighted too (no float
atomics: see the source); the plain version's ``index_add_`` on a CUDA
card is not.

AD: a counting histogram is piecewise constant in ``index``; with
``weights`` the VJP with respect to the weights is a gather of the bin
cotangent, in plain PyTorch as in the reference.

A LazyArray ``index`` or ``weights`` records the reference's lazy route
instead (``_hist_lazy``): a trace ``scatter_add`` into a zero float32
target, out-of-range lanes sent to a dropped slot, which the trace's
fused kernel runs with atomic adds on the card; its gradients flow
through the trace's tape. It does not reach the ``hist`` kernel.
"""

from __future__ import annotations

import torch

from .. import _build
from .router import _is_lazy, _lazy_device, _lift_arr, _trace, scatter_add

# csrc/hist.cu has two routes. Up to SMALL_BINS bins each of a block's
# 256 threads keeps a private row of counters in shared memory; above, each
# of its HIST_WARPS warps keeps one, and a block may use 227 KiB: the most
# bins the kernel takes
SMALL_BINS = 96
HIST_WARPS = 8
MAX_BINS = 7168


def hist_plain(index, bins: int, weights=None):
    """Plain version of the hist kernel -> (bins,) float32: the masked
    ``scatter_add`` of the weights (or of ones) at the int32 ``index``."""
    oob = (index < 0) | (index >= bins)
    target = torch.zeros(bins, dtype=torch.float32, device=index.device)
    return scatter_add(target, 1.0 if weights is None else weights, index,
                       mask=~oob)


def hist(index, bins: int, weights=None):
    """``hist[b] = sum_i (index_i == b) * weights_i`` -> (bins,) float32
    for a flat int32 ``index`` and float32 ``weights`` of the same length
    (``None``: a counting histogram, which reads no weight array): the
    hist kernels (per-block partial rows, then one fixed-order reduce) for
    CUDA tensors, the plain version for CPU ones.

    On a CUDA card ``bins`` may be at most ``MAX_BINS`` (7168: the
    block's 8 private rows must fit its shared memory); more raises
    ``ValueError``. An empty ``index`` gives zeros without a launch. The
    tensors may be views that start anywhere (``index[1:]``)."""
    if bins < 1:
        raise ValueError(f"bins must be at least 1, got {bins}")
    if not _build.is_cuda(index):
        return hist_plain(index, bins, weights)
    dev = index.device
    n = index.numel()
    _build.check(index, "index", (n,), dev, torch.int32)
    if weights is not None:
        _build.check(weights, "weights", (n,), dev)
    if bins > MAX_BINS:
        raise ValueError(f"the hist kernel takes at most {MAX_BINS} bins "
                         f"(its shared memory), got {bins}")
    if n == 0:
        # a zero-size grid is a launch error
        return torch.zeros(bins, dtype=torch.float32, device=dev)
    lib = _build.load("hist")
    rows = lib.hist_num_blocks(n, bins)
    partial = torch.empty((rows, bins), dtype=torch.float32, device=dev)
    out = torch.empty(bins, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.launch(
            "hist", lib.hist_partial_launch, index.data_ptr(),
            None if weights is None else weights.data_ptr(), n, bins,
            partial.data_ptr(), stream)
        _build.launch("hist_reduce", lib.hist_reduce_launch,
                      partial.data_ptr(), rows, bins, out.data_ptr(), stream)
    return out


class _HistogramFn(_build.KernelFunction):
    """Forward: the kernel route or the plain one. Backward: d / d
    weights_i = g[index_i] on in-range lanes, 0 on dropped ones; nothing
    for ``index`` (plain PyTorch, no kernel). ``vmap``: one forward an
    item of the batch."""

    @staticmethod
    def forward(index, weights, bins, impl):
        fn = hist_plain if impl == "fused" else hist
        return fn(index, bins, weights)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])
        ctx.bins = inputs[2]

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        if not ctx.needs_input_grad[1]:
            return None, None, None, None
        inr = (index >= 0) & (index < ctx.bins)
        gi = torch.where(inr, g[torch.where(inr, index, 0).long()], 0.0)
        return None, gi, None, None

    vmap = _build.loop_vmap("_HistogramFn",
                            lambda *a: _HistogramFn.apply(*a))


def _hist_lazy(index, bins, weights):
    """The lazy histogram: ``scatter_add`` of the weights (or 1) into a
    zero float32 LazyArray of ``bins`` on the operands' device, the lanes
    out of range redirected to the dropped slot ``bins``."""
    tr = _trace()
    dev = _lazy_device(index, weights)
    index = _lift_arr(index, dev)
    if index.dtype.is_floating_point:
        index = index.cast(torch.int32)  # the eager route's cast
    target = tr.LazyArray.zeros(bins, torch.float32, device=dev)
    w = target._coerce(1.0) if weights is None else _lift_arr(weights, dev)
    ok = (index >= 0) & (index < bins)
    target.scatter_add(tr.select(ok, index, bins), tr.select(ok, w, 0.0))
    return target


def histogram(index, bins: int, weights=None, impl: str = "kernel"):
    """``hist[b] = sum_i (index_i == b) * weights_i`` -> (bins,) float32.

    ``index`` is an integer tensor of any shape, taken flat (a float one
    is cast to int32, truncating); out-of-range and negative entries are
    dropped. ``weights`` defaults to ones (a counting histogram) and is
    taken in float32; the result is differentiable in it. ``impl``:
    ``"kernel"`` (default) is the hand-written CUDA kernel, reproducible
    bit for bit (on CPU tensors its plain version), and ``"pallas"``,
    the reference's name for its kernel, is another name for it;
    ``"fused"`` is the plain route through ``scatter_add`` on any device.
    Any other value raises ``ValueError``. The tensors' device decides
    where it runs. The call is the span ``enoki.ops.histogram``."""
    if impl not in ("kernel", "pallas", "fused"):
        raise ValueError(f"impl must be 'kernel', 'pallas' or 'fused', got "
                         f"{impl!r}")
    with _build.span("ops.histogram"):
        if _is_lazy(index) or _is_lazy(weights):
            return _hist_lazy(index, bins, weights)
        index = index.detach().to(torch.int32).reshape(-1).contiguous()
        if weights is None:
            return _HistogramFn.apply(index, None, bins, impl)
        flat = weights.to(torch.float32).reshape(-1).contiguous()
        return _HistogramFn.apply(index, flat, bins, impl)
