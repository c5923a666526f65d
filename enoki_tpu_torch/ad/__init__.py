"""Differentiation helpers (counterpart of enoki_tpu/ad): the reference's
AD-tape surface (autodiff.h, autodiff.cpp) on PyTorch's autograd.

  gradient / backward      reverse mode on the tape: torch.autograd.grad
                           over the flattened arguments, the grads in the
                           arguments' structure
  forward(f, args, tans)   forward mode: torch.func.jvp
  detach, suspend_grad     Tensor.detach leafwise
  CustomVJP, CustomJVP     decorators with jax.custom_vjp / custom_jvp's
                           usage, on a setup_context autograd.Function
  safe_mul / safe_fmadd    a zero weight kills inf/NaN partials
                           (autodiff.cpp:1191-1221)
  whos, graphviz           the graph of make_fx(f)(*args) (the
                           counterpart of make_jaxpr: fake tensors, no
                           compute), one node an aten op
  checkpoint               torch.utils.checkpoint, non-reentrant

``gradient`` and ``backward`` run on the tape and not through
``torch.func.grad``: the tape is what reaches the ``autograd.Function`` of
each kernel of the port, so ``backward`` of a render's loss runs the
render's CUDA backward. The kernels' Functions have no ``jvp`` or ``vmap``
rule (their reference counterparts are ``custom_vjp``s, which ``jax.jvp``
refuses too), so ``forward`` does not reach them, and ``whos`` /
``graphviz`` raise on a function that launches one (a ctypes launch needs
a real data pointer), naming it. The lazy (``LazyArray``) branch waits for
the port of trace/.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch
import torch.utils._pytree as pytree

from ..ops.router import _operands

# modules whose functions launch the port's kernels
_KERNEL_MODULES = ("enoki_tpu_torch.render.sdf_kernels",
                   "enoki_tpu_torch.render.sphere_kernels",
                   "enoki_tpu_torch.render.generic",
                   "enoki_tpu_torch.ops.hist_kernels",
                   "enoki_tpu_torch.ops.rounding")


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def detach(tree):
    """``Tensor.detach`` of every tensor of a pytree (``stop_gradient``)."""
    return pytree.tree_map(lambda l: l.detach() if _is_tensor(l) else l,
                           tree)


def suspend_grad(tree):
    """Detach a whole pytree (drjit-style suspend_grad)."""
    return detach(tree)


# ---------------------------------------------------------------------------
# Reverse and forward mode
# ---------------------------------------------------------------------------


def _value_and_grads(f, args, argnums):
    """f(*args) and its gradient in each argument of ``argnums``, on the
    tape. A float tensor leaf that already requires grad stays in the
    caller's graph and the gradient's graph is built (so that a gradient
    of a gradient works); any other float leaf is a fresh leaf."""
    args = list(args)
    specs, inputs, create_graph = [], [], False
    for i in argnums:
        leaves, spec = pytree.tree_flatten(args[i])
        slots = []
        for j, l in enumerate(leaves):
            if _is_tensor(l) and l.dtype.is_floating_point:
                if l.requires_grad:
                    create_graph = True
                else:
                    l = leaves[j] = l.detach().requires_grad_(True)
                slots.append(len(inputs))
                inputs.append(l)
            else:
                slots.append(None)
        args[i] = pytree.tree_unflatten(leaves, spec)
        specs.append((spec, slots))
    with torch.enable_grad():
        out = f(*args)
    if out.requires_grad:
        grads = torch.autograd.grad(out, inputs, create_graph=create_graph,
                                    allow_unused=True, materialize_grads=True)
    else:  # f does not depend on the arguments: zeros, as jax.grad gives
        grads = [torch.zeros_like(i) for i in inputs]
    trees = tuple(pytree.tree_unflatten(
        [None if s is None else grads[s] for s in slots], spec)
        for spec, slots in specs)
    return (out if create_graph else out.detach()), trees


def gradient(f: Callable, argnums=0) -> Callable:
    """``jax.grad``: a function that returns the gradient of the scalar
    ``f`` in argument ``argnums`` (a tuple of gradients for a tuple of
    argnums), each in its argument's structure."""
    nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)

    @functools.wraps(f)
    def grad_f(*args):
        _, grads = _value_and_grads(f, args, nums)
        return grads[0] if isinstance(argnums, int) else grads

    return grad_f


def backward(f: Callable, *args):
    """Reverse mode: (value, grads in every argument), the analog of
    ``backward(loss); gradient(x_i)`` (autodiff.h:1490)."""
    return _value_and_grads(f, args, tuple(range(len(args))))


def forward(f: Callable, args: Sequence, tangents: Sequence):
    """Forward mode: (value, directional derivative), ``torch.func.jvp``
    (``forward(x)``, autodiff.cpp:912)."""
    return torch.func.jvp(f, tuple(args), tuple(tangents))


# ---------------------------------------------------------------------------
# Custom rules
# ---------------------------------------------------------------------------


class _Unpack:
    """The tensor arguments of a call and where they go among the rest."""

    def __init__(self, args):
        self.args = args
        self.where = [i for i, a in enumerate(args) if _is_tensor(a)]

    def put(self, tensors):
        args = list(self.args)
        for i, t in zip(self.where, tensors):
            args[i] = t
        return tuple(args)


class CustomJVP:
    """``jax.custom_jvp``: ``f = CustomJVP(fun); f.defjvp(rule)`` where
    ``rule(primals, tangents) -> (out, tangent_out)`` is linear in the
    tangents. Forward mode calls the rule; reverse mode takes its
    transpose, ``torch.func.vjp`` of ``t -> rule(primals, t)[1]`` at zero
    tangents, so the rule is the only derivative given. A missing tangent
    (a Python number, or a tensor that needs none) is zeros."""

    def __init__(self, fun: Callable):
        self.fun = fun
        self.rule = None
        self._function = None
        functools.update_wrapper(self, fun)

    def defjvp(self, rule: Callable) -> Callable:
        self.rule = rule
        fun = self.fun

        class _Fn(torch.autograd.Function):
            generate_vmap_rule = True

            @staticmethod
            def forward(*args):
                return fun(*args)

            @staticmethod
            def setup_context(ctx, inputs, output):
                ctx.unpack = _Unpack(inputs)
                tensors = [inputs[i] for i in ctx.unpack.where]
                ctx.save_for_backward(*tensors)
                ctx.save_for_forward(*tensors)

            @staticmethod
            def jvp(ctx, *tangents):
                saved = ctx.saved_tensors
                ts = [torch.zeros_like(p) if tangents[i] is None
                      else tangents[i] for p, i in zip(saved, ctx.unpack.where)]
                return rule(ctx.unpack.put(saved), ctx.unpack.put(ts))[1]

            @staticmethod
            def backward(ctx, *cts):
                saved = ctx.saved_tensors
                primals = ctx.unpack.put(saved)

                def tangent_out(*ts):
                    return rule(primals, ctx.unpack.put(ts))[1]

                _, vjp = torch.func.vjp(tangent_out,
                                        *(torch.zeros_like(p) for p in saved))
                grads = iter(vjp(cts[0] if len(cts) == 1 else cts))
                return tuple(next(grads) if i in ctx.unpack.where else None
                             for i in range(len(ctx.unpack.args)))

        self._function = _Fn
        return rule

    def __call__(self, *args):
        if self._function is None:
            return self.fun(*args)
        return self._function.apply(*args)


class _Residuals:
    """A box that carries a VJP's residuals out of the forward as a
    non-tensor output (autograd passes it through untouched)."""

    def __init__(self, value):
        self.value = value


class CustomVJP:
    """``jax.custom_vjp``: ``f = CustomVJP(fun); f.defvjp(fwd, bwd)`` with
    ``fwd(*args) -> (out, residuals)`` and ``bwd(residuals, ct) -> one
    cotangent per argument`` (None for one that needs none). Where no
    argument requires grad, ``fun`` runs alone, as JAX calls it outside
    differentiation. Reverse mode only, as in JAX."""

    def __init__(self, fun: Callable):
        self.fun = fun
        self._function = None
        functools.update_wrapper(self, fun)

    def defvjp(self, fwd: Callable, bwd: Callable):
        class _Fn(torch.autograd.Function):
            @staticmethod
            def forward(*args):
                out, res = fwd(*args)
                outs = out if isinstance(out, tuple) else (out,)
                return (*outs, _Residuals((res, isinstance(out, tuple))))

            @staticmethod
            def setup_context(ctx, inputs, output):
                ctx.res, ctx.multi = output[-1].value
                ctx.n_args = len(inputs)

            @staticmethod
            def backward(ctx, *cts):
                ct = tuple(cts[:-1]) if ctx.multi else cts[0]
                grads = tuple(bwd(ctx.res, ct))
                if len(grads) != ctx.n_args:
                    raise ValueError(f"bwd gave {len(grads)} cotangents for "
                                     f"{ctx.n_args} arguments")
                return grads

        self._function = _Fn

    def __call__(self, *args):
        needs = torch.is_grad_enabled() and any(
            l.requires_grad for l in pytree.tree_leaves(args) if _is_tensor(l))
        if self._function is None or not needs:
            return self.fun(*args)
        *outs, box = self._function.apply(*args)
        return tuple(outs) if box.value[1] else outs[0]


# ---------------------------------------------------------------------------
# safe_mul / safe_fmadd: a zero weight suppresses inf/NaN from the other
# operand (autodiff.cpp:1191-1221 uses these for all tape edge products so
# that masked-out lanes cannot poison gradients).
# ---------------------------------------------------------------------------


def _safe_mul(a, b):
    r = a * b
    zero = (a == 0) | (b == 0)
    return torch.where(zero, torch.zeros_like(r), r)


def _safe_mul_jvp(primals, tangents):
    # linear in the tangents (reverse mode transposes it): the 0-kills-inf
    # rule applies to the primal partials, d/da = b with non-finite b
    # suppressed where a == 0, and the other way round
    a, b = primals
    da, db = tangents
    y = _safe_mul(a, b)
    pa = torch.where((a == 0) & ~torch.isfinite(b), torch.zeros_like(b), b)
    pb = torch.where((b == 0) & ~torch.isfinite(a), torch.zeros_like(a), a)
    dy = da * pa + db * pb
    return y, dy.to(y.dtype)


_safe_mul_fn = CustomJVP(_safe_mul)
_safe_mul_fn.defjvp(_safe_mul_jvp)


def safe_mul(a, b):
    """a * b, 0 where either is 0 (0 * inf = 0), with the reference's
    JVP (``jax.custom_jvp``). Python numbers take the tensor's device."""
    return _safe_mul_fn(*_operands(a, b))


def safe_fmadd(a, b, c):
    """safe_mul(a, b) + c (autodiff.cpp:1210)."""
    return safe_mul(a, b) + c


# ---------------------------------------------------------------------------
# Tape introspection: the graph of make_fx
# ---------------------------------------------------------------------------


def _launching_kernel(exc) -> str | None:
    """The port's function that launched a kernel in ``exc``'s traceback,
    innermost first, if any."""
    tb, name = exc.__traceback__, None
    while tb is not None:
        frame = tb.tb_frame
        if frame.f_globals.get("__name__") in _KERNEL_MODULES:
            name = frame.f_code.co_name
        tb = tb.tb_next
    return name


def trace_graph(f: Callable, *args, decompose: bool = False):
    """``make_fx(f)(*args)`` on fake tensors (no compute): the graph
    module, in core aten ops with ``decompose``. A function that launches
    one of the port's kernels cannot be traced (a ctypes launch needs a
    real data pointer): that raises a ``RuntimeError`` that names the
    launching function."""
    from torch._decomp import core_aten_decompositions
    from torch.fx.experimental.proxy_tensor import make_fx

    table = core_aten_decompositions() if decompose else None
    try:
        return make_fx(f, decomposition_table=table,
                       tracing_mode="fake")(*args)
    except Exception as e:
        kernel = _launching_kernel(e)
        if kernel is None:
            raise
        raise RuntimeError(
            f"make_fx cannot trace {kernel}: it launches a CUDA kernel of "
            f"the port through ctypes, which needs real tensors; "
            f"runtime.vectorization_report profiles such a function") from e


def graph_ops(gm):
    """(node, aten op name, shape, dtype) of each op node of a graph."""
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        val = node.meta.get("val")
        vals = val if isinstance(val, (tuple, list)) else (val,)
        for v in vals:
            if _is_tensor(v):
                yield node, str(node.target), tuple(v.shape), v.dtype


def whos(f: Callable, *args) -> str:
    """Tape table: one line per op output with its size and dtype (the
    analog of ``tape.whos()``, autodiff.cpp:1165)."""
    lines = ["  ID        Size     Type           Op"]
    for i, (_, op, shape, dtype) in enumerate(graph_ops(trace_graph(f, *args))):
        size = 1
        for s in shape:
            size *= s
        lines.append(f"  {i:<8} {size:<8} {str(dtype):<14} {op}")
    return "\n".join(lines)


def graphviz(f: Callable, *args) -> str:
    """DOT graph of make_fx's graph (autodiff.cpp:1076-1163): variables are
    ellipses, ops are boxes."""
    gm = trace_graph(f, *args)
    out = ["digraph {", "  rankdir=BT;", '  node [fontname="Helvetica"];']
    names = {}

    def vname(node):
        if node not in names:
            names[node] = f"v{len(names)}"
        return names[node]

    def label(node):
        v = node.meta.get("val")
        if _is_tensor(v):
            return f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"
        return node.name

    for i, node in enumerate(gm.graph.nodes):
        if node.op == "placeholder":
            out.append(f'  {vname(node)} [shape=ellipse, label="in '
                       f'{label(node)}", fillcolor=wheat, style=filled];')
        elif node.op == "call_function":
            op = f"e{i}"
            out.append(f'  {op} [shape=box, label="{node.target}", '
                       "fillcolor=lightblue, style=filled];")
            for a in node.all_input_nodes:
                out.append(f"  {vname(a)} -> {op};")
            out.append(f'  {vname(node)} [shape=ellipse, '
                       f'label="{label(node)}"];')
            out.append(f"  {op} -> {vname(node)};")
        elif node.op == "output":
            for a in node.all_input_nodes:
                out.append(f"  {vname(a)} [shape=ellipse, "
                           "fillcolor=salmon, style=filled];")
    out.append("}")
    return "\n".join(out)


def checkpoint(f: Callable, **kw) -> Callable:
    """Rematerialization: ``torch.utils.checkpoint.checkpoint`` of ``f``,
    non-reentrant (``jax.checkpoint``); ``kw`` goes to it."""
    from torch.utils.checkpoint import checkpoint as ckpt

    @functools.wraps(f)
    def wrapped(*args):
        return ckpt(f, *args, use_reentrant=False, **kw)

    return wrapped
