"""Complex numbers as a registered pytree of two real tensors (counterpart
of enoki_tpu/types/complex.py).

Parity with reference include/enoki/complex.h: ``Complex<T>`` is a
2-array with the full complex algebra, exp / log / sqrt / trig included
(complex.h:27, 136-230). As in the reference the parts are separate real
tensors, not ``torch.complex64``: every op is elementwise real code, works
in float32, float64 and the 16-bit floats, and differentiates.

Every function routes its math through ``ops.backend.math_ns`` and takes
``impl`` where the reference does. A Python operand takes the dtype and
device of the complex number beside it, as a weakly typed scalar does in
the reference. ``from_jnp_complex`` / ``to_jnp_complex`` are
``from_torch_complex`` / ``to_torch_complex`` here, over
``torch.complex64``. The reference's lazy branches (parts that are
LazyArrays) wait for the port of trace/ and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..ops import backend as B
from ..ops.math import _f, _scalar
from ..struct.pytree import register


@dataclasses.dataclass(frozen=True)
class Complex:
    re: torch.Tensor
    im: torch.Tensor

    # -- construction -------------------------------------------------------

    @staticmethod
    def of(re, im=0.0) -> "Complex":
        B.require_eager(re, im)
        re = _f(re)
        if isinstance(im, torch.Tensor):
            im = im.to(re.dtype)
            if im.ndim == 0:
                im = torch.broadcast_to(im, re.shape)
        else:
            im = torch.full_like(re, im)
        return Complex(re, im)

    # -- arithmetic ----------------------------------------------------------

    def __add__(self, o):
        o = _c(o, self)
        return Complex(self.re + o.re, self.im + o.im)

    __radd__ = __add__

    def __sub__(self, o):
        o = _c(o, self)
        return Complex(self.re - o.re, self.im - o.im)

    def __rsub__(self, o):
        return _c(o, self) - self

    def __mul__(self, o):
        if not isinstance(o, Complex):
            o = _real(o, self)
            return Complex(self.re * o, self.im * o)
        return Complex(self.re * o.re - self.im * o.im,
                       self.re * o.im + self.im * o.re)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if not isinstance(o, Complex):
            o = _real(o, self)
            return Complex(self.re / o, self.im / o)
        return self * rcp(o)

    def __rtruediv__(self, o):
        return _c(o, self) * rcp(self)

    def __neg__(self):
        return Complex(-self.re, -self.im)

    def __eq__(self, o):
        o = _c(o, self)
        return (self.re == o.re) & (self.im == o.im)

    def __ne__(self, o):
        o = _c(o, self)
        return (self.re != o.re) | (self.im != o.im)


register(Complex)


def _real(x, like: Complex):
    """A real operand: a tensor as it is, a Python number as a 0-d tensor
    of ``like``'s dtype and device (a weak type). A division by it is then
    one IEEE division on every device (PyTorch's CUDA kernels multiply by
    the reciprocal of a Python divisor)."""
    B.require_eager(x)
    return x if isinstance(x, torch.Tensor) else _scalar(like.re, x)


def _c(x, like: Complex) -> Complex:
    if isinstance(x, Complex):
        return x
    x = _real(x, like)
    return Complex(x, torch.zeros_like(x))


def real(z: Complex):
    return z.re


def imag(z: Complex):
    return z.im


def conj(z: Complex) -> Complex:
    return Complex(z.re, -z.im)


def squared_norm(z: Complex):
    return z.re * z.re + z.im * z.im


def abs_(z: Complex):
    return B.math_ns(z.re).hypot(z.re, z.im)


def arg(z: Complex):
    return B.math_ns(z.re).atan2(z.im, z.re)


def rcp(z: Complex) -> Complex:
    """1/z = conj(z)/|z|^2 (complex.h rcp)."""
    inv = 1.0 / squared_norm(z)
    return Complex(z.re * inv, -z.im * inv)


def sqrt(z: Complex) -> Complex:
    """Principal square root (complex.h sqrt).

    Uses safe_sqrt (zero slope at 0): on the real axis one of the two
    branches is sqrt(exactly 0), whose own derivative is inf -- the zero
    cotangent flowing into it would turn the other branch's finite
    gradient into NaN through 0 * inf."""
    from ..ops.router import safe_sqrt as _ss

    r = abs_(z)
    g = B.math_ns(z.re)
    re = _ss(0.5 * (r + z.re))
    im_mag = _ss(0.5 * (r - z.re))
    im = g.select(z.im < 0, -im_mag, im_mag)
    return Complex(re, im)


def exp(z: Complex, impl="native") -> Complex:
    g = B.math_ns(z.re, impl)
    e = g.exp(z.re)
    s, c = g.sincos(z.im)
    return Complex(e * c, e * s)


def log(z: Complex, impl="native") -> Complex:
    g = B.math_ns(z.re, impl)
    return Complex(0.5 * g.log(squared_norm(z)), arg(z))


def pow(z: Complex, w, impl="native") -> Complex:
    w = _c(w, z)
    return exp(w * log(z, impl), impl)


def sin(z: Complex, impl="native") -> Complex:
    g = B.math_ns(z.re, impl)
    s, c = g.sincos(z.re)
    sh, ch = g.sincosh(z.im)
    return Complex(s * ch, c * sh)


def cos(z: Complex, impl="native") -> Complex:
    g = B.math_ns(z.re, impl)
    s, c = g.sincos(z.re)
    sh, ch = g.sincosh(z.im)
    return Complex(c * ch, -s * sh)


def sincos(z: Complex, impl="native"):
    g = B.math_ns(z.re, impl)
    s, c = g.sincos(z.re)
    sh, ch = g.sincosh(z.im)
    return Complex(s * ch, c * sh), Complex(c * ch, -s * sh)


def tan(z: Complex, impl="native") -> Complex:
    s, c = sincos(z, impl)
    return s / c


def sinh(z: Complex, impl="native") -> Complex:
    g = B.math_ns(z.re, impl)
    sh, ch = g.sincosh(z.re)
    s, c = g.sincos(z.im)
    return Complex(sh * c, ch * s)


def cosh(z: Complex, impl="native") -> Complex:
    g = B.math_ns(z.re, impl)
    sh, ch = g.sincosh(z.re)
    s, c = g.sincos(z.im)
    return Complex(ch * c, sh * s)


def tanh(z: Complex, impl="native") -> Complex:
    return sinh(z, impl) / cosh(z, impl)


def asin(z: Complex, impl="native") -> Complex:
    """asin z = -i log(i z + sqrt(1 - z^2)) (complex.h)."""
    i_z = Complex(-z.im, z.re)
    s = sqrt(_c(1.0, z) - z * z)
    l = log(i_z + s, impl)  # noqa: E741
    return Complex(l.im, -l.re)


def acos(z: Complex, impl="native") -> Complex:
    a = asin(z, impl)
    return Complex(_scalar(a.re, math.pi / 2) - a.re, -a.im)


def atan(z: Complex, impl="native") -> Complex:
    """atan z = i/2 (log(1 - iz) - log(1 + iz))."""
    i_z = Complex(-z.im, z.re)
    one = _c(1.0, z)
    l = log((one - i_z) / (one + i_z), impl)  # noqa: E741
    return Complex(-0.5 * l.im, 0.5 * l.re)


def from_torch_complex(x) -> Complex:
    """A ``torch.complex64`` / ``complex128`` tensor as a ``Complex`` of
    its real and imaginary parts (the reference's ``from_jnp_complex``)."""
    return Complex(x.real, x.imag)


def to_torch_complex(z: Complex):
    """``z`` as a ``torch.complex64`` tensor, each part taken in float32
    (the reference's ``to_jnp_complex``)."""
    return torch.complex(z.re.to(torch.float32), z.im.to(torch.float32))
