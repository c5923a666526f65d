"""Masked-value idioms (counterpart of enoki_tpu/struct/masked.py).

The reference lets users write ``masked(x, m) += v`` / ``x[m] = v`` through
a proxy. Here, as in the JAX reference, the proxy is a small object whose
methods return the updated tensor: inactive lanes keep their values.

    x = masked(x, m).assign(v)      # x[m] = v
    x = masked(x, m).add(v)         # masked(x, m) += v
    x = masked(x, m).mul(v)

Eager tensors only: the lazy (``LazyArray``) branch waits for the port of
trace/ and raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from ..ops.backend import require_eager
from ..ops.router import _maximum, _minimum, _operands, select


class Masked:
    """Routes through ``ops.router.select`` and ``jnp.minimum`` /
    ``jnp.maximum``'s rules (NaN wins, -0.0 below +0.0)."""

    __slots__ = ("value", "mask")

    def __init__(self, value, mask):
        require_eager(value, mask)
        self.value = value
        self.mask = mask

    def _sel(self, taken):
        return select(self.mask, taken, self.value)

    def assign(self, v):
        return self._sel(v)

    def _operand(self, v):
        """A Python number as a 0-d tensor of the dtype it takes beside the
        value (a weak type: the value's own dtype, float32 for a float
        beside an integer value), on the value's device. PyTorch computes
        ``x / number`` on the card as a product with the number's
        reciprocal, and a 16-bit ``x * number`` or ``x / number`` with the
        number in float32 on every device; an operand of the value's dtype
        gives the IEEE result of that dtype, as the reference does."""
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and isinstance(self.value, torch.Tensor):
            return torch.full((), v, dtype=torch.result_type(self.value, v),
                              device=self.value.device)
        return v

    def add(self, v):
        return self._sel(self.value + self._operand(v))

    def sub(self, v):
        return self._sel(self.value - self._operand(v))

    def mul(self, v):
        return self._sel(self.value * self._operand(v))

    def div(self, v):
        return self._sel(self.value / self._operand(v))

    def min(self, v):
        return self._sel(_minimum(*_operands(self.value, v)))

    def max(self, v):
        return self._sel(_maximum(*_operands(self.value, v)))


def masked(value, mask) -> Masked:
    return Masked(value, mask)
