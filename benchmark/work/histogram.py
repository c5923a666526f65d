"""The work of one step of the histogram mini-app, counted once, whatever
implements it: each input byte read once and each output byte written
once, and the operations of one PCG32 step, the probit's Giles fit and
the binning, for every lane.

Bytes: a lane's 8-byte state read and its next state written (16); the
stream's increment is a function of the lane (``(initseq << 1) | 1``,
``initseq = lane + stream``) and is not counted; the counts written, 4
bytes a bin.

Operations, a lane, each add, multiply, compare, select, shift, logical
operation, floor, root and logarithm counted once:

* INT32, one PCG32 step on 32-bit halves (the H100 has no 64-bit
  integer multiply): the LCG's 64-bit multiply-add (the low halves'
  product in full, 2; the two cross products into the high half, 2; the
  increment's add with its carry, 2), the XSH-RR output (the shift by 18
  over both halves, 2; the xor, 2; the shift by 27 to 32 bits, 1; the
  rotation's count, 1; the rotate, 1) and the uniform's bits (the shift
  by 9 and the or, 2): 15;
* FP32: the uniform's subtraction and 2u - 1 (3); the Giles fit:
  (1 - x)(1 + x) and its logarithm and negation (5), w - 2.5 (1), the
  root of max(w, 0) less 3 (3), two polynomials of degree 8 by Horner
  (8 multiplies and 8 adds each, 32), the branch's compare and select
  (2) and the product with x (1); the product with sqrt(2) (1); the bin
  (g - lo) * scale, its floor, its clamp to [-1, bins] and its cast
  to int32 (6): 54.

H100 issues INT32 operations at half its FP32 rate (64 against 128 a
clock and SM), so each counts twice in the figure passed to
``peaks.least_seconds``, which holds it against the FP32 peak. At 2^24
lanes the bytes bound the step: 268 MB over 3.35 TB/s, 0.080 ms.
"""

STATE_BYTES = 16      # the state read, and its next value written
COUNT_BYTES = 4       # a float32 count a bin
INT32_OPS = 15        # one PCG32 step and the uniform's bits
FP32_OPS = 54         # 2u - 1, the Giles fit, sqrt(2), the bin
INT32_WEIGHT = 2      # INT32 issues at half the FP32 rate


def draws(lanes: int, bins: int):
    """(bytes, FP32-rate operations) of one step of ``lanes`` draws
    binned into ``bins``."""
    nbytes = STATE_BYTES * lanes + COUNT_BYTES * bins
    ops = (FP32_OPS + INT32_WEIGHT * INT32_OPS) * lanes
    return nbytes, ops
