"""The work of the sphere scene's render functions, counted once: each
input byte read once, each output byte written once, and the FP32
operations that the march, the shade and the closed-form cotangent need
(each add, multiply, compare, max and rsqrt counted once), for the
march's evaluations, advances and hits at the run's own inputs.

Frozen from the counts of the kernels' arithmetic that the port's card
checks used when this benchmark was written (``csrc/sdf_render.cu``):
a later change to the program is read against this same work.
"""

N_PARAMS = 16
FLOPS_PER_EVAL = 7      # z*z, +r2, rsqrt, x*r; s >= reach, z+s, <= escape
FLOPS_PER_ADVANCE = 2   # z + (s - radius)
FLOPS_HIT_TEST = 2      # s - radius < eps, on the march's last distance
FLOPS_PER_PIXEL = 16    # pixel coordinates, r2, folded constants, ts
FLOPS_PER_HIT = 28      # the normal and the Lambert shade
BWD_FLOPS_PER_HIT = 89  # the cotangent of the shade and of the root
BWD_FLOPS_PER_PIXEL = 2  # the hit test, the sum of g into d ambient


def render_fwd(evals: int, adv: int, hits: int, rays: int, residual: bool):
    """(bytes, FP32 operations) of the forward render: it reads the
    parameters and writes the image (one float a pixel), and where a
    backward follows (``residual``) the root it reads (one more)."""
    nbytes = (8 if residual else 4) * rays + 4 * N_PARAMS
    flops = (FLOPS_PER_EVAL * evals + FLOPS_PER_ADVANCE * adv
             + (FLOPS_PER_PIXEL + FLOPS_HIT_TEST) * rays
             + FLOPS_PER_HIT * hits)
    return nbytes, flops


def render_bwd(evals: int, adv: int, hits: int, rays: int,
               residual: bool = True):
    """(bytes, FP32 operations) of the backward render: it reads the
    parameters, the image's cotangent and the root, and writes the
    parameters' cotangent."""
    nbytes = 8 * rays + 2 * 4 * N_PARAMS
    return nbytes, BWD_FLOPS_PER_HIT * hits + BWD_FLOPS_PER_PIXEL * rays
