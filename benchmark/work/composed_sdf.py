"""The work of the composed scene's render functions, counted once: each
input byte read once, each output byte written once, and the FP32
operations of the scene's distance, shade and cotangent for the march's
evaluations and hits at the run's own inputs.

Frozen from the scene as the port's tracer counted it when this
benchmark was written (the arithmetic nodes of ``examples/composed.py``'s
distance function, of its ray, and of its forward shade and backward
cotangent differentiated in reverse mode): a later change to the program
is read against this same work.
"""

N_PARAMS = 12
SDF_OPS = 44            # one evaluation of the distance
RAY_OPS = 1             # the orthographic ray of a pixel
POINT_FLOPS = 6         # o + d * t, three components
STEP_FLOPS = 3          # d >= eps, t + d, <= t_max
PIXEL_FLOPS = 4         # the pixel's coordinates and ts
SHADE_OPS = 113         # the normal and the Lambert shade of a hit
COTANGENT_OPS = 261     # the cotangent of the shade and of the root a hit
BWD_FLOPS_PER_PIXEL = 2  # the hit test, the sum of g into d ambient


def render_fwd(evals: int, adv: int, hits: int, rays: int, residual: bool):
    """(bytes, FP32 operations) of the forward render: it reads the
    parameters and writes the image (one float a pixel), and where a
    backward follows (``residual``) the root it reads (one more)."""
    nbytes = (8 if residual else 4) * rays + 4 * N_PARAMS
    flops = ((SDF_OPS + POINT_FLOPS + STEP_FLOPS) * evals
             + (RAY_OPS + PIXEL_FLOPS) * rays + SHADE_OPS * hits)
    return nbytes, flops


def render_bwd(evals: int, adv: int, hits: int, rays: int,
               residual: bool = True):
    """(bytes, FP32 operations) of the backward render: it reads the
    parameters, the image's cotangent and the root, and writes the
    parameters' cotangent; each hit sums its n_params terms."""
    nbytes = 8 * rays + 2 * 4 * N_PARAMS
    flops = ((COTANGENT_OPS + N_PARAMS) * hits
             + BWD_FLOPS_PER_PIXEL * rays)
    return nbytes, flops
