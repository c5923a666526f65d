"""Special functions (counterpart of enoki_tpu/ops/special.py), ported
whole: the error-function family, Bessel i0e,
Dawson/erfi, the gamma family, the Carlson symmetric forms and the
Legendre elliptic integrals.

Parity target: reference ``include/enoki/special.h`` (erf/erfc :39-164,
i0e :168, erfinv :222, dawson :249, erfi :268, lgamma :275, tgamma :312,
carlson_rf/rd/rc/rj :328-558, ellint_1/2/3 + complete variants :570-670).

Conventions preserved from the reference:
  * elliptic integrals take ``k`` (the modulus), squared internally --
    this differs from Mathematica's ``m = k^2`` convention
    (special.h:562-564 comment).
  * ellint_3 uses the ``1 + nu sin^2`` characteristic sign convention
    (special.h:640,665) -- scipy uses ``1 - n sin^2``: ``nu = -n_scipy``.

``impl="native"`` routes to ``torch.special.erf`` / ``erfc`` / ``erfinv``
/ ``i0e`` and ``torch.lgamma`` where the reference takes jax.scipy.special;
``impl="poly"`` are the reference's polynomial and iterative versions,
coefficient for coefficient. The erf/erfc/i0e coefficient sets are the
classic public-domain Cephes fits (Moshier); erfinv follows M. Giles,
"Approximating the erfinv function" (GPU Computing Gems, 2011); the
Dawson rational fit and the float64 Chebyshev kernels are the
reference's own fits; Carlson forms use the duplication algorithm of
B.C. Carlson, Numerische Mathematik 33 (1979). The two packages' native
functions are different approximations, so a comparison of the two
packages goes through ``"poly"``.

Every function reaches its op namespace through ``_dispatch`` /
``_dispatch_many`` over ``backend.math_ns``, so that the same source
instantiates for ``trace.LazyArray``: over a LazyArray every function
records trace opcodes that fuse into the surrounding program (all of
special.h works on CUDAArray<float> in the source paper). As in the
reference, the lazy namespace is the trace's opcodes whatever ``impl``
says (erf, erfc and lgamma have opcodes of their own), and the lazy
``erfinv`` and ``i0e`` take the polynomial route for ``"native"`` too.
Square roots are correctly rounded (``router._sqrt_rn``), and a
division by a number that is not a power of two divides by a tensor that
holds it (``_c``): PyTorch's CUDA kernels multiply by the reciprocal of a
Python number instead, and compute a Python number divided by a tensor as
a reciprocal times the number on both devices, which are two roundings.
"""

from __future__ import annotations

import math

import torch

from . import backend as B
from . import polys as P
# _c(x, v): the number v as a 0-d tensor of x's dtype on x's device, a
# division by which is one IEEE division on the CPU and the card
from .math import _f, _floats, _scalar as _c

_NATIVE = "native"
_POLY = "poly"


# ---------------------------------------------------------------------------
# Backend dispatch ("one source, every backend"): every function below is
# written against a generic op namespace `ns` -- ops.backend.math_ns -- so
# that the same polynomial/iterative source instantiates for the lazy
# trace (the reference's architectural headline: all of special.h works
# on CUDAArray<float> because everything routes through L2 free
# functions, array_router.h:23-158).
# ---------------------------------------------------------------------------


def _dispatch(x, impl=_POLY):
    """(ns, x): op namespace for x's backend, x float-coerced."""
    x = _f(x)
    return B.math_ns(x, impl), x


def _dispatch_many(impl, *xs):
    """Multi-operand dispatch: every operand a float tensor on one device,
    a Python number in the tensors' dtype (``math._floats``); with a
    LazyArray among them, all of them on the trace."""
    out = _floats(*xs)
    return B.math_ns(out[0], impl), out


# ---------------------------------------------------------------------------
# erf / erfc (special.h:39-164; Cephes erff/erfcf coefficient sets)
# ---------------------------------------------------------------------------

_ERF_SMALL_F32 = (7.853861353153693e-5, -8.010193625184903e-4,
                  5.188327685732524e-3, -2.685381193529856e-2,
                  1.128358514861418e-1, -3.761262582423300e-1,
                  1.128379165726710e0)  # high -> low degree, poly in x^2

# Own least-squares fits of erfc(x)*x*exp(x^2) in 1/x^2 (max rel err
# ~1e-7 on each interval; fit methodology in tools/fit_special.py).
_ERFC_MID_F32 = (0.563827049263997, -0.2741486714207337, 0.3408510467790378,
                 -0.4962379964350489, 0.6259653005292505, -0.5906693064990044,
                 0.37671229807166046, -0.14292002259561576,
                 0.02420392324179574)  # low -> high, poly in 1/x^2, |x| in [1,2]

_ERFC_BIG_F32 = (0.5641894915108899, -0.2820770813080498, 0.4219410805387515,
                 -1.018370800866104, 2.9629135430239546, -7.7711177422056075,
                 13.853756360566171, -11.556587251550912)  # low -> high, |x| > 2


# ERF64_SMALL: deg 15, max abs err 4.9e-25 (monomial, low -> high)
_ERF64_SMALL = (
    1.1283791670955126, -0.37612638903183754, 0.11283791670955126,
    -0.026866170645131252, 0.005223977625442175, -0.0008548327023449497,
    0.00012055332981694495, -1.4925650353787866e-05, 1.6462114205798046e-06,
    -1.6365840648222765e-07, 1.4807117719731329e-08, -1.2289529419960295e-09,
    9.412558594992829e-11, -6.639294901316118e-12, 4.117309460970657e-13,
    -1.746609279318069e-14,
)
# ERFC64_BIG: 28 Chebyshev terms on [0.0013417595835178253, 0.25], max abs err 2.92e-19 (a0 pre-halved)
_ERFC64_BIG = (
    0.5355952668668763, -0.026347322309570733, 0.0016866118873189477,
    -0.00016010840260293128, 1.926335135759567e-05, -2.731940453529889e-06,
    4.3835667186741077e-07, -7.753747974149442e-08, 1.4852720144476457e-08,
    -3.041902222792052e-09, 6.597082644206111e-10, -1.5038023481338093e-10,
    3.581728411606054e-11, -8.871052181034189e-12, 2.2757310991203797e-12,
    -6.026889105556514e-13, 1.6431396350039202e-13, -4.600679548039466e-14,
    1.3201826124509799e-14, -3.875468212257644e-15, 1.1619877827187225e-15,
    -3.5534884221884737e-16, 1.1069793970299305e-16, -3.508828155937958e-17,
    1.1303886548351901e-17, -3.693631650914469e-18, 1.211430955680132e-18,
    -3.6486707176552197e-19,
)
# ERFC64_MID: 28 Chebyshev terms on [0.25, 1.0], max abs err 1.99e-20 (a0 pre-halved)
_ERFC64_MID = (
    0.46519932669884523, -0.04110133936262089, 0.003914495866689627,
    -0.0004906395650548979, 7.157479001377036e-05, -1.1530716341312328e-05,
    1.9946705902019974e-06, -3.642666471599223e-07, 6.944372610005012e-08,
    -1.371220902104366e-08, 2.7883896610071373e-09, -5.814164724331161e-10,
    1.2389204917527532e-10, -2.6906391453067435e-11, 5.9426143508479106e-12,
    -1.3323867357581193e-12, 3.0280468061771217e-13, -6.966648814940638e-14,
    1.620854541052417e-14, -3.809934465192936e-15, 9.040487813771914e-16,
    -2.164006186597287e-16, 5.222101905990895e-17, -1.269728330557074e-17,
    3.10909599028495e-18, -7.661827010872778e-19, 1.893216257909702e-19,
    -4.4422037200364615e-20,
)
_ERFC64_Q_MIN = 0.0013417595835178253


# DAWSON64_SMALL: 52 Chebyshev terms on [1e-24, 36.0], max abs err 1.42e-26 (a0 pre-halved)
_DAWSON64_SMALL = (
    0.14770448757545968, -0.2398534195953638, 0.18738428379289465,
    -0.1405735842044173, 0.10110742050985852, -0.06964467346926513,
    0.04590988329500305, -0.02895173024979205, 0.0174644950526268,
    -0.010079038005053508, 0.005566956686151923, -0.002944252141863637,
    0.001491992791298386, -0.0007249529727323651, 0.00033802670350880964,
    -0.00015137628877812196, 6.516457662067448e-05, -2.6989888383368587e-05,
    1.0765104660981909e-05, -4.138606994983442e-06, 1.5349573638158337e-06,
    -5.497005653471848e-07, 1.9024697513594356e-07, -6.368486439414856e-08,
    2.0636551037394904e-08, -6.4783696160122245e-09, 1.9717723508003027e-09,
    -5.822831808514027e-10, 1.6695958271124255e-10, -4.651474041283174e-11,
    1.2599809550972456e-11, -3.3205739664337557e-12, 8.519414744000667e-13,
    -2.129196119792782e-13, 5.186606757621425e-14, -1.2321287100163802e-14,
    2.856067855293235e-15, -6.463188451211329e-16, 1.428594748374242e-16,
    -3.085784084744163e-17, 6.51657152088065e-18, -1.3460640196934718e-18,
    2.7207844847479764e-19, -5.383774790706026e-20, 1.0433262702697108e-20,
    -1.980907289349781e-21, 3.68623850763235e-22, -6.725693101589979e-23,
    1.2035901308576106e-23, -2.113240830989033e-24, 3.6391316145499683e-25,
    -5.994533914033278e-26,
)
# DAWSON64_TAIL: 20 Chebyshev terms on [1e-24, 0.027777777777777776], max abs err 3.79e-22 (a0 pre-halved)
_DAWSON64_TAIL = (
    1.0071752259291502, 0.007254579074193654, 8.086455588294951e-05,
    1.5531562229740045e-06, 4.328531758315656e-08, 1.6123107664377305e-09,
    7.658641739865628e-11, 4.5073774093624016e-12, 3.2301123783078815e-13,
    2.7957319878989467e-14, 2.925190652004896e-15, 3.7253963988471424e-16,
    5.750901823018001e-17, 1.0260765854504379e-17, 1.883246018711638e-18,
    2.7898517307755096e-19, 2.6364862855584663e-21, -2.010576353629126e-20,
    -9.476498985572715e-21, -2.5697120693366522e-21,
)
# I0E64_A: 34 Chebyshev terms on [1e-24, 8.0], max abs err 1.42e-22 (a0 pre-halved)
_I0E64_A = (
    0.33839763720473803, -0.3046826723431984, 0.17162090152220877,
    -0.09490109704804764, 0.04930528423967071, -0.02373741480589947,
    0.010546460394594998, -0.004324309995050576, 0.0016394756169413357,
    -0.0005763755745385824, 0.00018850288509584165, -5.754195010082104e-05,
    1.6448448070728896e-05, -4.4167383584587505e-06, 1.1173875391201037e-06,
    -2.670793853940612e-07, 6.046995022541919e-08, -1.300025009986248e-08,
    2.6598237246823866e-09, -5.189795601635263e-10, 9.675809035373237e-11,
    -1.726826291441556e-11, 2.95505266312964e-12, -4.856446783111929e-13,
    7.676185498604936e-14, -1.1685332877993451e-14, 1.7153912855551317e-15,
    -2.431279846547818e-16, 3.330794518807876e-17, -4.4153416450074414e-18,
    5.669177859703422e-19, -7.057086331113794e-20, 8.523183862892743e-21,
    -9.87404944735617e-22,
)
# I0E64_B: 26 Chebyshev terms on [1e-24, 0.125], max abs err 1.81e-18 (a0 pre-halved)
_I0E64_B = (
    0.4022452055070544, 0.0033691164782556943, 6.889758346916825e-05,
    2.8913705208347567e-06, 2.0489185894690638e-07, 2.266668990498178e-08,
    3.396232025708386e-09, 4.940602388224974e-10, 1.1889147107846069e-11,
    -3.149916527963373e-11, -1.3215811840444411e-11, -1.7941785315052209e-12,
    7.180124451217564e-13, 3.8527783828690237e-13, 1.540086223622408e-14,
    -4.150569359939181e-14, -9.554846849041664e-15, 3.8116814243351245e-15,
    1.77256012037355e-15, -3.4255224890000575e-16, -2.8275912723664775e-16,
    3.4628248226046367e-17, 4.4627353687004704e-17, -4.894951052917917e-18,
    -7.039337842458663e-18, 1.2410185249324504e-18,
)


# LG64_A: 36 Chebyshev terms on [-0.4999999999, 0.5], max abs err 2.38e-22 (a0 pre-halved)
_LG64_A = (
    -0.6330114262150568, 0.44056755739200454, -0.05785740942964893,
    0.010513973684729979, -0.00216398909057367, 0.0004744402334572364,
    -0.00010799644516778291, 2.5201155268757586e-05, -5.9860144896837516e-06,
    1.4410616157720047e-06, -3.506069051478737e-07, 8.603823000314848e-08,
    -2.1265109080458022e-08, 5.287778079527005e-09, -1.3217135720045173e-09,
    3.318669846806063e-10, -8.365902544521852e-11, 2.1163386599195494e-11,
    -5.370507637027608e-12, 1.3666688055513991e-12, -3.486660027793325e-13,
    8.91562240030536e-14, -2.2845495847955506e-14, 5.865146691836755e-15,
    -1.5084071121215e-15, 3.8856146315901103e-16, -1.0024188141446238e-16,
    2.589641844340365e-17, -6.698674705408949e-18, 1.7348373203770305e-18,
    -4.497954079859277e-19, 1.1674174424612558e-19, -3.032889638371252e-20,
    7.884427100745802e-21, -2.043209471532687e-21, 4.983280028701445e-22,
)
# LG64_B: 32 Chebyshev terms on [-0.5, 0.75], max abs err 1.9e-28 (a0 pre-halved)
_LG64_B = (
    0.449956620949089, 0.19488913511169126, -0.012241630375398674,
    0.001123923112572209, -0.00012117714359534564, 1.4250979691533796e-05,
    -1.7674125073287517e-06, 2.2702308732315152e-07, -2.9884508114723646e-08,
    4.00485757338454e-09, -5.439990674066314e-10, 7.467629216647432e-11,
    -1.0337705753585266e-11, 1.4409727234815299e-12, -2.0201348197819655e-13,
    2.8458934689542795e-14, -4.026012834893851e-15, 5.716304481287189e-16,
    -8.142350533178055e-17, 1.1631160838685615e-17, -1.6657347163052649e-18,
    2.391052778527632e-19, -3.439380252402371e-20, 4.956772967253059e-21,
    -7.156098232475694e-22, 1.0347877809653167e-22, -1.4985476034213682e-23,
    2.1731346665491834e-24, -3.155420501958431e-25, 4.587125058812727e-26,
    -6.672953542493563e-27, 9.519033047896072e-28,
)
# LG64_MID: 34 Chebyshev terms on [2.75, 8.0], max abs err 1.41e-21 (a0 pre-halved)
_LG64_MID = (
    4.124047060041262, 4.061147246337851, 0.37093119763677385,
    -0.03527671631906673, 0.005038768911335157, -0.0008624087958159783,
    0.0001635908382728636, -3.314875787318577e-05, 7.030499715247594e-06,
    -1.5413611584723984e-06, 3.464806782830416e-07, -7.940924754395674e-08,
    1.8481450714055696e-08, -4.354997725806164e-09, 1.0367053628750137e-09,
    -2.488798691641504e-10, 6.017341095211362e-11, -1.463637888781839e-11,
    3.578504282026376e-12, -8.788262445948789e-13, 2.1666426451481918e-13,
    -5.359774989481278e-14, 1.329864234412958e-14, -3.3084423605824785e-15,
    8.250338335502667e-16, -2.0618000268435606e-16, 5.1624711362061504e-17,
    -1.2948731251403026e-17, 3.2530280541553494e-18, -8.184276028119995e-19,
    2.0618029420504918e-19, -5.1993555237774974e-20, 1.3079207412578295e-20,
    -3.1071918812382072e-21,
)
# LG64_STIR: 12 Chebyshev terms on [1e-18, 0.015625], max abs err 1.54e-26 (a0 pre-halved)
_LG64_STIR = (
    0.08331170390906488, -2.160555080544604e-05, 2.3805130306661253e-08,
    -6.796982741412553e-11, 3.598298746801336e-13, -3.006641868307272e-15,
    3.60073597694167e-17, -5.791695393592584e-19, 1.1937232345642649e-20,
    -3.042270769880426e-22, 9.32280692134094e-24, -3.3523315896989313e-25,
)


def _expx2_neg(ns, x):
    """exp(-x^2) without the quadratic error amplification: rounding
    x*x costs ~x^2 * ulp relative error (2000+ ulp at x = 27), so split
    hi = round(128 x)/128 (hi^2 is exactly representable) and use
    exp(-x^2) = exp(-hi^2) * exp(-m), m = (x-hi)(x+hi) -- the Cephes
    expx2 technique, rebuilt branch-free."""
    hi = ns.round(x * 128.0) * (1.0 / 128.0)
    m = (x - hi) * (x + hi)
    return ns.exp_native(-hi * hi) * ns.exp_native(-m)


def _chebeval(t, coeffs):
    """Clenshaw evaluation of sum_k coeffs[k] T_k(t) (coeffs[0] is the
    already-halved a_0 of the interpolation). Chebyshev basis because
    the degree-27 tail fits have |monomial coefficients| ~ 1e13 --
    catastrophic cancellation in f64; Chebyshev coefficients stay O(1).
    Backend-generic: only operators (records trace ops for LazyArray)."""
    b1 = b2 = t * 0.0
    for c in coeffs[:0:-1]:
        b1, b2 = 2.0 * t * b1 - b2 + c, b1
    return t * b1 - b2 + coeffs[0]


def _erfc64_pos(ns, a):
    """f64 erfc for a >= 0 (own fits, tools/fit_special_f64.py)."""
    z = a * a
    small = 1.0 - a * P.horner(z, _ERF64_SMALL)
    q = 1.0 / ns.maximum(z, 1.0)
    q = ns.maximum(q, _ERFC64_Q_MIN)
    t_big = (2.0 * q - (_ERFC64_Q_MIN + 0.25)) / _c(q, 0.25 - _ERFC64_Q_MIN)
    t_mid = (2.0 * q - 1.25) / _c(q, 0.75)
    kq = ns.select(a > 2.0, _chebeval(t_big, _ERFC64_BIG),
                   _chebeval(t_mid, _ERFC64_MID))
    tail = _expx2_neg(ns, ns.minimum(a, 28.0)) / ns.maximum(a, 1.0) * kq
    # underflow at the smallest NORMAL, as the reference's: XLA flushes
    # f64 denormals to zero (the source paper's GPU path is ftz
    # throughout, cuda.h:341), so erfc's denormal range x in (26.55, 27.3]
    # is zero by construction
    tail = ns.select(a > 26.55, tail * 0.0, tail)
    return ns.select(a <= 1.0, small, tail)


def _erf64(ns, x):
    a = ns.abs(x)
    r = ns.select(a <= 1.0, a * P.horner(a * a, _ERF64_SMALL),
                  1.0 - _erfc64_pos(ns, a))
    # mulsign, not select(x < 0): erf is odd INCLUDING the zero sign
    # (erf(-0.0) = -0.0, the scipy/IEEE convention; x < 0.0 misses -0.0)
    return ns.mulsign(r, x)


def erf(x, impl=_NATIVE):
    ns, x = _dispatch(x, impl)
    if impl == _NATIVE:
        return ns.erf_ref(x)
    if x.dtype == torch.float64:
        return _erf64(ns, x)
    a = ns.abs(x)
    # |x| < 1: direct series erf(x) = x * poly(x^2). z is clamped so the
    # untaken branch stays finite for huge |x| (mask discipline: an inf
    # in the unselected polynomial turns the where's backward into
    # 0 * inf = NaN gradients)
    z = ns.minimum(x * x, 1.0)
    small = x * P.horner(z, list(reversed(_ERF_SMALL_F32)))
    return ns.select(a < 1.0, small, 1.0 - _erfc_tail(ns, x))


def erfc(x, impl=_NATIVE):
    ns, x = _dispatch(x, impl)
    if impl == _NATIVE:
        return ns.erfc_ref(x)
    if x.dtype == torch.float64:
        r = _erfc64_pos(ns, ns.abs(x))
        return ns.select(x < 0.0, 2.0 - r, r)
    a = ns.abs(x)
    z = x * x
    small = 1.0 - x * P.horner(z, list(reversed(_ERF_SMALL_F32)))
    return ns.select(a < 1.0, small, _erfc_tail(ns, x))


def _erfc_tail(ns, x):
    """erfc for |x| >= 1 via exp(-x^2)/x * poly(1/x^2), reflected for x<0."""
    a = ns.maximum(ns.abs(x), 1.0)
    q = 1.0 / a
    y = q * q
    p_mid = P.horner(y, list(_ERFC_MID_F32))
    p_big = P.horner(y, list(_ERFC_BIG_F32))
    p = ns.select(a > 2.0, p_big, p_mid)
    # the exp argument is clamped at the underflow guard's own bound:
    # beyond it the select zeroes the value anyway, and an unclamped
    # -a*a reaching -inf makes the exp's derivative 0 * -inf = NaN
    # (grad discipline for the masked lanes)
    ac = ns.minimum(a, 10.06)
    zexp = ns.exp(-ac * ac)
    r = zexp * q * p
    r = ns.select(a > 10.06, r * 0.0, r)  # exp underflow guard (f32)
    return ns.select(x < 0.0, 2.0 - r, r)


# ---------------------------------------------------------------------------
# erfinv (special.h:222; Giles 2011 single-precision fit)
# ---------------------------------------------------------------------------

_ERFINV_P1 = (1.50140941, 0.246640727, -0.00417768164, -0.00125372503,
              0.00021858087, -4.39150654e-06, -3.5233877e-06,
              3.43273939e-07, 2.81022636e-08)  # low -> high in (w - 2.5)
_ERFINV_P2 = (2.83297682, 1.00167406, 0.00943887047, -0.0076224613,
              0.00573950773, -0.00367342844, 0.00134934322,
              0.000100950558, -0.000200214257)  # low -> high in (sqrt(w) - 3)


def erfinv(x, impl=_NATIVE):
    """Inverse error function; erfinv(+-1) = +-inf."""
    lazy = B.is_lazy(x)
    ns, x = _dispatch(x, impl if impl != _NATIVE else _POLY)
    if impl == _NATIVE and not lazy:
        return torch.special.erfinv(x)
    # the Giles fit composes from generic ops (the reference's lazy
    # impl="native" reroutes here too)
    w = -ns.log((1.0 - x) * (1.0 + x))
    w1 = w - 2.5
    w2 = ns.sqrt(ns.maximum(w, 0.0)) - 3.0
    p1 = P.poly8(w1, *_ERFINV_P1)
    p2 = P.poly8(w2, *_ERFINV_P2)
    y = ns.select(w < 5.0, p1, p2) * x
    if x.dtype != torch.float64:
        # erfinv(+-1) = +-inf: w = -log(0) = inf and poly8(inf) mixes
        # +-inf terms into NaN -- the f64 branch below has this fixup,
        # the f32 path needs it too
        y = ns.select(ns.abs(x) == 1.0, ns.copysign(
            ns.full_like(x, math.inf), x), y)
    if x.dtype == torch.float64:
        # f64 path (special.h:222 has a double-precision branch): the
        # Giles fit is a ~1e-7 seed; two Newton steps square the error
        # to full double precision: a 9-term seed + 2 steps instead of
        # the reference's long rational tables. In the
        # tail (|x| > 0.5) Newton runs on the COMPLEMENTARY equation
        # erfc(y) = 1-|x| -- the direct form cancels catastrophically
        # when erf(y) and x are both ~1.
        half_sqrt_pi = 0.8862269254527580137
        a = ns.abs(x)
        c = 1.0 - a  # exact for a in [0.5, 1] (Sterbenz)
        tail = a > 0.5
        ya = ns.abs(y)
        for _ in range(2):
            scale = half_sqrt_pi * ns.exp_native(ya * ya)
            step_mid = -(ns.erf_ref(ya) - a) * scale
            step_tail = (ns.erfc_ref(ya) - c) * scale
            ya = ya + ns.select(tail, step_tail, step_mid)
        y = ns.select(a == 1.0, math.inf, ya)
        y = ns.copysign(y, x)
    return y


# ---------------------------------------------------------------------------
# i0e: exponentially-scaled modified Bessel I0 (special.h:168; Cephes i0e)
# ---------------------------------------------------------------------------

_I0E_A = (-1.30002500998624804212e-8, 6.04699502254191894932e-8,
          -2.67079385394061173391e-7, 1.11738753912010371815e-6,
          -4.41673835845875056359e-6, 1.64484480707288970893e-5,
          -5.75419501008210370398e-5, 1.88502885095841655729e-4,
          -5.76375574538582365885e-4, 1.63947561694133579842e-3,
          -4.32430999505057594430e-3, 1.05464603945949983183e-2,
          -2.37374148058994688156e-2, 4.93052842396707084878e-2,
          -9.49010970480476444210e-2, 1.71620901522208775349e-1,
          -3.04682672343198398683e-1, 6.76795274409476084995e-1)

_I0E_B = (3.39623202570838634515e-9, 2.26666899049817806459e-8,
          2.04891858946906374183e-7, 2.89137052083475648297e-6,
          6.88975834691682398426e-5, 3.36911647825569408990e-3,
          8.04490411014108831608e-1)


def _chbevl(x, coeffs):
    """Chebyshev series evaluation, Cephes chbevl convention
    (special.h:23-37). Backend-generic (operators only)."""
    b0 = x * 0.0 + coeffs[0]
    b1 = x * 0.0
    b2 = b1
    for c in coeffs[1:]:
        b2 = b1
        b1 = b0
        b0 = x * b1 - b2 + c
    return (b0 - b2) * 0.5


def i0e(x, impl=_NATIVE):
    lazy = B.is_lazy(x)
    ns, x = _dispatch(x, impl)
    if impl == _NATIVE and not lazy:
        return torch.special.i0e(x)
    a = ns.abs(x)
    if x.dtype == torch.float64:
        # own full-precision Chebyshev fits; the f32 tables below are truncated Cephes sets (~1e-8)
        t_a = (2.0 * ns.minimum(a, 8.0) - 8.0) / 8.0
        small = _chebeval(t_a, _I0E64_A)
        q = 1.0 / ns.maximum(a, 8.0)
        t_b = (2.0 * q - 0.125) / 0.125
        big = _chebeval(t_b, _I0E64_B) * ns.rsqrt(ns.maximum(a, 8.0))
        return ns.select(a > 8.0, big, small)
    # clamp the untaken small-branch argument exactly like the f64 path:
    # _chbevl of an unclamped huge a overflows in the masked lanes and
    # poisons gradients through the where (0 * inf = NaN)
    small = _chbevl(ns.minimum(a, 8.0) * 0.5 - 2.0, _I0E_A)
    big = _chbevl(32.0 / ns.maximum(a, 8.0) - 2.0, _I0E_B) * ns.rsqrt(ns.maximum(a, 8.0))
    return ns.select(a > 8.0, big, small)


# ---------------------------------------------------------------------------
# Dawson's integral & erfi (special.h:249,268)
# ---------------------------------------------------------------------------

# Own rational minimax-style fit F(x) = x * P(x^2)/Q(x^2), fit against
# scipy.special.dawsn over the real line (tools/fit_dawson.py + IRLS refine);
# max rel err 8.4e-7 -- meets the reference's <1e-6 accuracy claim.
_DAWSON_P = (1.0000008294662397, 0.09265395753276819, 0.042687846749245105,
             0.006085398808648457, 0.0009993247124355736,
             3.585164406841002e-05, 1.590927753914693e-05)
_DAWSON_Q = (1.0, 0.7593552421380568, 0.2820196233023268, 0.06844432775483446,
             0.011406038376094413, 0.0019421904806522573,
             5.5820259368201406e-05, 3.1818534282458186e-05)


def _dawson64(ns, x):
    """f64 Dawson (own Chebyshev fits, tools/fit_special_f64.py):
    |x| <= 6 direct kernel in z = x^2; beyond, the 1/(2x) * K(1/x^2)
    asymptotic kernel."""
    a = ns.abs(x)
    z = ns.minimum(a * a, 36.0)
    t_small = (2.0 * z - 36.0) / _c(z, 36.0)
    small = a * _chebeval(t_small, _DAWSON64_SMALL)
    q = 1.0 / ns.maximum(a * a, 36.0)
    t_tail = (2.0 * q - (1.0 / 36.0)) * 36.0
    tail = _chebeval(t_tail, _DAWSON64_TAIL) / (2.0 * ns.maximum(a, 1.0))
    r = ns.select(a <= 6.0, small, tail)
    return ns.mulsign(r, x)


def dawson(x, impl=_POLY):
    """Dawson's integral e^{-x^2} \\int_0^x e^{t^2} dt (special.h:249).
    No native function exists; the polynomial paths are the only ones
    (f32: own rational fit; f64: own Chebyshev kernels, full double
    precision)."""
    ns, x = _dispatch(x, impl)
    if x.dtype == torch.float64:
        return _dawson64(ns, x)
    # the rational form's x2^7 term overflows f32 past |x| ~ 566
    # (returning 0, then NaN, and NaN at +-inf); switch to the exact
    # asymptote 1/(2x) + 1/(4x^3) where its truncation error is already
    # below the fit's 8.4e-7 (|x| > 30), and clamp the masked branch so
    # no inf enters the where (NaN-grad discipline)
    x2 = ns.minimum(x * x, 900.0)
    num = P.poly6(x2, *_DAWSON_P)
    den = P.poly7(x2, *_DAWSON_Q)
    rat = num / den * x
    # the tail's divisor is sign-preservingly clamped away from 0: the
    # untaken branch at x = 0 would otherwise be 0.5/0 = inf and poison
    # the gradient through the select (0 * inf = NaN)
    xt = ns.mulsign(ns.maximum(ns.abs(x), 30.0), x)
    tail = (0.5 + 0.25 / ns.maximum(x * x, 900.0)) / xt
    return ns.select(x * x > 900.0, tail, rat)


def erfi(x, impl=_POLY):
    """Imaginary error function erfi(x) = 2/sqrt(pi) e^{x^2} D(x)
    (special.h:268). The f64 path splits the e^{x^2} argument exactly
    (the positive-exponent twin of _expx2_neg) -- naive squaring costs
    ~x^2 ulp of relative error."""
    ns, x = _dispatch(x, impl)
    two_over_sqrt_pi = 1.1283791670955126
    if x.dtype == torch.float64:
        a = ns.abs(x)
        hi = ns.round(a * 128.0) * (1.0 / 128.0)
        m = (a - hi) * (a + hi)
        # two half-exponentials: exp(hi^2) alone would overflow at
        # hi^2 > 709.8 (a ~ 26.64) while erfi itself stays finite up to
        # a ~ 26.71. 0.5*hi*hi is EXACT (hi^2 is exactly representable,
        # halving is a scale), so the split costs no exponent rounding;
        # the correction exp(m) stays its own factor.
        half = ns.exp_native(0.5 * hi * hi)
        r = ((two_over_sqrt_pi * _dawson64(ns, a) * ns.exp_native(m))
             * half) * half
        # a = +inf: hi = inf and m = (inf-inf)*inf = NaN -- but
        # erfi(+-inf) = +-inf (scipy convention); the overflow boundary
        # a ~ 26.71 makes the select exact in value
        r = ns.select(a > 26.71, ns.full_like(a, float("inf")), r)
        return ns.mulsign(r, x)
    e = ns.exp_native(x * x) if impl == _NATIVE else ns.exp(x * x)
    return two_over_sqrt_pi * dawson(x, impl) * e


# ---------------------------------------------------------------------------
# Gamma family (special.h:275-312; classic Lanczos g=5, n=6)
# ---------------------------------------------------------------------------

_LANCZOS = (1.000000000190015, 76.18009172947146, -86.50532032941677,
            24.01409824083091, -1.231739572450155, 0.1208650973866179e-2,
            -0.5395239384953e-5)


# Central-interval fits with the zeros of lgamma factored out:
# lgamma(x) = u * polyA(u), u = x-1 on [0.5, 1.5] and u * polyB(u),
# u = x-2 on [1.5, 2.75] (tools/fit_lgamma.py; f32-Horner rel err ~2e-7).
# Direct evaluation (Lanczos or jax's own gammaln) has unbounded ULP error
# near x = 1 and x = 2 where the result crosses zero; factoring makes the
# error relative because u is exact in f32 and the centered coefficients
# (leading terms are -euler_gamma and pi^2/6 - 1 + ..., the Taylor series
# of lgamma at its zeros) keep the Horner sum well conditioned.
_LGAMMA_A = (-0.577215663456744, 0.8224669600023586, -0.40068601474304577,
             0.2705899284753273, -0.20737170534735425, 0.1692432975864104,
             -0.14416076274335293, 0.13000226894004868, -0.1122540911338095,
             0.07006221016609972, -0.07506543264312764, 0.17229244912618616,
             -0.14317630195638492)
_LGAMMA_B = (0.4227843350994001, 0.32246703343671734, -0.06735230127589555,
             0.020580807462167245, -0.007385542059947526,
             0.0028905284046411013, -0.0011928912709559469,
             0.0005095674553248059, -0.0002221819342750322,
             9.935890521648298e-05, -4.8055170114027025e-05,
             2.2765350647194328e-05, -6.303423125376528e-06)


def _poly_horner(coeffs, x):
    acc = x * 0.0 + coeffs[-1]
    for c in coeffs[-2::-1]:
        acc = acc * x + c
    return acc


def _lgamma_pos(ns, y):
    """lgamma for y >= 0.5: factored central polys + Lanczos tail."""
    log_sqrt2pi = 0.91893853320467274178
    # central [0.5, 2.75]
    yc = ns.clamp(y, 0.5, 2.75)
    ua = yc - 1.0
    ub = yc - 2.0
    central = ns.select(
        yc < 1.5,
        ua * _poly_horner(_LGAMMA_A, ua),
        ub * _poly_horner(_LGAMMA_B, ub))
    # Lanczos tail (g=5, n=6) for y > 2.75
    xx = ns.maximum(y, 2.75) - 1.0
    b = xx + 5.5
    s = y * 0.0 + _LANCZOS[0]
    for i in range(6, 0, -1):
        s = s + _c(xx, _LANCZOS[i]) / (xx + i)
    tail = (log_sqrt2pi + ns.log(s) - b) + ns.log(b) * (xx + 0.5)
    return ns.select(y <= 2.75, central, tail)


def _lgamma64_pos(ns, x):
    """f64 lgamma for x > 0 (own Chebyshev kernels, LG64_*): relative
    accuracy THROUGH the zeros at x=1 and x=2 (they are divided out),
    where XLA's gammaln loses ~12k ulp."""
    xs = ns.maximum(x, torch.finfo(torch.float64).tiny)  # guard log/recurrence
    # branch d: [0.5, 1.5) as u * A(u); also serves (0, 0.5) via the
    # recurrence lgamma(x) = lgamma(x+1) - log(x)
    small = x < 0.5
    xd = ns.select(small, xs + 1.0, xs)
    u = ns.clamp(xd - 1.0, -0.5, 0.5)
    t_a = 2.0 * u / _c(u, 0.5 + 0.4999999999) + (0.4999999999 - 0.5) / 1.0
    branch_d = u * _chebeval(t_a, _LG64_A)
    branch_d = ns.select(small, branch_d - ns.log_native(xs), branch_d)
    # branch c: [1.5, 2.75) as v * B(v)
    v = ns.clamp(xs - 2.0, -0.5, 0.75)
    t_b = (2.0 * v - 0.25) / _c(v, 1.25)
    branch_c = v * _chebeval(t_b, _LG64_B)
    # branch b: [2.75, 8) direct
    xm = ns.clamp(xs, 2.75, 8.0)
    t_m = (2.0 * xm - 10.75) / _c(xm, 5.25)
    branch_b = _chebeval(t_m, _LG64_MID)
    # branch a: x >= 8 Stirling
    xt = ns.maximum(xs, 8.0)
    w = 1.0 / (xt * xt)
    t_s = (2.0 * w - 0.015625) / 0.015625
    stir = ((xt - 0.5) * ns.log_native(xt) - xt + 0.9189385332046727
            + _chebeval(t_s, _LG64_STIR) / xt)
    r = ns.select(x >= 8.0, stir,
                  ns.select(x >= 2.75, branch_b,
                            ns.select(x >= 1.5, branch_c, branch_d)))
    return r


def _lgamma64(ns, x):
    """f64 lgamma over the real line: positive branches + reflection
    log(pi/|sin(pi x)|) - lgamma(1-x) for x < 0.25 (poles -> +inf)."""
    pos = _lgamma64_pos(ns, x)
    # reflection: sin(pi x) with the argument reduced exactly first
    r = x - ns.round(x)
    sinpix = ns.abs(ns.sin_native(math.pi * r))
    xa = ns.maximum(1.0 - x, 1.0)  # 1 - x >= 1 for x <= 0
    refl = (math.log(math.pi)
            - ns.log_native(sinpix) - _lgamma64_pos(ns, xa))
    refl = ns.select(sinpix == 0.0, math.inf, refl)  # poles at -n
    out = ns.select(x > 0.0, pos, refl)
    # +-inf: both Stirling (inf - inf) and the reflection (inf - round)
    # produce NaN, but lgamma(+-inf) = +inf (scipy gammaln convention)
    return ns.select(ns.isinf(x), ns.full_like(x, math.inf), out)


def lgamma(x, impl=_NATIVE):
    # f64 poly: own factored-zero kernels (relative accuracy through the
    # zeros at x=1, x=2 -- XLA's f64 gammaln is ~12k ulp off there)
    ns, x = _dispatch(x, impl)
    if impl == _NATIVE:
        return ns.lgamma_ref(x)
    if x.dtype == torch.float64:
        return _lgamma64(ns, x)
    reflect = x < 0.5
    # both branches evaluated on safe inputs, then selected (mask
    # discipline: no NaN from the untaken branch). The reflection's
    # argument is clamped so 1 - (-inf) cannot reach the Lanczos tail.
    pos = _lgamma_pos(ns, ns.minimum(ns.select(reflect, 1.0 - x, x),
                                     3.4e38))
    # Reflection: lgamma(x) = log|pi / sin(pi x)| - lgamma(1 - x), with
    # the sin argument reduced EXACTLY first (|sin(pi x)| is 1-periodic;
    # pi*x alone has ~1 ulp of argument noise per unit of |x| in f32 --
    # for large negative x the raw form returns garbage or a spurious
    # pole; mirrors the f64 path's x - round(x))
    xr = x - ns.round(x)
    sin_px = ns.sin(math.pi * ns.select(reflect, xr, x * 0.0 + 0.5))
    refl_val = ns.log(ns.abs(_c(sin_px, math.pi) / sin_px)) - pos
    result = ns.select(reflect, refl_val, pos)
    result = ns.select(reflect & (x == ns.round(x)), math.inf, result)
    # +-inf: the tails compute inf - inf; gammaln(+-inf) = +inf
    return ns.select(ns.isinf(x), ns.full_like(x, math.inf), result)


def tgamma(x, impl=_NATIVE):
    """Gamma function. The reference defines tgamma = exp(lgamma)
    (special.h:312), which drops the sign for negative arguments; we restore
    the correct sign via the reflection parity (an accuracy improvement,
    flagged for parity-diff awareness).

    f64 accuracy note: exp amplifies lgamma's absolute error by |lgamma|,
    so relative error grows to ~4e-13 (~1700 ulp) near the x=170 overflow
    edge -- inherent to the exp(lgamma) definition the reference uses; a
    direct rational would be needed to do better."""
    ns, x = _dispatch(x, impl)
    lg = lgamma(x, impl)
    g = ns.exp_native(lg) if impl == _NATIVE else ns.exp(lg)
    # Gamma is negative on (-1,0), (-3,-2), ... : odd floor(x) intervals
    neg = (x < 0.0) & (ns.floor(x) % 2.0 == 1.0)
    g = ns.select(neg, -g, g)
    # the x = 0 pole is signed: Gamma(+0) = +inf, Gamma(-0.0) = -inf
    # (1/x behavior; x < 0.0 cannot see the sign bit of -0.0)
    return ns.select(x == 0.0, ns.mulsign(g, x), g)


# ---------------------------------------------------------------------------
# Carlson symmetric forms (special.h:328-558; Carlson 1979 duplication)
# All loops run a fixed 10 iterations with lane masks -- the same bound the
# reference uses -- so the control flow is static: a Python loop over the
# trip count (the source paper's fixed-bound lane-masked loop,
# special.h:340-360).
# ---------------------------------------------------------------------------

_CARLSON_ITERS = 10


def _carlson_eps(dtype):
    return 0.0024608 if dtype == torch.float64 else 0.070154  # eps^(1/6)


def carlson_rf(x, y, z):
    """R_F(x,y,z) = 1/2 int_0^inf [(t+x)(t+y)(t+z)]^(-1/2) dt
    (special.h:328)."""
    ns, (x, y, z) = _dispatch_many(_POLY, x, y, z)
    x, y, z = ns.broadcast(x, y, z)
    thresh = _carlson_eps(x.dtype)

    active = x * 0.0 == 0.0  # all-true (finite inputs), backend-generic
    for _ in range(_CARLSON_ITERS):
        sx, sy, sz = ns.sqrt(x), ns.sqrt(y), ns.sqrt(z)
        lam = sx * sy + sy * sz + sz * sx
        mu = (x + y + z) / _c(x, 3.0)
        X = 1.0 - x / mu
        Y = 1.0 - y / mu
        Z = 1.0 - z / mu
        eps = ns.maximum(ns.maximum(ns.abs(X), ns.abs(Y)), ns.abs(Z))
        active = active & (eps > thresh)
        x = ns.select(active, (x + lam) * 0.25, x)
        y = ns.select(active, (y + lam) * 0.25, y)
        z = ns.select(active, (z + lam) * 0.25, z)
    mu = (x + y + z) / _c(x, 3.0)
    mu_inv = 1.0 / mu
    X = 1.0 - x * mu_inv
    Y = 1.0 - y * mu_inv
    Z = 1.0 - z * mu_inv
    e2 = X * Y - Z * Z
    e3 = X * Y * Z
    er = ((1.0 / 24.0) * e2 - 0.1 - (3.0 / 44.0) * e3) * e2 + (1.0 / 14.0) * e3
    return ns.sqrt(mu_inv) * (1.0 + er)


def carlson_rd(x, y, z):
    """R_D(x,y,z) = 3/2 int (t+x)^-1/2 (t+y)^-1/2 (t+z)^-3/2 dt
    (special.h:382)."""
    ns, (x, y, z) = _dispatch_many(_POLY, x, y, z)
    x, y, z = ns.broadcast(x, y, z)
    thresh = _carlson_eps(x.dtype) * 0.6

    active = x * 0.0 == 0.0
    s = x * 0.0
    num = x * 0.0 + 1.0
    for _ in range(_CARLSON_ITERS):
        sx, sy, sz = ns.sqrt(x), ns.sqrt(y), ns.sqrt(z)
        lam = sx * sy + sy * sz + sz * sx
        mu = 0.2 * x + 0.2 * y + 0.6 * z
        X = 1.0 - x / mu
        Y = 1.0 - y / mu
        Z = 1.0 - z / mu
        eps = ns.maximum(ns.maximum(ns.abs(X), ns.abs(Y)), ns.abs(Z))
        active = active & (eps > thresh)
        s = ns.select(active, s + num / (sz * (z + lam)), s)
        num = ns.select(active, num * 0.25, num)
        x = ns.select(active, (x + lam) * 0.25, x)
        y = ns.select(active, (y + lam) * 0.25, y)
        z = ns.select(active, (z + lam) * 0.25, z)
    mu = 0.2 * x + 0.2 * y + 0.6 * z
    mu_inv = 1.0 / mu
    X = 1.0 - x * mu_inv
    Y = 1.0 - y * mu_inv
    Z = 1.0 - z * mu_inv
    ea = X * Y
    eb = Z * Z
    ec = ea - eb
    ed = ea - 6.0 * eb
    ee = ed + 2.0 * ec
    # C6 = 1.5 * C4 = 9/52 (Carlson 1979; carlson_rj below uses the same
    # constant -- an earlier 0.25 here cost ~2 ulp at the duplication
    # loop's exit threshold)
    p = (ed * (-(3.0 / 14.0) + (9.0 / 88.0) * ed - (9.0 / 52.0) * Z * ee)
         + Z * ((1.0 / 6.0) * ee + Z * (-(9.0 / 22.0) * ec + Z * (3.0 / 26.0) * ea)))
    return 3.0 * s + num * mu_inv * ns.sqrt(mu_inv) * (1.0 + p)


def carlson_rc(x, y):
    """R_C(x,y) = 1/2 int (t+x)^-1/2 (t+y)^-1 dt (special.h:448)."""
    ns, (x, y) = _dispatch_many(_POLY, x, y)
    x, y = ns.broadcast(x, y)
    thresh = _carlson_eps(x.dtype) * 0.48

    active = x * 0.0 == 0.0
    for _ in range(_CARLSON_ITERS):
        lam = 2.0 * ns.sqrt(x) * ns.sqrt(y) + y
        mu = (x + 2.0 * y) / _c(x, 3.0)
        s = (y - mu) / mu
        active = active & (ns.abs(s) > thresh)
        x = ns.select(active, (x + lam) * 0.25, x)
        y = ns.select(active, (y + lam) * 0.25, y)
    mu = (x + 2.0 * y) / _c(x, 3.0)
    inv_mu = 1.0 / mu
    s = (y - mu) * inv_mu
    return ns.sqrt(inv_mu) * (1.0 + s * s * (0.3 + s * ((1.0 / 7.0) + s * (0.375 + s * (9.0 / 22.0)))))


def carlson_rj(x, y, z, rho):
    """R_J(x,y,z,rho) = 3/2 int [(t+x)(t+y)(t+z)]^-1/2 (t+rho)^-1 dt
    (special.h:499)."""
    ns, (x, y, z, rho) = _dispatch_many(_POLY, x, y, z, rho)
    x, y, z, rho = ns.broadcast(x, y, z, rho)
    thresh = _carlson_eps(x.dtype) * 0.6

    active = x * 0.0 == 0.0
    s = x * 0.0
    num = x * 0.0 + 1.0
    for _ in range(_CARLSON_ITERS):
        sx, sy, sz = ns.sqrt(x), ns.sqrt(y), ns.sqrt(z)
        lam = sx * sy + sy * sz + sz * sx
        mu = (x + y + z + 2.0 * rho) * 0.2
        X = 1.0 - x / mu
        Y = 1.0 - y / mu
        Z = 1.0 - z / mu
        R = 1.0 - rho / mu
        eps = ns.maximum(ns.maximum(ns.abs(X), ns.abs(Y)),
                         ns.maximum(ns.abs(Z), ns.abs(R)))
        active = active & (eps > thresh)
        alpha = rho * (sx + sy + sz) + sx * sy * sz
        alpha = alpha * alpha
        beta = rho * (rho + lam) * (rho + lam)
        s = ns.select(active, s + num * carlson_rc(alpha, beta), s)
        num = ns.select(active, num * 0.25, num)
        x = ns.select(active, (x + lam) * 0.25, x)
        y = ns.select(active, (y + lam) * 0.25, y)
        z = ns.select(active, (z + lam) * 0.25, z)
        rho = ns.select(active, (rho + lam) * 0.25, rho)
    mu = (x + y + z + 2.0 * rho) * 0.2
    mu_inv = 1.0 / mu
    X = 1.0 - x * mu_inv
    Y = 1.0 - y * mu_inv
    Z = 1.0 - z * mu_inv
    R = 1.0 - rho * mu_inv
    ea = X * (Y + Z) + Y * Z
    eb = X * Y * Z
    ec = R * R
    ed = ea - 3.0 * ec
    ee = eb + 2.0 * R * (ea - ec)
    return (3.0 * s + num * mu_inv * ns.sqrt(mu_inv) *
            (1.0 + ed * (-(3.0 / 14.0) + (9.0 / 88.0) * ed - (9.0 / 52.0) * ee)
             + eb * ((1.0 / 6.0) + R * (-(3.0 / 11.0) + R * (3.0 / 26.0)))
             + R * ea * ((1.0 / 3.0) - R * (3.0 / 22.0))
             - (1.0 / 3.0) * R * ec))


# ---------------------------------------------------------------------------
# Elliptic integrals (special.h:570-670). 'k' is the modulus and is squared
# internally (NOT Mathematica's m convention).
# ---------------------------------------------------------------------------


def comp_ellint_1(k):
    ns, k = _dispatch(k)
    return carlson_rf(k * 0.0, 1.0 - k * k, k * 0.0 + 1.0)


def ellint_1(phi, k):
    ns, (phi, k) = _dispatch_many(_POLY, phi, k)
    phi, k = ns.broadcast(phi, k)
    n = ns.floor(phi / _c(phi, math.pi) + 0.5)
    result = ns.select(n != 0.0, comp_ellint_1(k) * n * 2.0, 0.0)
    phi = phi - n * math.pi
    sp, cp = ns.sin_native(phi), ns.cos_native(phi)
    return result + sp * carlson_rf(cp * cp, 1.0 - k * k * sp * sp,
                                    phi * 0.0 + 1.0)


def comp_ellint_2(k):
    ns, k = _dispatch(k)
    k2 = k * k
    zero = k * 0.0
    one = k * 0.0 + 1.0
    return carlson_rf(zero, 1.0 - k2, one) - (1.0 / 3.0) * k2 * carlson_rd(zero, 1.0 - k2, one)


def ellint_2(phi, k):
    ns, (phi, k) = _dispatch_many(_POLY, phi, k)
    phi, k = ns.broadcast(phi, k)
    k2 = k * k
    n = ns.floor(phi / _c(phi, math.pi) + 0.5)
    result = ns.select(n != 0.0, comp_ellint_2(k) * n * 2.0, 0.0)
    phi = phi - n * math.pi
    sp, cp = ns.sin_native(phi), ns.cos_native(phi)
    spk2 = sp * sp * k2
    one = phi * 0.0 + 1.0
    return result + sp * (carlson_rf(cp * cp, 1.0 - spk2, one)
                          - (1.0 / 3.0) * spk2 * carlson_rd(cp * cp, 1.0 - spk2, one))


def comp_ellint_3(k, nu):
    ns, (k, nu) = _dispatch_many(_POLY, k, nu)
    k, nu = ns.broadcast(k, nu)
    k2 = k * k
    zero = k * 0.0
    one = k * 0.0 + 1.0
    return (carlson_rf(zero, 1.0 - k2, one)
            - (1.0 / 3.0) * nu * carlson_rj(zero, 1.0 - k2, one, 1.0 + nu))


def ellint_3(phi, k, nu):
    ns, (phi, k, nu) = _dispatch_many(_POLY, phi, k, nu)
    phi, k, nu = ns.broadcast(phi, k, nu)
    k2 = k * k
    n = ns.floor(phi / _c(phi, math.pi) + 0.5)
    result = ns.select(n != 0.0, comp_ellint_3(k, nu) * n * 2.0, 0.0)
    phi = phi - n * math.pi
    sp, cp = ns.sin_native(phi), ns.cos_native(phi)
    sp2 = sp * sp
    one = phi * 0.0 + 1.0
    return result + sp * (carlson_rf(cp * cp, 1.0 - k2 * sp2, one)
                          - (1.0 / 3.0) * nu * sp2 *
                          carlson_rj(cp * cp, 1.0 - k2 * sp2, one, 1.0 + nu * sp2))


def gamma(x, impl=_NATIVE):
    """Alias of tgamma (the reference exposes both names, special.h:312)."""
    return tgamma(x, impl)
