"""The port's ops/rounding.py against the reference's on the same seeded
numpy inputs.

Tolerances: the lanewise roundings and the directed-rounding family are
exact (the same IEEE operations in the same order). ``stochastic_round``
is handed the reference key's own random bits and is then bit-equal in
bfloat16 and equal in float16, NaN standing for NaN. The Philox words are
integers: exact against the Random123 known answer and an independent
numpy implementation. Statistical gates state their standard deviation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enoki_tpu.ops import rounding as JR
from enoki_tpu_torch import ops as TO
from enoki_tpu_torch.ops import rounding as TR


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _values(n=20000, seed=0):
    """Seeded normal data over many binades, with the awkward values mixed
    in: NaN, infinities, signed zeros, subnormals of f32, and values near
    the ends of float16's range."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-12, 12, n))).astype(
        np.float32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-41,
                        65504.0, 65519.9, 65520.0, 7e4, -65519.9, 6e-8,
                        5.9e-8, 1e-10, -1e-10, 3.4e38, -3.4e38, 1.0,
                        1.0 + 2.0 ** -8, 2.0 ** -14, 2.0 ** -24, 2.0 ** -25],
                       np.float32)
    x[:special.size] = special
    return x


# -- lanewise roundings ---------------------------------------------------------


@pytest.mark.parametrize("name", ["round_", "round_half_away", "floor",
                                  "ceil", "trunc"])
def test_lanewise_roundings(name):
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.uniform(-1000, 1000, 5000),
        np.arange(-10, 10) + 0.5, np.arange(-10, 10),
        [0.49999997, -0.49999997, 8388607.5, -8388607.5, 1e20, -0.0]
    ]).astype(np.float32)
    got = getattr(TR, name)(_t(x)).numpy()
    want = np.asarray(getattr(JR, name)(jnp.asarray(x)))
    assert np.array_equal(got, want)
    assert np.array_equal(np.signbit(got), np.signbit(want))
    assert getattr(TO, name) is getattr(TR, name)


def test_rounding_modes_on_halves():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5])
    assert TR.round_(x).tolist() == [0, 2, 2, -0, -2]  # half to even
    assert TR.round_half_away(x).tolist() == [1, 2, 3, -1, -2]


# -- stochastic rounding with the reference key's bits ---------------------------


def _same(got, want):
    """Equal values, any NaN standing for any NaN, zeros by their sign."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(got)
    return (np.array_equal(nan, np.isnan(want))
            and np.array_equal(got[~nan], want[~nan])
            and np.array_equal(np.signbit(got[~nan]), np.signbit(want[~nan])))


def test_stochastic_round_bf16_bit_equal_with_the_reference_bits():
    x = _values()
    key = jax.random.key(3)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
    want = JR.stochastic_round(jnp.asarray(x), key, jnp.bfloat16)
    got = TR.stochastic_round_from_bits(_t(x), _t(bits.astype(np.int64)),
                                        torch.bfloat16)
    assert got.dtype == torch.bfloat16 and not got.requires_grad
    gb = got.view(torch.int16).numpy().view(np.uint16)
    wb = np.asarray(want).view(np.uint16)
    nan = np.isnan(x)
    assert np.array_equal(gb[~nan], wb[~nan])
    assert np.isnan(got.float().numpy()[nan]).all()
    # the same words as an int32 bit pattern
    got32 = TR.stochastic_round_from_bits(
        _t(x), _t(bits.view(np.int32).copy()), torch.bfloat16)
    assert _same(got.float(), got32.float())


def test_stochastic_round_f16_equal_with_the_reference_uniforms():
    x = _values()
    key = jax.random.key(4)
    # the reference draws u = (23 random bits) * 2**-23; a word whose top
    # 24 bits are those 23 and a zero gives the port the same u
    u = np.asarray(jax.random.uniform(key, x.shape))
    words = np.round(u.astype(np.float64) * 2 ** 23).astype(np.int64) << 9
    want = JR.stochastic_round(jnp.asarray(x), key, jnp.float16)
    got = TR.stochastic_round_from_bits(_t(x), _t(words), torch.float16)
    assert got.dtype == torch.float16
    assert _same(got.float().numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype,np_dtype", [(torch.bfloat16, None),
                                            (torch.float16, np.float16)])
def test_stochastic_round_gives_a_neighbour_and_x_in_the_mean(dtype,
                                                              np_dtype):
    x = _values(4000, seed=5)
    fin = np.isfinite(x) & (np.abs(x) < 6e4)
    x = x[fin]
    gen = torch.Generator().manual_seed(11)
    draws = torch.stack([TR.stochastic_round(_t(x), gen, dtype).float()
                         for _ in range(64)]).numpy().astype(np.float64)
    # the two neighbours: x rounded toward zero and away from it
    if dtype == torch.bfloat16:
        t = _t(x)
        down = (t.view(torch.int32) & -65536).view(torch.float32).numpy()
        up = ((t.view(torch.int32) + 65535) & -65536).view(
            torch.float32).numpy()
    else:
        near = x.astype(np_dtype)
        away = np.nextafter(near, np.where(np.signbit(x), -np.inf,
                                           np.inf).astype(np_dtype))
        toward = np.nextafter(near, np_dtype(0))
        mag = np.abs(near.astype(np.float32))
        down = np.where(mag <= np.abs(x), near, toward).astype(np.float32)
        up = np.where(mag >= np.abs(x), near, away).astype(np.float32)
    down, up = down.astype(np.float64), up.astype(np.float64)
    assert (np.abs(down) <= np.abs(x)).all() and (np.abs(x) <= np.abs(up)).all()
    assert ((draws == down) | (draws == up)).all()
    exact = down == up
    assert (draws[:, exact] == x[exact]).all()
    # the mean of 64 draws: a two-point variable's standard deviation is
    # at most half the gap, so the mean's is gap / 16; gate at 6 of them
    gap = np.abs(up - down)
    assert (np.abs(draws.mean(0) - x) <= 6 * gap / 16 + 1e-45).all()
    # a generator gives a stream: equal seeds equal bits, next draw differs
    a = TR.stochastic_round(_t(x), torch.Generator().manual_seed(11), dtype)
    assert np.array_equal(a.float().numpy(), draws[0])
    assert not np.array_equal(draws[0], draws[1])


def test_stochastic_round_on_the_reference_test_value():
    # 1 + 1/512 lies a quarter of the way between two bfloat16 values
    n = 200_000
    x = torch.full((n,), 1.0 + 1 / 512)
    r = TR.stochastic_round(x, torch.Generator().manual_seed(0)).float()
    assert sorted(np.unique(r.numpy()).tolist()) == [1.0, 1.0 + 2.0 ** -7]
    # the share rounded up: binomial, standard deviation 9.7e-4
    assert abs((r > 1.0).float().mean().item() - 0.25) < 5e-3
    assert abs(r.mean().item() - (1.0 + 1 / 512)) < 1e-4
    r = TR.stochastic_round_cuda(x, 7).float()  # the plain version here
    assert abs((r > 1.0).float().mean().item() - 0.25) < 5e-3
    assert abs(r.double().mean().item() - (1.0 + 1 / 512)) < 1e-4
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        TR.stochastic_round(x, torch.Generator(), torch.float32)


# -- Philox ---------------------------------------------------------------------


def _philox_numpy(counter, key):
    """Philox4x32-10 in numpy uint64, after the Random123 reference code:
    counter (4,) and key (2,) of 32-bit words -> (4,) words."""
    c = [np.uint64(v) for v in counter]
    k = [np.uint64(v) for v in key]
    m32 = np.uint64(0xFFFFFFFF)
    for r in range(10):
        if r:
            k = [(k[0] + np.uint64(0x9E3779B9)) & m32,
                 (k[1] + np.uint64(0xBB67AE85)) & m32]
        p0 = np.uint64(0xD2511F53) * c[0]
        p1 = np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k[0], p1 & m32,
             (p0 >> np.uint64(32)) ^ c[3] ^ k[1], p0 & m32]
    return [int(v) for v in c]


def test_philox_known_answers():
    z = torch.zeros(1, dtype=torch.int64)
    got = [int(w) for w in TR.philox4x32(z, z, z, z, 0, 0)]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    f = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    got = [int(w) for w in TR.philox4x32(f, f, f, f, 0xFFFFFFFF, 0xFFFFFFFF)]
    assert got == _philox_numpy([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2)
    assert got == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def test_philox_words_against_numpy():
    rng = np.random.default_rng(9)
    for seed in (0, 1, 0xDEADBEEFCAFEF00D, -1, 1 << 63):
        words = TR.philox_words(41, seed, "cpu")
        assert words.dtype == torch.int64 and words.shape == (41,)
        s = seed & ((1 << 64) - 1)
        want = []
        for g in range(11):
            want += _philox_numpy([g, 0, 0, 0], [s & 0xFFFFFFFF, s >> 32])
        assert words.tolist() == want[:41]
    # a counter beyond 32 bits feeds the second counter word
    c = torch.from_numpy(rng.integers(0, 1 << 32, (4, 50)).astype(np.int64))
    got = torch.stack(TR.philox4x32(*c, 12345, 67890), 1).tolist()
    for i in range(50):
        assert got[i] == _philox_numpy(c[:, i].tolist(), [12345, 67890])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_stochastic_round_plain_is_a_function_of_x_and_seed(dtype):
    x = _t(_values(1027, seed=6))
    a = TR.stochastic_round_plain(x, 99, dtype)
    assert a.dtype == dtype and a.shape == x.shape
    assert _same(a.float(), TR.stochastic_round_cuda(x, 99, dtype).float())
    assert not _same(a.float(), TR.stochastic_round_plain(x, 100,
                                                          dtype).float())
    # element i takes word i % 4 of block i // 4, whatever the length
    assert _same(a[:515].float(),
                 TR.stochastic_round_plain(x[:515], 99, dtype).float())
    words = TR.philox_words(1027, 99, "cpu")
    assert _same(a.float(),
                 TR.stochastic_round_from_bits(x, words, dtype).float())
    assert TR.stochastic_round_cuda(x[:0], 1, dtype).shape == (0,)
    with pytest.raises(ValueError, match="1-D"):
        TR.stochastic_round_cuda(x.reshape(13, 79), 1, dtype)
    y = x.clone().requires_grad_(True)
    assert not TR.stochastic_round_cuda(y, 1, dtype).requires_grad


# -- directed rounding -------------------------------------------------------------


DIRECTED = ["add_up", "add_down", "sub_up", "sub_down", "mul_up", "mul_down",
            "div_up", "div_down"]


def _pairs():
    rng = np.random.default_rng(0)
    a = rng.normal(scale=10, size=5000).astype(np.float32)
    b = rng.normal(scale=1e-5, size=5000).astype(np.float32)
    # no subnormal operand: the reference's CPU backend flushes them to
    # zero, PyTorch's computes with them
    edge = np.array([0.0, -0.0, 3.4e38, -3.4e38, np.inf, -np.inf, np.nan,
                     1.0, 1e-30, 3e38], np.float32)
    a[:10] = edge
    b[:10] = [1.0, 2.0, 3.4e38, 3.4e38, 1.0, 0.0, 1.0, 0.0, 1e-30, -10.0]
    return a, b


@pytest.mark.parametrize("name", DIRECTED)
def test_directed_rounding_equals_the_reference(name):
    a, b = _pairs()
    got = getattr(TR, name)(_t(a), _t(b)).numpy()
    want = np.asarray(getattr(JR, name)(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == np.float32
    assert np.array_equal(got, want, equal_nan=True)
    # Python numbers are taken in float32
    assert np.array_equal(
        getattr(TR, name)(_t(a), 3.3).numpy(),
        np.asarray(getattr(JR, name)(jnp.asarray(a), 3.3)), equal_nan=True)


@pytest.mark.parametrize("name", ["sqrt_up", "sqrt_down"])
def test_directed_sqrt_equals_the_reference(name):
    a, _ = _pairs()
    a = np.abs(a)
    got = getattr(TR, name)(_t(a)).numpy()
    want = np.asarray(getattr(JR, name)(jnp.asarray(a)))
    assert np.array_equal(got, want, equal_nan=True)


def test_directed_bounds_are_sound():
    # against float64 ground truth: add/sub correctly rounded (two-sum),
    # mul/div/sqrt at most one ulp wider than optimal
    rng = np.random.default_rng(0)
    a = rng.normal(scale=10, size=5000).astype(np.float32)
    b = rng.normal(scale=1e-5, size=5000).astype(np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    for name, true in (("add", a64 + b64), ("sub", a64 - b64),
                       ("mul", a64 * b64), ("div", a64 / b64)):
        up = getattr(TR, name + "_up")(_t(a), _t(b)).numpy().astype(
            np.float64)
        dn = getattr(TR, name + "_down")(_t(a), _t(b)).numpy().astype(
            np.float64)
        assert (up >= true).all() and (dn <= true).all(), name
        width = 1 if name in ("add", "sub") else 2
        sp = np.spacing(np.abs(true).astype(np.float32)).astype(np.float64)
        assert (up - true <= width * sp).all(), name
        assert (true - dn <= width * sp).all(), name
    x = np.abs(a) + np.float32(0.1)
    true = np.sqrt(x.astype(np.float64))
    assert (TR.sqrt_up(_t(x)).numpy() >= true).all()
    assert (TR.sqrt_down(_t(x)).numpy() <= true).all()
    # overflow on finite inputs clamps to the bound that stays sound
    big = torch.tensor([3e38, -3e38])
    assert TR.add_down(big, big).tolist() == [pytest.approx(3.4028235e38),
                                              -np.inf]
    assert TR.add_up(big, big).tolist() == [np.inf,
                                            pytest.approx(-3.4028235e38)]
    assert TR.mul_up(torch.tensor([0.0]), torch.tensor([5.0])).item() == 0.0
