"""types/sh.py of the port against the reference's (enoki_tpu.types.sh)
on the same seeded numpy inputs, and under the gates of the reference's
own test against scipy (tests/test_sh.py:34-72).

Tolerances: bit-equal to the reference's, dtype included, at every order
0..9 in float32 and float64 (IEEE arithmetic only; the constants K_l^m
are the same Python doubles); against scipy's Y_l^m, the reference's
gates (band 1 atol 1e-6, m = 0 atol 2e-4, m != 0 atol 2e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from enoki_tpu.types.sh import sh_eval as j_sh_eval
from enoki_tpu.types.sh import sh_eval_stacked as j_sh_eval_stacked
from enoki_tpu_torch.types.sh import _K, sh_eval, sh_eval_stacked

from test_sh import _Y, _dirs


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("order", range(10))
def test_sh_is_bit_equal_to_the_reference(order):
    v = _dirs(2000, seed=order).astype(np.float32)
    got = sh_eval_stacked(*(_t(v[:, i]) for i in range(3)), order)
    want = np.asarray(j_sh_eval_stacked(*(jnp.asarray(v[:, i])
                                          for i in range(3)), order))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    outs = sh_eval(*(_t(v[:, i]) for i in range(3)), order)
    assert len(outs) == (order + 1) ** 2
    assert all(torch.equal(o, got[:, i]) for i, o in enumerate(outs))


def test_sh_float64_and_mixed_operands_match_the_reference():
    # float64 against the reference with JAX's 64-bit types on
    v = _dirs(500, seed=11)
    got = sh_eval_stacked(*(_t(v[:, i]) for i in range(3)), 6)
    assert got.dtype == torch.float64
    with jax.enable_x64(True):
        want = np.asarray(j_sh_eval_stacked(*(jnp.asarray(v[:, i])
                                              for i in range(3)), 6))
        # a float64 z beside float32 x and y promotes every band at once
        x, y = (v[:, i].astype(np.float32) for i in range(2))
        mixed = np.asarray(j_sh_eval_stacked(jnp.asarray(x), jnp.asarray(y),
                                             jnp.asarray(v[:, 2]), 4))
    np.testing.assert_array_equal(got.numpy(), want)
    got = sh_eval_stacked(_t(x), _t(y), _t(v[:, 2]), 4)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), mixed)
    # a Python number takes the tensors' dtype
    z = v[:, 2].astype(np.float32)
    got = sh_eval_stacked(0.5, _t(y), _t(z), 3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_sh_eval_stacked(0.5, jnp.asarray(y),
                                                  jnp.asarray(z), 3)))


def test_band1_matches_reference_convention():
    # tests/test_sh.py:34-46
    v = _dirs(100)
    out = sh_eval(*(_t(v[:, i].astype(np.float32)) for i in range(3)), 1)
    c = 0.4886025119029199
    assert np.allclose(out[0].numpy(), 0.28209479177387814)
    assert np.allclose(out[1].numpy(), -c * v[:, 1], atol=1e-6)
    assert np.allclose(out[2].numpy(), c * v[:, 2], atol=1e-6)
    assert np.allclose(out[3].numpy(), -c * v[:, 0], atol=1e-6)
    assert _K(1, 1) == _K(1, -1)


@pytest.mark.parametrize("order", [0, 2, 4, 9])
def test_vs_scipy(order):
    # tests/test_sh.py:49-67
    v = _dirs(200, seed=order)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    polar = np.arccos(np.clip(z, -1, 1))
    az = np.arctan2(y, x)
    out = sh_eval_stacked(*(_t(c.astype(np.float32)) for c in (x, y, z)),
                          order).numpy()
    for l in range(order + 1):  # noqa: E741
        assert np.allclose(out[:, l * (l + 1)], _Y(0, l, polar, az).real,
                           atol=2e-4), (l, 0)
        for m in range(1, l + 1):
            ym = _Y(m, l, polar, az)
            assert np.allclose(out[:, l * (l + 1) + m], np.sqrt(2) * ym.real,
                               atol=2e-3), (l, m)
            assert np.allclose(out[:, l * (l + 1) - m], np.sqrt(2) * ym.imag,
                               atol=2e-3), (l, -m)


def test_order_too_high():
    with pytest.raises(ValueError):
        sh_eval(torch.ones(1), torch.ones(1), torch.ones(1), 10)
    with pytest.raises(ValueError):
        j_sh_eval(jnp.ones(1), jnp.ones(1), jnp.ones(1), 10)
