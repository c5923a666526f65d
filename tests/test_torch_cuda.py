"""The port's CUDA kernels against their plain PyTorch versions on a card.

Imports torch and the port only (no JAX), so that it runs where the card
is:  python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
Every test here skips where torch.cuda.is_available() is false. The scene
recipe is shared with the CPU parity tests.
"""

import numpy as np
import pytest
import torch

from enoki_tpu_torch.render import LAUNCHES, reset_launch_counts
from enoki_tpu_torch.render.sdf_kernels import (
    render_sdf_cuda, sdf_bwd, sdf_bwd_plain, sdf_fwd, sdf_fwd_plain)
from enoki_tpu_torch.render.sphere_kernels import (
    render_sphere_cuda, sphere_bwd, sphere_bwd_plain, sphere_fwd,
    sphere_fwd_plain)

SCENES = {"reference": None, "seed1": 1, "seed2": 2}
N = 256
STEPS = 64


def scene_vec(seed):
    """The reference scene's 16-vector (seed None), or a seeded
    perturbation of it: center +-0.1, radius 0.8-1.1, a random light."""
    v = np.zeros(16, np.float32)
    v[:9] = [0, 0, 0, 1.0, 0.2, 90.0, -1.0, -1.0, 2.0]
    if seed is not None:
        rng = np.random.default_rng(seed)
        v[0:3] = rng.uniform(-0.1, 0.1, 3)
        v[3] = rng.uniform(0.8, 1.1)
        v[6:9] = rng.uniform(-2.0, 2.0, 3)
    return v


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(params=list(SCENES), ids=list(SCENES))
def params(request, cuda):
    return torch.from_numpy(scene_vec(SCENES[request.param])).to(cuda)


@pytest.mark.cuda
def test_sdf_fwd_kernel_matches_plain(params):
    img_k, ts_k = sdf_fwd(params, N, STEPS, 1.2)
    img_p, ts_p = sdf_fwd_plain(params, N, STEPS, 1.2)
    torch.cuda.synchronize()
    # the kernel's march rounds each product and sum as the plain version
    # does, so it walks the same trajectory: no pixel flips between hit
    # and miss, and the image agrees to the reference's atol
    assert torch.equal(ts_k >= 0, ts_p >= 0)
    assert (img_k - img_p).abs().max().item() <= 1e-3
    assert (ts_k - ts_p).abs().max().item() <= 2e-4


@pytest.mark.cuda
def test_sdf_bwd_kernel_matches_plain_and_is_deterministic(params):
    _, ts = sdf_fwd(params, N, STEPS, 1.2)
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (N, N)).astype(np.float32)).to(params.device)
    dp1 = sdf_bwd(params, g, ts, N, 1.2)
    dp2 = sdf_bwd(params, g, ts, N, 1.2)
    ref = sdf_bwd_plain(params, g, ts, N, 1.2)
    torch.cuda.synchronize()
    assert torch.equal(dp1, dp2)
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(dp1, ref, rtol=2e-4, atol=2e-4 * scale)


@pytest.mark.cuda
def test_render_sdf_cuda_launches_one_of_each(cuda):
    p = torch.from_numpy(scene_vec(None)).to(cuda).requires_grad_(True)
    reset_launch_counts()
    render_sdf_cuda(p, N, STEPS).mean().backward()
    torch.cuda.synchronize()
    assert LAUNCHES == {"sdf_fwd": 1, "sdf_bwd": 1, "sdf_bwd_reduce": 1}
    assert torch.isfinite(p.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sphere_fwd_kernel_is_bit_equal_to_plain(params, dtype):
    # the kernel rounds each op as PyTorch's eager ops round it, in the
    # reference's order and dtype policy
    img_k = sphere_fwd(params, N, 1.2, dtype)
    img_p = sphere_fwd_plain(params, N, 1.2, dtype)
    torch.cuda.synchronize()
    assert img_k.dtype == dtype and img_k.shape == (N, N)
    assert torch.equal(img_k, img_p)


@pytest.mark.cuda
def test_sphere_bwd_kernel_matches_plain_and_is_deterministic(params):
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (N, N)).astype(np.float32)).to(params.device)
    dp1 = sphere_bwd(params, g, N, 1.2)
    dp2 = sphere_bwd(params, g, N, 1.2)
    ref = sphere_bwd_plain(params, g, N, 1.2)
    # a bf16 cotangent is upcast: the same gradient as its f32 value
    gb = g.to(torch.bfloat16)
    dpb = sphere_bwd(params, gb, N, 1.2)
    torch.cuda.synchronize()
    assert torch.equal(dp1, dp2)
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(dp1, ref, rtol=2e-4, atol=2e-4 * scale)
    assert torch.equal(dpb, sphere_bwd(params, gb.float(), N, 1.2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_render_sphere_cuda_launches_one_of_each(cuda, dtype):
    p = torch.from_numpy(scene_vec(None)).to(cuda).requires_grad_(True)
    reset_launch_counts()
    render_sphere_cuda(p, N, dtype=dtype).float().mean().backward()
    torch.cuda.synchronize()
    fwd = "sphere_fwd" if dtype == torch.float32 else "sphere_fwd_bf16"
    assert LAUNCHES == {fwd: 1, "sphere_bwd": 1, "sphere_bwd_reduce": 1}
    assert torch.isfinite(p.grad).all()
