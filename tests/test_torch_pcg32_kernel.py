"""The pcg32 kernel (csrc/pcg32.cu), the eager CUDA route of ``PCG32``'s
draws, against its plain version, ``PCG32._step``'s op chain: integer
arithmetic and exact subtractions, so every comparison is bit for bit.

On the CPU: a CPU generator and a lazy one take the op chain and launch
no kernel; the wrapper's argument checks. On a card (the ``cuda`` tests,
skipped without one): the kernel's state and draw of each kind equal the
op chain's at ragged and misaligned sizes, with and without a mask, on
states whose step wraps past 2^63 and 2^64; the seeding, ``advance`` and
the bounded draws equal the CPU generator's; one eager step of the
benchmark's histogram mini-app launches the kernel once.

The file imports no JAX, so that the card runs it:
``python -m pytest tests/test_torch_pcg32_kernel.py -m cuda --noconftest
-q``.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from chip_smoke import same_tree  # noqa: E402
from enoki_tpu_torch import _build, trace  # noqa: E402
from enoki_tpu_torch.types import PCG32, PCG32_MULT, u64 as U  # noqa: E402
from enoki_tpu_torch.types.random import (pcg32_next,  # noqa: E402
                                          pcg32_next_plain)

KINDS = ("uint32", "float32", "float64")
DRAWS = ("next_uint32", "next_float32", "next_float64", "next_uint64")
# the lanes of the card tests: one, a ragged pair, a ragged block, and
# more than a wave of blocks with a ragged end
SIZES = (1, 3, 1023, (1 << 20) + 3)
SEED = 0x9E3779B97F4A7C15
M64 = (1 << 64) - 1


def signed(value: int) -> int:
    value &= M64
    return value - (1 << 64) if value >> 63 else value


# states and increments whose step s * MULT + inc wraps past 2^63 and past
# 2^64 (the int64 pattern's sign and its carry out), and the top bits that
# set the rotation (s >> 59 of 0 and 31)
EDGE_STATES = (0, 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, M64, M64 - 1,
               (1 << 59) - 1, 1 << 59, 31 << 59, (M64 // PCG32_MULT) + 1,
               ((1 << 63) // PCG32_MULT) + 1)
EDGE_INCS = (1, M64, (1 << 63) + 1, (1 << 63) - 1, 0xDA3E39CB94B95BDB * 2 + 1)


def lanes(n: int, device, seed: int = 0):
    """``n`` lanes of int64 state and odd increments from numpy, with the
    edge states and increments at the front."""
    rng = np.random.default_rng(seed)
    state = rng.integers(0, 1 << 63, n, dtype=np.int64) * 2 + rng.integers(
        0, 2, n, dtype=np.int64)
    inc = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64) * 2 + 1
    k = min(n, len(EDGE_STATES))
    state[:k] = [signed(v) for v in EDGE_STATES[:k]]
    j = min(n, len(EDGE_INCS))
    inc[:j] = [signed(v) for v in EDGE_INCS[:j]]
    return (torch.from_numpy(state).to(device),
            torch.from_numpy(inc).to(device))


def counted(fn):
    """``fn()`` between two reads of the pcg32 launches: (result, launches
    it made)."""
    before = _build.LAUNCHES["pcg32"]
    out = fn()
    return out, _build.LAUNCHES["pcg32"] - before


# -- the CPU: the op chain, no launch ----------------------------------------


@pytest.mark.parametrize("draw", DRAWS)
def test_a_cpu_generator_launches_nothing(draw):
    (gen, made) = counted(lambda: PCG32.create(257, device="cpu"))
    (value, gen2), drew = counted(lambda: getattr(gen, draw)())
    assert made == drew == 0
    assert value is not None and gen2.state.v.device.type == "cpu"


def host(x):
    """A draw as numpy: a ``U64`` as uint64, a lazy array evaluated."""
    if isinstance(x, U.U64):
        return U.to_py(x)
    return x.numpy() if isinstance(x, torch.Tensor) else x.torch().numpy()


@pytest.mark.parametrize("draw", DRAWS)
def test_a_lazy_generator_records_and_launches_nothing(draw):
    before = _build.LAUNCHES["pcg32"]
    gen = PCG32.create_lazy(257, device="cpu")
    value, gen2 = getattr(gen, draw)()
    trace.eval(value.v if draw == "next_uint64" else value, gen2.state.v)
    assert _build.LAUNCHES["pcg32"] == before
    want, eager = getattr(PCG32.create(257, device="cpu"), draw)()
    assert np.array_equal(host(value), host(want))
    assert np.array_equal(U.to_py(gen2.state), U.to_py(eager.state))
    trace.reset()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_the_plain_version_is_the_generators_cpu_draw(kind, masked):
    state, inc = lanes(1023, "cpu")
    mask = torch.arange(1023) % 3 != 0 if masked else None
    gen = PCG32(U.U64(state), U.U64(inc))
    value, gen2 = getattr(gen, f"next_{kind}")(mask)
    out, new_state = pcg32_next_plain(state, inc, mask, kind)
    assert same_tree(torch, (value, gen2.state.v), (out, new_state))
    if masked:
        assert torch.equal(new_state[~mask], state[~mask])


@pytest.mark.parametrize("args,match", [
    (dict(kind="uint64"), "kind"),
    (dict(state=torch.zeros(4, dtype=torch.int32)), "int64"),
    (dict(inc=torch.ones(4, dtype=torch.uint8)), "int64"),
    (dict(mask=torch.ones(4, dtype=torch.int64)), "bool"),
    (dict(inc=torch.ones(4, dtype=torch.int64, device="meta")), "inc on"),
    (dict(mask=torch.ones(4, dtype=torch.bool, device="meta")), "mask on"),
], ids=["kind", "state_dtype", "inc_dtype", "mask_dtype", "inc_device",
        "mask_device"])
def test_the_kernels_wrapper_refuses_what_the_kernel_does_not_take(
        args, match):
    # each refused before the library is built or loaded
    call = dict(state=torch.zeros(4, dtype=torch.int64),
                inc=torch.ones(4, dtype=torch.int64), mask=None,
                kind="float32")
    call.update(args)
    with pytest.raises(ValueError, match=match):
        pcg32_next(**call)


@pytest.mark.parametrize("draw", DRAWS)
def test_a_state_on_another_device_takes_the_op_chain(draw):
    # only a CUDA state launches the kernel; a meta one runs the op chain
    _build.reset_launch_counts()
    gen = PCG32(U.U64(torch.zeros(4, dtype=torch.int64, device="meta")),
                U.U64(torch.ones(4, dtype=torch.int64, device="meta")))
    value, gen2 = getattr(gen, draw)()
    value = value.lo if draw == "next_uint64" else value
    assert value.device.type == "meta" and tuple(value.shape) == (4,)
    assert gen2.state.v.device.type == "meta"
    assert _build.LAUNCHES["pcg32"] == 0


# -- the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pcg32 kernel has no CPU mode)")
    return torch.device("cuda")


def assert_kernel_is_plain(state, inc, mask, kind):
    """One launch of the kernel gives the op chain's draw and state, bit
    for bit; returns the kernel's draw."""
    _build.reset_launch_counts()
    got = pcg32_next(state, inc, mask, kind)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"pcg32": 1}
    assert _build.ROUTES == {f"pcg32.{kind}": 1}
    assert same_tree(torch, got, pcg32_next_plain(state, inc, mask, kind))
    return got[0]


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_the_kernel_is_the_op_chain_bit_for_bit(cuda, n, kind, masked):
    state, inc = lanes(n, cuda, seed=n)
    mask = (torch.arange(n, device=cuda) % 3 != 1) if masked else None
    before = state.clone(), inc.clone()
    assert_kernel_is_plain(state, inc, mask, kind)
    # the functional API: the old state and increment are not written
    assert torch.equal(state, before[0]) and torch.equal(inc, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("offset", [1, 3])
def test_a_misaligned_view_takes_the_scalar_path_with_the_same_bits(
        cuda, kind, offset):
    state, inc = lanes(4099, cuda, seed=offset)
    mask = torch.arange(4099, device=cuda) % 5 != 0
    assert_kernel_is_plain(state[offset:], inc[offset:], mask[offset:], kind)
    # the increment aligned where the state is not
    assert_kernel_is_plain(state[offset:], inc[:-offset], None, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_a_broadcast_increment_and_a_strided_state(cuda, kind):
    state, inc = lanes(2 * 1025, cuda)
    one = inc[:1].reshape(())
    out = assert_kernel_is_plain(state[::2], one,
                                 torch.tensor(True, device=cuda), kind)
    assert out.shape == (1025,)


@pytest.mark.cuda
def test_no_lanes_launch_nothing(cuda):
    _build.reset_launch_counts()
    state = torch.zeros(0, dtype=torch.int64, device=cuda)
    out, new_state = pcg32_next(state, state, None, "float32")
    assert out.shape == new_state.shape == (0,)
    assert _build.LAUNCHES["pcg32"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("initstate", [SEED, 0, M64])
def test_seeding_on_the_card_is_two_launches_and_the_cpus_state(cuda,
                                                                initstate):
    _build.reset_launch_counts()
    gen = PCG32.create((1 << 16) + 1, initstate=initstate, device=cuda)
    assert _build.ROUTES == {"pcg32.uint32": 2}
    cpu = PCG32.create((1 << 16) + 1, initstate=initstate, device="cpu")
    assert same_tree(torch, gen, cpu)
    for draw in DRAWS:
        got, want = getattr(gen, draw)(), getattr(cpu, draw)()
        assert same_tree(torch, got, want)
        (_, gen), (_, cpu) = got, want
    # next_uint64 is two 32-bit draws
    assert _build.ROUTES == {"pcg32.uint32": 5, "pcg32.float32": 1,
                             "pcg32.float64": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("delta", [1, 12345678901234, -100, 1 << 63])
def test_advance_then_a_draw_is_the_cpus(cuda, delta):
    gen = PCG32.create(4097, device=cuda).advance(delta)
    cpu = PCG32.create(4097, device="cpu").advance(delta)
    for kind in KINDS:
        got = getattr(gen, f"next_{kind}")()
        want = getattr(cpu, f"next_{kind}")()
        assert same_tree(torch, got, want)
        (_, gen), (_, cpu) = got, want


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_the_bounded_draws_are_the_cpus(cuda, masked):
    n = 4097
    mask = torch.arange(n) % 4 != 2 if masked else None
    gen, cpu = PCG32.create(n, device=cuda), PCG32.create(n, device="cpu")
    card_mask = None if mask is None else mask.to(cuda)
    for bound in (7, (1 << 31) + 12345):
        got = gen.next_uint32_bounded(bound, card_mask)
        want = cpu.next_uint32_bounded(bound, mask)
        assert same_tree(torch, got, want)
        (_, gen), (_, cpu) = got, want
    _build.reset_launch_counts()
    assert same_tree(torch, gen.next_uint64_bounded((1 << 62) + 3, card_mask),
                     cpu.next_uint64_bounded((1 << 62) + 3, mask))
    assert set(_build.ROUTES) == {"pcg32.uint32"}


@pytest.mark.cuda
def test_one_eager_histogram_step_launches_the_kernel_once(cuda):
    cfg = json.loads((ROOT / "benchmark" / "configs" /
                      "histogram.json").read_text())
    program = harness.load_module(ROOT / "benchmark" / "configs" /
                                  "histogram.py", "histogram_pcg32_program")
    prog = program.Program(cfg, cuda)
    prog.path, prog.initstate = "eager", SEED
    m = prog.model(torch.tensor(cfg["base"]), 1 << 16)
    state = m.state()
    _build.reset_launch_counts()
    with torch.no_grad():
        m()
    assert _build.ROUTES == {"pcg32.float32": 1}
    assert _build.LAUNCHES["pcg32"] == 1
    _, want = pcg32_next_plain(state, m.gen.inc.v, None, "uint32")
    assert torch.equal(m.state(), want)
