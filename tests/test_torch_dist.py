"""The port's dist/ against the reference's (tests/test_dist.py), under
the reference's own gates.

One spawned world of four ``gloo`` processes (a 2x2 mesh) runs every
check of the port once (tests/torch_dist_world.py) and hands numpy
results back; the reference runs here, on ``make_mesh(4)`` of the 8
virtual CPU devices (tests/conftest.py). ``measured_weak_scaling`` spawns
worlds of its own. Every world has a 60 s init timeout, a FileStore under
tmp_path as its rendezvous and a deadline after which it is killed.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import enoki_tpu.dist as JD
from enoki_tpu.dist.render import mse_loss as j_mse_loss
from enoki_tpu.render import SphereScene as JScene, render_fused as j_fused
from enoki_tpu.render.vec import Vec3 as JVec3
from enoki_tpu_torch import dist as D
from enoki_tpu_torch.dist import bench_scaling as bs
from enoki_tpu_torch.dist._world import run_world
from enoki_tpu_torch.dist.mesh import _factor2

import torch_dist_world as W

WORLD = 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist")
    return run_world("torch_dist_world:world_checks", WORLD,
                     (str(root / "fit"),), store_dir=str(root),
                     deadline_s=240)


@pytest.fixture(scope="module")
def rank0(world):
    return world[0]


def j_scene(center, radius, ambient, gain, light=(-1.0, -1.0, 2.0)):
    f = jnp.float32
    return JScene(center=JVec3(*map(f, center)), radius=f(radius),
                  ambient=f(ambient), gain=f(gain), light=JVec3(*map(f, light)))


@pytest.fixture(scope="module")
def reference():
    """The reference's image, losses and gradient on its 4-device mesh."""
    mesh = JD.make_mesh(4)
    out = {"image": np.asarray(JD.render_sharded(JScene.reference(), 256,
                                                 mesh))}
    n = 128
    target = jnp.asarray(np.asarray(j_fused(JScene.reference(), n))
                         .reshape(n, n))
    init = j_scene(**W.PERTURBED)
    opt = optax.sgd(0.0)
    tgt = jax.device_put(target, JD.image_sharding(mesh))
    for name, maker in (("gspmd", JD.make_train_step),
                        ("shardmap", JD.make_train_step_shardmap)):
        _, _, loss = maker(n, mesh, opt)(init, tgt, opt.init(init))
        out[f"loss_{name}"] = float(loss)
    g = jax.grad(lambda s: j_mse_loss(s, target, n))(init)
    out["grad"] = np.array([float(x) for x in jax.tree_util.tree_leaves(g)])
    return out


# -- the mesh ---------------------------------------------------------------------


def test_factor2_is_the_references():
    assert _factor2(8) == (4, 2) == JD.mesh._factor2(8)
    assert [_factor2(k) for k in range(1, 17)] == \
        [JD.mesh._factor2(k) for k in range(1, 17)]


def test_world_mesh_shape_and_names(world):
    assert [r["mesh_shape"] for r in world] == [(2, 2)] * WORLD
    assert world[0]["mesh_names"] == ("dp", "sp")
    # rows over dp, columns over sp; the inner axis runs over consecutive
    # ranks
    assert [r["coordinate"] for r in world] == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]


def test_ranks_outside_a_smaller_mesh_sit_out(world):
    assert [r["sub_coordinate"] for r in world] == [(0, 0), (1, 0), None,
                                                    None]
    assert world[2]["sub_image"] is None and world[2]["sub_fit"] is None
    assert world[0]["sub_image"].shape == (16, 16)
    assert np.isfinite(world[0]["sub_fit"])


# -- the sharded render --------------------------------------------------------------


def test_render_sharded_is_a_dtensor_over_the_mesh(world):
    for r in world:
        assert r["is_dtensor"] and r["local_shape"] == (128, 128)
        assert r["placements"] == ["S(0)", "S(1)"]


def test_render_sharded_matches_the_reference(rank0, reference):
    d = np.abs(rank0["image"] - reference["image"])
    # tests/test_dist.py:32-34
    assert d.max() < 5e-3 and d.mean() < 1e-4, (d.max(), d.mean())


def test_render_sharded_is_bit_equal_to_render_fused(world):
    for r in world:
        assert np.array_equal(r["image"], r["fused"])


# -- the train steps ------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["gspmd", "shardmap"])
def test_train_step_loss_matches_the_reference(world, reference, strategy):
    losses = {r[f"loss_{strategy}"] for r in world}
    assert len(losses) == 1  # the reduced loss, on every rank
    got = losses.pop()
    assert np.isclose(got, reference[f"loss_{strategy}"], rtol=1e-4)


def test_the_two_steps_agree(rank0):
    # tests/test_dist.py:53-58
    assert np.isclose(rank0["loss_gspmd"], rank0["loss_shardmap"],
                      rtol=1e-4)
    assert rank0["loss_dtensor_target"] == rank0["loss_gspmd"]


@pytest.mark.parametrize("strategy", ["gspmd", "shardmap"])
def test_step_gradient_matches_jax_grad(world, reference, strategy):
    # tests/test_dist.py:60-75: SGD(1) moves each leaf by exactly -grad
    g = reference["grad"]
    g_scale = np.abs(g).max()
    for r in world:
        np.testing.assert_allclose(r[f"grad_{strategy}"], g, rtol=1e-3,
                                   atol=1e-5 * g_scale)


def test_inverse_rendering_recovers_radius(rank0):
    # tests/test_dist.py:78-94
    assert rank0["fit_loss"] < 10.0
    assert abs(rank0["fit_radius"] - 1.0) < 0.02, rank0["fit_radius"]


def test_fit_scene_checkpoint_resume(world):
    # tests/test_dist.py:97-117, and the resumed run bitwise the straight
    for r in world:
        assert r["latest_after_4"] == 4 and r["latest_after_6"] == 6
        assert np.isfinite(r["resumed_loss"])
        assert np.array_equal(r["resumed"], r["straight"])
    assert not np.array_equal(world[0]["resumed"],
                              np.asarray([0, 0, 0, 0.75, 0.2, 90.0, -1, -1,
                                          2.0], np.float32))


# -- collectives and the efficiency model -----------------------------------------


def test_collective_payload_is_the_parameters(rank0):
    # tests/test_dist.py:120-137: <= 64 bytes, the same at two resolutions
    nd, nbytes, shapes, flops = rank0["payload_64"]
    assert nd == WORLD and nbytes <= 64 and shapes == ["f32[10]"]
    assert rank0["payload_128"][1] == nbytes
    assert flops is None


@pytest.mark.parametrize("n,n_devices,mode,gate", [
    (1024, 8, "weak", ">= 0.95"), (1024, 16, "weak", ">= 0.90"),
    (4096, 8, "strong", ">= 0.95"), (1024, 256, "strong", "< 0.5")])
def test_predicted_efficiency_meets_the_references_thresholds(
        rank0, n, n_devices, mode, gate):
    # tests/test_dist.py:139-149, with the H100's constants
    eff = bs.predicted_efficiency(n, n_devices, rank0["payload_64"][1],
                                  mode=mode)
    op, bound = gate.split()
    assert (eff >= float(bound)) if op == ">=" else (eff < float(bound)), \
        eff


def test_schedule_overlap_report(world):
    # tests/test_dist.py:152-170
    for r in world:
        rep = r["report"]
        assert rep.ok and rep.n_allreduce == 1, rep
        assert rep.trailing_total > 0 and rep.comm_share <= 0.10, rep


def test_measured_weak_scaling_rows_and_square_policy(capsys, tmp_path):
    # tests/test_dist.py:204-224, without its wall-clock ratio (which
    # fails under a loaded CPU)
    rows = bs.measured_weak_scaling(device_counts=(1, 2, 4), tile=32,
                                    iters=2, timeshare=True, device="cpu",
                                    store_dir=str(tmp_path))
    err = capsys.readouterr().err
    assert "skipping n_devices=2" in err and "square" in err
    assert [r[0] for r in rows] == [1, 4]
    nd, n, rps, eff = rows[1]
    assert nd == 4 and n == 64 and rps > 0 and eff > 0


# -- the entry points ---------------------------------------------------------------


@pytest.fixture
def no_cluster(monkeypatch):
    for k in D.mesh.CLUSTER_VARS + ("MASTER_PORT", "SLURM_NTASKS",
                                    "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_init_distributed_makes_a_world_of_one(no_cluster):
    with pytest.warns(UserWarning, match="a world of one"):
        assert D.init_distributed(device="cpu") == 1
    assert dist.get_backend() == "gloo"
    mesh = D.make_mesh(device="cpu")
    assert tuple(mesh.shape) == (1, 1)
    # a world of one: the sharded image is render_fused's
    from enoki_tpu_torch.render import SphereScene, render_fused
    scene = SphereScene.reference("cpu")
    img = D.render_sharded(scene, 32, mesh).full_tensor()
    assert torch.equal(img, render_fused(scene, 32).reshape(32, 32))
    with pytest.raises(ValueError):
        D.make_mesh(2, device="cpu")


@pytest.mark.parametrize("env,kw", [
    ({"WORLD_SIZE": "2", "RANK": "0"}, {}),
    ({"SLURM_JOB_ID": "7"}, {}),
    ({}, {"num_processes": 2}),
    ({}, {"coordinator_address": "localhost:1"})])
def test_init_distributed_raises_where_a_cluster_fails(no_cluster,
                                                       monkeypatch, env,
                                                       kw):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError):
        D.init_distributed(device="cpu", **kw)
    assert not dist.is_initialized()


def test_make_mesh_needs_a_process_group(no_cluster):
    with pytest.raises(ValueError, match="process group"):
        D.make_mesh(device="cpu")


@pytest.mark.parametrize("call", [
    "init_distributed", "make_mesh", "fit_scene", "collective_stats",
    "schedule_overlap_report", "measured_weak_scaling",
    "predicted_efficiency"])
def test_entry_points_raise_without_a_card(no_cluster, call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults take it")
    if call == "init_distributed":
        with pytest.raises(RuntimeError, match="CUDA device"):
            D.init_distributed()
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        D.init_distributed(device="cpu")
    mesh = D.make_mesh(device="cpu")
    calls = {
        "make_mesh": lambda: D.make_mesh(),
        "fit_scene": lambda: D.fit_scene(torch.zeros(8, 8), 8, mesh, 1),
        "collective_stats": lambda: bs.collective_stats(8),
        "schedule_overlap_report": lambda: bs.schedule_overlap_report(8),
        "measured_weak_scaling": lambda: bs.measured_weak_scaling((1,)),
        "predicted_efficiency": lambda: bs.predicted_efficiency(64, 4),
    }
    with pytest.raises(RuntimeError, match="CUDA device"):
        calls[call]()
