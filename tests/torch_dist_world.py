"""The checks of tests/test_torch_dist.py that run inside a spawned world
of ``gloo`` processes (``enoki_tpu_torch.dist._world.run_world``). Imports
torch and the port only: each rank returns numpy arrays and numbers, and
the test module holds them against the JAX reference in its own process.
"""

import numpy as np
import torch
import torch.distributed as dist

from enoki_tpu_torch import dist as D
from enoki_tpu_torch.dist import bench_scaling as bs
from enoki_tpu_torch.render import SphereScene, Vec3, render_fused
from enoki_tpu_torch.render.sphere import scene_leaves
from enoki_tpu_torch.runtime import checkpoint as ck

CPU = "cpu"


def scene(center, radius, ambient, gain, light=(-1.0, -1.0, 2.0)):
    def f(v):
        return torch.tensor(v, dtype=torch.float32)
    return SphereScene(center=Vec3(*map(f, center)), radius=f(radius),
                       ambient=f(ambient), gain=f(gain),
                       light=Vec3(*map(f, light)))


# tests/test_dist.py:46-49 and :85-88
PERTURBED = dict(center=(0.1, -0.1, 0.0), radius=0.8, ambient=0.3, gain=80.0)
FIT_INIT = dict(center=(0.0, 0.0, 0.0), radius=0.75, ambient=0.2, gain=90.0)


def leaves(s):
    return np.array([float(x) for x in scene_leaves(s)], np.float64)


def target_of(n):
    return render_fused(SphereScene.reference(CPU), n).reshape(n, n)


def sgd(lr):
    return lambda p: torch.optim.SGD(p, lr=lr)


def world_checks(rank, world, ckpt_root):
    """Every check of the 2x2 world; rank r returns its results."""
    from torch.distributed.tensor import DTensor

    out = {}
    mesh = D.make_mesh(device=CPU)
    out["mesh_shape"] = tuple(mesh.shape)
    out["mesh_names"] = tuple(mesh.mesh_dim_names)
    out["coordinate"] = tuple(mesh.get_coordinate())

    # the sharded render at 256^2
    n = 256
    img = D.render_sharded(SphereScene.reference(CPU), n, mesh)
    out["is_dtensor"] = isinstance(img, DTensor)
    out["local_shape"] = tuple(img.to_local().shape)
    out["placements"] = [str(p) for p in img.placements]
    out["image"] = img.full_tensor().numpy()
    out["fused"] = render_fused(SphereScene.reference(CPU), n) \
        .reshape(n, n).numpy()

    # one step of each formulation at 128^2 from the perturbed scene:
    # SGD(0) reads the loss, SGD(1) moves the scene by exactly -grad
    n = 128
    target = target_of(n)
    init = scene(**PERTURBED)
    for name, maker in (("gspmd", D.make_train_step),
                        ("shardmap", D.make_train_step_shardmap)):
        _, _, loss = maker(n, mesh, sgd(0.0))(init, target, None)
        moved, state, _ = maker(n, mesh, sgd(1.0))(init, target, None)
        out[f"loss_{name}"] = float(loss)
        out[f"grad_{name}"] = leaves(init) - leaves(moved)
    tgt = D.render_sharded(SphereScene.reference(CPU), n, mesh)
    _, _, loss = D.make_train_step(n, mesh, sgd(0.0))(init, tgt, None)
    out["loss_dtensor_target"] = float(loss)

    # inverse rendering, 200 Adam steps (tests/test_dist.py:78-94)
    fitted, loss = D.fit_scene(target, n, mesh, steps=200, lr=5e-3,
                               init=scene(**FIT_INIT))
    out["fit_loss"], out["fit_radius"] = float(loss), float(fitted.radius)

    # checkpoint resume (tests/test_dist.py:97-117) against a straight run
    # from the fit's start, so that the scene moves
    n = 32
    target = target_of(n)
    start = scene(**FIT_INIT)
    D.fit_scene(target, n, mesh, steps=4, checkpoint_dir=ckpt_root,
                checkpoint_every=2, init=start)
    out["latest_after_4"] = ck.latest_step(ckpt_root)
    dist.barrier()
    resumed, loss = D.fit_scene(target, n, mesh, steps=6,
                                checkpoint_dir=ckpt_root, checkpoint_every=2,
                                init=start)
    out["latest_after_6"] = ck.latest_step(ckpt_root)
    out["resumed_loss"] = float(loss)
    straight, _ = D.fit_scene(target, n, mesh, steps=6, init=start)
    out["resumed"], out["straight"] = (
        np.stack([x.numpy() for x in scene_leaves(s)])
        for s in (resumed, straight))

    # the collectives of a step, at two resolutions
    for n in (64, 128):
        st = bs.collective_stats(n, device=CPU)
        out[f"payload_{n}"] = (st.n_devices, st.allreduce_bytes,
                               st.allreduce_shapes, st.flops_per_device)
    out["report"] = bs.schedule_overlap_report(64, device=CPU)

    # a mesh of two of the four ranks: the others sit out
    sub = D.make_mesh(2, device=CPU)
    img = D.render_sharded(SphereScene.reference(CPU), 16, sub)
    out["sub_coordinate"] = sub.get_coordinate()
    out["sub_image"] = None if img is None else img.full_tensor().numpy()
    out["sub_fit"] = D.fit_scene(target_of(16), 16, sub, steps=2,
                                 init=SphereScene.reference(CPU))[1]
    out["sub_fit"] = None if out["sub_fit"] is None else \
        float(out["sub_fit"])
    return out
