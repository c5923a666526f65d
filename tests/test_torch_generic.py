"""The port's bring-your-own-SDF renderer (enoki_tpu_torch.render.generic)
against the reference's (enoki_tpu.render.generic): the counterpart of every
render test of tests/test_generic_render.py at its size (128^2, 48 steps,
tile 64). The sanity tests of the primitives are in test_torch_sdflib.py.

The port runs on the CPU here, so its wrappers take the kernels' plain
versions (generic_fwd_plain, generic_bwd_plain); the reference's kernels
run under pltpu.force_tpu_interpret_mode() (render_pallas) and through
their jnp path (render_xla). Parameters cross as numpy arrays.

Tolerances, the reference's own:
  image        max |port - reference| < 1e-3 (both cameras); where a
               grazing pixel stops one step apart the flip gate of the
               head-start tests applies instead and is named in the test
  gradients    rtol 2e-2, atol 2e-3 * max(1, |g|max)
  coarse/bands flip share < 1e-3, off-flip max < 0.05 and mean < 5e-3,
               gradients rtol 5e-2 / atol 5e-3 * max(1, |g|max)
  relax        flip share < 0.01, off-flip mean < 1e-3; relax = 1 with
               unimodal bit-equal to the plain march
  all-miss     image and gradient exact
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from enoki_tpu.render import generic as jgen, sdflib as jsd
from enoki_tpu.render.vec import Vec3 as JVec3
from enoki_tpu_torch.render import generic as tgen, sdflib as tsd
from enoki_tpu_torch.render.vec import Vec3 as TVec3

N, STEPS, TILE = 128, 48, 64

PARAMS = np.asarray(
    # ambient gain  light(x,y,z)   sphere(c,r)          torus(R,r) plane
    [0.15, 40.0, -1.0, -1.0, 2.0, 0.1, -0.2, 0.3, 0.45, 0.55, 0.18, 1.05],
    np.float32)
SPHERE = np.asarray([0.15, 40.0, -1.0, -1.0, 2.0, 0.0, 0.0, 0.3, 0.5],
                    np.float32)
FAR_SPHERE = np.asarray([0.15, 40.0, -1.0, -1.0, 2.0, 50.0, 0.0, 0.3, 0.45],
                        np.float32)


def composed(sd, Vec3):
    """Union of a sphere, a torus and a ground plane, with a smooth blend;
    geometry params live at pv[5:] (tests/test_generic_render.py:16)."""

    def scene_sdf(p, pv):
        s = sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])
        t = sd.sd_torus(p, Vec3(0.0, 0.0, 1.0), pv[9], pv[10])
        g = sd.sd_plane(p, Vec3(0.0, -1.0, 0.0), pv[11])
        return sd.op_union(sd.op_smooth_union(s, t, 0.1), g)

    return scene_sdf


def sphere_only(sd, Vec3):
    return lambda p, pv: sd.sd_sphere(p, Vec3(pv[5], pv[6], pv[7]), pv[8])


SCENES = {"composed": (composed, 12), "sphere": (sphere_only, 9)}
J_CAMERAS = {"ortho": jgen.ortho_camera,
             "perspective": jgen.perspective_camera()}
T_CAMERAS = {"ortho": tgen.ortho_camera,
             "perspective": tgen.perspective_camera()}


@functools.cache
def j_renderer(scene, camera):
    make, n_params = SCENES[scene]
    return jgen.make_sdf_renderer(make(jsd, JVec3), n_params,
                                  ray_fn=J_CAMERAS[camera])


@functools.cache
def t_renderer(scene, camera):
    make, n_params = SCENES[scene]
    return tgen.make_sdf_renderer(make(tsd, TVec3), n_params,
                                  ray_fn=T_CAMERAS[camera])


@functools.cache
def j_image(scene, camera, which, params=None, options=()):
    """The reference's image: ``which`` is "pallas" (interpret mode) or
    "xla"."""
    pv = jnp.asarray(PARAMS if params is None else np.asarray(params))
    rp, rx = j_renderer(scene, camera)
    if which == "xla":
        return np.asarray(rx(pv, N, STEPS))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(rp(pv, N, STEPS, 1.2, TILE, *options))


@functools.cache
def j_grad(scene, camera, which, options=()):
    pv = jnp.asarray(PARAMS)
    rp, rx = j_renderer(scene, camera)
    if which == "xla":
        return np.asarray(jax.grad(lambda v: jnp.mean(rx(v, N, STEPS)))(pv))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(jax.grad(lambda v: jnp.mean(
            rp(v, N, STEPS, 1.2, TILE, *options)))(pv))


def t_image(scene, camera, params=PARAMS, options=(), twin=False):
    render, render_plain = t_renderer(scene, camera)
    pv = torch.from_numpy(np.asarray(params))
    with torch.no_grad():
        if twin:
            return render_plain(pv, N, STEPS).numpy()
        return render(pv, N, STEPS, 1.2, TILE, *options).numpy()


@functools.cache
def t_grad(scene, camera, options=(), twin=False):
    render, render_plain = t_renderer(scene, camera)
    pv = torch.from_numpy(PARAMS).clone().requires_grad_(True)
    img = (render_plain(pv, N, STEPS) if twin
           else render(pv, N, STEPS, 1.2, TILE, *options))
    img.mean().backward()
    return pv.grad.numpy()


def assert_grads_close(g, ref, rtol=2e-2, atol=2e-3):
    assert np.isfinite(g).all() and np.isfinite(ref).all()
    assert np.allclose(g, ref, rtol=rtol,
                       atol=atol * max(1.0, np.abs(ref).max())), (g, ref)


def assert_image_close(img, ref):
    """max < 1e-3; if a grazing pixel flipped between hit and miss, the
    flip gate instead: flips (|d| > 1) under 1e-3 of the pixels, every
    other pixel within 1e-3."""
    assert img.shape == (N, N)
    d = np.abs(img - ref)
    flips = d > 1.0
    assert flips.mean() < 1e-3, flips.mean()
    assert d[~flips].max() < 1e-3, d[~flips].max()


@pytest.mark.parametrize("which", ["pallas", "xla"])
@pytest.mark.parametrize("camera", ["ortho", "perspective"])
def test_generic_image_parity(camera, which):
    img = t_image("composed", camera)
    assert_image_close(img, j_image("composed", camera, which))
    if camera == "ortho":
        # the scene is actually visible: hits and background both present
        assert (img > 0.2).mean() > 0.05 and (img < 0.16).mean() > 0.05


@pytest.mark.parametrize("camera", ["ortho", "perspective"])
def test_generic_twin_image_parity(camera):
    twin = t_image("composed", camera, twin=True)
    assert_image_close(twin, j_image("composed", camera, "xla"))
    assert_image_close(twin, t_image("composed", camera))


@pytest.mark.parametrize("which", ["pallas", "xla"])
def test_generic_grads_parity(which):
    g = t_grad("composed", "ortho")
    assert_grads_close(g, j_grad("composed", "ortho", which))
    # geometry params actually receive gradient signal
    assert np.abs(g[5:]).max() > 1e-4


def test_generic_twin_grads_parity():
    g = t_grad("composed", "ortho", twin=True)
    assert_grads_close(g, j_grad("composed", "ortho", "xla"))
    assert_grads_close(t_grad("composed", "ortho"), g)


def test_perspective_camera_parity():
    img = t_image("composed", "perspective")
    # perspective view differs from orthographic (the camera matters)
    assert np.abs(img - t_image("composed", "ortho")).mean() > 1e-3
    # grads flow, incl. through ray directions, and match the reference's
    g = t_grad("composed", "perspective")
    assert np.isfinite(g).all() and np.abs(g[5:]).max() > 1e-4
    assert_grads_close(g, j_grad("composed", "perspective", "pallas"))


def test_generic_bwd_plain_matches_the_twins_autograd():
    """generic_bwd_plain on the forward's residual against autograd
    through the twin (march_implicit + the shade), same tolerance as the
    gradient parity."""
    sdf_fn = composed(tsd, TVec3)
    for cam in T_CAMERAS.values():
        pv = torch.from_numpy(PARAMS)
        _, ts = tgen.generic_fwd_plain(sdf_fn, cam, pv, N, STEPS)
        g = torch.full((N, N), 1.0 / (N * N))
        dp = tgen.generic_bwd_plain(sdf_fn, cam, pv, g, ts, N).numpy()
        _, twin = tgen.make_sdf_renderer(sdf_fn, 12, ray_fn=cam)
        pg = pv.clone().requires_grad_(True)
        twin(pg, N, STEPS).mean().backward()
        assert_grads_close(dp, pg.grad.numpy())


def test_generic_work_elimination_knobs():
    """coarse=8, bands=8 stay within the calibrated drift bounds of the
    reference's test (:98-117) against the port's own plain march, and
    against the reference's render with the same knobs; gradients keep
    parity."""
    base = t_image("composed", "ortho")
    wk = t_image("composed", "ortho", options=(None, 8, 8))
    for ref in (base, j_image("composed", "ortho", "pallas",
                              options=(None, 8, 8))):
        d = np.abs(ref - wk)
        flips = d > 1.0
        assert flips.mean() < 1e-3, flips.mean()
        assert d[~flips].max() < 0.05 and d[~flips].mean() < 5e-3
    g_wk = t_grad("composed", "ortho", options=(None, 8, 8))
    assert_grads_close(g_wk, t_grad("composed", "ortho"), 5e-2, 5e-3)
    assert_grads_close(g_wk, j_grad("composed", "ortho", "pallas",
                                    options=(None, 8, 8)), 5e-2, 5e-3)


def test_bands_alone_change_nothing():
    np.testing.assert_array_equal(
        t_image("composed", "ortho"),
        t_image("composed", "ortho", options=(None, 0, 8)))


def test_generic_miss_tile_fast_path_exact():
    # every ray escapes (sphere far off-screen): image == ambient
    # bit-exactly and the only gradient is sum(g) into the ambient slot
    img = t_image("sphere", "ortho", params=FAR_SPHERE)
    np.testing.assert_array_equal(
        img, np.full((N, N), FAR_SPHERE[0], np.float32))
    np.testing.assert_array_equal(
        img, j_image("sphere", "ortho", "pallas", tuple(FAR_SPHERE)))
    render, _ = t_renderer("sphere", "ortho")
    pv = torch.from_numpy(FAR_SPHERE).clone().requires_grad_(True)
    render(pv, N, STEPS, 1.2, TILE).sum().backward()
    g = pv.grad.numpy()
    assert g[0] == N * N and np.all(g[1:] == 0.0), g


def test_generic_prepass_rejects_custom_camera():
    render, _ = t_renderer("composed", "perspective")
    with pytest.raises(ValueError, match="orthographic"):
        render(torch.from_numpy(PARAMS), N, STEPS, 1.2, TILE, None, 8)


def test_generic_refuses_a_tile_that_does_not_divide_the_image():
    render, _ = t_renderer("composed", "ortho")
    with pytest.raises(ValueError, match="divisible by the tile"):
        render(torch.from_numpy(PARAMS), N, STEPS, 1.2, 48)
    with pytest.raises(ValueError, match="shape"):
        render(torch.from_numpy(PARAMS[:9]), N, STEPS, 1.2, TILE)


def test_generic_relax_knobs():
    """relax / unimodal on a single convex sphere: parity-close to the
    plain march and to the reference's render with the same knobs; at
    relax = 1 + unimodal the image is bit-exact."""
    img0 = t_image("sphere", "ortho", params=SPHERE)
    assert_image_close(img0, j_image("sphere", "ortho", "pallas",
                                     tuple(SPHERE)))
    img_uni = t_image("sphere", "ortho", params=SPHERE,
                      options=(None, 0, 1, 1.0, True))
    np.testing.assert_array_equal(img0, img_uni)
    img_w = t_image("sphere", "ortho", params=SPHERE,
                    options=(None, 0, 1, 1.6, True))
    for ref in (img0, j_image("sphere", "ortho", "pallas", tuple(SPHERE),
                              (None, 0, 1, 1.6, True))):
        d = np.abs(ref - img_w)
        flip = d > 1.0
        assert flip.mean() < 0.01, flip.mean()
        assert d[~flip].mean() < 1e-3, d[~flip].mean()
    render, _ = t_renderer("sphere", "ortho")
    pv = torch.from_numpy(SPHERE).clone().requires_grad_(True)
    render(pv, N, STEPS, 1.2, TILE, None, 0, 1, 1.6, True).mean().backward()
    g = pv.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g[5:]).max() > 1e-4


def test_generic_render_module_trains_on_the_cpu():
    render, _ = t_renderer("composed", "ortho")
    model = tgen.GenericRender(render, PARAMS, n=N, n_steps=STEPS,
                               device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    before = model.params.detach().clone()
    model().mean().backward()
    np.testing.assert_array_equal(model.params.grad.numpy(),
                                  t_grad("composed", "ortho"))
    opt.step()
    assert not torch.equal(model.params.detach(), before)


def test_march_counts_stay_inside_the_step_cap():
    sdf_fn = composed(tsd, TVec3)
    pv = torch.from_numpy(PARAMS)
    counts = tgen.generic_march_counts(sdf_fn, tgen.ortho_camera, pv, N,
                                       STEPS)
    _, ts = tgen.generic_fwd_plain(sdf_fn, tgen.ortho_camera, pv, N, STEPS)
    assert counts.shape == (N, N)
    # never fewer than the freeze test and the hit test, never more than
    # one evaluation per step
    assert counts.min().item() == 2 and counts.max().item() <= STEPS
    # a ray that starts under the ground plane hits at t = 0: two
    # evaluations
    assert (counts[ts == 0.0] == 2).all()
