"""enoki_tpu_torch.render -- the differentiable renderer: the closed-form
sphere, the SDF sphere march and the bring-your-own-SDF renderer, each
with its CUDA kernel pair."""

from .vec import Vec2, Vec3, dot3, cross3, norm3, normalize3  # noqa: F401
from .sphere import (  # noqa: F401
    Ray, SphereScene, make_rays, intersect_rays, shade_hits, combined,
    pixel_grid, render_fused, render_staged, image_loss, render_and_grads,
    numpy_reference,
)
from .implicit import implicit_t_vjp  # noqa: F401
from .sdf import (  # noqa: F401
    SDFScene, sdf, sdf_ortho_parts, sdf_ortho_dist, march, march_implicit,
    normal_at, shade, render_sdf, sdf_loss, render_sdf_grads,
    shade_implicit, render_sdf_implicit, sdf_loss_implicit,
    render_sdf_grads_implicit,
)
from .._build import LAUNCHES, ROUTES, reset_launch_counts  # noqa: F401
from .sdf_kernels import (  # noqa: F401
    N_PARAMS, scene_to_vec, vec_to_scene, tile_pixels, march_tile, cone_t0,
    sdf_fwd_plain, sdf_fwd_split_plain, sdf_fwd_split_list_plain,
    sdf_tail_plain, sdf_split_plain, sdf_bwd_plain, sdf_bwd_ad_plain,
    sdf_fwd, sdf_fwd_split, sdf_fwd_split_list, sdf_tail, sdf_split,
    sdf_bwd, render_sdf_cuda, SDFRender,
)
from .sphere_kernels import (  # noqa: F401
    sphere_fwd_plain, sphere_bwd_plain, sphere_fwd, sphere_bwd,
    render_sphere_cuda, SphereRender,
)
from . import sdflib, sdf_trace  # noqa: F401
from .generic import (  # noqa: F401
    AMBIENT, GAIN, LIGHT, ortho_camera, perspective_camera, make_sdf_renderer,
    generic_fwd_plain, generic_bwd_plain, generic_fwd, generic_bwd,
    SceneKernels, GenericRender,
)
