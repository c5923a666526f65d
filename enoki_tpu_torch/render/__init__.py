"""enoki_tpu_torch.render -- the differentiable SDF renderer."""

from .vec import Vec2, Vec3, dot3, norm3, normalize3  # noqa: F401
from .sphere import Ray, SphereScene, make_rays, pixel_grid  # noqa: F401
from .implicit import implicit_t_vjp  # noqa: F401
from .sdf import (  # noqa: F401
    SDFScene, sdf, sdf_ortho_parts, sdf_ortho_dist, march, march_implicit,
    normal_at, shade, render_sdf, shade_implicit, render_sdf_implicit,
    sdf_loss_implicit, render_sdf_grads_implicit,
)
from .sdf_kernels import (  # noqa: F401
    N_PARAMS, LAUNCHES, reset_launch_counts, scene_to_vec, vec_to_scene,
    tile_pixels, sdf_fwd_plain, sdf_bwd_plain, sdf_fwd, sdf_bwd,
    render_sdf_cuda, SDFRender,
)
