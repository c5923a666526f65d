"""enoki_tpu_torch.dist -- process-group meshes and distributed
render/train (counterpart of enoki_tpu.dist): one process a GPU over
``nccl`` (``torchrun --nproc-per-node=N``), or ``gloo`` processes on the
CPU."""

from .mesh import (make_mesh, image_sharding, replicated,  # noqa: F401
                   init_distributed)
from .render import (  # noqa: F401
    render_sharded, mse_loss, make_train_step, make_train_step_shardmap,
    fit_scene,
)
from . import bench_scaling  # noqa: F401
