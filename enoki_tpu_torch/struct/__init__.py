"""enoki_tpu_torch.struct -- structured vectorization (counterpart of
enoki_tpu/struct): struct support, masks, vectorize, vectorized method
calls. Eager tensors; the lazy halves wait for the port of trace/."""

from .pytree import (  # noqa: F401
    enoki_struct, width, zeros_like, full_like, select_struct,
    gather_struct, scatter_struct, slice_struct, set_slice_struct,
    concat_structs, detach,
)
from .masked import masked, Masked  # noqa: F401
from .call import (  # noqa: F401
    dispatch_masked, dispatch_partition, dispatch_switch, InstanceRegistry,
)
from .vectorize import vectorize, vectorize_safe, vectorize_wrapper  # noqa: F401
