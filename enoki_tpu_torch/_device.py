"""Device resolution for every entry point of the port.

The port is written for an NVIDIA GPU. An entry point that creates tensors
takes ``device=None`` and resolves it here: ``None`` means the CUDA card,
and when there is none the call raises instead of falling back to the CPU.
The CPU runs only when the caller asks for it (``device="cpu"``), which is
what the CPU tests do; kernel wrappers then take their plain versions.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` -> ``cuda``, or raise."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "enoki_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
