"""selfc_tpu_torch — the PyTorch/CUDA port of selfc_tpu for NVIDIA Hopper.

Sub-packages mirror the JAX package's names so counterparts are easy to
find. Activations are channels-last ``(B, T, H, W, C)`` at every public
function, and parameters keep the JAX package's layouts and tree names.

Entry points take ``device=None``, which means the GPU: they raise when
CUDA is not available. The CPU is used only when the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "selfc_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
