"""Mixed-precision and device policy.

Activations and matmul/conv operands run in one compute dtype: float32
by default, bfloat16 for serving and training on the card. Parameters and BatchNorm
state stay float32; each layer casts its parameters to the dtype of the
activation it receives, so the dtype is chosen once, where the model
input enters (``FFCGenerator.forward``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
a CUDA request on a machine without CUDA raises instead of quietly
running on the CPU.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "f32": torch.float32,
    "float32": torch.float32,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
}

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def resolve_dtype(dtype) -> torch.dtype:
    """A compute dtype from a name ("f32", "bf16", ...) or a torch dtype."""
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(
                f"unknown compute dtype {dtype!r}; want one of {sorted(_DTYPES)}"
            )
        return _DTYPES[dtype]
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
    return dtype


def default_dtype(device: torch.device) -> torch.dtype:
    """The compute dtype an entry point takes unless told otherwise: bf16
    on the card, f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for and
    absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device
