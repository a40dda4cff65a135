"""PyTorch/CUDA port of `interdiff_tpu` for one NVIDIA H100.

Each module keeps the path of its JAX counterpart in `interdiff_tpu`, which
stays the reference the port is tested against.  The package imports torch
and numpy only, never jax or `interdiff_tpu`.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no device given and no CUDA device present this raises, so a run
    meant for the card never carries on quietly on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "interdiff_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def full_f32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions, process-wide."""
    # the JAX package pins Precision.HIGHEST, and the ball query's and the
    # skinning's selections are decided at ties that TF32 products would move
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
