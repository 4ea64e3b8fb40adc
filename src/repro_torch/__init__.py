"""OverSketched Newton on PyTorch and CUDA: the port of ``repro`` to an
NVIDIA H100.

The package mirrors ``repro``'s module names and imports neither ``jax``
nor ``repro``.  Its entry points run on the CUDA device unless the caller
passes ``device="cpu"``; with no device given and no GPU present they
raise (``resolve_device``).

The reference computes in IEEE float32, so every float32 matrix product
here does too: TF32 is switched off for matmuls and cuDNN on import.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    CUDA device; raises when none is given and no GPU is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")
