"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    there is no card, so an entry point never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def float32_exact() -> None:
    """Exact float32 on the card for the rest of the process, as the JAX
    package computes on the CPU: cuDNN convolutions and CUDA matmuls without
    TF32 (PyTorch's default lets cuDNN round float32 operands to TF32). Every
    CLI of the port calls this first; a library caller who wants the CLIs'
    numbers calls it too. It sets the legacy pair
    ``torch.backends.cudnn.allow_tf32`` / ``torch.backends.cuda.matmul.
    allow_tf32`` and nothing of the ``fp32_precision`` API: PyTorch refuses a
    read of one API after a write of the other."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
