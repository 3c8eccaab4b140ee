"""Device resolution shared by the package's entry points.

Entry points take ``device=`` and default to ``"cuda"``.  Without a CUDA
device they raise: nothing drops to the CPU unless the caller asks for it.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch finds no "
                           "CUDA device; pass device='cpu' to run on the host")
    return dev
