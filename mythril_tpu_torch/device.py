"""Device resolution for the port's entry points.

Entry points take `device=None`, which means the CUDA card. A caller that
asks for the card on a machine without one gets an error, never a silent
run on the CPU; `device="cpu"` is for tests, which run the plain twins."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The torch.device an entry point should place its tensors on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mythril_tpu_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
