"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. A CUDA device that is not there raises:
    the port never carries on on the CPU unless the caller asks for it
    (the tests pass ``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "emfusion_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions")
    return dev
