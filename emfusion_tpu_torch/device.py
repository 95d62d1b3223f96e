"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. A CUDA device that is not there raises:
    the port never carries on on the CPU unless the caller asks for it
    (the tests pass ``device="cpu"``). ``cuda`` without an index becomes
    the current card, ``cuda:N``; the kernels launch on the card of their
    tensors (``kernels.launch``), whichever card is current."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "emfusion_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"emfusion_tpu_torch: no device {dev}: "
                               f"{torch.cuda.device_count()} visible")
    return dev
