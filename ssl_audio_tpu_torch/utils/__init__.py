"""Device resolution and weight conversion for the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """"cuda" unless the caller asks for something else.  Raises when no
    card is present and the caller did not ask for the CPU: an entry point
    never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
