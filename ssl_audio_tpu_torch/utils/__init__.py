"""Device resolution and weight conversion for the port."""
from __future__ import annotations

import torch

from ssl_audio_tpu_torch import parallel


def resolve_device(device=None) -> torch.device:
    """"cuda" unless the caller asks for something else.  Raises when no
    card is present and the caller did not ask for the CPU: an entry point
    never drops to the CPU on its own.  In a process group
    (parallel.init_distributed) "cuda" is this process's card,
    cuda:LOCAL_RANK."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None and parallel.is_distributed():
        dev = torch.device("cuda", parallel.local_rank())
    return dev
