"""Patch-wise random masking for conv encoders (port of
ssl_audio_tpu/augment/mask_conv.py; reference old/utils/mask_conv.py:12-59,
which uses unfold / fold): zero random patch-aligned regions of a
spectrogram, by reshapes alone.  No trainer calls it, in JAX either."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def mask_conv(x: torch.Tensor, mask_ratio: float, patch_size: Tuple[int, int] = (16, 16),
              noise: Optional[torch.Tensor] = None,
              gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, C, F, T) with F, T multiples of the patch -> (masked x, mask
    (B, L)), 1 = removed patch: the patches of rank >= floor(L * (1 -
    mask_ratio)) in the order of `noise` (B, L), U(0, 1) drawn from `gen`
    when not given, are zeroed."""
    B, C, F, T = x.shape
    ph, pw = patch_size
    gh, gw = F // ph, T // pw
    L = gh * gw
    len_keep = int(L * (1 - mask_ratio))
    if noise is None:
        noise = torch.rand(B, L, generator=gen, device=x.device)
    ranks = torch.argsort(torch.argsort(noise, dim=1, stable=True), dim=1, stable=True)
    mask = (ranks >= len_keep).to(x.dtype)
    keep = 1.0 - mask.reshape(B, 1, gh, 1, gw, 1)
    patches = x.reshape(B, C, gh, ph, gw, pw)
    return (patches * keep).reshape(B, C, F, T), mask
