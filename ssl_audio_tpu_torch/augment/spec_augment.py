"""SpecAugment-style masking and label mixup for supervised finetuning
(port of ssl_audio_tpu/augment/spec_augment.py; reference
old/data_manager/augmentations.py eval transforms and
old/evaluate/finetune.py), as batched ops on the batch's device.

Each function takes its random numbers as tensors, or draws them from a
torch.Generator when they are not given, as JAX draws them: a band's width
~ U{0..max_width} and the uniform u ~ U(0, 1) that puts its start at
floor(u * (size - width + 1)); mixup's lambda ~ Beta(alpha, alpha) for the
batch and one permutation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def draw_band(gen: torch.Generator, batch: int, max_width: int,
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (width, u), (B,) each: one band per sample (torchaudio
    FrequencyMasking / TimeMasking): its width ~ U{0..max_width} (int32)
    and the uniform u ~ U(0, 1) that places it (band_keep)."""
    width = torch.randint(0, max_width + 1, (batch,), generator=gen, device=device,
                          dtype=torch.int32)
    return width, torch.rand(batch, generator=gen, device=device)


def band_keep(width: torch.Tensor, u: torch.Tensor, size: int) -> torch.Tensor:
    """(B, size) bool keep mask, False inside each sample's band [start,
    start + width), start = floor(u * (size - width + 1)) ~ U{0..size -
    width}."""
    start = (u * (size - width + 1).to(torch.float32)).to(torch.int32)
    idx = torch.arange(size, device=width.device)[None, :]
    return ~((idx >= start[:, None]) & (idx < (start + width)[:, None]))


def freq_mask(lms: torch.Tensor, band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              gen: Optional[torch.Generator] = None, max_width: int = 8) -> torch.Tensor:
    """(B, C, F, T): zero one frequency band per sample.  band: (width, u),
    else drawn from `gen`."""
    B, _, F, _ = lms.shape
    if band is None:
        band = draw_band(gen, B, max_width, lms.device)
    return lms * band_keep(*band, F)[:, None, :, None]


def time_mask(lms: torch.Tensor, band: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              gen: Optional[torch.Generator] = None, max_width: int = 20) -> torch.Tensor:
    """(B, C, F, T): zero one time band per sample.  band: (width, u), else
    drawn from `gen`."""
    B, _, _, T = lms.shape
    if band is None:
        band = draw_band(gen, B, max_width, lms.device)
    return lms * band_keep(*band, T)[:, None, None, :]


def draw_mixup(gen: torch.Generator, batch: int, alpha: float) -> Tuple[float, torch.Tensor]:
    """-> (lambda ~ Beta(alpha, alpha), a permutation of the batch) from a
    CPU generator: lambda by the inverse CDF of one uniform (torch's Beta
    sampler takes no generator), on the host, so no step waits on the
    device for it."""
    from scipy.special import betaincinv

    u = float(torch.rand((), generator=gen, dtype=torch.float64))
    return float(betaincinv(alpha, alpha, u)), torch.randperm(batch, generator=gen)


def mixup_batch(x: torch.Tensor, y: torch.Tensor, alpha: float = 0.2,
                draws: Optional[Tuple[float, torch.Tensor]] = None,
                gen: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Supervised mixup over a batch: each sample convex-combined with a
    permuted partner, the labels mixed alike.  draws: (lambda, perm), else
    draw_mixup(gen, ...).  lambda is taken in fp32, as JAX's."""
    lam, perm = draws if draws is not None else draw_mixup(gen, x.shape[0], alpha)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=x.device)
    perm = perm.to(x.device)
    return lam * x + (1 - lam) * x[perm], lam * y + (1 - lam) * y[perm]
