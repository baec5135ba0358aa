"""BYOL-A objective (port of ssl_audio_tpu/objectives/byol.py; reference
old/byola/byol_pytorch.py:47-50): the MSE of L2-normalised online
predictions and target projections, 2 - 2 cos."""
from __future__ import annotations

import torch

NORM_CLIP = 1e-12


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(NORM_CLIP)


def byol_loss_fn(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample loss (B,): 2 - 2 <x / |x|, y / |y|>."""
    return 2.0 - 2.0 * (_l2n(x) * _l2n(y)).sum(dim=-1)


def byol_symmetric_loss(online_pred_1: torch.Tensor, target_proj_2: torch.Tensor,
                        online_pred_2: torch.Tensor, target_proj_1: torch.Tensor) -> torch.Tensor:
    """Both view assignments, summed per sample, averaged over the batch."""
    return (byol_loss_fn(online_pred_1, target_proj_2)
            + byol_loss_fn(online_pred_2, target_proj_1)).mean()
