"""Barlow Twins cross-correlation loss (port of
ssl_audio_tpu/objectives/barlow.py).

Single device: the batch axis holds the whole batch, so the BatchNorm
statistics and the correlation are global-batch.  `world_scale` reproduces
the reference's world_size multiplier on the correlation matrix.
"""
from __future__ import annotations

import torch

BN_EPS = 1e-5  # torch BatchNorm1d default


def _bn(z: torch.Tensor) -> torch.Tensor:
    """BatchNorm1d(affine=False) in training mode: batch mean, biased
    variance, eps 1e-5."""
    mean = z.mean(dim=0, keepdim=True)
    var = z.var(dim=0, keepdim=True, unbiased=False)
    return (z - mean) / torch.sqrt(var + BN_EPS)


def barlow_twins_pair_loss(z1: torch.Tensor, z2: torch.Tensor, lmbda: float = 0.005,
                           alpha: float = 1.0, HSIC: bool = False,
                           world_scale: float = 1.0) -> torch.Tensor:
    """Loss of one (teacher, student) pair of (B, D) embeddings."""
    c = (_bn(z1).t() @ _bn(z2)) / z1.shape[0]
    c = c * world_scale
    diag = torch.diagonal(c)
    on_diag = ((diag - 1.0) ** 2).sum()
    if HSIC:
        # off-diagonal terms pulled toward -1
        off_all = ((c + 1.0) ** 2).sum() - ((diag + 1.0) ** 2).sum()
    else:
        off_all = (c ** 2).sum() - (diag ** 2).sum()
    return alpha * on_diag + lmbda * off_all


def barlow_twins_loss(student_views, teacher_views, lmbda: float = 0.005,
                      alpha: float = 1.0, HSIC: bool = False,
                      world_scale: float = 1.0) -> torch.Tensor:
    """Multi-crop pairing: the mean of the pair losses; with more than one
    teacher view, same-index pairs are skipped."""
    total, n_terms = 0.0, 0
    for q, tz in enumerate(teacher_views):
        for v, sz in enumerate(student_views):
            if len(teacher_views) > 1 and q == v:
                continue
            total = total + barlow_twins_pair_loss(
                tz, sz, lmbda=lmbda, alpha=alpha, HSIC=HSIC, world_scale=world_scale)
            n_terms += 1
    return total / n_terms
