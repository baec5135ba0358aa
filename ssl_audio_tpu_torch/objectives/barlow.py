"""Barlow Twins cross-correlation loss (port of
ssl_audio_tpu/objectives/barlow.py).

The BatchNorm statistics and the correlation are those of the global
batch: in a process group (parallel/) each rank holds its rows, and the
sums over the batch (the mean, the squared deviations, the correlation
matrix) are summed over ranks with a differentiable all-reduce, so the
loss reads the same on every rank.  `world_scale` reproduces the
reference's world_size multiplier on the correlation matrix (the Trainer
passes the world size W, as the JAX Trainer passes its data-axis size).
"""
from __future__ import annotations

import torch

from ssl_audio_tpu_torch import parallel

BN_EPS = 1e-5  # torch BatchNorm1d default


def _bn(z: torch.Tensor) -> torch.Tensor:
    """BatchNorm1d(affine=False) in training mode over the global batch:
    batch mean, biased variance (two passes, as jnp.var), eps 1e-5."""
    n = parallel.batch_count(z.shape[0])
    mean = parallel.all_reduce_sum(z.sum(dim=0, keepdim=True)) / n
    var = parallel.all_reduce_sum(((z - mean) ** 2).sum(dim=0, keepdim=True)) / n
    return (z - mean) / torch.sqrt(var + BN_EPS)


def barlow_twins_pair_loss(z1: torch.Tensor, z2: torch.Tensor, lmbda: float = 0.005,
                           alpha: float = 1.0, HSIC: bool = False,
                           world_scale: float = 1.0) -> torch.Tensor:
    """Loss of one (teacher, student) pair of (B, D) embeddings (this
    rank's rows of the global batch)."""
    c = parallel.all_reduce_sum(_bn(z1).t() @ _bn(z2)) / parallel.batch_count(z1.shape[0])
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
