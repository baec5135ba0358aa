"""Barlow Twins projector and predictor heads (port of
ssl_audio_tpu/models/heads.py).  Applied per view, so the BatchNorm
statistics are per view, and BatchNorm has flax's training semantics
(models/batchnorm.py)."""
from __future__ import annotations

import torch
from torch import nn

from ssl_audio_tpu_torch.models.batchnorm import BatchNorm1d


def _mlp(in_dim: int, hidden: list[int], out_dim: int) -> nn.Sequential:
    layers: list[nn.Module] = []
    for h in hidden:
        layers += [nn.Linear(in_dim, h, bias=False), BatchNorm1d(h), nn.ReLU()]
        in_dim = h
    return nn.Sequential(*layers, nn.Linear(in_dim, out_dim, bias=False))


class BarlowTwinsHead(nn.Module):
    """MLP projector: in -> [hidden] * n -> out; Linear(bias=False) + BN1d +
    ReLU per hidden layer, then a plain Linear(bias=False)."""

    def __init__(self, in_dim: int, projector_n_hidden_layers: int = 1,
                 projector_hidden_dim: int = 8192, projector_out_dim: int = 256):
        super().__init__()
        self.projector = _mlp(in_dim, [projector_hidden_dim] * projector_n_hidden_layers,
                              projector_out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projector(x)


class BarlowTwinsPredictor(nn.Module):
    """Optional 2-layer predictor d -> d -> d (the identity when use=False)."""

    def __init__(self, dim: int, use: bool = True):
        super().__init__()
        self.predictor = _mlp(dim, [dim], dim) if use else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.predictor(x)
