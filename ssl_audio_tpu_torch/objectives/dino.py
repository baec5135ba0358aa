"""DINO objective (port of ssl_audio_tpu/objectives/dino.py; reference
old/methods/dino.py:295-388): the weight-normalised projection head, the
teacher temperature schedule and the centred, sharpened cross-entropy with
its EMA centre.

The parameter names are the upstream DINO head's: mlp.{0,2,4} (Linear,
GELU, Linear, GELU, Linear; with use_bn a BatchNorm after each hidden
Linear, mlp.{0,1,3,4,6}), last_layer.weight_g (out, 1) and
last_layer.weight_v (out, bottleneck), so w = g v / |v| row by row.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from ssl_audio_tpu_torch.models.batchnorm import BatchNorm1d

INIT_STD = 0.02      # the head's normal initialiser (JAX DINOHead, dino.py:27)
NORM_CLIP = 1e-12    # the L2 norms are clipped below at this


class WeightNormLinear(nn.Module):
    """x @ (g v / |v|).T without bias, |v| per output row clipped at
    NORM_CLIP.  With norm_last_layer g takes no gradient and stays 1."""

    def __init__(self, in_dim: int, out_dim: int, norm_last_layer: bool = True):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(out_dim, 1),
                                     requires_grad=not norm_last_layer)
        self.weight_v = nn.Parameter(torch.empty(out_dim, in_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.weight_v
        w = self.weight_g * v / v.norm(dim=1, keepdim=True).clamp_min(NORM_CLIP)
        return x @ w.t()


class DINOHead(nn.Module):
    """MLP -> L2 normalisation -> weight-normalised last layer
    (JAX DINOHead).  Exact GELU; BatchNorm (flax semantics, momentum 0.9)
    after each hidden Linear only with use_bn."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = False,
                 norm_last_layer: bool = True, nlayers: int = 3, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256):
        super().__init__()
        n = max(nlayers, 1)
        layers: list[nn.Module] = []
        dims = [in_dim] + [hidden_dim] * (n - 1)
        for d_in, d_out in zip(dims[:-1], dims[1:]):
            layers.append(nn.Linear(d_in, d_out))
            if use_bn:
                layers.append(BatchNorm1d(d_out))
            layers.append(nn.GELU())
        layers.append(nn.Linear(dims[-1], bottleneck_dim))
        self.mlp = nn.Sequential(*layers)
        self.last_layer = WeightNormLinear(bottleneck_dim, out_dim, norm_last_layer)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mlp(x)
        x = x / x.norm(dim=-1, keepdim=True).clamp_min(NORM_CLIP)
        return self.last_layer(x)


def init_dino_head_(head: DINOHead, generator: torch.Generator) -> DINOHead:
    """The JAX head's initialisers, drawn from `generator`: N(0, 0.02)
    kernels and v, zero biases, g = 1, BatchNorm scale 1 and shift 0."""
    with torch.no_grad():
        for m in head.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, INIT_STD, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
        head.last_layer.weight_v.normal_(0.0, INIT_STD, generator=generator)
        head.last_layer.weight_g.fill_(1.0)
    return head


def teacher_temp_schedule(warmup_teacher_temp: float, teacher_temp: float,
                          warmup_teacher_temp_epochs: int, nepochs: int) -> np.ndarray:
    """The teacher temperature per epoch: a linear warm-up over
    warmup_teacher_temp_epochs, then teacher_temp."""
    return np.concatenate((
        np.linspace(warmup_teacher_temp, teacher_temp, warmup_teacher_temp_epochs),
        np.ones(max(nepochs - warmup_teacher_temp_epochs, 0)) * teacher_temp))


def dino_loss(student_views: List[torch.Tensor], teacher_views: List[torch.Tensor],
              center: torch.Tensor, teacher_temp: float, student_temp: float = 0.1,
              center_momentum: float = 0.9) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (loss, new_center), DINOLoss.forward: each teacher view's
    softmax((t - center) / teacher_temp) against every other student view's
    log_softmax(s / student_temp), same-index pairs skipped, the mean over
    the terms; the centre moves to center * m + (1 - m) * the mean over the
    concatenated teacher views.  The teacher side and the new centre carry
    no gradient."""
    t_probs = [torch.softmax((t - center) / teacher_temp, dim=-1).detach()
               for t in teacher_views]
    log_p = [torch.log_softmax(s / student_temp, dim=-1) for s in student_views]
    terms = [torch.mean(torch.sum(-q * lp, dim=-1))
             for iq, q in enumerate(t_probs) for v, lp in enumerate(log_p) if v != iq]
    loss = sum(terms) / max(len(terms), 1)
    batch_center = torch.cat(teacher_views).mean(dim=0, keepdim=True)
    new_center = center * center_momentum + batch_center * (1 - center_momentum)
    return loss, new_center.detach()
