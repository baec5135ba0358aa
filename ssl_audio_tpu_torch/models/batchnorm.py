"""BatchNorm with flax's training semantics, under torch's parameter names.

flax.linen.BatchNorm (momentum 0.9 = torch's 0.1) normalises with the biased
batch variance, computed as mean(x^2) - mean(x)^2 in fp32 and clamped at 0,
and folds that same biased variance into the running average.  torch's
BatchNorm folds the unbiased one (n / (n - 1) larger).  These subclasses
take over the training-mode forward and leave everything else to torch:
the fp32 eval mode, the parameter and buffer names (weight, bias,
running_mean, running_var, num_batches_tracked), so reference state dicts
load with strict=True.

In a process group (parallel/) the training-mode statistics are those of
the global batch (batch_moments), so the running buffers move alike on
every rank; eval mode reads the running buffers and crosses no rank.

Half-precision input (the bf16 compute mode, models/precision.py), as
flax's BatchNorm does it: the statistics in fp32, the normalisation
(x - mean) * (rsqrt(var + eps) * weight) + bias in fp32 with bf16 weight
and bias widened, the result in the input's type; in eval mode the fp32
running statistics, which torch's own batch_norm would not take beside
bf16 weights.
"""
from __future__ import annotations

import torch
from torch import nn

from ssl_audio_tpu_torch import parallel


class _BiasedVarianceMixin:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = x.dtype in HALF_DTYPES
        if not self.training and not half:
            return super().forward(x)
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1, -1] + [1] * (x.dim() - 2)
        x32 = at_least_fp32(x)
        if self.training:
            mean, var = batch_moments(x32, dims)
            var = var.clamp_min(0.0)
            update_running_stats_(self, mean, var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((x32 - mean.view(shape)) * scale.view(shape)
                + self.bias.view(shape)).to(x.dtype)


HALF_DTYPES = (torch.float16, torch.bfloat16)


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """Half-precision activations take their statistics in fp32."""
    return x.float() if x.dtype in HALF_DTYPES else x


def batch_moments(x32: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased var = mean(x^2) - mean^2) per channel over `dims` of
    the global batch: the fp32 sums of x and x^2 and the count are summed
    over ranks (parallel.all_reduce_sum, one all-reduce, differentiable)
    before the division, SyncBatchNorm with flax's semantics.  Outside a
    process group the same sums over this process's batch."""
    n = parallel.batch_count(x32.numel() // x32.shape[1])
    s = parallel.all_reduce_sum(torch.stack([x32.sum(dim=dims), (x32 * x32).sum(dim=dims)]))
    mean = s[0] / n
    return mean, s[1] / n - mean * mean


def update_running_stats_(bn: nn.modules.batchnorm._BatchNorm,
                          mean: torch.Tensor, var: torch.Tensor) -> None:
    """Fold a batch mean and *biased* batch variance into bn's running
    buffers, in place: new = (1 - momentum) * old + momentum * batch."""
    with torch.no_grad():
        bn.running_mean.lerp_(mean.detach().to(bn.running_mean.dtype), bn.momentum)
        bn.running_var.lerp_(var.detach().to(bn.running_var.dtype), bn.momentum)
        bn.num_batches_tracked += 1


class BatchNorm1d(_BiasedVarianceMixin, nn.BatchNorm1d):
    """(B, C) or (B, C, L); statistics over every axis but 1."""


class BatchNorm2d(_BiasedVarianceMixin, nn.BatchNorm2d):
    """(B, C, H, W); statistics over (B, H, W)."""
