"""AudioNTT2022 encoder (port of ssl_audio_tpu/models/audiontt.py; the
BYOL-A v2 CNN of the reference model.py:130-210).

Parameter names are the reference's torch layout (`features.{0,1,4,5}`,
`fc.{0,3}`; with squeeze_excitation=True a block is 5 modules, its SE block
at `features.{4,9}` with `excitation.{0,2}`, so block 2's conv and BN are
`features.{5,6}`):

  2 x [Conv3x3(64) - BN - ReLU - MaxPool2x2 (- SE)]   -> (B, 64, F/4, T/4)
  per-timeframe flatten (mel x channel = 1024)          -> (B, T/4, 1024)
  FC: 1024 -> 2048 -> ReLU -> Dropout(0.3) -> 2048 -> ReLU
  stack conv features with FC features                  -> (B, T/4, 3072)
  mean + max pooling over time                          -> (B, 3072)

Block 1 goes through the fused Conv-BN-ReLU-Pool kernels (ops/fused_conv.py)
when fused_conv=True and the input's H and W are even, the rule of the JAX
module: the forward-only kernel with running statistics in eval mode, the
autograd Function with its hand-written backward in train mode.  Otherwise
(the 10-s scene clips, T = 1001) it is the plain Conv2d + BatchNorm + ReLU +
MaxPool2d composition.  The fused block's output is channel-major in memory,
so block 2 receives a contiguous NCHW tensor either way.

SE (squeeze_excitation=True) follows every block, as in JAX: the mean over
(F, T) of each channel, Linear(C, C / 16) - ReLU - Linear(C / 16, C) -
sigmoid, both without bias, scales the channel.  It reads the fused block
1's channel-major output as it is and hands block 2 a contiguous NCHW
tensor; in bf16 its Linears run in bf16, as JAX's Dense.

Block 2 runs no hand-written kernel, as in JAX.  In train mode with
pool_reorder=True it is the pool-reordered composition of the JAX module:
cuDNN conv, fp32 batch statistics over the full conv output, a sign-aware
2x2 pool of y, then the BN affine and ReLU on the pooled tensor, which
autograd differentiates (max_pool2d routes a tie to the first window
element on the CPU and on the card, as select-and-scatter does).

Every train-mode BatchNorm has flax's semantics (models/batchnorm.py): the
running variance takes the biased batch variance.  Convolutions run with
TF32 off: the embeddings are an fp32 contract, and cuDNN would otherwise
take fp32 convolutions through TF32.  The flag is read when a convolution
runs, so whoever calls backward() on this module's output does so under
ops.no_tf32() as well (train/steps.py does).  Dropout draws from torch's global
generator unless the caller hands frames()/forward() the keep mask.

Under the bf16 compute mode (models/precision.py: bf16 parameters and
input, as the JAX module runs with them) block 1 takes the fused kernels'
bf16 instantiation (or, for odd H or W, cuDNN's bf16 conv); blocks 2's
convolutions are cuDNN bf16; every BatchNorm takes its statistics in fp32,
folds them into fp32 running buffers and returns bf16 (models/batchnorm.py);
the pool-reordered block 2's epilogue runs in fp32 and rounds to bf16; the
dropout mask multiplies in bf16, and mean_max_pooling runs in bf16 (JAX
models/audiontt.py:70).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ssl_audio_tpu_torch.models.batchnorm import (
    BatchNorm2d,
    at_least_fp32,
    batch_moments,
    update_running_stats_,
)
from ssl_audio_tpu_torch.ops import no_tf32
from ssl_audio_tpu_torch.ops.fused_conv import (
    fused_conv1_bn_relu_pool,
    fused_conv1_bn_relu_pool_eval,
)

DROPOUT_RATE = 0.3


def mean_max_pooling(frames: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, D): max over time + mean over time.  amax, not
    max(dim): where frames tie (a feature constant over time), amax shares
    the gradient evenly among them, as jnp.max does; max(dim) would hand it
    to one frame."""
    return frames.amax(dim=1) + frames.mean(dim=1)


class SEBlock(nn.Module):
    """Squeeze-and-excitation (reference model.py:194-210) on an NCHW input:
    each channel scaled by sigmoid(W2 relu(W1 mean_hw(x)))."""

    def __init__(self, channels: int, r: int = 16):
        super().__init__()
        self.excitation = nn.Sequential(
            nn.Linear(channels, channels // r, bias=False), nn.ReLU(),
            nn.Linear(channels // r, channels, bias=False), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.excitation(x.mean(dim=(2, 3)))[:, :, None, None]


class AudioNTT2022(nn.Module):
    """Pooled encoder: (B, 1, F, T) -> (B, d)."""

    def __init__(self, n_mels: int = 64, d: int = 3072, base_d: int = 64,
                 mlp_hidden_d: int = 2048, fused_conv: bool = False,
                 pool_reorder: bool = False, squeeze_excitation: bool = False):
        super().__init__()
        self.n_mels, self.d, self.base_d = n_mels, d, base_d
        self.fused_conv = fused_conv
        self.pool_reorder = pool_reorder          # train mode only, as in JAX
        self.squeeze_excitation = squeeze_excitation
        blocks = []
        for cin in (1, base_d):
            blocks += [nn.Conv2d(cin, base_d, 3, padding=1), BatchNorm2d(base_d),
                       nn.ReLU(), nn.MaxPool2d(2, 2)]
            if squeeze_excitation:
                blocks.append(SEBlock(base_d))
        self.block_len = 5 if squeeze_excitation else 4
        self.features = nn.Sequential(*blocks)
        conv_d = base_d * (n_mels // 4)
        self.fc = nn.Sequential(
            nn.Linear(conv_d, mlp_hidden_d), nn.ReLU(), nn.Dropout(DROPOUT_RATE),
            nn.Linear(mlp_hidden_d, d - conv_d), nn.ReLU())

    @property
    def embed_dim(self) -> int:
        return self.d

    def _se(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Block i's SE block on h, where the encoder has them."""
        return self.features[self.block_len * i + 4](h) if self.squeeze_excitation else h

    def _block1(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.features[0], self.features[1]
        if self.fused_conv and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            args = (x.permute(0, 2, 3, 1), conv.weight.permute(2, 3, 1, 0),
                    conv.bias, bn.weight, bn.bias)
            if self.training:
                pooled, mean, var = fused_conv1_bn_relu_pool(*args, bn.eps)
                update_running_stats_(bn, mean, var)
            else:
                pooled = fused_conv1_bn_relu_pool_eval(
                    *args, bn.running_mean, bn.running_var, bn.eps)
            return pooled.permute(0, 3, 1, 2)        # contiguous NCHW, as block 2's conv reads it
        return self.features[:4](x)

    def _block2(self, h: torch.Tensor) -> torch.Tensor:
        first = self.block_len
        if not (self.training and self.pool_reorder):
            return self.features[first:first + 4](h)
        conv, bn = self.features[first], self.features[first + 1]
        y = conv(h)
        mean, var = batch_moments(at_least_fp32(y), (0, 2, 3))
        update_running_stats_(bn, mean, var)
        # per-window extreme of y: max where gamma > 0, min otherwise
        # (gamma == 0 included, the fused block's convention)
        shape = (1, -1, 1, 1)
        s = torch.where(bn.weight > 0, 1.0, -1.0).to(y.dtype).view(shape)
        ps = s * torch.nn.functional.max_pool2d(y * s, 2)
        r = torch.rsqrt(var + bn.eps)
        z = bn.weight.view(shape) * (at_least_fp32(ps) - mean.view(shape)) * r.view(shape) \
            + bn.bias.view(shape)
        return torch.relu(z).to(h.dtype)

    def frames(self, x: torch.Tensor,
               dropout_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(B, 1, F, T) -> frame embeddings (B, T/4, d).  dropout_mask: in
        train mode, the keep mask (B, T/4, mlp_hidden_d) of the FC's
        dropout, 1 = keep (kept values are scaled by 1 / 0.7); None draws it
        from torch's global generator."""
        with no_tf32():
            h = self._se(1, self._block2(self._se(0, self._block1(x))))
        B, C, Fp, Tp = h.shape
        h = h.permute(0, 3, 2, 1).reshape(B, Tp, Fp * C)   # (B, T', F'*C)
        if self.training and dropout_mask is not None:
            y = self.fc[1](self.fc[0](h))
            y = y * (dropout_mask.to(y.dtype) / (1.0 - DROPOUT_RATE))
            y = self.fc[4](self.fc[3](y))
        else:
            y = self.fc(h)
        return torch.cat([h, y], dim=-1)

    def forward(self, x: torch.Tensor,
                dropout_mask: torch.Tensor | None = None) -> torch.Tensor:
        return mean_max_pooling(self.frames(x, dropout_mask))


def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX module's initialisers, drawn from `generator`: lecun-normal
    (truncated at 2 std) conv and dense kernels (SE's Linears too: flax
    Dense's default), zero biases, BN scale 1,
    shift 0, running mean 0 and running var 1 (the heads' too).  The draws differ from
    jax.random's; tests hand both packages the same weights instead."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                # flax lecun_normal: truncated normal, std corrected for the truncation
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
    return model
