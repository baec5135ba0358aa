"""AudioNTT2022 encoder, eval mode (port of ssl_audio_tpu/models/audiontt.py;
the BYOL-A v2 CNN of the reference model.py:130-210).

Parameter names are the reference's torch layout (`features.{0,1,4,5}`,
`fc.{0,3}`), so a reference `.pth` loads with strict=True:

  2 x [Conv3x3(64) - BN - ReLU - MaxPool2x2]          -> (B, 64, F/4, T/4)
  per-timeframe flatten (mel x channel = 1024)          -> (B, T/4, 1024)
  FC: 1024 -> 2048 -> ReLU -> Dropout(0.3) -> 2048 -> ReLU
  stack conv features with FC features                  -> (B, T/4, 3072)
  mean + max pooling over time                          -> (B, 3072)

Block 1 goes through the fused Conv-BN-ReLU-Pool kernel
(ops/fused_conv.py) when fused_conv=True and the input's H and W are even,
the rule of the JAX module; otherwise (the 10-s scene clips, T = 1001) it is
the plain Conv2d + BatchNorm + ReLU + MaxPool2d composition.  Block 2 is
always plain, as in JAX.  Convolutions run with TF32 off: the HEAR
embeddings are an fp32 contract, and cuDNN would otherwise take fp32
convolutions through TF32.  Training mode belongs to the training slice.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ssl_audio_tpu_torch.ops import no_tf32
from ssl_audio_tpu_torch.ops.fused_conv import fused_conv1_bn_relu_pool_eval


def mean_max_pooling(frames: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, D): max over time + mean over time."""
    return frames.max(dim=1).values + frames.mean(dim=1)


class AudioNTT2022(nn.Module):
    """Pooled encoder: (B, 1, F, T) -> (B, d)."""

    def __init__(self, n_mels: int = 64, d: int = 3072, base_d: int = 64,
                 mlp_hidden_d: int = 2048, fused_conv: bool = False):
        super().__init__()
        self.n_mels, self.d, self.base_d = n_mels, d, base_d
        self.fused_conv = fused_conv
        self.features = nn.Sequential(
            nn.Conv2d(1, base_d, 3, padding=1), nn.BatchNorm2d(base_d),
            nn.ReLU(), nn.MaxPool2d(2, 2),
            nn.Conv2d(base_d, base_d, 3, padding=1), nn.BatchNorm2d(base_d),
            nn.ReLU(), nn.MaxPool2d(2, 2))
        conv_d = base_d * (n_mels // 4)
        self.fc = nn.Sequential(
            nn.Linear(conv_d, mlp_hidden_d), nn.ReLU(), nn.Dropout(0.3),
            nn.Linear(mlp_hidden_d, d - conv_d), nn.ReLU())

    @property
    def embed_dim(self) -> int:
        return self.d

    def _block1(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.features[0], self.features[1]
        if self.fused_conv and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            pooled = fused_conv1_bn_relu_pool_eval(
                x.permute(0, 2, 3, 1), conv.weight.permute(2, 3, 1, 0),
                conv.bias, bn.weight, bn.bias, bn.running_mean,
                bn.running_var, bn.eps)
            return pooled.permute(0, 3, 1, 2)        # NCHW view, channels-last memory
        return self.features[:4](x)

    def frames(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, F, T) -> frame embeddings (B, T/4, d)."""
        if self.training:
            raise NotImplementedError(
                "AudioNTT2022 training mode is not ported yet; call .eval()")
        with no_tf32():
            h = self._block1(x)
            h = self.features[4:](h)
        B, C, Fp, Tp = h.shape
        h = h.permute(0, 3, 2, 1).reshape(B, Tp, Fp * C)   # (B, T', F'*C)
        return torch.cat([h, self.fc(h)], dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mean_max_pooling(self.frames(x))


def init_weights_(model: AudioNTT2022, generator: torch.Generator) -> AudioNTT2022:
    """The JAX module's initialisers, drawn from `generator`: lecun-normal
    (truncated at 2 std) conv and dense kernels, zero biases, BN scale 1,
    shift 0, running mean 0 and running var 1.  The draws differ from
    jax.random's; tests hand both packages the same weights instead."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                # flax lecun_normal: truncated normal, std corrected for the truncation
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model
