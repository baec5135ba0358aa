"""Audio-modified ResNet encoders (port of ssl_audio_tpu/models/resnet.py;
the reference's models/resnet.py).

Parameter names are the reference's torch layout, the ones
ssl_audio_tpu/utils/torch_export.py export_resnet_state_dict writes:

  conv1.{0,1,3,4,6,7}                 the deep (ResNet-C) stem: 3 x [Conv, BN, ReLU]
  conv1, bn1                          the 7x7 stem without C
  layer{s}.{b}.conv{c}, .bn{c}        the blocks (c = 1, 2; 1, 2, 3 in a bottleneck)
  layer{s}.{b}.downsample.{0,1}       the projection: 1x1 conv, BN
  layer{s}.{b}.downsample.{1,2}       ResNet-D: AvgPool2d at .0, then conv, BN

The input is the reference's (B, 1, F, T), NCHW throughout (JAX runs NHWC:
the same function).  Padding as in JAX: 1 for a 3x3 conv, 3 for the 7x7
stem, 0 for a 1x1; the stem's 3x3 / 2 max pool padded by 1 with -inf; an
odd input size rounds up through a stride-2 conv and down through a pool,
as XLA's.  ResNet-D's average pool is a VALID pool of the stride's window.

The head: the global average pool over (F, T) -> (B, C), or ReGP (the
ReGP-NRF factories): (B, C, F, T) -> (B, T, F * C), frequency outer and
channel inner as in JAX's NHWC reshape, then max + mean over time.  The max
is amax: after the last block's ReLU zeros tie over time, and amax shares a
tie's gradient evenly, as jnp.max does.

Every BatchNorm has flax's semantics (models/batchnorm.py); the
convolutions run with TF32 off, so whoever calls backward() on the output
does so under ops.no_tf32() too (train/steps.py does).  Under the bf16
compute mode (models/precision.py) the convolutions are cuDNN bf16 and each
BatchNorm takes fp32 statistics into its fp32 buffers and returns bf16.
The ResNets run no hand-written kernel, as the JAX ones run no Pallas one.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Type, Union

import torch
from torch import nn

from ssl_audio_tpu_torch.models.batchnorm import BatchNorm2d
from ssl_audio_tpu_torch.ops import no_tf32


def _as_hw(stride) -> Tuple[int, int]:
    if isinstance(stride, (list, tuple)):
        return (int(stride[0]), int(stride[1]))
    return (int(stride), int(stride))


def _conv(cin: int, cout: int, k: int, stride=1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=_as_hw(stride), padding=k // 2, bias=False)


def _downsample(cin: int, cout: int, stride: Tuple[int, int], D: bool) -> nn.Sequential:
    """The projection of a block's shortcut: a strided 1x1 conv and BN, or for
    ResNet-D with a stride an average pool of the stride's window, then an
    unstrided 1x1 conv and BN."""
    if D and stride != (1, 1):
        return nn.Sequential(nn.AvgPool2d(stride, stride), _conv(cin, cout, 1),
                             BatchNorm2d(cout))
    return nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride=(1, 1),
                 use_projection: bool = False, D: bool = False):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 3, stride)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (_downsample(in_planes, planes, _as_hw(stride), D)
                           if use_projection else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    """ResNet v1.5 bottleneck: the stride on the 3x3 conv."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride=(1, 1),
                 use_projection: bool = False, D: bool = False):
        super().__init__()
        self.conv1 = _conv(in_planes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (_downsample(in_planes, planes * 4, _as_hw(stride), D)
                           if use_projection else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """Pooled encoder: (B, 1, F, T) -> (B, embed_dim).  strides: 5 entries,
    the stem's and the four stages' (an int or an (F, T) pair)."""

    def __init__(self, block_cls: Type[Union[BasicBlock, Bottleneck]], layers: Sequence[int],
                 strides: Sequence, ReGP: bool = False, C: bool = True, D: bool = False):
        super().__init__()
        self.block_cls, self.strides, self.ReGP = block_cls, [_as_hw(s) for s in strides], ReGP
        s0 = self.strides[0]
        if C:
            self.conv1 = nn.Sequential(
                _conv(1, 32, 3, s0), BatchNorm2d(32), nn.ReLU(),
                _conv(32, 32, 3), BatchNorm2d(32), nn.ReLU(),
                _conv(32, 64, 3), BatchNorm2d(64), nn.ReLU())
        else:
            self.conv1 = _conv(1, 64, 7, s0)
            self.bn1 = BatchNorm2d(64)
        self.C = C
        self.maxpool = nn.MaxPool2d(3, 2, padding=1)
        in_planes = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, self.strides[1:]), start=1):
            mods = []
            for b in range(blocks):
                s = stride if b == 0 else (1, 1)
                proj = b == 0 and (s != (1, 1) or in_planes != planes * block_cls.expansion)
                mods.append(block_cls(in_planes, planes, s, proj, D))
                in_planes = planes * block_cls.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*mods))

    @property
    def embed_dim(self) -> int:
        c = 512 * self.block_cls.expansion
        if not self.ReGP:
            return c
        # the frequency extent after the stride plan (64 mels assumed, as in JAX)
        f = 64 // self.strides[0][0] // 2
        for s in self.strides[1:]:
            f //= s[0]
        return c * f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            h = self.conv1(x) if self.C else torch.relu(self.bn1(self.conv1(x)))
            h = self.maxpool(h)
            h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        return regp_pooling(h) if self.ReGP else h.mean(dim=(2, 3))   # or the global average


def regp_pooling(h: torch.Tensor) -> torch.Tensor:
    """The ReGP head: (B, C, F, T) -> (B, T, F * C) -> max + mean over time,
    (B, F * C).  amax shares a tie's gradient evenly among the tied frames,
    as jnp.max does (max(dim) would hand it to one)."""
    B, C, Fr, T = h.shape
    h = h.permute(0, 3, 2, 1).reshape(B, T, Fr * C)
    return h.amax(dim=1) + h.mean(dim=1)


def resnet18(**kw) -> ResNet:
    return ResNet(BasicBlock, [2, 2, 2, 2], [2, 1, 2, 2, 2], **kw)


def resnet34(**kw) -> ResNet:
    return ResNet(BasicBlock, [3, 4, 6, 3], [2, 1, 2, 2, 2], **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(Bottleneck, [3, 4, 6, 3], [2, 1, 2, 2, 2], **kw)


def resnet18_ReGP_NRF(**kw) -> ResNet:
    return ResNet(BasicBlock, [2, 2, 2, 2], [1, 1, 2, 2, (1, 2)], ReGP=True, **kw)


def resnet34_ReGP_NRF(**kw) -> ResNet:
    return ResNet(BasicBlock, [3, 4, 6, 3], [1, 1, 2, 2, (1, 2)], ReGP=True, **kw)


def resnet50_ReGP_NRF(**kw) -> ResNet:
    return ResNet(Bottleneck, [3, 4, 6, 3], [1, 1, 2, 2, (1, 2)], ReGP=True, **kw)


FACTORIES = {f.__name__: f for f in (resnet18, resnet34, resnet50, resnet18_ReGP_NRF,
                                     resnet34_ReGP_NRF, resnet50_ReGP_NRF)}
# the --model_type values and HEAR conv model types of the family (JAX
# models/wrapper.py:22-29, hear/conv.py:48-55)
MODEL_TYPES = ("resnet18", "resnet18_ReGP_NRF", "resnet50", "resnet50_ReGP_NRF")


def init_resnet_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX module's initialisers, drawn from `generator`: every conv
    kaiming fan-out normal, untruncated (variance_scaling(2.0, "fan_out",
    "normal"): std sqrt(2 / (kh kw out))), BN scale 1, shift 0, running
    mean 0 and running var 1.  The draws differ from jax.random's; tests
    hand both packages the same weights instead."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.reset_parameters()
    return model
