"""The bf16 compute mode (port of the JAX package's cast, not an autocast:
ssl_audio_tpu/train/state.py:85-100, eval/linear.py:30-39, hear/conv.py:83-101,
hear/vit.py:65-73).

The encoder's parameters and its input are cast to bfloat16, the module
runs as written, and its outputs are cast back to float32.  Inside it each
op follows its operands: convolutions, linear layers, matrix products and
elementwise ops run in bf16; BatchNorm and LayerNorm take their statistics
in fp32 and return bf16 (models/batchnorm.py); the running statistics stay
fp32 buffers; the ViT casts its fp32 position tables and mask token to the
activation's type and takes its reconstruction loss in fp32.  The log-mel
frontend and the augmentations before the encoder, and the heads, loss and
optimizer after it, stay fp32.

Training keeps fp32 master parameters: bf16_params() takes differentiable
bf16 copies for one step, so the gradients flow back through the cast into
the fp32 masters the optimizer updates and the checkpoints hold.  Serving
casts the parameters once, in place (cast_params_).  torch.autocast would
do otherwise (BN's affine parameters in fp32, elementwise ops in whatever
type arrives), so it is not used.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn
from torch.func import functional_call

COMPUTE_DTYPE = torch.bfloat16
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    """"float32" or "bfloat16" (the HEAR wrappers' compute_dtype) -> the
    torch type; anything else raises."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {name!r}")
    return COMPUTE_DTYPES[name]


def bf16_params(module: nn.Module, detach: bool = False) -> Dict[str, torch.Tensor]:
    """bf16 copies of module's floating-point parameters, by name, for
    functional_call.  Differentiable casts (unless `detach`): a backward
    through a forward that used them leaves fp32 gradients on the fp32
    parameters."""
    out = {}
    for name, p in module.named_parameters():
        t = p.detach() if detach else p
        out[name] = t.to(COMPUTE_DTYPE) if t.is_floating_point() else t
    return out


def to_fp32(out):
    """The encoder's output (a tensor or a tuple of them) cast to float32."""
    if isinstance(out, (tuple, list)):
        return type(out)(to_fp32(o) for o in out)
    return out.float() if torch.is_tensor(out) and out.is_floating_point() else out


def forward_bf16(module: nn.Module, params: Dict[str, torch.Tensor], x: torch.Tensor,
                 *args, **kwargs):
    """module(x, *args, **kwargs) with its parameters replaced by `params`
    (bf16_params) and its own buffers (the fp32 running statistics, updated
    in place in train mode), x cast to bf16, the outputs cast to fp32."""
    return to_fp32(functional_call(module, params, (x.to(COMPUTE_DTYPE), *args), kwargs))


def cast_params_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast module's floating-point parameters to `dtype` in place, leaving
    its buffers (BN running statistics, fixed position tables) as they are."""
    with torch.no_grad():
        for p in module.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
    return module
