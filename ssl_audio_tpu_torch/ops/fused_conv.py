"""Fused Conv3x3(Cin=1) + BatchNorm + ReLU + MaxPool2x2 block, forward
(port of ssl_audio_tpu/ops/fused_conv.py, AudioNTT block 1).

The CUDA kernel (csrc/fused_conv_fwd.cu) replaces the Pallas forward
_fwd_kernel/_fwd_call: for x (B, H, W) with H and W even it computes the
per-2x2-window extreme of the conv output y (max where gamma > 0, else min)
laid out (B, H/2, W/2, C), and the per-channel sums s1 = sum(y),
s2 = sum(y^2) over the full conv output.  Because the BN affine and ReLU
are monotone in y with direction sign(gamma), pool(relu(bn(y))) equals
relu(bn(extreme)), so the (B, H, W, C) activation is never stored.  The
eval block fuses the running-statistics epilogue into the same kernel.
It is bound by the bytes of the pooled output on the H100 (see the source).

The plain version beside it (conv2d + per-channel sums + a sign-aware 2x2
max pool) is the CPU path and the kernel's oracle.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ssl_audio_tpu_torch.ops import _build, no_tf32

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_conv1_fwd_launch": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _P],
    "fused_conv1_fwd_blocks": [_I, _I, _I],
}
MAX_GRID_Z = 65535
C_OUT = 64                     # the kernel's channel count, a compile-time constant


def fused_conv1_fwd_plain(x: torch.Tensor, wk: torch.Tensor,
                          bias: torch.Tensor, gamma: torch.Tensor):
    """x (B, H, W), wk (9, C) tap-major -> (sel (B, H/2, W/2, C), s1 (C,),
    s2 (C,)) in plain PyTorch."""
    C = wk.shape[1]
    with no_tf32():
        y = F.conv2d(x[:, None], wk.t().reshape(C, 1, 3, 3), bias, padding=1)
    s1 = y.sum(dim=(0, 2, 3))
    s2 = (y * y).sum(dim=(0, 2, 3))
    sign = torch.where(gamma > 0, 1.0, -1.0).to(y.dtype)[None, :, None, None]
    sel = sign * F.max_pool2d(y * sign, 2)
    return sel.permute(0, 2, 3, 1).contiguous(), s1, s2


def fused_conv1_fwd_cuda(x: torch.Tensor, wk: torch.Tensor, bias: torch.Tensor,
                         gamma: torch.Tensor, stats: torch.Tensor | None = None):
    """Launch the CUDA kernel.  stats None: returns (sel, s1, s2).
    stats (3, C) = (running mean, rsqrt(running var + eps), beta): returns
    the eval block's relu(gamma * (sel - mean) * r + beta), (B, H/2, W/2, C)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_conv1_fwd_cuda needs a CUDA tensor, got {dev}")
    B, H, W = x.shape
    C = wk.shape[-1]
    if H % 2 or W % 2 or C != C_OUT or not 0 < B <= MAX_GRID_Z:
        raise ValueError(f"unsupported shape: x {tuple(x.shape)}, C={C} "
                         f"(H, W even; C = {C_OUT}; 0 < B <= {MAX_GRID_Z})")
    _build.require(x, "x", (B, H, W), dev)
    _build.require(wk, "wk", (9, C), dev)
    _build.require(bias, "bias", (C,), dev)
    _build.require(gamma, "gamma", (C,), dev)
    out = torch.empty(B, H // 2, W // 2, C, device=dev)
    lib = _build.load("fused_conv_fwd.cu", _SIGNATURES)
    if stats is not None:
        _build.require(stats, "stats", (3, C), dev)
        args = (stats.data_ptr(), out.data_ptr(), None, None)
    else:
        n_blocks = lib.fused_conv1_fwd_blocks(B, H, W)
        partials = torch.empty(2, n_blocks, C, device=dev)
        sums = torch.empty(2, C, device=dev)
        args = (None, out.data_ptr(), partials.data_ptr(), sums.data_ptr())
    with torch.cuda.device(dev):
        code = lib.fused_conv1_fwd_launch(
            x.data_ptr(), B, H, W, wk.data_ptr(), bias.data_ptr(),
            gamma.data_ptr(), *args, C, int(stats is not None),
            _build.stream_ptr(dev))
    _build.check(code, "fused_conv1_fwd_launch")
    fused_conv1_fwd_cuda.launches += 1
    return out if stats is not None else (out, sums[0], sums[1])


fused_conv1_fwd_cuda.launches = 0


def fused_conv1_fwd(x: torch.Tensor, wk: torch.Tensor, bias: torch.Tensor,
                    gamma: torch.Tensor):
    """(sel, s1, s2) of the fused block (the contract of the Pallas
    _fwd_call): the kernel for a CUDA tensor, the plain version on the CPU."""
    if x.is_cuda:
        return fused_conv1_fwd_cuda(x, wk, bias, gamma)
    return fused_conv1_fwd_plain(x, wk, bias, gamma)


def fused_conv1_bn_relu_pool_eval(x, kernel, bias, gamma, beta, mean, var,
                                  eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode block, forward only: conv + BN with running stats +
    relu + 2x2 max pool.  x (B, H, W, 1) with H, W even, kernel (3, 3, 1, C)
    -> (B, H/2, W/2, C), the JAX function's layouts."""
    x2 = x[..., 0].float().contiguous()
    C = kernel.shape[-1]
    wk = kernel.reshape(9, C).float().contiguous()
    r = torch.rsqrt(var.float() + eps)
    if x2.is_cuda:
        stats = torch.stack([mean.float(), r, beta.float()]).contiguous()
        return fused_conv1_fwd_cuda(x2, wk, bias.float().contiguous(),
                                    gamma.float().contiguous(), stats)
    sel, _, _ = fused_conv1_fwd_plain(x2, wk, bias, gamma)
    return torch.relu(gamma * (sel - mean) * r + beta)
