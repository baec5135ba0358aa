"""Fused multi-head self-attention over the raw qkv projection, forward and
backward (port of ssl_audio_tpu/ops/fused_attention.py).

The contract of the JAX function fused_attention(qkv, key_bias, num_heads):
qkv (B, N, 3C) is the ViT's x @ W_qkv (+ q/v biases), columns [q | k | v]
with head h at columns h*hd of each third; key_bias (B, N) is an additive
pre-softmax logit bias per key (the token mask: 0 or -1e9), broadcast over
heads and queries.  Per head, with hd = C / H and scale = hd^-0.5:

    S = bf16(q) . bf16(k)^T * scale + key_bias     (fp32 sums)
    P = softmax(S)                                 (fp32, max subtracted)
    O = bf16(P) . bf16(v)                          (fp32 sums) -> (B, N, C)

The backward recomputes S and P (no (B, H, N, N) tensor is saved) and gives

    dV = bf16( bf16(P)^T . bf16(dO) )
    dP = bf16(dO) . bf16(v)^T,   T = dP * P,   dS = T - P * rowsum(T)
    dQ = bf16(dS) . bf16(k) * scale                (not rounded)
    dK = bf16( bf16(dS)^T . bf16(q) * scale )
    d key_bias = sum over queries and heads of dS  (fp32)

with the rounding points of the Pallas _bwd_kernel: its fold matmul rounds
dk and dv to bf16 (fused_attention.py:210-211), dq leaves it in fp32 (:207).
The dot operands are bf16 as on the TPU's matrix unit, so this is another
function than the fp32 einsum attention at the ~1e-3 level; the ViT takes it
only with --fused_attention.

The CUDA kernels (csrc/fused_attention.cu) replace the Pallas _fwd_kernel
(:152) and _bwd_kernel (:187); the head packing into block-diagonal slabs
and the 0/1 fold matmuls were a workaround for the TPU's matrix unit and are
gone.  Each has a plain PyTorch version here with the same signature and the
same rounding points: the CPU path and the kernels' oracle.  A wrapper takes
the plain version only for a CPU tensor; for a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ssl_audio_tpu_torch.ops import _build

MAX_SEQ = 256          # the JAX envelope (supports()); the kernels' shared memory holds
MAX_PACKED = 1024      # K and V of one head at N <= 256, hd <= 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fused_attention_fwd_launch": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
    "fused_attention_bwd_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}


def supports(batch: int, seq: int, dim: int, heads: int) -> bool:
    """Shape envelope of the kernels, the JAX function's (callers take the
    einsum path outside it)."""
    if dim % heads:
        return False
    hd = dim // heads
    return (hd % 8 == 0 and hd <= 128 and 1 <= seq <= MAX_SEQ
            and heads * seq <= MAX_PACKED and batch >= 1)


def _scale(dim: int, heads: int) -> float:
    """hd^-0.5 as the fp32 the kernels multiply by."""
    return float(torch.tensor((dim // heads) ** -0.5, dtype=torch.float32))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to fp32."""
    return x.to(torch.bfloat16).float()


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, C) -> (B, H, N, hd)."""
    B, N, C = x.shape
    return x.reshape(B, N, heads, C // heads).transpose(1, 2)


def _qkv_heads(qkv: torch.Tensor, heads: int):
    C = qkv.shape[-1] // 3
    return [_bf16(_heads(qkv[..., i * C:(i + 1) * C], heads)) for i in range(3)]


def _probs(q, k, key_bias, scale):
    """fp32 softmax of the scores, with the Pallas kernel's order of
    operations: (q . k^T) * scale + bias, exp(s - max), e / sum."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale + key_bias[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def fused_attention_fwd_plain(qkv: torch.Tensor, key_bias: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """qkv (B, N, 3C), key_bias (B, N) -> (B, N, C) in plain PyTorch, with
    the kernel's rounding points."""
    B, N, C3 = qkv.shape
    scale = _scale(C3 // 3, num_heads)
    q, k, v = _qkv_heads(qkv, num_heads)
    out = torch.matmul(_bf16(_probs(q, k, key_bias, scale)), v)
    return out.transpose(1, 2).reshape(B, N, C3 // 3)


def fused_attention_bwd_plain(qkv: torch.Tensor, key_bias: torch.Tensor,
                              dout: torch.Tensor, num_heads: int):
    """Plain PyTorch version of fused_attention_bwd_cuda, same signature and
    results: (dqkv (B, N, 3C) = [dq | dk | dv], d key_bias (B, N))."""
    B, N, C3 = qkv.shape
    scale = _scale(C3 // 3, num_heads)
    q, k, v = _qkv_heads(qkv, num_heads)
    do = _bf16(_heads(dout, num_heads))
    p = _probs(q, k, key_bias, scale)
    dv = _bf16(torch.matmul(_bf16(p).transpose(-1, -2), do))
    t = torch.matmul(do, v.transpose(-1, -2)) * p
    ds = t - p * t.sum(dim=-1, keepdim=True)
    dbias = ds.sum(dim=2).sum(dim=1)
    ds16 = _bf16(ds)
    dq = torch.matmul(ds16, k) * scale
    dk = _bf16(torch.matmul(ds16.transpose(-1, -2), q) * scale)
    dqkv = torch.cat([g.transpose(1, 2).reshape(B, N, C3 // 3) for g in (dq, dk, dv)], dim=-1)
    return dqkv, dbias


def _require(qkv, key_bias, num_heads):
    dev = qkv.device
    if dev.type != "cuda":
        raise ValueError(f"the fused attention kernels need CUDA tensors, got {dev}")
    B, N, C3 = qkv.shape
    if C3 % 3 or not supports(B, N, C3 // 3, num_heads):
        raise ValueError(f"unsupported shape: qkv {tuple(qkv.shape)}, {num_heads} heads "
                         f"(supports(): hd % 8 == 0, hd <= 128, N <= {MAX_SEQ}, "
                         f"H * N <= {MAX_PACKED})")
    _build.require(qkv, "qkv", (B, N, C3), dev)
    _build.require(key_bias, "key_bias", (B, N), dev)
    return dev, B, N, C3 // 3


def fused_attention_fwd_cuda(qkv: torch.Tensor, key_bias: torch.Tensor,
                             num_heads: int) -> torch.Tensor:
    """Launch the forward kernel: (B, N, C)."""
    dev, B, N, C = _require(qkv, key_bias, num_heads)
    out = torch.empty(B, N, C, device=dev)
    lib = _build.load("fused_attention.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        code = lib.fused_attention_fwd_launch(
            qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), B, N, num_heads,
            C // num_heads, _scale(C, num_heads), _build.stream_ptr(dev))
    _build.check(code, "fused_attention_fwd_launch")
    fused_attention_fwd_cuda.launches += 1
    return out


fused_attention_fwd_cuda.launches = 0


def fused_attention_bwd_cuda(qkv: torch.Tensor, key_bias: torch.Tensor,
                             dout: torch.Tensor, num_heads: int):
    """Launch the backward kernel: (dqkv (B, N, 3C), d key_bias (B, N)).  The
    kernel writes the bias cotangent per (sample, head, key); the sum over
    heads is a PyTorch reduction, in a fixed order."""
    dev, B, N, C = _require(qkv, key_bias, num_heads)
    _build.require(dout, "dout", (B, N, C), dev)
    dqkv = torch.empty(B, N, 3 * C, device=dev)
    dbias_heads = torch.empty(B, num_heads, N, device=dev)
    lib = _build.load("fused_attention.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        code = lib.fused_attention_bwd_launch(
            qkv.data_ptr(), key_bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            dbias_heads.data_ptr(), B, N, num_heads, C // num_heads,
            _scale(C, num_heads), _build.stream_ptr(dev))
    _build.check(code, "fused_attention_bwd_launch")
    fused_attention_bwd_cuda.launches += 1
    return dqkv, dbias_heads.sum(dim=1)


fused_attention_bwd_cuda.launches = 0


def fused_attention_fwd(qkv, key_bias, num_heads: int) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version on the CPU."""
    if qkv.is_cuda:
        return fused_attention_fwd_cuda(qkv, key_bias, num_heads)
    return fused_attention_fwd_plain(qkv, key_bias, num_heads)


def fused_attention_bwd(qkv, key_bias, dout, num_heads: int):
    if qkv.is_cuda:
        return fused_attention_bwd_cuda(qkv, key_bias, dout, num_heads)
    return fused_attention_bwd_plain(qkv, key_bias, dout, num_heads)


class _FusedAttention(torch.autograd.Function):
    """The JAX custom_vjp fused_attention: saves qkv and the key bias only."""

    @staticmethod
    def forward(ctx, qkv, key_bias, num_heads):
        ctx.num_heads = num_heads
        ctx.save_for_backward(qkv, key_bias)
        return fused_attention_fwd(qkv, key_bias, num_heads)

    @staticmethod
    def backward(ctx, dout):
        qkv, key_bias = ctx.saved_tensors
        dqkv, dbias = fused_attention_bwd(qkv, key_bias, dout.contiguous(), ctx.num_heads)
        return dqkv, (dbias if ctx.needs_input_grad[1] else None), None


def fused_attention(qkv: torch.Tensor, key_bias: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """Multi-head self-attention over the raw qkv projection: qkv (B, N, 3C),
    key_bias (B, N) -> (B, N, C) fp32, differentiable in both through the
    hand-written backward."""
    return _FusedAttention.apply(qkv.float().contiguous(),
                                 key_bias.float().contiguous(), num_heads)
