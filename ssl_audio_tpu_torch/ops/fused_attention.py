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

    dV = bf16( bf16(P)^T . bf16(dO) )             (fp32 sums over queries in order)
    dP = bf16(dO) . bf16(v)^T,   T = dP * P,   dS = T - P * rowsum(T)
    dQ = bf16(dS) . bf16(k) * scale                (not rounded)
    dK = bf16( bf16(dS)^T . bf16(q) * scale )     (the same)
    d key_bias = sum over queries and heads of dS  (fp32)

with the rounding points of the Pallas _bwd_kernel: its fold matmul rounds
dk and dv to bf16 (fused_attention.py:210-211), dq leaves it in fp32 (:207).
The dot operands are bf16 as on the TPU's matrix unit, so this is another
function than the fp32 einsum attention at the ~1e-3 level; the ViT takes it
only with --fused_attention.

The CUDA kernels (csrc/fused_attention.cu) replace the Pallas _fwd_kernel
(:152) and _bwd_kernel (:187); the head packing into block-diagonal slabs
and the 0/1 fold matmuls were a workaround for the TPU's matrix unit and are
gone.  A block takes G heads of one sample, staged from the raw qkv by
cp.async and converted to bf16 once.  The scores and dP are fp32 FMA sums in
the plain versions' order (so P and dS round to bf16 as here); P V and dQ
run on the tensor cores (mma.sync m16n8k16, bf16 operands, exact products,
fp32 sums in another order).  dK and dV, which the contract rounds to bf16,
are fp32 FMA sums over queries in order on the CUDA cores, the plain
version's order (_sum_over_queries), so they round to the same bf16 values.
A warp owns a 16-query tile for the softmax -- row max, then the row sum,
then the normalised P, as the contract rounds it -- P V and dQ, or a 16-key
tile for dK and dV, summed over every query inside the warp.  plan() picks
G and the number R of 16-query tiles resident at once (all of them unless N
is above 64); the kernels check the same layout.  The bias cotangent comes
out per (sample, group of G heads) and is summed over the H / G groups here
when G < H.  Each kernel has a plain PyTorch version here with the same
signature and the same rounding points: the CPU path and the kernels'
oracle.  A wrapper takes the plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises.

Precision: qkv (and dO) are float32, or bfloat16 under the bf16 compute
mode, read as they are (the kernels are templates over the type: a bf16
qkv is staged without conversion).  The output and dq / dk / dv come back
in qkv's type (the JAX function's out_shape, fused_attention.py:178,
:230-232); the key bias and its cotangent stay fp32 (:233).  The products
and sums are the same in both types; in bf16 the output and dq take one
more rounding (to bf16) than in fp32, where the contract leaves them fp32,
and dk / dv, already rounded to bf16 in fp32, are stored as they are.  Each
wrapper counts its fp32 and bf16 launches apart (`launches`,
`launches_bf16`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ssl_audio_tpu_torch.ops import _build

MAX_SEQ = 256          # the JAX envelope (supports()); the kernels' shared memory holds
MAX_PACKED = 1024      # K and V of one head at N <= 256, hd <= 128

# the launch geometry of csrc/fused_attention.cu (layout(), warps_of())
TILE = 16              # query / key rows per mma tile
MAX_WARPS = 8
SMEM_PER_BLOCK = 232448    # H100: the most dynamic shared memory a block may take
ROWS_PER_BLOCK = 64        # padded query rows of the heads a block takes, at most (plan())

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "fused_attention_fwd_launch": [_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    "fused_attention_bwd_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                                   _P],
    "fused_attention_smem_bytes": [_I, _I, _I, _I, _I],
    "fused_attention_warps": [_I, _I, _I, _I],
}


def supports(batch: int, seq: int, dim: int, heads: int) -> bool:
    """Shape envelope of the kernels, the JAX function's (callers take the
    einsum path outside it)."""
    if dim % heads:
        return False
    hd = dim // heads
    return (hd % 8 == 0 and hd <= 128 and 1 <= seq <= MAX_SEQ
            and heads * seq <= MAX_PACKED and batch >= 1)


@functools.lru_cache(maxsize=None)
def _scale(dim: int, heads: int) -> float:
    """hd^-0.5 as the fp32 the kernels multiply by."""
    return float(torch.tensor((dim // heads) ** -0.5, dtype=torch.float32))


def _pad(n: int) -> int:
    return -(-n // TILE) * TILE


def padded_head_dim(hd: int) -> int:
    """The kernels' instantiation for head width hd: 32, 64 or 128 columns."""
    return 32 if hd <= 32 else 64 if hd <= 64 else 128


def launch_warps(seq: int, G: int, R: int, backward: bool) -> int:
    """Warps per block: one per (head, query tile) of a round, and in the
    backward one per (head, key tile), at most MAX_WARPS (warps loop over
    the rest)."""
    tasks = G * R
    if backward:
        tasks = max(tasks, G * (_pad(seq) // TILE))
    return min(tasks, MAX_WARPS)


def ring_slots(seq: int, hd: int, G: int, R: int, backward: bool) -> int:
    """16-byte cp.async slots per thread: all of the first round's chunks of
    k, q, v (and dO) where they fit in 32 KB, else as many as do."""
    T = 32 * launch_warps(seq, G, R, backward)
    cpr, rq = G * hd // 4, min(R * TILE, seq)
    want = 2 * -(-seq * cpr // T) + (2 if backward else 1) * -(-rq * cpr // T)
    return min(want, 2048 // T)


def smem_bytes(seq: int, hd: int, G: int, R: int, backward: bool) -> int:
    """Dynamic shared memory of one block: bf16 K and V of G heads (all keys,
    rows padded to 16, row stride padded hd + 8) and q (and dO) for R query
    tiles; the key bias (and the tiles' column sums of dS and the per-head
    bias cotangent) in fp32; then the larger of the score rows of the
    round's queries -- fp32 scores (and dP * P), stride N + 2; bf16 P (and
    dS), stride N + 8 -- and the cp.async ring that overlays them."""
    lds = padded_head_dim(hd) + 8
    np_, rq = _pad(seq), R * TILE
    bwd = 1 if backward else 0
    tiles = 2 * (2 * G * np_ * lds + (1 + bwd) * G * rq * lds)
    floats = np_ + bwd * (G * R * np_ + G * np_)
    scores = G * rq * (1 + bwd) * (4 * (np_ + 2) + 2 * (np_ + 8))
    ring = 16 * 32 * launch_warps(seq, G, R, backward) * ring_slots(seq, hd, G, R, backward)
    return tiles + 4 * floats + max(scores, ring)


class Plan(NamedTuple):
    heads_per_block: int       # G, a divisor of H
    rounds_tiles: int          # R: 16-query tiles resident at once
    warps: int
    smem: int                  # bytes per block
    blocks: int


def plan_for(batch: int, seq: int, heads: int, hd: int, backward: bool, G: int) -> Plan:
    """The launch with G heads per block: the most query tiles per round
    that fit in a block's shared memory."""
    if heads % G:
        raise ValueError(f"{G} heads per block do not divide {heads}")
    for R in range(_pad(seq) // TILE, 0, -1):
        smem = smem_bytes(seq, hd, G, R, backward)
        if smem <= SMEM_PER_BLOCK:
            return Plan(G, R, launch_warps(seq, G, R, backward), smem, batch * heads // G)
    raise ValueError(f"no round of query tiles fits: N {seq}, hd {hd}, G {G}")


@functools.lru_cache(maxsize=None)
def plan(batch: int, seq: int, heads: int, hd: int, backward: bool) -> Plan:
    """G and R for one launch: the most heads per block whose padded query
    rows stay within 64 (four warps on the query tiles) and whose block fits
    with every query tile resident; else one head per block, with rounds of
    query tiles where they do not all fit.  At the ViT-B step this is G = 2
    at N = 25 and G = 4 at N = 7, the fastest or within 2 % of it among every
    G timed on the card (tools/attention_sweep.py, PERF.md)."""
    ntiles = _pad(seq) // TILE
    for G in range(min(heads, ROWS_PER_BLOCK // _pad(seq)), 1, -1):
        if heads % G == 0:
            p = plan_for(batch, seq, heads, hd, backward, G)
            if p.rounds_tiles == ntiles:
                return p
    return plan_for(batch, seq, heads, hd, backward, 1)


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
    """qkv (B, N, 3C), key_bias (B, N) -> (B, N, C) in qkv's type, in plain
    PyTorch, with the kernel's rounding points."""
    B, N, C3 = qkv.shape
    scale = _scale(C3 // 3, num_heads)
    q, k, v = _qkv_heads(qkv, num_heads)
    out = torch.matmul(_bf16(_probs(q, k, key_bias.float(), scale)), v)
    return out.transpose(1, 2).reshape(B, N, C3 // 3).to(qkv.dtype)


def _sum_over_queries(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^T b for a (B, H, N, N) and b (B, H, N, hd), both bf16 values: the
    fp32 sum over queries i = 0, 1, ..., N - 1 in that order, one term at a
    time.  A product of two bf16 values is exact in fp32, so each step
    rounds once, as the kernel's fmaf chain does: the two give the same
    bits, and dK and dV round to the same bf16 values."""
    acc = torch.zeros(*a.shape[:2], a.shape[3], b.shape[3], dtype=a.dtype, device=a.device)
    for i in range(a.shape[2]):
        acc = acc + a[:, :, i, :, None] * b[:, :, i, None, :]
    return acc


def fused_attention_bwd_plain(qkv: torch.Tensor, key_bias: torch.Tensor,
                              dout: torch.Tensor, num_heads: int):
    """Plain PyTorch version of fused_attention_bwd_cuda, same signature and
    results: (dqkv (B, N, 3C) = [dq | dk | dv] in qkv's type, d key_bias
    (B, N) fp32)."""
    B, N, C3 = qkv.shape
    scale = _scale(C3 // 3, num_heads)
    q, k, v = _qkv_heads(qkv, num_heads)
    do = _bf16(_heads(dout, num_heads))
    p = _probs(q, k, key_bias.float(), scale)
    dv = _bf16(_sum_over_queries(_bf16(p), do))
    t = torch.matmul(do, v.transpose(-1, -2)) * p
    ds = t - p * t.sum(dim=-1, keepdim=True)
    dbias = ds.sum(dim=2).sum(dim=1)
    ds16 = _bf16(ds)
    dq = torch.matmul(ds16, k) * scale
    dk = _bf16(_sum_over_queries(ds16, q) * scale)
    dqkv = torch.cat([g.transpose(1, 2).reshape(B, N, C3 // 3) for g in (dq, dk, dv)], dim=-1)
    return dqkv.to(qkv.dtype), dbias


def _require(qkv, key_bias, num_heads):
    """qkv float32 or bfloat16, key_bias float32, on the card, in the
    envelope."""
    dev = qkv.device
    if dev.type != "cuda":
        raise ValueError(f"the fused attention kernels need CUDA tensors, got {dev}")
    B, N, C3 = qkv.shape
    if C3 % 3 or not supports(B, N, C3 // 3, num_heads):
        raise ValueError(f"unsupported shape: qkv {tuple(qkv.shape)}, {num_heads} heads "
                         f"(supports(): hd % 8 == 0, hd <= 128, N <= {MAX_SEQ}, "
                         f"H * N <= {MAX_PACKED})")
    _build.dtype_code(qkv, "qkv")
    _build.require(qkv, "qkv", (B, N, C3), dev, qkv.dtype)
    _build.require(key_bias, "key_bias", (B, N), dev)
    return dev, B, N, C3 // 3


def fused_attention_fwd_cuda(qkv: torch.Tensor, key_bias: torch.Tensor,
                             num_heads: int) -> torch.Tensor:
    """Launch the forward kernel: (B, N, C)."""
    dev, B, N, C = _require(qkv, key_bias, num_heads)
    return _launch_fwd(qkv, key_bias, num_heads, plan(B, N, num_heads, C // num_heads, False))


def _launch_fwd(qkv, key_bias, num_heads: int, p: Plan) -> torch.Tensor:
    B, N, C3 = qkv.shape
    C = C3 // 3
    out = torch.empty(B, N, C, device=qkv.device, dtype=qkv.dtype)
    lib = _build.load("fused_attention.cu", _SIGNATURES)
    with torch.cuda.device(qkv.device):
        code = lib.fused_attention_fwd_launch(
            qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), B, N, num_heads,
            C // num_heads, _scale(C, num_heads), p.heads_per_block, p.rounds_tiles,
            _build.DTYPE_CODES[qkv.dtype], _build.stream_ptr(qkv.device))
    _build.check(code, "fused_attention_fwd_launch")
    _build.count_launch(fused_attention_fwd_cuda, qkv.dtype)
    return out


fused_attention_fwd_cuda.launches = 0
fused_attention_fwd_cuda.launches_bf16 = 0


def fused_attention_bwd_cuda(qkv: torch.Tensor, key_bias: torch.Tensor,
                             dout: torch.Tensor, num_heads: int):
    """Launch the backward kernel: (dqkv (B, N, 3C), d key_bias (B, N)).  The
    kernel writes the bias cotangent per (sample, group of G heads, key),
    summed over its heads in a fixed order; where G < H the sum over the
    groups is a PyTorch reduction, also in a fixed order."""
    dev, B, N, C = _require(qkv, key_bias, num_heads)
    _build.require(dout, "dout", (B, N, C), dev, qkv.dtype)
    return _launch_bwd(qkv, key_bias, dout, num_heads,
                       plan(B, N, num_heads, C // num_heads, True))


def _launch_bwd(qkv, key_bias, dout, num_heads: int, p: Plan):
    B, N, C3 = qkv.shape
    C = C3 // 3
    groups = num_heads // p.heads_per_block
    dqkv = torch.empty(B, N, C3, device=qkv.device, dtype=qkv.dtype)
    dbias = torch.empty(B, groups, N, device=qkv.device)
    # bf16 with rounds of query tiles: the running dK / dV sums need fp32 room
    run = None
    if qkv.dtype == torch.bfloat16 and p.rounds_tiles < _pad(N) // TILE:
        run = torch.empty(B, N, C3, device=qkv.device)
    lib = _build.load("fused_attention.cu", _SIGNATURES)
    with torch.cuda.device(qkv.device):
        code = lib.fused_attention_bwd_launch(
            qkv.data_ptr(), key_bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            dbias.data_ptr(), None if run is None else run.data_ptr(), B, N, num_heads,
            C // num_heads, _scale(C, num_heads), p.heads_per_block, p.rounds_tiles,
            _build.DTYPE_CODES[qkv.dtype], _build.stream_ptr(qkv.device))
    _build.check(code, "fused_attention_bwd_launch")
    _build.count_launch(fused_attention_bwd_cuda, qkv.dtype)
    return dqkv, (dbias[:, 0] if groups == 1 else dbias.sum(dim=1))


fused_attention_bwd_cuda.launches = 0
fused_attention_bwd_cuda.launches_bf16 = 0


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
    key_bias (B, N) -> (B, N, C), differentiable in both through the
    hand-written backward.  A bfloat16 qkv runs the kernels' bf16
    instantiation and gives bf16; anything else is taken in float32."""
    if qkv.dtype != torch.bfloat16:
        qkv = qkv.float()
    return _FusedAttention.apply(qkv.contiguous(), key_bias.float().contiguous(), num_heads)
