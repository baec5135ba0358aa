"""Fused Conv3x3(Cin=1) + BatchNorm + ReLU + MaxPool2x2 block, forward and
backward (port of ssl_audio_tpu/ops/fused_conv.py, AudioNTT block 1).

The CUDA kernel (csrc/fused_conv_fwd.cu) replaces the Pallas forward
_fwd_kernel/_fwd_call: for x (B, H, W) with H and W even it computes the
per-2x2-window extreme of the conv output y (max where gamma > 0, else min)
of shape (B, H/2, W/2, C), and the per-channel sums s1 = sum(y),
s2 = sum(y^2) over the full conv output.  Because the BN affine and ReLU
are monotone in y with direction sign(gamma), pool(relu(bn(y))) equals
relu(bn(extreme)), so the (B, H, W, C) activation is never stored.  The
eval block fuses the running-statistics epilogue into the same kernel.
Its bytes and its FMA nearly tie as bounds on the H100 (see the source).

Layout: the (B, H/2, W/2, C) results are views of channel-major memory,
(B, C, H/2, W/2) contiguous (as the TPU kernel's own sel), so that the
model's permute to NCHW hands block 2's cuDNN convolution a contiguous
NCHW tensor: with channels-last memory cuDNN converted it to NCHW and its
output back around every block-2 convolution.  The plain versions give the
same layout; the backward kernels read pooled and its cotangent in it
(nchw_memory() says whether a tensor is in it).

The training block fused_conv1_bn_relu_pool is a torch.autograd.Function
around that forward in its statistics mode.  Its backward is two more CUDA
kernels (csrc/fused_conv_bwd.cu), the ports of the Pallas _bwd_kernel and
_dx_kernel: fused_conv1_bwd_cuda recomputes the conv corners, routes the
cotangent to the first extreme of each window and reduces the per-channel
and per-tap sums the parameter gradients are assembled from (in tap space;
the TPU's X16 slots have no counterpart); fused_conv1_dx_cuda writes the
conv output's cotangent dy and runs only when the block's input itself
needs a gradient, which the encoder's first layer never does.

Each kernel has a plain version beside it with the kernel's own signature
(conv2d, unfold and einsum): the CPU path and the kernel's oracle.  A
wrapper takes it only for a CPU tensor; for a CUDA tensor it launches the
kernel or raises.  In a process group (parallel/) the training block's
autograd Function takes the global batch's statistics: the forward's s1 and
s2 and the backward's T1 and T2 are summed over ranks between the kernel
launches (NCCL outside the kernels), and n counts the global batch; the
kernels themselves run unchanged on each rank's rows, and the parameter
gradients stay each rank's share, as in JAX's sharded block.

Precision, the JAX function's contract in both types: x and the conv and
BN parameters are float32, or bfloat16 under the bf16 compute mode (a
model cast to bf16 hands the block bf16 parameters; the kernels are
templates over the type).  bf16 values widen to fp32 exactly and their
products are exact, so y, s1 / s2, the batch statistics and every sum of
the backward are fp32; sel is rounded to bf16 as it is stored, and pooled,
the eval output, dW and db come back in x's type, dgamma and dbeta in
gamma's (fused_conv.py:534-536).  The backward's relu' follows JAX in
bf16: z = gamma xhat + beta > 0 in fp32 at the selected corner, since the
bf16 pooled (z of the rounded sel) can differ from it in sign near 0; fp32
keeps pooled > 0, which agrees with z but for last-bit cases.  The dx
kernel stays fp32 only and raises on bf16 (no bf16 path differentiates
block 1's input).  Each wrapper counts
its fp32 and bf16 launches apart (`launches`, `launches_bf16`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ssl_audio_tpu_torch import parallel
from ssl_audio_tpu_torch.ops import _build, no_tf32

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_conv1_fwd_launch": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _P],
    "fused_conv1_fwd_blocks": [_I, _I, _I],
    "fused_conv1_fwd_blocks_per_sm": [_I, _I],
}
_BWD_SIGNATURES = {
    "fused_conv1_bwd_blocks": [_I, _I, _I],
    "fused_conv1_bwd_blocks_per_sm": [_I],
    "fused_conv1_bwd_launch": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                               _P, _P, _I, _I, _P],
    "fused_conv1_dx_launch": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              ctypes.c_float, _P, _I, _P],
}
N_CHAN_SUMS = 12               # rows of the backward's per-channel sums: T1, T2, Sx, A1[0..8]
N_TAP_SUMS = 90                # ... and its channel-free sums: Gram (9 x 9), A2 (9)
MAX_GRID_Z = 65535             # the dx kernel's grid: one z per image
C_OUT = 64                     # the kernel's channel count, a compile-time constant

# the launch geometry of csrc/fused_conv_common.cuh: a thread per group of
# CELLS window cells of one window row, THREADS threads a block
CELLS = 4
THREADS = 128
SMEM_FWD = C_OUT * 16 * 4 + 2 * (THREADS // 32) * C_OUT * 4     # weights, per-warp s1 / s2
SMEM_BWD = C_OUT * 16 * 4 + (THREADS // 32) * (N_CHAN_SUMS * C_OUT + 64) * 4
SMS = 132                      # H100 SXM


class ConvPlan(NamedTuple):
    groups_per_row: int        # groups of CELLS cells in a window row (the last may be ragged)
    groups: int                # threads with cells: B * H/2 * groups_per_row
    blocks: int                # of THREADS threads, each writing one row of partial sums


def launch_plan(B: int, H: int, W: int) -> ConvPlan:
    """The forward and backward kernels' grid for x (B, H, W) (the
    kernels' n_blocks()): groups numbered row-major over (b, i, j / CELLS)."""
    g4 = -(-(W // 2) // CELLS)
    groups = B * (H // 2) * g4
    blocks = -(-groups // THREADS)
    return ConvPlan(g4, groups, blocks)


def waves(blocks: int, blocks_per_sm: int, sms: int = SMS) -> float:
    """Rounds of resident blocks the card runs a grid in."""
    return blocks / (blocks_per_sm * sms)


def working_dtype(x: torch.Tensor) -> torch.dtype:
    """The type the block computes in for an input x: bfloat16 stays
    bfloat16, float32 and float64 run in float32; any other type raises."""
    if x.dtype == torch.bfloat16:
        return x.dtype
    if x.dtype in (torch.float32, torch.float64):
        return torch.float32
    raise ValueError(f"the fused conv block takes float32 or bfloat16, got {x.dtype}")


def nchw_memory(t: torch.Tensor) -> bool:
    """t (B, H/2, W/2, C) is a view of contiguous (B, C, H/2, W/2) memory."""
    return t.dim() == 4 and t.permute(0, 3, 1, 2).is_contiguous()


def _require_pooled(t: torch.Tensor, name: str, shape: tuple, dev: torch.device,
                    dtype: torch.dtype) -> None:
    """Raise unless t is a `dtype` (B, H/2, W/2, C) view of channel-major
    memory on `dev`: strides, not just contiguity."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not nchw_memory(t):
        raise ValueError(
            f"{name}: want {dtype} {tuple(shape)} on {dev} over (B, C, H/2, W/2) memory, "
            f"got {t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}")


def fused_conv1_fwd_plain(x: torch.Tensor, wk: torch.Tensor,
                          bias: torch.Tensor, gamma: torch.Tensor):
    """x (B, H, W), wk (9, C) tap-major -> (sel (B, H/2, W/2, C) over
    channel-major memory, in x's type; s1 (C,), s2 (C,) fp32) in plain
    PyTorch.  bf16 operands are widened (exactly) and the conv runs in fp32;
    sel is rounded to x's type."""
    C = wk.shape[1]
    with no_tf32():
        y = F.conv2d(x.float()[:, None], wk.float().t().reshape(C, 1, 3, 3), bias.float(),
                     padding=1)
    s1 = y.sum(dim=(0, 2, 3))
    s2 = (y * y).sum(dim=(0, 2, 3))
    sign = torch.where(gamma > 0, 1.0, -1.0).to(y.dtype)[None, :, None, None]
    sel = (sign * F.max_pool2d(y * sign, 2)).to(x.dtype)
    return sel.permute(0, 2, 3, 1), s1, s2


def fused_conv1_fwd_cuda(x: torch.Tensor, wk: torch.Tensor, bias: torch.Tensor,
                         gamma: torch.Tensor, stats: torch.Tensor | None = None):
    """Launch the CUDA kernel.  stats None: returns (sel, s1, s2).
    stats (3, C) = (running mean, rsqrt(running var + eps), beta), fp32:
    returns the eval block's relu(gamma * (sel - mean) * r + beta),
    (B, H/2, W/2, C).  Either output is a view of (B, C, H/2, W/2) memory in
    x's type; x, wk, bias and gamma are all float32 or all bfloat16 (the
    kernel's bf16 instantiation), s1 and s2 fp32."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_conv1_fwd_cuda needs a CUDA tensor, got {dev}")
    B, H, W = x.shape
    C = wk.shape[-1]
    if H % 2 or W % 2 or C != C_OUT or B < 1:
        raise ValueError(f"unsupported shape: x {tuple(x.shape)}, C={C} "
                         f"(H, W even; C = {C_OUT}; B >= 1)")
    code = _build.dtype_code(x, "x")
    _build.require(x, "x", (B, H, W), dev, x.dtype)
    _build.require(wk, "wk", (9, C), dev, x.dtype)
    _build.require(bias, "bias", (C,), dev, x.dtype)
    _build.require(gamma, "gamma", (C,), dev, x.dtype)
    out = torch.empty(B, C, H // 2, W // 2, device=dev, dtype=x.dtype)
    lib = _build.load("fused_conv_fwd.cu", _SIGNATURES)
    if stats is not None:
        _build.require(stats, "stats", (3, C), dev)
        args = (stats.data_ptr(), out.data_ptr(), None, None)
    else:
        partials = torch.empty(lib.fused_conv1_fwd_blocks(B, H, W), 2, C, device=dev)
        sums = torch.empty(2, C, device=dev)
        args = (None, out.data_ptr(), partials.data_ptr(), sums.data_ptr())
    with torch.cuda.device(dev):
        err = lib.fused_conv1_fwd_launch(
            x.data_ptr(), B, H, W, wk.data_ptr(), bias.data_ptr(),
            gamma.data_ptr(), *args, C, int(stats is not None), code,
            _build.stream_ptr(dev))
    _build.check(err, "fused_conv1_fwd_launch")
    _build.count_launch(fused_conv1_fwd_cuda, x.dtype)
    out = out.permute(0, 2, 3, 1)
    return out if stats is not None else (out, sums[0], sums[1])


fused_conv1_fwd_cuda.launches = 0
fused_conv1_fwd_cuda.launches_bf16 = 0


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
    -> (B, H/2, W/2, C), the JAX function's shapes; the output is a view of
    (B, C, H/2, W/2) memory, bf16 for a bf16 x (the parameters then go in
    bf16 too, the running statistics and the epilogue stay fp32)."""
    dt = working_dtype(x)
    x2 = x[..., 0].to(dt).contiguous()
    C = kernel.shape[-1]
    wk = kernel.reshape(9, C).to(dt).contiguous()
    r = torch.rsqrt(var.float() + eps)
    if x2.is_cuda:
        stats = torch.stack([mean.float(), r, beta.float()]).contiguous()
        return fused_conv1_fwd_cuda(x2, wk, bias.to(dt).contiguous(),
                                    gamma.to(dt).contiguous(), stats)
    sel, _, _ = fused_conv1_fwd_plain(x2, wk, bias, gamma)
    return torch.relu(gamma.float() * (sel.float() - mean.float()) * r
                      + beta.float()).to(dt)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _routed_dz(x, wk, bias, gamma, mean, r, pooled, dpooled, beta=None):
    """The shared prologue of the two backward functions in plain PyTorch
    (the Pallas _corners_dz): (xhat, dz, xcols), xhat and dz (B, C, H, W)
    at full resolution, dz nonzero only at the first corner, in the order
    (0,0) (0,1) (1,0) (1,1), that holds its window's extreme (max where
    gamma > 0, else min) and only where the forward's output is positive:
    pooled > 0 for fp32, gamma xhat + beta > 0 (fp32, at that corner) for
    bf16; xcols (B, 9, H*W) the zero-padded input seen by each tap."""
    B, H, W = x.shape
    C = wk.shape[1]
    h2, w2 = H // 2, W // 2
    z_rule = x.dtype == torch.bfloat16
    x, wk, bias, dpooled = x.float(), wk.float(), bias.float(), dpooled.float()
    with no_tf32():
        y = F.conv2d(x[:, None], wk.t().reshape(C, 1, 3, 3), bias, padding=1)
    xhat = (y - mean[:, None, None]) * r[:, None, None]
    sign = torch.where(gamma > 0, 1.0, -1.0).to(y.dtype)[:, None, None]
    yw = (y * sign).reshape(B, C, h2, 2, w2, 2).permute(0, 1, 2, 4, 3, 5) \
        .reshape(B, C, h2, w2, 4)
    eq = yw == yw.max(dim=-1, keepdim=True).values
    first = eq & (eq.cumsum(-1) == 1)
    if z_rule:
        z = gamma.float()[:, None, None] * xhat + beta.float()[:, None, None]
        zw = z.reshape(B, C, h2, 2, w2, 2).permute(0, 1, 2, 4, 3, 5).reshape(B, C, h2, w2, 4)
        first = first & (zw > 0)
        dzp = dpooled.permute(0, 3, 1, 2)                       # (B, C, h2, w2)
    else:
        dzp = (dpooled * (pooled > 0)).permute(0, 3, 1, 2)
    dz = (dzp[..., None] * first).reshape(B, C, h2, w2, 2, 2) \
        .permute(0, 1, 2, 4, 3, 5).reshape(B, C, H, W)
    xcols = F.unfold(x[:, None], 3, padding=1)                  # (B, 9, H*W)
    return xhat, dz, xcols


def fused_conv1_bwd_plain(x, wk, bias, gamma, mean, r, pooled, dpooled, beta=None):
    """Plain PyTorch version of fused_conv1_bwd_cuda, same signature and
    results: (t1, t2, sx (C,), a1 (9, C), a2 (9,), gram (9, 9))."""
    xhat, dz, xcols = _routed_dz(x, wk, bias, gamma, mean, r, pooled, dpooled, beta)
    t1 = dz.sum(dim=(0, 2, 3))
    t2 = (dz * xhat).sum(dim=(0, 2, 3))
    sx = xhat.sum(dim=(0, 2, 3))
    a1 = torch.einsum("bcp,bsp->sc", dz.flatten(2), xcols)
    a2 = xcols.sum(dim=(0, 2))
    gram = torch.einsum("bsp,btp->st", xcols, xcols)
    return t1, t2, sx, a1, a2, gram


def fused_conv1_dx_plain(x, wk, bias, gamma, mean, r, pooled, dpooled, t1, t2,
                         n: float):
    """Plain PyTorch version of fused_conv1_dx_cuda: dy (B, H, W, C), the
    conv output's cotangent r g (dz - T1/n - xhat T2/n).  fp32 only, as the
    kernel."""
    _require_fp32_dx(x)
    xhat, dz, _ = _routed_dz(x, wk, bias, gamma, mean, r, pooled, dpooled)
    rg, t1n, t2n = ((v / d)[:, None, None] for v, d in ((r * gamma, 1.0), (t1, n), (t2, n)))
    dy = rg * (dz - t1n - xhat * t2n)
    return dy.permute(0, 2, 3, 1).contiguous()


def _require_fp32_dx(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"the fused conv dx (the input's gradient) is fp32 only, got {x.dtype}")


def _require_bwd_args(x, wk, bias, gamma, mean, r, pooled, dpooled, beta=None):
    """Shapes, device and types of the backward kernels' inputs: x, wk,
    bias, gamma, pooled and dpooled all float32 or all bfloat16, and beta
    for bf16; mean and r float32.  -> (device, B, H, W, C, the type's C
    code)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the fused conv backward kernels need CUDA tensors, got {dev}")
    B, H, W = x.shape
    C = wk.shape[-1]
    if H % 2 or W % 2 or C != C_OUT or not 0 < B <= MAX_GRID_Z:
        raise ValueError(f"unsupported shape: x {tuple(x.shape)}, C={C} "
                         f"(H, W even; C = {C_OUT}; 0 < B <= {MAX_GRID_Z})")
    code = _build.dtype_code(x, "x")
    _build.require(x, "x", (B, H, W), dev, x.dtype)
    _build.require(wk, "wk", (9, C), dev, x.dtype)
    for name, t in (("bias", bias), ("gamma", gamma)) + (
            (("beta", beta),) if x.dtype == torch.bfloat16 else ()):
        _build.require(t, name, (C,), dev, x.dtype)
    for name, t in (("mean", mean), ("r", r)):
        _build.require(t, name, (C,), dev)
    for name, t in (("pooled", pooled), ("dpooled", dpooled)):
        _require_pooled(t, name, (B, H // 2, W // 2, C), dev, x.dtype)
    return dev, B, H, W, C, code


def fused_conv1_bwd_cuda(x, wk, bias, gamma, mean, r, pooled, dpooled, beta=None):
    """Launch the backward reduction kernel and its fixed-order reduction.
    x (B, H, W), wk (9, C), mean and r = rsqrt(var + eps) the forward's
    batch statistics, pooled the forward's output (B, H/2, W/2, C) and
    dpooled its cotangent, both over (B, C, H/2, W/2) memory ->
    (t1, t2, sx (C,), a1 (9, C), a2 (9,), gram (9, 9)):
      t1 = sum dz, t2 = sum dz xhat, sx = sum xhat,
      a1[s, c] = sum dz[c] xpad[. + tap s], a2[s] = sum xpad[. + tap s],
      gram[s', s] = sum xpad[. + s'] xpad[. + s],
    every sum over all B*H*W conv output positions, reduced inside the
    kernels in a fixed order.  bf16 inputs: the kernel's bf16
    instantiation, which takes beta (BN's shift, for relu') and reads no
    pooled; the sums are fp32 either way."""
    dev, B, H, W, C, code = _require_bwd_args(x, wk, bias, gamma, mean, r, pooled, dpooled,
                                              beta)
    lib = _build.load("fused_conv_bwd.cu", _BWD_SIGNATURES)
    n_sums = N_CHAN_SUMS * C + N_TAP_SUMS
    partials = torch.empty(lib.fused_conv1_bwd_blocks(B, H, W), n_sums, device=dev)
    sums = torch.empty(n_sums, device=dev)
    with torch.cuda.device(dev):
        err = lib.fused_conv1_bwd_launch(
            x.data_ptr(), B, H, W, wk.data_ptr(), bias.data_ptr(), gamma.data_ptr(),
            None if beta is None else beta.data_ptr(), mean.data_ptr(), r.data_ptr(),
            pooled.data_ptr(), dpooled.data_ptr(), partials.data_ptr(), sums.data_ptr(), C,
            code, _build.stream_ptr(dev))
    _build.check(err, "fused_conv1_bwd_launch")
    _build.count_launch(fused_conv1_bwd_cuda, x.dtype)
    chan = sums[:N_CHAN_SUMS * C].view(N_CHAN_SUMS, C)
    taps = sums[N_CHAN_SUMS * C:].view(10, 9)
    return chan[0], chan[1], chan[2], chan[3:], taps[9], taps[:9]


fused_conv1_bwd_cuda.launches = 0
fused_conv1_bwd_cuda.launches_bf16 = 0


def fused_conv1_dx_cuda(x, wk, bias, gamma, mean, r, pooled, dpooled, t1, t2,
                        n: float):
    """Launch the dy kernel: the conv output's cotangent (B, H, W, C) from
    the same prologue as fused_conv1_bwd_cuda and its reduced t1, t2;
    n = the number of positions the batch statistics were taken over.
    fp32 only: raises on bf16."""
    _require_fp32_dx(x)
    dev, B, H, W, C, _ = _require_bwd_args(x, wk, bias, gamma, mean, r, pooled, dpooled)
    _build.require(t1, "t1", (C,), dev)
    _build.require(t2, "t2", (C,), dev)
    lib = _build.load("fused_conv_bwd.cu", _BWD_SIGNATURES)
    dy = torch.empty(B, H, W, C, device=dev)
    with torch.cuda.device(dev):
        code = lib.fused_conv1_dx_launch(
            x.data_ptr(), B, H, W, wk.data_ptr(), bias.data_ptr(), gamma.data_ptr(),
            mean.data_ptr(), r.data_ptr(), pooled.data_ptr(), dpooled.data_ptr(),
            t1.data_ptr(), t2.data_ptr(), float(n), dy.data_ptr(), C, _build.stream_ptr(dev))
    _build.check(code, "fused_conv1_dx_launch")
    fused_conv1_dx_cuda.launches += 1
    return dy


fused_conv1_dx_cuda.launches = 0
fused_conv1_dx_cuda.launches_bf16 = 0     # stays 0: the kernel is fp32 only


def fused_conv1_bwd(*args):
    """The kernel for CUDA tensors, the plain version on the CPU."""
    if args[0].is_cuda:
        return fused_conv1_bwd_cuda(*args)
    return fused_conv1_bwd_plain(*args)


def fused_conv1_dx(*args):
    if args[0].is_cuda:
        return fused_conv1_dx_cuda(*args)
    return fused_conv1_dx_plain(*args)


def param_grads_from_sums(wk, bias, gamma, mean, r, n: float, t1, t2, sx, a1, a2, gram):
    """(dwk (9, C), db, dgamma, dbeta) from the backward's reduced sums: the
    (C, 9)-sized algebra the JAX package also does outside its kernel.
    A3[s, c] = sum xhat[c] xpad[. + s] is rebuilt from the tap Gram, since
    xhat = r (sum_s' w[s'] xpad[. + s'] + bias - mean).  In fp32 whatever
    the parameters' type."""
    wk, bias, gamma = wk.float(), bias.float(), gamma.float()
    a3 = r * (gram @ wk + a2[:, None] * (bias - mean))
    rg = r * gamma
    dwk = rg * (a1 - a2[:, None] * (t1 / n) - a3 * (t2 / n))
    db = -(rg * sx * t2) / n                 # mathematically 0: sx is float noise
    return dwk, db, t2, t1


class _FusedConv1BnReluPool(torch.autograd.Function):
    """Training block 1 (the JAX custom_vjp fused_conv1_bn_relu_pool).
    Saves the input and the pooled output only: the conv activation is
    recomputed in the backward kernels and never stored.  The epilogue runs
    in fp32 on the stored sel and pooled is rounded to x2's type."""

    @staticmethod
    def forward(ctx, x2, wk, bias, gamma, beta, eps):
        sel, s1, s2 = fused_conv1_fwd(x2, wk, bias, gamma)
        # the moments of the global batch: one (2, C) all-reduce between the
        # launches (JAX fused_conv.py:431-437)
        s1, s2 = parallel.all_reduce_(torch.stack([s1, s2]))
        n = parallel.batch_count(x2.numel())
        mean = s1 / n
        var = s2 / n - mean * mean
        r = torch.rsqrt(var + eps)
        pooled = torch.relu(gamma.float() * (sel.float() - mean) * r
                            + beta.float()).to(x2.dtype)
        ctx.save_for_backward(x2, wk, bias, gamma, beta, mean, r, pooled)
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, dpooled, _dmean, _dvar):
        x2, wk, bias, gamma, beta, mean, r, pooled = ctx.saved_tensors
        n = float(parallel.batch_count(x2.numel()))
        if not nchw_memory(dpooled):          # the kernels read the forward's layout
            dpooled = dpooled.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        args = (x2, wk, bias, gamma, mean, r, pooled, dpooled)
        t1, t2, sx, a1, a2, gram = fused_conv1_bwd(*args, beta)
        # T1 and T2 over the global batch (one (2, C) all-reduce), since the
        # batch statistics are; Sx, A1, A2 and the Gram stay local, and so do
        # the parameter gradients: each rank's share, which the gradient
        # all-reduce combines (JAX fused_conv.py:506-519).  dgamma and
        # dbeta are the local T2 and T1.
        t1g, t2g = parallel.all_reduce_(torch.stack([t1, t2]))
        dwk, db, _, _ = param_grads_from_sums(wk, bias, gamma, mean, r, n, t1g, t2g, sx,
                                              a1, a2, gram)
        dgamma, dbeta = t2, t1
        # the JAX rule's types: dW and db in x's, dgamma and dbeta in gamma's
        dwk, db = dwk.to(x2.dtype), db.to(x2.dtype)
        dgamma, dbeta = dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)
        dx = None
        if ctx.needs_input_grad[0]:
            dy = fused_conv1_dx(*args, t1g.contiguous(), t2g.contiguous(), n)
            # dx[h, w] = sum_{s, c} dy[c, h - (dh - 1), w - (dw - 1)] wk[s, c]
            H, W = x2.shape[1:]
            taps = F.pad(dy @ wk.t(), (0, 0, 1, 1, 1, 1))       # (B, H+2, W+2, 9)
            dx = sum(taps[:, 2 - dh: 2 - dh + H, 2 - dw: 2 - dw + W, dh * 3 + dw]
                     for dh in range(3) for dw in range(3))
        return dx, dwk, db, dgamma, dbeta, None


def fused_conv1_bn_relu_pool(x, kernel, bias, gamma, beta, eps: float = 1e-5):
    """Training-mode block: x (B, H, W, 1) with H, W even, kernel (3, 3, 1, C)
    -> (pooled (B, H/2, W/2, C), mean (C,), var (C,)), the JAX function's
    layouts.  mean and var are the batch statistics (biased variance) over
    the full conv output; they carry no gradient, and the caller folds them
    into its running averages.  Differentiable in x, kernel, bias, gamma and
    beta through the hand-written backward.  A bf16 x runs the block in
    bf16 (pooled bf16, mean and var fp32); its input gradient is not
    available (the dx kernel is fp32 only)."""
    C = kernel.shape[-1]
    dt = working_dtype(x)
    return _FusedConv1BnReluPool.apply(
        x[..., 0].to(dt).contiguous(), kernel.reshape(9, C).to(dt).contiguous(),
        bias.to(dt).contiguous(), gamma.to(dt).contiguous(),
        beta.to(dt).contiguous(), eps)
