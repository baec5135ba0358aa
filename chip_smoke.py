#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ssl_audio_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. builds every CUDA kernel from csrc/ with nvcc (one process per source,
     all at once) and prints the build seconds and ptxas register reports;
  3. holds each kernel against its plain PyTorch version on the card at the
     serving and training paths' shapes, with the tolerances below, and times
     kernel, plain version and the PyTorch library yardstick with CUDA events
     (the attention kernels at the ViT-B step's shapes: N = 25 with zero and
     with masked-key biases, and the token-drop teacher's N = 7, by the
     device-only timer, cold and warm, with the wrappers' host time and the
     tensor-core bound beside the byte bound); the
     log-mel rows carry the tensor-core bound (three TF32 passes) beside the
     fp32 one, and both instantiations are held against the plain version in
     float64 on 0.3 tones over a 1e-4 noise floor; the fused conv rows
     (forward eval at the serving chunk and in statistics mode at the
     training shape, backward, dx) carry the device time cold and warm, the
     grid (blocks, resident blocks per SM, waves), the forward's byte and
     FMA bounds side by side, the backward's split per launch, and two
     launches of each reduction giving the same bits;
  4. serving: AudioNTT2022 at full width (64 mels, d = 3072, fp32,
     fused_conv=True) with seeded random weights answers a timestamp request
     and a scene request for 16 seeded 10-s clips through the HEAR API; the
     kernels' launch counters are zeroed just before each request and read
     just after it, and a small request is held against the same model on
     the CPU;
  5. training: the default pretraining configuration at full width
     (AudioNTT2022, projector 3072 -> 8192 -> 256, batch 128, crop_frames 96,
     fp32, LARS) with seeded weights takes Barlow Twins steps, raw wav in:
     one epoch through the training entry point's Trainer and DataLoader
     (--dataset synthetic_wav), the launch counters zeroed just before each
     of its steps and read just after it, then timed steps on 128 seeded
     10-s clips resident on the card; a small step is held against the same
     step on the CPU from the same weights and draws; the dx kernel is
     reached through the autograd Function once the input asks for a
     gradient (phase 3);
  6. ViT training: ViT-B at full width (embed 768, depth 12, 12 heads,
     24 patches + CLS, projector 768 -> 8192 -> 256, batch 128, crop_frames
     96, AdamW, --fused_attention) with seeded weights, raw wav in: one
     epoch through the Trainer with the teacher masked by key bias at ratio
     0.75 (every block's attention through the fused kernels, forward and
     backward, the counters zeroed around each step), then timed steps on
     the resident batch unmasked and with token drop, each beside the same
     step with --no_fused_attention; a small step (vit_tiny, batch 16) is
     held against the same step on the CPU;
  7. ViT serving: vitc_base 16x8, the HEAR ViT wrapper's default (embed 768,
     depth 11, 12 heads of 64, 48 patches + CLS over (64, 96), fp32 einsum
     attention, seeded random weights and ConvStem statistics) answers a
     timestamp request (3,216 windows in 7 chunks of 512) and a scene
     request (16 x 11 units) for 16 seeded 10-s clips through the HEAR API,
     the counters zeroed just before each and read just after (log-mel
     folded 7 / 1, every other kernel 0); median wall times, the device
     time by kernel and idle share (torch.profiler), the fp32 operation
     bound; a small request of each kind held against the CPU;
  8. the evaluation stack: eval_linear (embeddings of three seeded
     class-structured SyntheticLMS loaders, the MLP probe, the low-shot
     protocol) with make_embedding_forward of AudioNTT2022 (the fused block
     1's eval kernel) and of ViT-B --fused_attention (the attention forward
     kernel), each path's launches counted; a batch's embeddings held
     against the same encoder on the CPU.
The `kernels` JSON line lists every ported kernel; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

# H100 SXM data sheet (dense, no sparsity): fp32 outside the tensor cores,
# bf16 and TF32 on the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12

# tolerances, each with its reason
MEL_ATOL = 1e-4      # log-mel: three TF32 passes (~2^-22 per product) against cuBLAS fp32,
                     # sums of 200-1023 terms in another order
MEL_RANGE_FACTOR = 4  # dynamic-range input: the kernel's error against float64 may be this
                      # many times the fp32 plain version's (or MEL_ATOL)
CONV_ATOL = 1e-4     # pooled conv values O(1-10): cuDNN's fp32 algorithm rounds otherwise
STATS_RTOL = 1e-4    # s1, s2: 3.1e6-term fp32 sums in another order
EMB_RTOL = 1e-3      # embeddings / max|embedding|: fp32 through four layers, card vs CPU
SUMS_RTOL = 1e-4     # backward sums / their largest value: 7.9e5-term fp32 sums in another order
SX_RTOL = 1e-5       # Sx / n: mathematically 0, float noise of 7.9e5 terms of size O(1)
GRAD_ATOL = 2e-2     # dW, dgamma, dbeta (values up to ~3e3, fp32 ulp 2.4e-4): differences of
                     # sums of size ~1e4 that each carry ~5e-7 of relative error; absolute
DB_ATOL = 1e-2       # db is mathematically 0 (-(r g Sx T2)/n): float noise on both sides
DY_ATOL = 1e-4       # dy values O(1); its T1/n, T2/n terms come from the sums above
STEP_LOSS_RTOL = 1e-3   # one train step, card vs CPU: fp32 through the whole network
STEP_GRAD_RTOL = 3e-2   # its gradients, |card - CPU| / |CPU| per tensor (L2): the step's pool and
                        # ReLU decisions flip on input differences of 1e-7, and a flip moves
                        # single elements by up to ~1e-1 of the tensor's largest value while
                        # the L2 error stays under 1e-2 (tools/grad_sensitivity.py measures
                        # both, on the CPU alone and card against CPU)
ATTN_SPACING = 2.0 ** -7  # attention kernels vs plain, / max|ref|: bf16 keeps 8 significant bits,
                          # so a P or dS operand (or a dk, dv output) that rounds the other way
                          # on one side (fp32 sums in another order, expf) moves by one spacing
ATTN_REL_L2 = 1e-4        # ... and only a few do: relative L2 (a left-out rounding point: ~2e-3)
# ViT step (vit_tiny, batch 16), card vs CPU.  With the fp32 einsum attention:
# its gradients move by <= 9e-5 (relative L2, worst tensor) when the wavs move
# by 1e-7 of their peak (tools/grad_sensitivity.py, CPU alone).  With the fused
# attention the bf16 operands turn such a seventh-digit difference into
# flipped roundings, and the batch-16 Barlow Twins loss amplifies them: the
# same study reads 0.110-0.134 for the worst tensor (late LayerNorm and v
# biases) and 0.029-0.032 over all gradients at once; the limits leave 2-3x
VIT_FP32_GRAD_RTOL = 1e-3
VIT_FUSED_GRAD_RTOL = 0.3        # worst tensor
VIT_FUSED_GLOBAL_RTOL = 0.1      # all gradients as one vector

CHUNK = 512          # the HEAR pipeline's BATCH_SIZE: one kernel launch's batch
WINDOW = 15200       # 0.95 s at 16 kHz: one timestamp window
N_CLIPS = 16         # clips per serving request
CLIP = 160000        # 10 s at 16 kHz: one scene clip
TRAIN_BATCH = 128    # config.py batch_size
TRAIN_FRAMES = 96    # config.py crop_frames
TRAIN_STEPS = 12     # timed steps after the warm-up steps
ENTRY_STEPS = 6      # steps of the epoch that the Trainer runs over its DataLoader
VIT_FLAGS = ["--dataset", "synthetic_wav", "--model_type", "vit_base", "--fused_attention",
             "--mask", "--mask_ratio", "0.75", "--no_token_drop"]
VIT_DEPTH, VIT_HEADS, VIT_DIM, VIT_TOKENS = 12, 12, 768, 25
EVAL_ITEMS = {"train": 1024, "val": 256, "test": 256}   # SyntheticLMS clips per loader
EVAL_CLASSES = 10
EVAL_MAX_ITER = 20   # probe epochs (eval_linear's max_iter)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def mel_bounds(ops, frames: int, nbytes: float) -> dict:
    """The log-mel kernel's bounds for `frames` frames: bound_ms with the DFT
    in three TF32 passes on the tensor cores and the power and mel product at
    the fp32 rate; fp32_bound_ms with everything at the fp32 rate (the
    CUDA-core version's bound); either against the bytes."""
    dft = frames * ops.dft_flops_per_frame()
    rest = frames * ops.flops_per_frame() - dft
    t_ops = 3 * dft / PEAK_TF32_FLOPS + rest / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    fp32, fp32_by = bound_ms(dft + rest, nbytes)
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "fp32_bound_ms": fp32, "fp32_bound_by": fp32_by,
            "dft_gflop": dft / 1e9}


def both_bounds(flops: float, nbytes: float) -> dict:
    """bound_ms / bound_by beside the two times they are the larger of."""
    bound, by = bound_ms(flops, nbytes)
    return {"bound_ms": bound, "bound_by": by, "bytes_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "ops_bound_ms": flops / PEAK_FP32_FLOPS * 1e3}


def device_times(fn) -> dict:
    """A kernel wrapper's device time, cold (the L2 flushed between calls)
    and warm, and the older back-to-back CUDA-event mean."""
    from ssl_audio_tpu_torch.tools.serving import cuda_ms, device_ms

    return {"ms": device_ms(fn, cold=True), "ms_warm": device_ms(fn),
            "cuda_events_ms": cuda_ms(fn)}


def conv_grid(B: int, H: int, W: int, backward: bool, eval_mode: bool = False) -> dict:
    """The fused conv kernels' grid, resident blocks per SM and waves."""
    from ssl_audio_tpu_torch.ops import _build
    from ssl_audio_tpu_torch.ops import fused_conv as fc

    blocks = fc.launch_plan(B, H, W).blocks
    if backward:
        per_sm = _build.load("fused_conv_bwd.cu", fc._BWD_SIGNATURES) \
            .fused_conv1_bwd_blocks_per_sm()
    else:
        per_sm = _build.load("fused_conv_fwd.cu", fc._SIGNATURES) \
            .fused_conv1_fwd_blocks_per_sm(int(eval_mode))
    return {"blocks": blocks, "blocks_per_sm": per_sm, "waves": fc.waves(blocks, per_sm)}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def check(name: str, err: float, tol: float, why: str) -> None:
    ok = err <= tol
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.0e}: {why}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: error {err} above {tol}")


def launch_counts() -> dict[str, int]:
    from ssl_audio_tpu_torch.ops import launch_counts as counts

    return counts()


def zero_launch_counts() -> None:
    from ssl_audio_tpu_torch.ops import zero_launch_counts as zero

    zero()


def mel_row(wav: torch.Tensor, spec, fold, label: str) -> dict:
    """log_mel_cuda against log_mel_spectrogram_plain on `wav`, with kernel,
    plain and library (torch.stft) times and the bound."""
    from ssl_audio_tpu_torch.ops.mel import TORCH_FLOAT32_EPS, log_mel_spectrogram_plain
    from ssl_audio_tpu_torch.ops.mel_kernel import kernel_operands, log_mel_cuda
    from ssl_audio_tpu_torch.tools.serving import cuda_ms

    out = log_mel_cuda(wav, spec, fold=fold)
    ref = log_mel_spectrogram_plain(wav, spec, fold=fold)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    B, L = wav.shape
    check(f"log_mel[{label}] ({B} x {L})", err, MEL_ATOL,
          "three TF32 passes, sums in another order")
    ops = kernel_operands(spec, fold)
    nbytes = 4 * (wav.numel() + out.numel() + ops.basis_c.size
                  + ops.basis_s.size + ops.fb.size)
    bounds = mel_bounds(ops, B * spec.num_frames(L), nbytes)
    window = torch.hann_window(spec.win_length, periodic=True, device=wav.device)
    fb_full = torch.from_numpy(spec.filterbank).to(wav.device)

    def library():
        st = torch.stft(wav, spec.n_fft, spec.hop_length, spec.win_length,
                        window, center=True, pad_mode="reflect",
                        return_complex=True)
        power = st.real ** 2 + st.imag ** 2
        return torch.log(torch.einsum("bft,fm->bmt", power, fb_full)
                         + TORCH_FLOAT32_EPS)

    row = {"max_abs_err": err, "library_max_abs_err": max_err(library(), ref),
           "ms": cuda_ms(lambda: log_mel_cuda(wav, spec, fold=fold)),
           "plain_ms": cuda_ms(lambda: log_mel_spectrogram_plain(wav, spec, fold=fold)),
           **bounds, "library_ms": cuda_ms(library),
           "shape": f"{B} x {L} samples -> {tuple(out.shape)}"}
    print(f"  log_mel[{label}]: " + json.dumps(row))
    return row


def cropped_mel_row(wav: torch.Tensor, starts: torch.Tensor, spec, fold, label: str) -> dict:
    """log_mel_cuda with per-clip crop starts against
    log_mel_spectrogram_cropped_plain at the training step's input, with the
    library yardstick torch.stft of the gathered segments."""
    from ssl_audio_tpu_torch.ops.mel import (
        TORCH_FLOAT32_EPS, log_mel_spectrogram_cropped_plain)
    from ssl_audio_tpu_torch.ops.mel_kernel import kernel_operands, log_mel_cuda
    from ssl_audio_tpu_torch.tools.serving import cuda_ms

    T = TRAIN_FRAMES
    out = log_mel_cuda(wav, spec, fold, starts, T)
    ref = log_mel_spectrogram_cropped_plain(wav, spec, fold, starts, T)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    B, L = wav.shape
    check(f"log_mel[{label}] ({B} x {L}, {T} frames from per-clip starts)", err,
          MEL_ATOL, "three TF32 passes, sums in another order")
    ops = kernel_operands(spec, fold)
    # bytes the function needs: each clip's cropped segment, not the whole clip
    seg = (T - 1) * spec.hop_length + spec.n_fft
    nbytes = 4 * (B * seg + out.numel() + ops.basis_c.size + ops.basis_s.size
                  + ops.fb.size + B)
    bounds = mel_bounds(ops, B * T, nbytes)
    window = torch.hann_window(spec.win_length, periodic=True, device=wav.device)
    fb_full = torch.from_numpy(spec.filterbank).to(wav.device)
    pad = spec.n_fft // 2
    offs = torch.arange(seg, device=wav.device)

    def library():
        x = torch.nn.functional.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
        segs = torch.gather(x, 1, starts.long()[:, None] * spec.hop_length + offs)
        st = torch.stft(segs, spec.n_fft, spec.hop_length, spec.win_length, window,
                        center=False, return_complex=True)
        power = st.real ** 2 + st.imag ** 2
        return torch.log(torch.einsum("bft,fm->bmt", power, fb_full) + TORCH_FLOAT32_EPS)

    row = {"max_abs_err": err, "library_max_abs_err": max_err(library(), ref),
           "ms": cuda_ms(lambda: log_mel_cuda(wav, spec, fold, starts, T)),
           "plain_ms": cuda_ms(lambda: log_mel_spectrogram_cropped_plain(
               wav, spec, fold, starts, T)),
           **bounds, "library_ms": cuda_ms(library),
           "shape": f"{B} x {L} samples, per-clip starts -> {tuple(out.shape)}"}
    print(f"  log_mel[{label}]: " + json.dumps(row))
    return row


def mel_dynamic_range(gen: torch.Generator, dev: torch.device) -> dict:
    """64 one-second clips, 0.3 tones over the first half of each and a 1e-4
    noise floor throughout, at both specs and through both instantiations:
    the kernel and the fp32 plain version, each against the plain version
    run in float64 on the card (its fp32 tables cast to float64)."""
    from ssl_audio_tpu_torch.ops.mel import MelSpec, log_mel_spectrogram_plain
    from ssl_audio_tpu_torch.ops.mel_kernel import log_mel_cuda

    n, samples = 64, 16000
    t = torch.arange(samples, dtype=torch.float64) / 16000
    freqs = 100.0 + 4000.0 * torch.rand(n, 1, generator=gen, dtype=torch.float64)
    tone = 0.3 * torch.sin(2 * torch.pi * freqs * t)
    tone[:, samples // 2:] = 0.0
    noise = 1e-4 * torch.randn(n, samples, generator=gen, dtype=torch.float64)
    wav = (tone + noise).float().to(dev)
    errs = {"folded": {}, "unfolded": {}}
    for win in (400, 1024):
        spec = MelSpec(win_length=win)
        for label, fold in (("folded", None), ("unfolded", False)):
            exact = log_mel_spectrogram_plain(wav.double(), spec, fold=fold)
            kernel = max_err(log_mel_cuda(wav, spec, fold), exact)
            plain = max_err(log_mel_spectrogram_plain(wav, spec, fold=fold), exact)
            errs[label][f"win_{win}"] = {"kernel_vs_float64": kernel,
                                         "plain_fp32_vs_float64": plain}
            print(f"  log_mel dynamic range [{label}, win {win}]: kernel {kernel:.3e}, "
                  f"fp32 plain {plain:.3e}, against float64")
            check(f"log_mel[{label}, win {win}, dynamic range] vs float64", kernel,
                  max(MEL_ATOL, MEL_RANGE_FACTOR * plain),
                  f"max(1e-4, {MEL_RANGE_FACTOR} x the fp32 plain version's)")
    return errs


def backward_rows(gen: torch.Generator, dev: torch.device) -> tuple[list[dict], dict]:
    """fused_conv1_bwd_cuda and fused_conv1_dx_cuda against their plain
    versions at one view of the training step, (128, 64, 96): inputs
    quantised to 0.5 so windows tie, a quarter of the gammas negative, one
    exactly 0.  -> (their rows of the kernels line, the forward kernel's
    times at the same shape)."""
    from ssl_audio_tpu_torch.ops import fused_conv as fc
    from ssl_audio_tpu_torch.ops import no_tf32
    from ssl_audio_tpu_torch.tools.serving import cuda_ms, per_launch_ms

    B, H, W, C = TRAIN_BATCH, 64, TRAIN_FRAMES, 64
    x = (torch.round(torch.randn(B, H, W, generator=gen) * 2) / 2).to(dev)
    wk = (0.3 * torch.randn(9, C, generator=gen)).to(dev)
    bias = (0.1 * torch.randn(C, generator=gen)).to(dev)
    gamma = 1.0 + 0.3 * torch.randn(C, generator=gen)
    gamma[: C // 4] *= -1.0
    gamma[C // 2] = 0.0
    gamma = gamma.to(dev)
    beta = (0.2 * torch.randn(C, generator=gen)).to(dev)
    kernel_hwio = wk.reshape(3, 3, 1, C)
    with torch.no_grad():
        pooled, mean, var = fc.fused_conv1_bn_relu_pool(x[..., None], kernel_hwio, bias,
                                                        gamma, beta)
    r = torch.rsqrt(var + 1e-5)
    # the cotangent in the forward's layout, (B, C, H/2, W/2) memory, as the
    # Function hands it to the kernels
    dp = torch.randn(B, C, H // 2, W // 2, generator=gen).to(dev).permute(0, 2, 3, 1)
    args = (x, wk, bias, gamma, mean, r, pooled, dp)
    n = float(x.numel())

    sums = fc.fused_conv1_bwd_cuda(*args)
    again = fc.fused_conv1_bwd_cuda(*args)
    sums_p = fc.fused_conv1_bwd_plain(*args)
    dy = fc.fused_conv1_dx_cuda(*args, sums[0], sums[1], n)
    dy_p = fc.fused_conv1_dx_plain(*args, sums[0], sums[1], n)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(sums, again)):
        raise SystemExit("fused_conv1_bwd: two launches gave different bits")
    print("  fused_conv1_bwd: two launches give the same bits")
    bwd_err = 0.0
    for name, a, b in zip(("T1", "T2", "Sx", "A1", "A2", "Gram"), sums, sums_p):
        if name == "Sx":
            check("fused_conv1_bwd Sx / n", max(float(a.abs().max()), float(b.abs().max())) / n,
                  SX_RTOL, "mathematically 0: float noise of 7.9e5 terms")
            continue
        rel = max_err(a, b) / float(b.abs().max())
        bwd_err = max(bwd_err, rel)
        check(f"fused_conv1_bwd {name} / max|{name}|", rel, SUMS_RTOL,
              "7.9e5-term fp32 sums in another order")
    grads = fc.param_grads_from_sums(wk, bias, gamma, mean, r, n, *sums)
    grads_p = fc.param_grads_from_sums(wk, bias, gamma, mean, r, n, *sums_p)
    for name, a, b in zip(("dW", "db", "dgamma", "dbeta"), grads, grads_p):
        if name == "db":
            check("fused_conv1_bwd db (absolute)",
                  max(float(a.abs().max()), float(b.abs().max())), DB_ATOL,
                  "mathematically 0: float noise on both sides")
        else:
            check(f"fused_conv1_bwd {name} (absolute, max|{name}| "
                  f"{float(b.abs().max()):.3g})", max_err(a, b), GRAD_ATOL,
                  "assembled from the sums above")
    dy_err = max_err(dy, dy_p)
    check(f"fused_conv1_dx dy ({B} x {H} x {W} x {C})", dy_err, DY_ATOL,
          "fp32, the T1/n and T2/n terms from sums in another order")

    # library yardstick: autograd through cuDNN's four calls, forward and backward
    w4 = wk.t().reshape(C, 1, 3, 3)
    dp_nchw = dp.permute(0, 3, 1, 2)

    def library(need_dx: bool):
        ts = [t.detach().clone().requires_grad_() for t in (w4, bias, gamma, beta)]
        xin = x[:, None].detach().clone().requires_grad_(need_dx)
        with no_tf32():
            y = torch.nn.functional.conv2d(xin, ts[0], ts[1], padding=1)
            z = torch.nn.functional.batch_norm(y, None, None, ts[2], ts[3], training=True,
                                               eps=1e-5)
            out = torch.nn.functional.max_pool2d(torch.relu(z), 2)
            out.backward(dp_nchw)

    def ours(need_dx: bool):
        ts = [t.detach().clone().requires_grad_() for t in (kernel_hwio, bias, gamma, beta)]
        xin = x[..., None].detach().clone().requires_grad_(need_dx)
        out, _, _ = fc.fused_conv1_bn_relu_pool(xin, *ts)
        out.backward(dp)

    cells = B * (H // 2) * (W // 2) * C
    # what the function needs per window cell and channel: 4 corners x 9 conv FMA to
    # find the selected corner, 9 A1 FMA (dz is nonzero at that one corner), ~12 FMA
    # for the corners' xhat, Sx, T1 and T2: 57 FMA; per input position the 45
    # unique products of the symmetric 9 x 9 tap Gram and the 9 sums of A2
    bwd_bound, bwd_by = bound_ms(2 * 57 * cells + (2 * 45 + 9) * B * H * W,
                                 4 * (x.numel() + 2 * pooled.numel() + 22 * C + 90))
    dx_bound, dx_by = bound_ms(96 * cells,
                               4 * (x.numel() + 2 * pooled.numel() + dy.numel() + 16 * C))
    bwd_fn = lambda: fc.fused_conv1_bwd_cuda(*args)          # noqa: E731
    bwd_row = {
        "max_abs_err": bwd_err, "error_is": "largest sum error / that sum's largest value",
        "shape": f"x {(B, H, W)}, dpooled {tuple(dp.shape)} -> T1, T2, Sx, A1, A2, Gram",
        **device_times(bwd_fn), "per_launch_ms": per_launch_ms(bwd_fn),
        **conv_grid(B, H, W, backward=True),
        "plain_ms": cuda_ms(lambda: fc.fused_conv1_bwd_plain(*args), iters=5),
        "bound_ms": bwd_bound, "bound_by": bwd_by,
        "library_ms": cuda_ms(lambda: library(False)),
        "library_is": "autograd through cuDNN conv2d + batch_norm(training) + relu + "
                      "max_pool2d, forward and backward",
        "function_fwd_bwd_ms": cuda_ms(lambda: ours(False)),
    }
    print("  fused_conv1_bwd: " + json.dumps(bwd_row))
    dx_row = {
        "max_abs_err": dy_err,
        "shape": f"x {(B, H, W)}, dpooled {tuple(dp.shape)} -> dy {tuple(dy.shape)}",
        **device_times(lambda: fc.fused_conv1_dx_cuda(*args, sums[0], sums[1], n)),
        "plain_ms": cuda_ms(lambda: fc.fused_conv1_dx_plain(*args, sums[0], sums[1], n),
                            iters=5),
        "bound_ms": dx_bound, "bound_by": dx_by,
        "library_ms": cuda_ms(lambda: library(True)),
        "library_is": "the same autograd yardstick with the input's gradient",
        "function_fwd_bwd_ms": cuda_ms(lambda: ours(True)),
    }
    print("  fused_conv1_dx: " + json.dumps(dx_row))
    # the Function reaches the dx kernel only when the input asks for a gradient
    zero_launch_counts()
    ours(False)
    without = launch_counts()
    zero_launch_counts()
    ours(True)
    with_dx = launch_counts()
    print(f"  Function launches without / with x.requires_grad_(): {without} / {with_dx}")
    if (without["fused_conv1_fwd"], without["fused_conv1_bwd"], without["fused_conv1_dx"]) \
            != (1, 1, 0) or with_dx["fused_conv1_dx"] != 1:
        raise SystemExit("the Function did not launch its kernels as expected")
    # the forward kernel in its statistics mode at this shape, as the step runs it
    fwd_bounds = both_bounds(19 * 4 * cells, 4 * (x.numel() + pooled.numel() + 20 * C))

    def library_fwd():
        with no_tf32():
            y = torch.nn.functional.conv2d(x[:, None], w4, bias, padding=1)
            z = torch.nn.functional.batch_norm(y, None, None, gamma, beta, training=True,
                                               eps=1e-5)
            return torch.nn.functional.max_pool2d(torch.relu(z), 2)

    fwd_row = {"shape": f"{(B, H, W)} -> sel {tuple(pooled.shape)}, s1, s2",
               **device_times(lambda: fc.fused_conv1_fwd_cuda(x, wk, bias, gamma)),
               "per_launch_ms": per_launch_ms(lambda: fc.fused_conv1_fwd_cuda(x, wk, bias, gamma)),
               **conv_grid(B, H, W, backward=False),
               "plain_ms": cuda_ms(lambda: fc.fused_conv1_fwd_plain(x, wk, bias, gamma)),
               **fwd_bounds,
               "library_ms": cuda_ms(library_fwd),
               "library_is": "cuDNN conv2d + batch_norm(training=True) + relu + max_pool2d, "
                             "forward, TF32 off"}
    print("  fused_conv1_fwd[train shape, stats mode]: " + json.dumps(fwd_row))
    src = "ssl_audio_tpu_torch/csrc/fused_conv_bwd.cu"
    return [{"name": "fused_conv1_bwd", "route": "cuda", "source": src,
             "replaces": "ssl_audio_tpu/ops/fused_conv.py:257", **bwd_row},
            {"name": "fused_conv1_dx", "route": "cuda", "source": src,
             "replaces": "ssl_audio_tpu/ops/fused_conv.py:344", **dx_row}], fwd_row


def attention_check(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """Hold one output of an attention kernel against its plain version:
    max abs error within ATTN_SPACING of max|ref|, relative L2 within
    ATTN_REL_L2.  -> the max abs error."""
    err = max_err(got, ref)
    scale = float(ref.abs().max())
    rel_l2 = float((got.double() - ref.double()).norm() / ref.double().norm())
    check(f"{name} / max|ref| ({scale:.3g}); relative L2 {rel_l2:.1e}", err / scale,
          ATTN_SPACING, "one bf16 spacing: an operand rounded the other way")
    if rel_l2 > ATTN_REL_L2:
        raise SystemExit(f"{name}: relative L2 {rel_l2} above {ATTN_REL_L2}")
    return err


def attention_rows(gen: torch.Generator, dev: torch.device) -> list[dict]:
    """fused_attention_fwd_cuda and fused_attention_bwd_cuda against their
    plain versions at the ViT-B step's shapes: qkv (128, 25, 2304) with zero
    biases and with -1e9 on ~3/4 of the patch keys (key-bias masking at
    ratio 0.75, CLS visible), and the token-drop teacher's (128, 7, 2304).
    Times at N = 25 and N = 7 by device_ms (cold: the L2 flushed between
    launches, as the step finds qkv; and warm), the wrapper's host time per
    call beside them (host_ms) and the older back-to-back CUDA-event time;
    the byte bound and the tensor-core operation bound.  The library
    yardstick is the raw-qkv split and transpose plus
    scaled_dot_product_attention on bf16 q, k, v with the additive mask:
    forward; for the backward row its backward alone (and, under its own
    name, forward and backward through autograd)."""
    from ssl_audio_tpu_torch.ops import fused_attention as fa
    from ssl_audio_tpu_torch.tools.serving import cuda_ms, device_ms, host_ms

    B, C, H = TRAIN_BATCH, VIT_DIM, VIT_HEADS
    hd = C // H
    shapes = {"N=25": (VIT_TOKENS, 0.0), "N=25, masked keys": (VIT_TOKENS, 0.75),
              "N=7, token drop": (7, 0.0)}
    inputs, errs = {}, {"fwd": 0.0, "bwd": 0.0}
    for label, (N, drop) in shapes.items():
        qkv = torch.randn(B, N, 3 * C, generator=gen)
        bias = torch.zeros(B, N)
        if drop:
            dead = torch.rand(B, N, generator=gen) < drop
            dead[:, 0] = False
            bias[dead] = -1e9
        dout = torch.randn(B, N, C, generator=gen)
        qkv, bias, dout = inputs[label] = tuple(t.to(dev) for t in (qkv, bias, dout))
        out = fa.fused_attention_fwd_cuda(qkv, bias, H)
        dqkv, dbias = fa.fused_attention_bwd_cuda(qkv, bias, dout, H)
        again = fa.fused_attention_bwd_cuda(qkv, bias, dout, H)
        out_p = fa.fused_attention_fwd_plain(qkv, bias, H)
        dqkv_p, dbias_p = fa.fused_attention_bwd_plain(qkv, bias, dout, H)
        torch.cuda.synchronize()
        if not (torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])):
            raise SystemExit("fused_attention_bwd: two launches gave different bits")
        if not torch.equal(dqkv[..., C:], dqkv[..., C:].bfloat16().float()):
            raise SystemExit("fused_attention_bwd: dk, dv are not bf16 values")
        errs["fwd"] = max(errs["fwd"], attention_check(
            f"fused_attention_fwd out [{label}]", out, out_p))
        for i, name in enumerate(("dq", "dk", "dv")):
            errs["bwd"] = max(errs["bwd"], attention_check(
                f"fused_attention_bwd {name} [{label}]", dqkv[..., i * C:(i + 1) * C],
                dqkv_p[..., i * C:(i + 1) * C]))
        errs["bwd"] = max(errs["bwd"], attention_check(
            f"fused_attention_bwd dbias [{label}]", dbias, dbias_p))
    print("  fused_attention_bwd: two launches give the same bits; dk, dv are bf16 values")

    def split(x):
        return [x[..., i * C:(i + 1) * C].reshape(x.shape[0], x.shape[1], H, hd)
                .transpose(1, 2).bfloat16() for i in range(3)]

    def library_fwd(qkv, bias):
        q, k, v = split(qkv)
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bias[:, None, None, :].bfloat16())

    def library_fwd_bwd(qkv, bias, dout):
        x = qkv.detach().requires_grad_()
        o = library_fwd(x, bias)
        o.transpose(1, 2).reshape(dout.shape).float().backward(dout)

    def ours_fwd_bwd(qkv, bias, dout):
        x = qkv.detach().requires_grad_()
        fa.fused_attention(x, bias, H).backward(dout)

    rows = {"fwd": {}, "bwd": {}}
    for label in ("N=25", "N=7, token drop"):
        qkv, bias, dout = inputs[label]
        N = qkv.shape[1]
        lib = library_fwd(qkv, bias).transpose(1, 2).reshape(B, N, C).float()
        # the library's backward alone: its forward once, then the gradient
        # of the same output timed (the graph kept)
        x = qkv.detach().requires_grad_()
        lib_o = library_fwd(x, bias)
        lib_g = dout.reshape(B, N, H, hd).transpose(1, 2).bfloat16()

        def library_bwd():
            return torch.autograd.grad(lib_o, x, lib_g, retain_graph=True)

        # bounds: each input read once and each output written once, against
        # the bf16 products on the tensor cores (forward S and P V; backward
        # S, dP, dQ, dK, dV)
        fwd_bytes, bwd_bytes = 4 * (4 * B * N * C + B * N), 4 * (7 * B * N * C + 2 * B * N)
        fwd_flops, bwd_flops = 4 * B * N * N * C, 10 * B * N * N * C
        for kind, fn, plain, nbytes, flops, library in (
                ("fwd", lambda: fa.fused_attention_fwd_cuda(qkv, bias, H),
                 lambda: fa.fused_attention_fwd_plain(qkv, bias, H), fwd_bytes, fwd_flops,
                 lambda: library_fwd(qkv, bias)),
                ("bwd", lambda: fa.fused_attention_bwd_cuda(qkv, bias, dout, H),
                 lambda: fa.fused_attention_bwd_plain(qkv, bias, dout, H), bwd_bytes,
                 bwd_flops, library_bwd)):
            bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
            plan = fa.plan(B, N, H, hd, kind == "bwd")
            row = {"shape": f"qkv {tuple(qkv.shape)}, bias {tuple(bias.shape)}"
                            + (f", dout {tuple(dout.shape)} -> dqkv, dbias" if kind == "bwd"
                               else f" -> ({B}, {N}, {C})"),
                   "ms": device_ms(fn, cold=True), "ms_warm": device_ms(fn),
                   "host_ms": host_ms(fn), "cuda_events_ms": cuda_ms(fn),
                   "plain_ms": device_ms(plain, iters=5), "bound_ms": bound, "bound_by": by,
                   "bytes_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                   "ops_bound_ms": flops / PEAK_BF16_FLOPS * 1e3,
                   "library_ms": device_ms(library),
                   "plan": {"heads_per_block": plan.heads_per_block,
                            "query_tiles_per_round": plan.rounds_tiles, "warps": plan.warps,
                            "smem_bytes": plan.smem, "blocks": plan.blocks}}
            row["bound_share_cold"] = row["bytes_bound_ms"] / row["ms"]
            if kind == "fwd":
                row["library_max_abs_err"] = max_err(
                    lib, fa.fused_attention_fwd_plain(qkv, bias, H))
            else:
                row["library_fwd_bwd_ms"] = device_ms(lambda: library_fwd_bwd(qkv, bias, dout))
                row["function_fwd_bwd_ms"] = device_ms(lambda: ours_fwd_bwd(qkv, bias, dout))
            rows[kind][label] = row
            print(f"  fused_attention_{kind}[{label}]: " + json.dumps(row))
    src = "ssl_audio_tpu_torch/csrc/fused_attention.cu"
    return [{"name": "fused_attention_fwd", "route": "cuda", "source": src,
             "replaces": "ssl_audio_tpu/ops/fused_attention.py:152",
             "max_abs_err": errs["fwd"], **rows["fwd"]["N=25"],
             "timer": "ms: device_ms with the L2 flushed between launches (cold), ms_warm "
                      "without; host_ms: the wrapper's host time per call",
             "library_is": "split + transpose of the raw qkv, scaled_dot_product_attention "
                           "on bf16 q, k, v with the additive mask",
             "token_drop": rows["fwd"]["N=7, token drop"]},
            {"name": "fused_attention_bwd", "route": "cuda", "source": src,
             "replaces": "ssl_audio_tpu/ops/fused_attention.py:187",
             "max_abs_err": errs["bwd"], **rows["bwd"]["N=25"],
             "library_is": "the same yardstick's backward alone (torch.autograd.grad of its "
                           "output, forward run once); library_fwd_bwd_ms: forward and "
                           "backward through autograd",
             "token_drop": rows["bwd"]["N=7, token drop"]}]


def phase_kernels(gen: torch.Generator, dev: torch.device) -> list[dict]:
    from ssl_audio_tpu_torch.ops import no_tf32
    from ssl_audio_tpu_torch.ops.fused_conv import (
        fused_conv1_bn_relu_pool_eval, fused_conv1_fwd_cuda,
        fused_conv1_fwd_plain, nchw_memory)
    from ssl_audio_tpu_torch.ops.mel import MelSpec, log_mel_spectrogram_plain
    from ssl_audio_tpu_torch.ops.mel_kernel import log_mel_cuda
    from ssl_audio_tpu_torch.tools.serving import cuda_ms, seeded_clips

    print("phase 3: kernels against their plain versions on the card")
    hear_spec = MelSpec(win_length=400)
    # the timestamp path's input: one chunk of CHUNK windows
    wav = seeded_clips(gen, CHUNK, WINDOW).to(dev)
    mel_rows = {"folded": mel_row(wav, hear_spec, None, "folded"),
                "unfolded": mel_row(wav, hear_spec, False, "unfolded")}
    # the scene path's input: the request's 16 whole 10-s clips (T = 1001,
    # a partial last frame tile, reflect indexing over a 160k-sample row)
    scene_wav = seeded_clips(gen, N_CLIPS, CLIP).to(dev)
    mel_rows["scene_shape"] = mel_row(scene_wav, hear_spec, None, "folded, scene")
    train_err = {}
    for label, fold in (("folded", None), ("unfolded", False)):
        spec = MelSpec(win_length=1024)
        train_err[label] = max_err(log_mel_cuda(wav, spec, fold=fold),
                                   log_mel_spectrogram_plain(wav, spec, fold=fold))
        check(f"log_mel[train_spec_{label}] ({CHUNK} x {WINDOW})", train_err[label], MEL_ATOL,
              "three TF32 passes, sums in another order")
    # the training step's input: 128 whole 10-s clips, 96 frames from per-clip
    # starts (first, last valid and random ones), both instantiations
    train_spec = MelSpec(win_length=1024)
    train_wav = seeded_clips(gen, TRAIN_BATCH, CLIP).to(dev)
    last = train_spec.num_frames(CLIP) - TRAIN_FRAMES
    starts = torch.randint(0, last + 1, (TRAIN_BATCH,), generator=gen, dtype=torch.int32)
    starts[0], starts[1] = 0, last
    starts = starts.to(dev)
    mel_rows["cropped"] = cropped_mel_row(train_wav, starts, train_spec, None,
                                          "folded, cropped")
    mel_rows["cropped_unfolded"] = cropped_mel_row(train_wav, starts, train_spec, False,
                                                   "unfolded, cropped")
    dynamic_range = mel_dynamic_range(gen, dev)

    # fused conv forward at one chunk of timestamp windows: (512, 64, 96),
    # inputs quantised to 0.5 so windows tie, mixed-sign gamma, one exact 0
    B, H, W, C = CHUNK, 64, 96, 64
    x = (torch.round(torch.randn(B, H, W, generator=gen) * 2) / 2).to(dev)
    wk = (0.3 * torch.randn(9, C, generator=gen)).to(dev)
    bias = (0.1 * torch.randn(C, generator=gen)).to(dev)
    gamma = 1.0 + 0.3 * torch.randn(C, generator=gen)
    gamma[: C // 4] *= -1.0
    gamma[C // 2] = 0.0
    gamma = gamma.to(dev)
    beta = (0.2 * torch.randn(C, generator=gen)).to(dev)
    mean = (0.5 * torch.randn(C, generator=gen)).to(dev)
    var = (0.5 + torch.rand(C, generator=gen)).to(dev)
    kernel_hwio = wk.reshape(3, 3, 1, C)

    sel, s1, s2 = fused_conv1_fwd_cuda(x, wk, bias, gamma)
    again = fused_conv1_fwd_cuda(x, wk, bias, gamma)
    sel_p, s1_p, s2_p = fused_conv1_fwd_plain(x, wk, bias, gamma)
    ev = fused_conv1_bn_relu_pool_eval(x[..., None], kernel_hwio, bias, gamma,
                                       beta, mean, var)
    # the eval kernel as the wrapper launches it, with its statistics precomputed
    stats = torch.stack([mean, torch.rsqrt(var + 1e-5), beta]).contiguous()

    def plain_eval():
        sp, _, _ = fused_conv1_fwd_plain(x, wk, bias, gamma)
        return torch.relu(gamma * (sp - mean) * torch.rsqrt(var + 1e-5) + beta)

    ev_p = plain_eval()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((sel, s1, s2), again)):
        raise SystemExit("fused_conv1_fwd: two launches gave different bits")
    if not (nchw_memory(sel) and nchw_memory(ev)):
        raise SystemExit("fused_conv1_fwd: the output is not (B, C, H/2, W/2) in memory")
    print("  fused_conv1_fwd: two launches give the same bits; output (B, C, H/2, W/2) in memory")
    check(f"fused_conv1_fwd sel ({B} x {H} x {W})", max_err(sel, sel_p), CONV_ATOL,
          "cuDNN fp32 conv algorithm rounding")
    for name, a, b in (("s1", s1, s1_p), ("s2", s2, s2_p)):
        check(f"fused_conv1_fwd {name} / max|{name}|",
              max_err(a, b) / float(b.abs().max()), STATS_RTOL,
              "3.1e6-term fp32 sums in another order")
    conv_err = max_err(ev, ev_p)
    check("fused_conv1_bn_relu_pool_eval", conv_err, CONV_ATOL,
          "cuDNN fp32 conv algorithm rounding")

    def library_conv():
        with no_tf32():
            y = torch.nn.functional.conv2d(x[:, None], wk.t().reshape(C, 1, 3, 3),
                                           bias, padding=1)
            z = torch.nn.functional.batch_norm(y, mean, var, gamma, beta,
                                               training=False, eps=1e-5)
            return torch.nn.functional.max_pool2d(torch.relu(z), 2)

    lib_conv_err = max_err(library_conv().permute(0, 2, 3, 1), ev_p)
    conv_flops = 19 * B * H * W * C + 7 * B * (H // 2) * (W // 2) * C
    conv_bytes = 4 * (x.numel() + ev.numel() + 14 * C)
    stats_mode = device_times(lambda: fused_conv1_fwd_cuda(x, wk, bias, gamma))
    conv_row = {
        "max_abs_err": max(conv_err, max_err(sel, sel_p)),
        "shape": f"{(B, H, W)} -> {tuple(ev.shape)}, eval epilogue fused",
        "layout": "(B, C, H/2, W/2) in memory, a (B, H/2, W/2, C) view",
        "library_max_abs_err": lib_conv_err,
        **device_times(lambda: fused_conv1_fwd_cuda(x, wk, bias, gamma, stats)),
        "function_ms": cuda_ms(lambda: fused_conv1_bn_relu_pool_eval(
            x[..., None], kernel_hwio, bias, gamma, beta, mean, var)),
        **conv_grid(B, H, W, backward=False, eval_mode=True),
        "plain_ms": cuda_ms(plain_eval), **both_bounds(conv_flops, conv_bytes),
        "library_ms": cuda_ms(library_conv),
        "stats_mode_ms": stats_mode["ms"], "stats_mode_ms_warm": stats_mode["ms_warm"],
        "stats_mode_plain_ms": cuda_ms(lambda: fused_conv1_fwd_plain(x, wk, bias, gamma)),
        "timer": "ms: device_ms with the L2 flushed between launches (cold), ms_warm without; "
                 "cuda_events_ms: the mean of back-to-back launches",
    }
    print("  fused_conv1_fwd[eval]: " + json.dumps(conv_row))
    bwd_rows, fwd_train_row = backward_rows(gen, dev)
    return [
        {"name": "log_mel_folded", "route": "cuda",
         "source": "ssl_audio_tpu_torch/csrc/log_mel.cu",
         "replaces": "ssl_audio_tpu/ops/mel_pallas.py:185",
         **mel_rows["folded"],
         "max_abs_err": max(train_err["folded"], *(mel_rows[k]["max_abs_err"] for k in (
             "folded", "scene_shape", "cropped"))),
         "train_spec_max_abs_err": train_err["folded"],
         "dynamic_range": dynamic_range["folded"],
         "scene_shape": mel_rows["scene_shape"],
         "cropped": mel_rows["cropped"]},
        {"name": "log_mel_unfolded", "route": "cuda",
         "source": "ssl_audio_tpu_torch/csrc/log_mel.cu",
         "replaces": "ssl_audio_tpu/ops/mel_pallas.py:139",
         **mel_rows["unfolded"],
         "max_abs_err": max(train_err["unfolded"], *(mel_rows[k]["max_abs_err"] for k in (
             "unfolded", "cropped_unfolded"))),
         "train_spec_max_abs_err": train_err["unfolded"],
         "dynamic_range": dynamic_range["unfolded"],
         "cropped": mel_rows["cropped_unfolded"]},
        {"name": "fused_conv1_fwd", "route": "cuda",
         "source": "ssl_audio_tpu_torch/csrc/fused_conv_fwd.cu",
         "replaces": "ssl_audio_tpu/ops/fused_conv.py:186", **conv_row,
         "train_shape": fwd_train_row},
        *bwd_rows,
        *attention_rows(gen, dev),
    ]


def phase_serving(gen: torch.Generator, dev: torch.device, smi: str) -> dict:
    from ssl_audio_tpu_torch.hear import conv as hear_conv
    from ssl_audio_tpu_torch.ops.mel_kernel import kernel_operands
    from ssl_audio_tpu_torch.tools.serving import seeded_clips, seeded_serving_model

    print("phase 4: HEAR serving, AudioNTT2022 (64 mels, d=3072, fp32, fused_conv=True)")
    model = seeded_serving_model(gen, dev)
    audio = seeded_clips(gen, N_CLIPS, CLIP)

    # the kernels each request's path runs: the log-mel instantiation of the
    # serving spec, and the fused block 1 where the log-mel's H and W are
    # even (the 96-frame timestamp windows; not the 1001-frame scene clips)
    mel = "log_mel_folded" if kernel_operands(model.mel).fold else "log_mel_unfolded"
    block1 = ("fused_conv1_fwd",)
    path_kernels = {
        "timestamp": (mel,) + block1,
        "scene": (mel,) + (block1 if model.mel.num_frames(CLIP) % 2 == 0 else ())}
    requests = {
        "timestamp": lambda: hear_conv.get_timestamp_embeddings(audio, model),
        "scene": lambda: hear_conv.get_scene_embeddings(audio, model)}
    launches, outputs = {}, {}
    for path, request in requests.items():
        zero_launch_counts()
        outputs[path] = request()
        torch.cuda.synchronize()
        launches[path] = launch_counts()
        print(f"  {path} request launches: {launches[path]}")
        missing = [k for k in path_kernels[path] if launches[path][k] <= 0]
        if missing:
            raise SystemExit(f"{path} request: {missing} not launched")
    ts_emb, ts = outputs["timestamp"]
    scene = outputs["scene"]
    n_frames = ts.shape[1]
    if ts_emb.shape != (N_CLIPS, n_frames, 3072) or scene.shape != (N_CLIPS, 3072):
        raise SystemExit(f"bad shapes {tuple(ts_emb.shape)} {tuple(scene.shape)}")
    if not (torch.isfinite(ts_emb).all() and torch.isfinite(scene).all()):
        raise SystemExit("non-finite embeddings")
    print(f"  timestamp {tuple(ts_emb.shape)}, scene {tuple(scene.shape)}, finite")

    ts_ms = statistics.median(wall_ms(requests["timestamp"]))
    sc_ms = statistics.median(wall_ms(requests["scene"]))
    serving = {
        "clips": N_CLIPS, "clip_seconds": CLIP / 16000, "windows": N_CLIPS * n_frames,
        "timestamp_ms_per_request": ts_ms,
        "timestamp_clips_per_s": N_CLIPS / ts_ms * 1e3,
        "scene_ms_per_request": sc_ms, "scene_clips_per_s": N_CLIPS / sc_ms * 1e3,
        "launches": launches, "card": smi,
    }
    print("  serving: " + json.dumps(serving))

    # the same model on the CPU (plain path) on a small request
    cpu = hear_conv.load_model("", "audiontt", fused_conv=True, device="cpu")
    cpu.model.load_state_dict(model.model.state_dict())
    small = audio[:2, : 2 * 16000]
    for name, fn in (("timestamp", lambda m: hear_conv.get_timestamp_embeddings(small, m)[0]),
                     ("scene", lambda m: hear_conv.get_scene_embeddings(small, m))):
        a, b = fn(model), fn(cpu)
        check(f"{name} embeddings card vs CPU, / max|emb|",
              max_err(a, b) / float(b.abs().max()), EMB_RTOL,
              "fp32 sums in another order through four layers")
    return serving


def entry_epoch(argv: list[str], want: dict, seed: int):
    """One ENTRY_STEPS-step epoch of the training entry point's path:
    config_from_args(argv), its Trainer, the DataLoader over SyntheticWav
    and train_one_epoch, the launch counters zeroed just before each step
    and read just after it; every step must launch `want`.
    -> (trainer, the last step's launches, the epoch's numbers)."""
    from ssl_audio_tpu_torch.config import config_from_args
    from ssl_audio_tpu_torch.train.loop import Trainer

    cfg = config_from_args(argv + ["--epochs", "1", "--synthetic_steps_per_epoch",
                                   str(ENTRY_STEPS), "--seed", str(seed)])
    log_lines = []
    trainer = Trainer(cfg, log=log_lines.append)
    if trainer.device.type != "cuda":
        raise SystemExit(f"the Trainer chose {trainer.device}, not the card")
    step = trainer.train_step
    per_step, step_ends = [], []

    def counted_step(*args, **kwargs):
        zero_launch_counts()
        out = step(*args, **kwargs)
        torch.cuda.synchronize()
        per_step.append(launch_counts())
        step_ends.append(time.perf_counter())
        return out

    trainer.train_step = counted_step
    t0 = time.perf_counter()
    epoch_loss = trainer.train_one_epoch(1)
    epoch_s = time.perf_counter() - t0
    trainer.train_step = step
    for line in log_lines:
        print(f"  | {line}")
    print(f"  Trainer.train_one_epoch: {len(per_step)} steps, each step's launches: {per_step[0]}")
    if len(per_step) != ENTRY_STEPS or any(c != want for c in per_step):
        raise SystemExit(f"the epoch's steps launched {per_step}, expected {ENTRY_STEPS} x {want}")
    if epoch_loss != epoch_loss or abs(epoch_loss) == float("inf"):
        raise SystemExit(f"the epoch's mean loss is {epoch_loss}")
    # from the end of one step to the end of the next: the loader's batch (made
    # on the host), its upload and the step
    entry_ms = statistics.median([(b - a) * 1e3 for a, b in zip(step_ends, step_ends[1:])])
    return trainer, per_step[-1], {"steps": ENTRY_STEPS, "epoch_s": epoch_s,
                                   "mean_loss": epoch_loss,
                                   "ms_per_step_after_first_median": entry_ms,
                                   "clips_per_s": TRAIN_BATCH / entry_ms * 1e3}


def card_vs_cpu_step(seed: int, dev: torch.device, overrides: dict, step_kwargs: dict,
                     zero_grad: tuple, loss_rtol: float, grad_rtol: float, why: str,
                     global_rtol: float | None = None) -> dict:
    """One small step on the card against the same step on the CPU (plain
    versions): the same seeded weights, the same 16 wavs, the same draws.
    zero_grad: parameters whose gradient is mathematically 0 (float noise).
    Limits: the loss (relative), the worst tensor's gradient (relative L2)
    and, if given, all gradients as one vector (relative L2)."""
    from ssl_audio_tpu_torch.tools.serving import seeded_clips
    from ssl_audio_tpu_torch.tools.train_profile import seeded_training
    from ssl_audio_tpu_torch.train.steps import draw_step

    wav_small = seeded_clips(torch.Generator().manual_seed(seed + 7), 16, 2 * 16000)
    runs = {}
    for where in ("cpu", dev):
        cfg_s, state_s, step_s, _ = seeded_training(seed, where, **overrides)
        draws = draw_step(torch.Generator().manual_seed(seed + 9), cfg_s,
                          tuple(wav_small.shape), state_s.modules["encoder"], wav=True)
        loss = float(step_s(state_s, wav_small.to(where), draws=draws.to(where),
                            **step_kwargs)["loss"])
        grads = {k: p.grad.detach().cpu() for k, p in state_s.modules.named_parameters()
                 if p.grad is not None}
        runs[str(where)] = (loss, grads)
    (loss_c, grads_c), (loss_d, grads_d) = runs["cpu"], runs[str(dev)]
    loss_err = abs(loss_d - loss_c) / abs(loss_c)
    worst, worst_name, worst_max, sq_diff, sq_ref = 0.0, "", 0.0, 0.0, 0.0
    for k, g in grads_c.items():
        if k in zero_grad:
            continue
        diff = grads_d[k].double() - g.double()
        worst_max = max(worst_max, float(diff.abs().max() / g.abs().max()))
        rel = float(diff.norm() / g.double().norm())
        sq_diff += float(diff.norm()) ** 2
        sq_ref += float(g.double().norm()) ** 2
        if rel > worst:
            worst, worst_name = rel, k
    overall = (sq_diff / sq_ref) ** 0.5
    print(f"  small step (batch 16, {overrides}), card vs CPU: loss {loss_d!r} vs {loss_c!r}; "
          f"gradients worst relative L2 {worst:.2e} ({worst_name}), all at once {overall:.2e}, "
          f"largest single element {worst_max:.1e} of its tensor's largest")
    check("train step loss, card vs CPU, relative", loss_err, loss_rtol, why)
    check("train step gradients, |card - CPU| / |CPU| per tensor", worst, grad_rtol, why)
    if global_rtol is not None:
        check("train step gradients, |card - CPU| / |CPU| all at once", overall, global_rtol, why)
    return {"loss_rel_err": loss_err, "grad_rel_l2_err": worst, "worst_grad": worst_name,
            "grad_rel_l2_err_all": overall, "grad_max_elem_err": worst_max}


def timed_steps(step, state, wavs, gen, **kwargs) -> tuple[list[float], list[float]]:
    """Host-clock ms of TRAIN_STEPS steps on the resident batch after two
    warm-up steps, and the losses of all of them, which must be finite."""
    from ssl_audio_tpu_torch.tools.train_profile import step_wall_ms

    losses = [float(step(state, wavs, gen=gen, **kwargs)["loss"]) for _ in range(2)]
    pending = []
    times = step_wall_ms(lambda: pending.append(step(state, wavs, gen=gen, **kwargs)["loss"]),
                         TRAIN_STEPS)
    losses += [float(v) for v in pending]
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        raise SystemExit(f"non-finite loss among {losses}")
    return times, losses


def phase_training(seed: int, dev: torch.device, smi: str) -> dict:
    from ssl_audio_tpu_torch.tools.serving import seeded_clips

    print("phase 5: Barlow Twins training, AudioNTT2022 (64 mels, d=3072, projector "
          "3072-8192-256, batch 128, crop 96, fp32, LARS), raw 10-s clips in")
    want = {"log_mel_folded": 1, "log_mel_unfolded": 0, "fused_conv1_fwd": 2,
            "fused_conv1_bwd": 2, "fused_conv1_dx": 0, "fused_attention_fwd": 0,
            "fused_attention_bwd": 0}
    trainer, launches, entry = entry_epoch(
        ["--dataset", "synthetic_wav", "--model_type", "audiontt"], want, seed)
    state, step, gen = trainer.state, trainer.train_step, trainer.gen
    before = {k: v.clone() for k, v in state.modules.state_dict().items()}

    # the step alone, on one batch resident on the card
    wavs = seeded_clips(torch.Generator().manual_seed(seed), TRAIN_BATCH, CLIP).to(dev)
    times, losses = timed_steps(step, state, wavs, gen)
    after = state.modules.state_dict()
    frozen = [k for k, v in after.items()
              if torch.equal(v, before[k])
              # a conv bias before a batch norm has a zero gradient
              and k not in ("encoder.features.0.bias", "encoder.features.4.bias")]
    if frozen:
        raise SystemExit(f"did not move in {TRAIN_STEPS + 2} steps: {frozen}")
    print(f"  {ENTRY_STEPS} steps through the Trainer (mean loss {entry['mean_loss']:.2f}), "
          f"then {TRAIN_STEPS + 2} on a resident batch, all finite; every parameter and "
          "running statistic moved")
    median = statistics.median(times)
    training = {"batch": TRAIN_BATCH, "clip_seconds": CLIP / 16000, "steps_timed": TRAIN_STEPS,
                "ms_per_step_median": median, "ms_per_step_min": min(times),
                "ms_per_step_max": max(times), "clips_per_s": TRAIN_BATCH / median * 1e3,
                "first_loss": losses[0], "last_loss": losses[-1], "launches": launches,
                "entry_point": entry, "card": smi}
    print("  training: " + json.dumps(training))
    training["cpu_check"] = card_vs_cpu_step(
        seed, dev, dict(batch_size=16), {},
        ("encoder.features.0.bias", "encoder.features.4.bias"), STEP_LOSS_RTOL,
        STEP_GRAD_RTOL, "pool and ReLU decisions flip on 1e-7 input differences")
    return training


def phase_training_vit(seed: int, dev: torch.device, smi: str) -> dict:
    from ssl_audio_tpu_torch.tools.serving import seeded_clips
    from ssl_audio_tpu_torch.tools.train_profile import seeded_training
    from ssl_audio_tpu_torch.train.loop import token_drop_len_keep

    print("phase 6: Barlow Twins training, ViT-B (embed 768, depth 12, 12 heads, 24 patches "
          "+ CLS, projector 768-8192-256, batch 128, crop 96, fp32 with bf16-operand "
          "attention kernels, AdamW), raw 10-s clips in")
    want = {"log_mel_folded": 1, "log_mel_unfolded": 0, "fused_conv1_fwd": 0,
            "fused_conv1_bwd": 0, "fused_conv1_dx": 0,
            "fused_attention_fwd": 2 * VIT_DEPTH, "fused_attention_bwd": 2 * VIT_DEPTH}
    trainer, launches, entry = entry_epoch(VIT_FLAGS, want, seed)
    state = trainer.state
    before = {k: v.clone() for k, v in state.modules.state_dict().items()}

    # timed steps on a resident batch, unmasked and with token drop, with the
    # kernels and with the fp32 einsum attention, in turns (A B B A)
    wavs = seeded_clips(torch.Generator().manual_seed(seed), TRAIN_BATCH, CLIP).to(dev)
    _, einsum_state, einsum_step, einsum_gen = seeded_training(
        seed, dev, model_type="vit_base", fused_attention=False)
    runs = {"fused_attention": (trainer.train_step, state, trainer.gen),
            "einsum_attention": (einsum_step, einsum_state, einsum_gen)}
    maskings = {"unmasked": {},
                "token_drop_0.75": dict(mask_ratio=0.75, len_keep=token_drop_len_keep(
                    VIT_TOKENS - 1, 0.75))}
    times = {f"{a}/{m}": [] for a in runs for m in maskings}
    step_launches = {}
    for attn in ("fused_attention", "einsum_attention", "einsum_attention", "fused_attention"):
        step, st, gen = runs[attn]
        for m, kw in maskings.items():
            times[f"{attn}/{m}"] += timed_steps(step, st, wavs, gen, **kw)[0]
            zero_launch_counts()
            step(st, wavs, gen=gen, **kw)
            torch.cuda.synchronize()
            step_launches[f"{attn}/{m}"] = launch_counts()
    print(f"  launches per timed step: {step_launches}")
    for m in maskings:
        if (step_launches[f"fused_attention/{m}"]["fused_attention_fwd"],
                step_launches[f"fused_attention/{m}"]["fused_attention_bwd"],
                step_launches[f"einsum_attention/{m}"]["fused_attention_fwd"]) \
                != (2 * VIT_DEPTH, 2 * VIT_DEPTH, 0):
            raise SystemExit(f"timed {m} steps launched {step_launches}")
    after = state.modules.state_dict()
    moved = {k: not torch.equal(v, before[k]) for k, v in after.items()}
    frozen = [k for k in moved if k.startswith("encoder.patch_embed")]
    if any(moved[k] for k in frozen) or any(
            trainer.state.modules.get_parameter(k).requires_grad for k in frozen):
        raise SystemExit(f"the frozen patch projection moved or takes a gradient: {frozen}")
    still = [k for k, m in moved.items()
             if not m and k not in frozen and not k.endswith("pos_embed")
             and k != "encoder.norm.bias"]        # BT gradient 0: BatchNorm follows
    if still:
        raise SystemExit(f"did not move: {still}")
    print(f"  {ENTRY_STEPS} steps through the Trainer (mean loss {entry['mean_loss']:.2f}), then "
          f"{4 * (TRAIN_STEPS + 3)} per attention on a resident batch, all finite; every "
          "trained parameter moved, the frozen patch projection did not")
    medians = {k: statistics.median(v) for k, v in times.items()}
    training = {"model": "vit_base", "batch": TRAIN_BATCH, "clip_seconds": CLIP / 16000,
                "steps_timed": 2 * TRAIN_STEPS, "order": "fused, einsum, einsum, fused",
                "ms_per_step_median": medians,
                "ms_per_step_min": {k: min(v) for k, v in times.items()},
                "clips_per_s": {k: TRAIN_BATCH / v * 1e3 for k, v in medians.items()},
                "launches": launches, "timed_step_launches": step_launches,
                "entry_point": {"flags": VIT_FLAGS, **entry}, "card": smi}
    print("  training_vit: " + json.dumps(training))
    # vit_tiny steps, teacher masked by key bias through the kernels on the card;
    # the final LayerNorm's bias has a zero Barlow Twins gradient (BatchNorm follows)
    training["cpu_check"] = {
        attn: card_vs_cpu_step(
            seed, dev, dict(model_type="vit_tiny", fused_attention=fused, batch_size=16),
            dict(mask_ratio=0.75), ("encoder.norm.bias",), STEP_LOSS_RTOL, *limits)
        for attn, fused, limits in (
            ("einsum_attention", False,
             (VIT_FP32_GRAD_RTOL, "fp32 sums in another order, through 12 blocks")),
            ("fused_attention", True,
             (VIT_FUSED_GRAD_RTOL, "bf16 roundings flipped by 1e-7 differences, amplified",
              VIT_FUSED_GLOBAL_RTOL)))}
    return training


def wall_ms(fn, reps: int = 3) -> list[float]:
    """Host-clock ms of `reps` calls of fn, each ending in a synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def unit_flops(model: torch.nn.Module, unit: torch.Tensor) -> float:
    """FLOPs of one forward of `model` on a batch-1 unit: 2 x the
    multiply-adds of every Conv2d and Linear (from a forward's output
    shapes) and of the attention's two products (2 N^2 C per block)."""
    macs = []

    def conv(mod, inp, out):
        macs.append(out.numel() * mod.in_channels // mod.groups * mod.weight[0, 0].numel())

    def linear(mod, inp, out):
        macs.append(out.numel() * mod.in_features)

    hooks = [m.register_forward_hook(conv if isinstance(m, torch.nn.Conv2d) else linear)
             for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            tokens = model(unit, return_all=True)
    finally:
        for h in hooks:
            h.remove()
    n, c = tokens.shape[1], tokens.shape[2]
    return 2.0 * (sum(macs) + len(model.blocks) * 2 * n * n * c)


def phase_serving_vit(gen: torch.Generator, dev: torch.device, smi: str) -> dict:
    from ssl_audio_tpu_torch.hear import vit as hear_vit
    from ssl_audio_tpu_torch.tools.serving import profile, seeded_clips, seeded_vit_serving_model

    print("phase 7: HEAR serving, vitc_base 16x8 (embed 768, depth 11, 12 heads, 48 patches "
          "+ CLS, fp32, einsum attention)")
    model = seeded_vit_serving_model(gen, dev)
    spec = model.model.spec
    if (spec.embed_dim, spec.depth, spec.num_heads, model.model.grid_size()) != (
            768, 11, 12, (4, 12)) or model.model.training:
        raise SystemExit(f"not the vitc_base 16x8 serving model: {spec}")
    audio = seeded_clips(gen, N_CLIPS, CLIP)
    requests = {"hear_vit_timestamp": lambda: hear_vit.get_timestamp_embeddings(audio, model),
                "hear_vit_scene": lambda: hear_vit.get_scene_embeddings(audio, model)}
    for fn in requests.values():
        fn()                                     # warm-up: cuBLAS and cuDNN plans
    launches, outputs = {}, {}
    for path, request in requests.items():
        zero_launch_counts()
        outputs[path] = request()
        torch.cuda.synchronize()
        launches[path] = launch_counts()
        print(f"  {path} request launches: {launches[path]}")
    ts_emb, ts = outputs["hear_vit_timestamp"]
    scene = outputs["hear_vit_scene"]
    windows = N_CLIPS * ts.shape[1]
    chunks = -(-windows // CHUNK)
    for path, n in (("hear_vit_timestamp", chunks), ("hear_vit_scene", 1)):
        want = {k: 0 for k in launches[path]}
        want["log_mel_folded"] = n
        if launches[path] != want:
            raise SystemExit(f"{path} request launched {launches[path]}, expected {want}")
    if ts_emb.shape != (N_CLIPS, ts.shape[1], 768) or scene.shape != (N_CLIPS, 768):
        raise SystemExit(f"bad shapes {tuple(ts_emb.shape)} {tuple(scene.shape)}")
    if not (torch.isfinite(ts_emb).all() and torch.isfinite(scene).all()):
        raise SystemExit("non-finite embeddings")
    print(f"  timestamp {tuple(ts_emb.shape)} ({windows} windows, {chunks} chunks), "
          f"scene {tuple(scene.shape)}, finite")

    # the work: one forward per window, one silent unit per chunk; the scene
    # request's units of 96 frames (the last one padded) per clip
    per_unit = unit_flops(model.model, torch.zeros(1, 1, 64, 96, device=dev))
    scene_units = N_CLIPS * (model.mel.num_frames(CLIP) // 96 + 1)
    times = {p: wall_ms(fn) for p, fn in requests.items()}
    serving = {"model": "vitc_base 16x8", "clips": N_CLIPS, "clip_seconds": CLIP / 16000,
               "windows": windows, "chunks": chunks, "scene_units": scene_units,
               "gflop_per_unit": per_unit / 1e9, "launches": launches, "card": smi}
    for path, units in (("hear_vit_timestamp", windows + chunks),
                        ("hear_vit_scene", scene_units)):
        prof = profile(requests[path])
        median = statistics.median(times[path])
        serving[path] = {
            "ms_per_request_median": median, "ms_per_request": times[path],
            "clips_per_s": N_CLIPS / median * 1e3, "unit_forwards": units,
            "tflop": units * per_unit / 1e12,
            "bound_ms": units * per_unit / PEAK_FP32_FLOPS * 1e3, "bound_by": "operations",
            "profiled_wall_ms": prof["wall_ms"], "device_busy_ms": prof["device_busy_ms"],
            "idle_share": prof["idle_share"],
            "device_ms_by_kernel": {k[:90]: v for k, v in prof["device_ms_by_kernel"].items()}}
        print(f"  {path}: " + json.dumps(serving[path]))

    # the same model on the CPU (plain path) on a small request
    cpu = hear_vit.load_model("", "vitc_base", "16x8", device="cpu")
    cpu.model.load_state_dict(model.model.state_dict())
    small = audio[:2, :16000]
    serving["cpu_check"] = {}
    for name, fn in (("timestamp", lambda m: hear_vit.get_timestamp_embeddings(small, m)[0]),
                     ("scene", lambda m: hear_vit.get_scene_embeddings(small, m))):
        a, b = fn(model), fn(cpu)
        err = max_err(a, b) / float(b.abs().max())
        serving["cpu_check"][name] = err
        check(f"ViT {name} embeddings card vs CPU, / max|emb|", err, EMB_RTOL,
              "fp32 sums in another order through the stem and 11 blocks")
    return serving


def phase_eval(seed: int, dev: torch.device, smi: str) -> dict:
    import copy

    from ssl_audio_tpu_torch.config import default_config
    from ssl_audio_tpu_torch.data.datasets import SyntheticLMS
    from ssl_audio_tpu_torch.data.pipeline import DataLoader
    from ssl_audio_tpu_torch.eval.linear import eval_linear, make_embedding_forward
    from ssl_audio_tpu_torch.models.audiontt import init_weights_
    from ssl_audio_tpu_torch.models.vit import init_vit_weights_
    from ssl_audio_tpu_torch.train.state import build_encoder

    print("phase 8: evaluation stack: eval_linear over seeded SyntheticLMS loaders "
          f"({EVAL_ITEMS}, {EVAL_CLASSES} classes, crop 96), probe max_iter {EVAL_MAX_ITER}")
    paths = {"eval_audiontt": (dict(model_type="audiontt"), "fused_conv1_fwd"),
             "eval_vit": (dict(model_type="vit_base", fused_attention=True),
                          "fused_attention_fwd")}
    out = {"card": smi, "items": EVAL_ITEMS, "classes": EVAL_CLASSES,
           "max_iter": EVAL_MAX_ITER, "launches": {}}
    for path, (kw, kernel) in paths.items():
        cfg = default_config(dataset="synthetic", **kw)
        gen = torch.Generator().manual_seed(seed)
        enc, dim = build_encoder(cfg)
        if kw["model_type"] == "audiontt":
            init_weights_(enc, gen)
            with torch.no_grad():
                for bn in (enc.features[1], enc.features[5]):
                    c = bn.num_features
                    bn.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=gen))
                    bn.weight[: c // 4] *= -1.0
                    bn.running_mean.copy_(0.5 * torch.randn(c, generator=gen))
                    bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
        else:
            init_vit_weights_(enc, gen)
        cpu_enc = copy.deepcopy(enc)
        enc.to(dev)
        forward = make_embedding_forward(cfg, enc)
        loaders = [DataLoader(SyntheticLMS(cfg, length=n, n_classes=EVAL_CLASSES, seed=i),
                              batch_size=cfg.batch_size, shuffle=False, drop_last=False,
                              num_workers=4)
                   for i, n in enumerate(EVAL_ITEMS.values())]
        forward(torch.zeros(2, 1, 64, 96, device=dev))     # warm-up
        zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = eval_linear(forward, *loaders, max_iter=EVAL_MAX_ITER, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = out["launches"][path] = launch_counts()
        print(f"  {path} launches: {launches}")
        if launches[kernel] <= 0 or any(v for k, v in launches.items() if k != kernel):
            raise SystemExit(f"{path}: expected {kernel} launches only, got {launches}")
        # one batch's embeddings, card against the same encoder on the CPU
        x, _ = next(iter(loaders[2]))
        x = torch.from_numpy(x[:16])
        a = forward(x.to(dev)).cpu()
        b = make_embedding_forward(cfg, cpu_enc)(x)
        err = max_err(a, b) / float(b.abs().max())
        check(f"{path} embeddings card vs CPU, / max|emb|", err, EMB_RTOL,
              "fp32 sums in another order" + ("; bf16 attention operands that round "
                                              "the other way" if kernel.startswith("fused_att")
                                              else ""))
        s5 = scores["score_5"]
        if not (0.0 < scores["score_all"] <= 1.0 and all(0.0 <= v <= 1.0 for v in s5)):
            raise SystemExit(f"{path}: scores out of range {scores}")
        out[path] = {"encoder": kw, "embed_dim": dim, "score_all_map": scores["score_all"],
                     "score_5_map_mean_std": list(s5), "eval_linear_s": seconds,
                     "cpu_check": err}
        print(f"  {path}: " + json.dumps(out[path]))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from ssl_audio_tpu_torch.ops import _build
    from ssl_audio_tpu_torch.tools.serving import smi_line

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    t_start = time.perf_counter()
    print("phase 1: device")
    smi = smi_line()
    print(smi)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    print("phase 2: build")
    secs = _build.build_all()
    print(f"  built {', '.join(_build.SOURCES)} in {secs:.1f} s")
    for src, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    kernels = phase_kernels(gen, dev)
    serving = phase_serving(gen, dev, smi)
    training = phase_training(args.seed, dev, smi)
    training_vit = phase_training_vit(args.seed, dev, smi)
    serving_vit = phase_serving_vit(gen, dev, smi)
    evaluation = phase_eval(args.seed, dev, smi)
    # launches on the main paths, per path (timestamp request, scene request,
    # one AudioNTT train step, one ViT-B train step, the ViT timestamp and
    # scene requests, eval_linear with each encoder) and in all
    by_path = {**serving["launches"], "train": training["launches"],
               "train_vit": training_vit["launches"], **serving_vit["launches"],
               **evaluation["launches"]}
    for entry in kernels:
        entry["launches_by_path"] = {p: c[entry["name"]] for p, c in by_path.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
