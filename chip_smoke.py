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
     against the same encoder on the CPU;
  9. the pretraining run: `ssl_audio_tpu_torch.main.main` in-process at
     the defaults (AudioNTT2022, batch 128, LARS, mixup bank 2,048, raw wav
     in) for 3 epochs of 3 steps, twice uninterrupted and once resumed from
     the first run's model_2.pt, in a temporary directory: the per-epoch
     losses, the largest parameter difference resumed vs uninterrupted
     beside uninterrupted vs uninterrupted (the resumed run may differ by no
     more; bit-identical where the two uninterrupted runs are), the
     checkpoint's bytes and its save and load seconds; the same for ViT-B
     (--fused_attention, AdamW, --lr_schedule, 3 epochs of 2 steps); HEAR
     serving of the timestamp request from the AudioNTT run's model_3.pt
     with fused_conv=True, bit-identical to a model given the trainer's
     encoder in memory (log-mel folded 7, fused forward 7); and a 3-epoch
     learning proof (tools/prove_learning.py: SyntheticMultiCue, batch 128,
     50 steps per epoch, Adam 1e-3, the probe at init and after each epoch
     through Trainer.fit's eval_fn hook), its losses finite and its scores
     in [0, 1], launches counted per step and per probe;
 10. the on-disk data path, in a temporary directory with `data/` in it, as
     a user runs it: an FSD50K tree (768 train and 128 val rows in dev.csv,
     128 in eval.csv, 200 classes, 1-3 labels a clip, `.npy` log-mels of
     30-3000 frames and a wav of each) and an AudioSet wav tree (512 + 256
     10-s clips, every 8th stereo, every 16th 2.5, 5 or 7.5 s) are written;
     (a) tools/wav_to_lms over the 256 balanced wavs, one log-mel launch per
     length group, outputs held against the plain version on the CPU, and the
     kernel timed at the converter's group shape; (b) main at the defaults
     on FSD50K (C++ npy reader, pinned batches) for 2 epochs with the
     per-epoch probe on: launches per step and per probe, the probe's
     seconds and mAP, epochs through the Trainer timed by CUDA events with
     pinned and pageable batches (A B B A) and one profiled (data_time /
     step_time, idle share) beside the step on a resident batch and an
     epoch of the loader alone, and the pinned ring's batches against host
     ones bit for bit; (c) main on
     audioset_wav (C++ wav reader, the device frontend), then the same A B
     B A and profile; (d) main with
     --load_wav (one log-mel launch a batch, held against the CPU); (e) the
     resume check of phase 9 on FSD50K, bit-identical; (f) the linear CLI on
     (b)'s last checkpoint; (g) main --use_fp16 --use_fp16_eval on FSD50K for
     an epoch with the per-epoch probe in bf16 (bf16 kernels only in its
     steps), the linear CLI --use_fp16_eval on its checkpoint, and a second
     epoch through the same Trainer, ms per step from the device's step ends;
 11. bf16 compute: the bf16 instantiations of the fused conv (eval at the
     serving chunk, statistics mode and backward at a view of the step) and
     of the attention kernels (ViT-B's qkv at N = 25, masked and not, and
     N = 7) against their plain versions in bf16, timed beside their bf16
     bounds and the library's bf16 calls; main --use_fp16 for 3 steps of
     AudioNTT2022 at the defaults and of ViT-B --fused_attention (each step
     must launch the bf16 kernels and no fp32 one); TRAIN_STEPS + 2 steps of each on a
     resident batch of 128 beside the fp32 step (fp32, bf16, bf16, fp32),
     each profiled once (device busy, idle); a batch-16 bf16 step against the
     CPU's and against the card's fp32 step (AudioNTT2022, vit_tiny fused);
     HEAR serving with compute_dtype="bfloat16" of AudioNTT2022
     (fused_conv=True) and vitc_base 16x8 beside the same weights in fp32:
     per-request launches (the bf16 fused conv only; the ViT, as in JAX, runs
     no attention kernel), medians in turns, the timestamp request profiled,
     a small request against the CPU.
 12. --steps_per_dispatch 4, a window of steps as one CUDA graph: through
     the Trainer over SyntheticWav at full width, batch 128, (a) the defaults
     (AudioNTT2022, LARS, fp32), (b) the same with --use_fp16, (c) ViT-B
     --fused_attention, AdamW, --lr_schedule, the teacher masked by key bias
     at --random_mask_ratio (a ratio per step), (d) ViT-B --fused_attention
     --use_fp16 at --random_mask_ratio, (e) ViT-B --fused_attention with
     --mask_ratio_schedule and token drop over two len_keep values (two
     graphs captured); each epoch (10 steps, (e) 14: an eager warm-up window,
     captured and replayed windows, a tail of single steps) against the same
     epoch at one step a dispatch from the same seed: every tensor of the
     train state, the generator and the epoch loss bit for bit, or the gap
     per tensor with the loss within the card-vs-card tolerance; every
     dispatch's launches (a replay DISPATCH x the eager step's); for (a)-(d)
     ms per step eager against graphed on a resident batch (A B B A), the
     capture's seconds, peak memory and each side's device busy and idle
     share; a --profile_dir trace at one step a dispatch that names the
     log-mel and fused conv kernels.
 13. the BYOL-style variant (main_bt_byol) over SyntheticWav at full width,
     batch 128, every BYOL step's launches counted: (a) the defaults
     (AudioNTT2022, LARS, fp32) with --stop_gradient --predictor, 3 epochs of
     3 steps twice and once resumed from model_2.pt (phase 9's resume check,
     the target in the train state; log-mel 1, fused forward 4, backward 2
     a step); (b) the same without --stop_gradient for an epoch (forward 4,
     backward 4); (c) ViT-B --fused_attention --mask --random_mask_ratio
     AdamW --lr_schedule for an epoch (attention forward 48, backward 24);
     (d) (a) at --steps_per_dispatch 4 against one step a dispatch, phase
     12's checks (bit for bit, a replay's launches against the profiler's);
     (e) (a) with --use_fp16 (bf16 kernels only); (f) a batch-16 BYOL step of
     AudioNTT2022 and of vit_tiny (fused attention) on the card against the
     CPU, and the target's gap after the EMA; (g) the BYOL step of (a) and of
     (c) against the Barlow Twins step of the same configuration on a
     resident batch (A B B A): ms per step, clips/s, device busy and idle
     share, peak memory; (h) the reproduce chain (tools/reproduce.py) on a
     tree written in a temporary directory: convert, pretrain, probe, HEAR,
     aggregate, each stage's seconds and launches, every score in [0, 1].
 14. the rest of the encoder zoo at full width, batch 128, raw 10-s clips
     in, every step's launches counted: (a) AudioNTT2022
     --squeeze_excitation at the defaults, an epoch through main with the
     per-epoch FSD50K probe (log-mel 1, fused forward 2, backward 2 a step;
     the probe's odd 711-frame crops launch nothing), then an epoch under
     --use_fp16 (bf16 kernels only); (b) resnet50_ReGP_NRF at the defaults
     (embedding 16,384), 3 epochs of 2 steps twice and once resumed from
     model_2.pt (phase 9's check, under cuDNN's deterministic algorithms,
     deterministic_cudnn says why; log-mel 1 a step, nothing else), resnet18
     for an epoch and under main_bt_byol --stop_gradient --predictor;
     (c) SE and resnet18 (deterministic cuDNN) at --steps_per_dispatch 4 and
     ViT-B --remat, 14-step epochs against one step a dispatch, bit for bit
     (phase 12's checks; resnet18 timed, with the profiler's kernel
     events);
     (d) ViT-B --fused_attention --remat with key-bias masking at 0.75, an
     epoch through the Trainer in fp32 and in bf16 (attention forward 48,
     backward 24 a step: the recompute runs the forward again), and one
     step with remat against the same step without it (losses and
     gradients within REMAT_RTOL, the largest gap printed); (e) batch-16
     steps card vs CPU (SE, resnet18_ReGP_NRF, vit_tiny fused with remat);
     (f) HEAR serving of resnet50 and resnet50_ReGP_NRF with seeded
     weights: phase 4's requests (log-mel 7 / 1, nothing else), a small
     request against the CPU, bf16 against fp32, ms, clips/s and the share
     of the fp32 operation bound, and the timestamp request from (b)'s
     model_3.pt bit-identical to the trainer's encoder in memory; (g) A B
     B A timings on a resident batch: SE against no SE, resnet18, resnet50
     and resnet50_ReGP_NRF beside AudioNTT2022, ViT-B remat against no
     remat (ms per step, clips/s, device busy and idle, peak memory).
 15. data-parallel pretraining (--distributed): (a) main under torchrun at
     world size 1 over NCCL at the defaults (AudioNTT2022, batch 128, LARS,
     raw wav in) for an epoch of 8 steps, eagerly and at
     --steps_per_dispatch 4 (the all-reduces captured in the graph), and
     main_bt_byol --stop_gradient --predictor likewise eagerly, against each
     entry point alone from the same seed: the checkpoints bit for bit
     (parameters, running statistics, optimizer, mixup bank, generators,
     the BYOL target), the logged and epoch losses equal; (b) one step on two gloo ranks that share the card
     (NCCL refuses two ranks on one device) of AudioNTT2022 at a global batch
     of 128 and of ViT-B --fused_attention with key-bias masking at 0.75 at
     32, each rank's launches counted (the real kernels with the cross-rank
     sums between their launches), against one process on the global batch
     with world_scale 2: the loss and the parameters within DP_RTOL, the ranks
     bit for bit; (c) ms per step under torchrun at world size 1 against one
     process, eager and graphed (tools/data_parallel.py), beside the card's
     name and power limit;
 16. the legacy families through ssl_audio_tpu_torch.main_pretrain's
     LegacyTrainer at full width, batch 128, log-mels in (--dataset
     synthetic), one epoch of LEGACY_EPOCH_STEPS steps each, the counters
     zeroed just before each step and read just after it: (a) --method dino
     on AudioNTT2022 through run_legacy (its checkpoint written; fused fwd 4
     / bwd 2 a step: the teacher's block 1 under no_grad launches the
     forward alone), (b) --method dino on ViT-B --fused_attention with two
     16x16 local crops (attention fwd 72 / bwd 48 a step, 24 of the forwards
     at N = 2, counted by sequence length), (c) --method byola --use_fp16 on
     AudioNTT2022 (the bf16 rows 1b 4 / 4b 2); each timed on a resident batch
     (median ms, a profiled step's idle share, peak memory); (d) (a)'s
     checkpoint through the linear CLI's loader (load_encoder_checkpoint
     grafts its encoder, which must equal the trainer's) scored by
     eval_linear; (e) batch-16 steps of DINO AudioNTT2022 and of DINO
     vit_tiny --fused_attention with two local crops against the same steps
     on the CPU (loss, gradients, the centre).
Phase 3 also holds the attention kernels at DINO's local crops (N = 2, the
ViT-B 16x16 crop; N = 3, the vitc 16x8 crop) and phase 11 their bf16
instantiations; the fused block's Function under torch.no_grad() must
launch its forward alone.
The `kernels` JSON line lists every ported kernel, the bf16 instantiations
as entries of their own; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
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
# bf16 (phase 11).  A bf16 kernel against its plain version in bf16: sel and
# the eval output within one bf16 spacing of each element (a value rounded to
# the other neighbour: the fp32 sums before the rounding run in other orders)
# beside CONV_ATOL (near 0 the values' own spacing is far below the fp32
# sums' difference); s1 / s2 and the backward's sums as in fp32 (fp32 sums of
# exact bf16 products); attention as in fp32 (ATTN_SPACING, ATTN_REL_L2): in
# bf16 the output and dq take one more rounding, to bf16, on both sides.
# In bf16 dq / dk / dv may take one more bf16 rounding than in fp32 (dq is
# stored in bf16; a P rounded the other way moves a dK / dV sum over a
# rounding boundary as in fp32): relative L2 ATTN_REL_L2_BF16 for them (dv at
# N = 7 read 1.04e-4 against the fp32 bound of 1e-4, PR 10 call 3)
ATTN_REL_L2_BF16 = 2e-4
BF16_STEP_LOSS_RTOL = 1e-2   # a bf16 step (batch 16), card vs CPU: the loss, relative
# ... and its gradients per tensor (relative L2), and the card's bf16 step
# against its fp32 step: recorded as measured, held only to this loose limit.
# bf16 rounds every activation at 2^-9 and the batch-16 Barlow Twins loss
# amplifies it: JAX's own bf16 step is 0.1-0.29 from its fp32 step at batch
# 4-16 (tests/test_torch_bf16_train.py)
BF16_STEP_GRAD_RTOL = 0.6
BF16_EMB_REL_L2 = 2e-2       # bf16 embeddings, card vs CPU, relative L2 (the CPU tests' ceiling)

CHUNK = 512          # the HEAR pipeline's BATCH_SIZE: one kernel launch's batch
WINDOW = 15200       # 0.95 s at 16 kHz: one timestamp window
N_CLIPS = 16         # clips per serving request
CLIP = 160000        # 10 s at 16 kHz: one scene clip
TRAIN_BATCH = 128    # config.py batch_size
TRAIN_FRAMES = 96    # config.py crop_frames
TRAIN_STEPS = 8      # timed steps after the warm-up steps
ENTRY_STEPS = 6      # steps of the epoch that the Trainer runs over its DataLoader
VIT_FLAGS = ["--dataset", "synthetic_wav", "--model_type", "vit_base", "--fused_attention",
             "--mask", "--mask_ratio", "0.75", "--no_token_drop"]
VIT_DEPTH, VIT_HEADS, VIT_DIM, VIT_TOKENS = 12, 12, 768, 25
# the attention kernels at DINO's 16x16 local crops: one patch + CLS (ViT-B,
# 16x16 patches) and two patches + CLS (vitc, 16x8 patches), unmasked
LOCAL_CROP_SHAPES = {"N=2, local crop": (2, 0.0), "N=3, vitc local crop": (3, 0.0)}
LOCAL_CROP_KEYS = {"local_crop": "N=2, local crop", "vitc_local_crop": "N=3, vitc local crop"}
EVAL_ITEMS = {"train": 1024, "val": 256, "test": 256}   # SyntheticLMS clips per loader
EVAL_CLASSES = 10
EVAL_MAX_ITER = 20   # probe epochs (eval_linear's max_iter)
RESUME_EPOCHS = 3    # phase 9: epochs of each pretraining run; the resumed run starts at 3
PRETRAIN = {         # phase 9: each run's flags, steps per epoch and launches per step
    "pretrain_audiontt": (["--dataset", "synthetic_wav", "--model_type", "audiontt"], 3,
                          {"log_mel_folded": 1, "fused_conv1_fwd": 2, "fused_conv1_bwd": 2}),
    "pretrain_vit": (["--dataset", "synthetic_wav", "--model_type", "vit_base",
                      "--fused_attention", "--optimizer", "AdamW", "--lr_schedule"], 2,
                     {"log_mel_folded": 1, "fused_attention_fwd": 2 * 12,
                      "fused_attention_bwd": 2 * 12})}
PROOF_FLAGS = ["--dataset", "synthetic_multicue", "--model_type", "audiontt", "--epochs", "3",
               "--batch_size", "128", "--synthetic_steps_per_epoch", "50",
               "--optimizer", "Adam", "--lr", "1e-3"]
PROOF_STEP = {"fused_conv1_fwd": 2, "fused_conv1_bwd": 2}     # log-mels in: no frontend
PROOF_PROBE = {"fused_conv1_fwd": 8}   # eval batches of 128: 400 + 200 + 200 clips
# phase 10: FSD50K-layout trees (dev.csv train / val rows, eval.csv rows; the
# 200-class vocabulary, 1-3 labels a clip, 0.3-30 s clips as 30-3000 frames)
DISK_SPLITS = {"train": 768, "val": 128, "test": 128}
DISK_CLASSES, DISK_MAX_LABELS, DISK_FRAMES = 200, 3, (30, 3000)
AUDIOSET_FILES = (512, 256)       # unbalanced, balanced 10-s 16-kHz wavs
AUDIOSET_SHORT = (2.5, 5.0, 7.5)  # the seconds of every 16th wav (every 8th is stereo)
RESUME_TRAIN = 256                # (e): clips of the resume tree, 2 steps an epoch
STEP_LAUNCHES = {"fused_conv1_fwd": 2, "fused_conv1_bwd": 2}       # log-mels in
WAV_STEP_LAUNCHES = {"log_mel_folded": 1, **STEP_LAUNCHES}         # one log-mel a batch


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


def conv_grid(B: int, H: int, W: int, backward: bool, eval_mode: bool = False,
              dtype: int = 0) -> dict:
    """The fused conv kernels' grid, resident blocks per SM and waves
    (dtype: 0 the fp32 instantiation, 1 the bf16 one)."""
    from ssl_audio_tpu_torch.ops import _build
    from ssl_audio_tpu_torch.ops import fused_conv as fc

    blocks = fc.launch_plan(B, H, W).blocks
    if backward:
        per_sm = _build.load("fused_conv_bwd.cu", fc._BWD_SIGNATURES) \
            .fused_conv1_bwd_blocks_per_sm(dtype)
    else:
        per_sm = _build.load("fused_conv_fwd.cu", fc._SIGNATURES) \
            .fused_conv1_fwd_blocks_per_sm(int(eval_mode), dtype)
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


def counts_with(**nonzero) -> dict:
    """Every kernel counter at 0 (fp32 and bf16 instantiations), but those given."""
    return {**{k: 0 for k in launch_counts()}, **nonzero}


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

    # the legacy teacher's launch: the Function under torch.no_grad() runs the
    # statistics-mode forward alone, keeps no graph, and gives the bits it
    # gives with a graph; held against the plain versions on the CPU
    def no_grad_block():
        with torch.no_grad():
            return fc.fused_conv1_bn_relu_pool(x[..., None], kernel_hwio, bias, gamma, beta)

    zero_launch_counts()
    ng = no_grad_block()
    torch.cuda.synchronize()
    ng_launches = launch_counts()
    if ng_launches != counts_with(fused_conv1_fwd=1) or ng[0].grad_fn is not None:
        raise SystemExit(f"the Function under no_grad launched {ng_launches}, "
                         f"grad_fn {ng[0].grad_fn}")
    with_graph = fc.fused_conv1_bn_relu_pool(x[..., None], kernel_hwio.clone().requires_grad_(),
                                             bias, gamma, beta)
    if not all(torch.equal(a, b) for a, b in zip(ng, with_graph)):
        raise SystemExit("the Function gave other bits under no_grad")
    with torch.no_grad():
        ng_cpu = fc.fused_conv1_bn_relu_pool(x[..., None].cpu(), kernel_hwio.cpu(), bias.cpu(),
                                             gamma.cpu(), beta.cpu())
    ng_err = max_err(ng[0].cpu(), ng_cpu[0])
    check("fused block under no_grad (the teacher's), card vs CPU plain", ng_err, CONV_ATOL,
          "fp32 conv sums in another order")
    no_grad_row = {"launches": {"fused_conv1_fwd": 1, "fused_conv1_bwd": 0},
                   "max_abs_err": ng_err, "function_ms": cuda_ms(no_grad_block)}
    print("  fused block under no_grad: " + json.dumps(no_grad_row))
    fwd_row = {"shape": f"{(B, H, W)} -> sel {tuple(pooled.shape)}, s1, s2",
               "no_grad_function": no_grad_row,
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


def attention_check(name: str, got: torch.Tensor, ref: torch.Tensor,
                    rel_l2_limit: float = ATTN_REL_L2) -> float:
    """Hold one output of an attention kernel against its plain version:
    max abs error within ATTN_SPACING of max|ref|, relative L2 within
    rel_l2_limit.  -> the max abs error."""
    err = max_err(got, ref)
    scale = float(ref.abs().max())
    rel_l2 = float((got.double() - ref.double()).norm() / ref.double().norm())
    check(f"{name} / max|ref| ({scale:.3g}); relative L2 {rel_l2:.1e}", err / scale,
          ATTN_SPACING, "one bf16 spacing: an operand rounded the other way")
    if rel_l2 > rel_l2_limit:
        raise SystemExit(f"{name}: relative L2 {rel_l2} above {rel_l2_limit}")
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
              "N=7, token drop": (7, 0.0), **LOCAL_CROP_SHAPES}
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
    for label in ("N=25", "N=7, token drop", *LOCAL_CROP_SHAPES):
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
             "token_drop": rows["fwd"]["N=7, token drop"],
             **{key: rows["fwd"][label] for key, label in LOCAL_CROP_KEYS.items()}},
            {"name": "fused_attention_bwd", "route": "cuda", "source": src,
             "replaces": "ssl_audio_tpu/ops/fused_attention.py:187",
             "max_abs_err": errs["bwd"], **rows["bwd"]["N=25"],
             "library_is": "the same yardstick's backward alone (torch.autograd.grad of its "
                           "output, forward run once); library_fwd_bwd_ms: forward and "
                           "backward through autograd",
             "token_drop": rows["bwd"]["N=7, token drop"],
             **{key: rows["bwd"][label] for key, label in LOCAL_CROP_KEYS.items()}}]


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


def bf16_close(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """got within one bf16 spacing of ref at each element (at the larger
    magnitude of the two), beside CONV_ATOL -> the max abs error."""
    g, r = got.float(), ref.float()
    _, e = torch.frexp(torch.maximum(g.abs(), r.abs()))
    tol = torch.ldexp(torch.ones_like(g), e - 8) + CONV_ATOL
    beyond = int(((g - r).abs() > tol).sum())
    err = max_err(g, r)
    flipped = int((g != r).sum())
    print(f"  {name}: max_abs_err {err:.3e}; {flipped} of {g.numel()} elements differ, "
          f"{beyond} by more than one bf16 spacing + {CONV_ATOL:.0e} "
          f"{'ok' if not beyond else 'FAIL'}")
    if beyond:
        raise SystemExit(f"{name}: {beyond} elements beyond one bf16 spacing")
    return err


def bf16_conv_inputs(gen: torch.Generator, dev: torch.device, B: int):
    """(B, 64, 96) log-mel-like x quantised to 0.5 (windows tie; bf16 values),
    the conv and BN parameters in bf16 (a quarter of the gammas negative, one
    exactly 0), running statistics fp32."""
    C, bf = 64, torch.bfloat16
    x = torch.round(torch.randn(B, 64, TRAIN_FRAMES, generator=gen) * 2) / 2
    wk = 0.3 * torch.randn(9, C, generator=gen)
    bias = 0.1 * torch.randn(C, generator=gen)
    gamma = 1.0 + 0.3 * torch.randn(C, generator=gen)
    gamma[: C // 4] *= -1.0
    gamma[C // 2] = 0.0
    beta = 0.2 * torch.randn(C, generator=gen)
    mean = 0.5 * torch.randn(C, generator=gen)
    var = 0.5 + torch.rand(C, generator=gen)
    return ([t.to(dev).to(bf) for t in (x, wk, bias, gamma, beta)]
            + [t.to(dev) for t in (mean, var)])


def bf16_kernel_rows(gen: torch.Generator, dev: torch.device) -> list[dict]:
    """The bf16 instantiations of B1 (eval at the serving chunk, statistics
    mode at a view of the step), B4 (the step's view) and B6 / B7 (ViT-B's
    qkv, N = 25 with masked keys and unmasked, N = 7) against their plain
    versions in bf16 on the card, timed cold and warm beside the plain
    version, the bound (bf16 bytes; operations at the bf16 tensor-core rate)
    and the library's bf16 yardstick."""
    from ssl_audio_tpu_torch.ops import fused_attention as fa
    from ssl_audio_tpu_torch.ops import fused_conv as fc
    from ssl_audio_tpu_torch.ops import no_tf32
    from ssl_audio_tpu_torch.tools.serving import cuda_ms, device_ms, per_launch_ms

    F, bf, C = torch.nn.functional, torch.bfloat16, 64
    rows = []
    # B1 eval at one chunk of timestamp windows
    x, wk, bias, gamma, beta, mean, var = bf16_conv_inputs(gen, dev, CHUNK)
    B, H, W = x.shape
    stats = torch.stack([mean, torch.rsqrt(var + 1e-5), beta.float()]).contiguous()
    ev = fc.fused_conv1_fwd_cuda(x, wk, bias, gamma, stats)

    def plain_eval():
        sp, _, _ = fc.fused_conv1_fwd_plain(x, wk, bias, gamma)
        return torch.relu(gamma.float() * (sp.float() - mean) * torch.rsqrt(var + 1e-5)
                          + beta.float()).to(bf)

    w4 = wk.t().reshape(C, 1, 3, 3)

    def library_eval():
        y = F.conv2d(x[:, None], w4, bias, padding=1)
        z = F.batch_norm(y, mean, var, gamma.float(), beta.float(), training=False, eps=1e-5)
        return F.max_pool2d(torch.relu(z), 2)

    if ev.dtype != bf:
        raise SystemExit(f"fused_conv1_fwd_cuda on bf16 gave {ev.dtype}")
    eval_err = bf16_close(f"fused_conv1_fwd_bf16 eval ({B} x {H} x {W})", ev, plain_eval())
    cells = B * (H // 2) * (W // 2) * C
    bound, by = bound_ms(19 * 4 * cells + 7 * cells,
                         2 * (x.numel() + ev.numel() + 11 * C) + 4 * 3 * C, PEAK_BF16_FLOPS)
    eval_row = {"max_abs_err": eval_err, "dtype": "bfloat16",
                "shape": f"{(B, H, W)} bf16 -> {tuple(ev.shape)} bf16, eval epilogue fused",
                **device_times(lambda: fc.fused_conv1_fwd_cuda(x, wk, bias, gamma, stats)),
                **conv_grid(B, H, W, backward=False, eval_mode=True, dtype=1),
                "plain_ms": cuda_ms(plain_eval), "bound_ms": bound, "bound_by": by,
                "library_ms": cuda_ms(library_eval),
                "library_is": "cuDNN conv2d + batch_norm (fp32 running statistics) + relu + "
                              "max_pool2d, bf16"}
    print("  fused_conv1_fwd_bf16[eval]: " + json.dumps(eval_row))

    # B1 statistics mode and B4 at one view of the step
    x, wk, bias, gamma, beta, _, _ = bf16_conv_inputs(gen, dev, TRAIN_BATCH)
    B = x.shape[0]
    sel, s1, s2 = fc.fused_conv1_fwd_cuda(x, wk, bias, gamma)
    again = fc.fused_conv1_fwd_cuda(x, wk, bias, gamma)
    sel_p, s1_p, s2_p = fc.fused_conv1_fwd_plain(x, wk, bias, gamma)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((sel, s1, s2), again)):
        raise SystemExit("fused_conv1_fwd_bf16: two launches gave different bits")
    sel_err = bf16_close(f"fused_conv1_fwd_bf16 sel ({B} x {H} x {W})", sel, sel_p)
    for name, a, b in (("s1", s1, s1_p), ("s2", s2, s2_p)):
        check(f"fused_conv1_fwd_bf16 {name} / max|{name}|", max_err(a, b) / float(b.abs().max()),
              STATS_RTOL, "fp32 sums of exact bf16 products in another order")
    with torch.no_grad():
        pooled, mean, var = fc.fused_conv1_bn_relu_pool(x[..., None], wk.reshape(3, 3, 1, C),
                                                        bias, gamma, beta)
    r = torch.rsqrt(var + 1e-5)
    dp = torch.randn(B, C, H // 2, W // 2, generator=gen).to(dev).to(bf).permute(0, 2, 3, 1)
    args = (x, wk, bias, gamma, mean, r, pooled, dp)
    n = float(x.numel())
    sums = fc.fused_conv1_bwd_cuda(*args, beta)
    again = fc.fused_conv1_bwd_cuda(*args, beta)
    sums_p = fc.fused_conv1_bwd_plain(*args, beta)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(sums, again)):
        raise SystemExit("fused_conv1_bwd_bf16: two launches gave different bits")
    bwd_err = 0.0
    for name, a, b in zip(("T1", "T2", "Sx", "A1", "A2", "Gram"), sums, sums_p):
        if name == "Sx":
            check("fused_conv1_bwd_bf16 Sx / n",
                  max(float(a.abs().max()), float(b.abs().max())) / n, SX_RTOL,
                  "mathematically 0: float noise of 7.9e5 terms")
            continue
        rel = max_err(a, b) / float(b.abs().max())
        bwd_err = max(bwd_err, rel)
        check(f"fused_conv1_bwd_bf16 {name} / max|{name}|", rel, SUMS_RTOL,
              "fp32 sums of exact bf16 products in another order")
    grads = fc.param_grads_from_sums(wk, bias, gamma, mean, r, n, *sums)
    grads_p = fc.param_grads_from_sums(wk, bias, gamma, mean, r, n, *sums_p)
    check("fused_conv1_bwd_bf16 dW (absolute)", max_err(grads[0], grads_p[0]), GRAD_ATOL,
          "assembled from the sums above")

    def library_chain(train_grad: bool):
        ts = [t.detach().clone().requires_grad_(train_grad) for t in (w4, bias)]
        g32 = gamma.float().detach().clone().requires_grad_(train_grad)
        b32 = beta.float().detach().clone().requires_grad_(train_grad)
        y = F.conv2d(x[:, None], *ts, padding=1)
        z = F.batch_norm(y, None, None, g32, b32, training=True, eps=1e-5)
        out = F.max_pool2d(torch.relu(z), 2)
        if train_grad:
            out.backward(dp.permute(0, 3, 1, 2))
        return out

    def ours_fwd_bwd():
        ts = [t.detach().clone().requires_grad_() for t in
              (wk.reshape(3, 3, 1, C), bias, gamma, beta)]
        out, _, _ = fc.fused_conv1_bn_relu_pool(x[..., None], *ts)
        out.backward(dp)

    cells = B * (H // 2) * (W // 2) * C
    fwd_bound, fwd_by = bound_ms(19 * 4 * cells,
                                 2 * (x.numel() + sel.numel() + 11 * C) + 4 * 2 * C,
                                 PEAK_BF16_FLOPS)
    stats_row = {"max_abs_err": sel_err, "dtype": "bfloat16",
                 "shape": f"{(B, H, W)} bf16 -> sel {tuple(sel.shape)} bf16, s1, s2 fp32",
                 **device_times(lambda: fc.fused_conv1_fwd_cuda(x, wk, bias, gamma)),
                 "per_launch_ms": per_launch_ms(lambda: fc.fused_conv1_fwd_cuda(x, wk, bias, gamma)),
                 **conv_grid(B, H, W, backward=False, dtype=1),
                 "plain_ms": cuda_ms(lambda: fc.fused_conv1_fwd_plain(x, wk, bias, gamma)),
                 "bound_ms": fwd_bound, "bound_by": fwd_by,
                 "library_ms": cuda_ms(lambda: library_chain(False)),
                 "library_is": "cuDNN conv2d + batch_norm(training=True) + relu + max_pool2d, "
                               "forward, bf16"}
    print("  fused_conv1_fwd_bf16[train shape, stats mode]: " + json.dumps(stats_row))
    # the bf16 kernel reads x and dpooled (relu' from z, not from pooled)
    bwd_bound, bwd_by = bound_ms(2 * 57 * cells + (2 * 45 + 9) * B * H * W,
                                 2 * (x.numel() + dp.numel() + 12 * C) + 4 * (14 * C + 90),
                                 PEAK_BF16_FLOPS)
    bwd_fn = lambda: fc.fused_conv1_bwd_cuda(*args, beta)          # noqa: E731
    bwd_row = {"max_abs_err": bwd_err, "dtype": "bfloat16",
               "error_is": "largest sum error / that sum's largest value",
               "shape": f"x {(B, H, W)}, dpooled {tuple(dp.shape)} bf16 -> fp32 sums",
               **device_times(bwd_fn), "per_launch_ms": per_launch_ms(bwd_fn),
               **conv_grid(B, H, W, backward=True, dtype=1),
               "plain_ms": cuda_ms(lambda: fc.fused_conv1_bwd_plain(*args, beta), iters=5),
               "bound_ms": bwd_bound, "bound_by": bwd_by,
               "library_ms": cuda_ms(lambda: library_chain(True)),
               "library_is": "autograd through cuDNN conv2d + batch_norm(training) + relu + "
                             "max_pool2d in bf16, forward and backward",
               "function_fwd_bwd_ms": cuda_ms(ours_fwd_bwd)}
    print("  fused_conv1_bwd_bf16: " + json.dumps(bwd_row))
    src_f, src_b = "ssl_audio_tpu_torch/csrc/fused_conv_fwd.cu", "ssl_audio_tpu_torch/csrc/fused_conv_bwd.cu"
    rows.append({"name": "fused_conv1_fwd_bf16", "route": "cuda", "source": src_f,
                 "replaces": "ssl_audio_tpu/ops/fused_conv.py:186",
                 **eval_row, "max_abs_err": max(eval_err, sel_err), "train_shape": stats_row})
    rows.append({"name": "fused_conv1_bwd_bf16", "route": "cuda", "source": src_b,
                 "replaces": "ssl_audio_tpu/ops/fused_conv.py:257", **bwd_row})

    # B6 / B7 at the ViT-B step's shapes
    Bv, Cv, Hv = TRAIN_BATCH, VIT_DIM, VIT_HEADS
    hd = Cv // Hv
    errs, inputs = {"fwd": 0.0, "bwd": 0.0}, {}
    for label, (N, drop) in {"N=25": (VIT_TOKENS, 0.0), "N=25, masked keys": (VIT_TOKENS, 0.75),
                             "N=7, token drop": (7, 0.0), **LOCAL_CROP_SHAPES}.items():
        qkv = torch.randn(Bv, N, 3 * Cv, generator=gen)
        bias_k = torch.zeros(Bv, N)
        if drop:
            dead = torch.rand(Bv, N, generator=gen) < drop
            dead[:, 0] = False
            bias_k[dead] = -1e9
        dout = torch.randn(Bv, N, Cv, generator=gen)
        qkv, dout = qkv.to(dev).to(bf), dout.to(dev).to(bf)
        bias_k = bias_k.to(dev)
        inputs[label] = (qkv, bias_k, dout)
        out = fa.fused_attention_fwd_cuda(qkv, bias_k, Hv)
        dqkv, dbias = fa.fused_attention_bwd_cuda(qkv, bias_k, dout, Hv)
        again = fa.fused_attention_bwd_cuda(qkv, bias_k, dout, Hv)
        out_p = fa.fused_attention_fwd_plain(qkv, bias_k, Hv)
        dqkv_p, dbias_p = fa.fused_attention_bwd_plain(qkv, bias_k, dout, Hv)
        torch.cuda.synchronize()
        if out.dtype != bf or dqkv.dtype != bf or dbias.dtype != torch.float32:
            raise SystemExit(f"bf16 attention kernels gave {out.dtype} {dqkv.dtype} {dbias.dtype}")
        if not (torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])):
            raise SystemExit("fused_attention_bwd_bf16: two launches gave different bits")
        errs["fwd"] = max(errs["fwd"], attention_check(
            f"fused_attention_fwd_bf16 out [{label}]", out.float(), out_p.float()))
        for i, name in enumerate(("dq", "dk", "dv")):
            sl = slice(i * Cv, (i + 1) * Cv)
            errs["bwd"] = max(errs["bwd"], attention_check(
                f"fused_attention_bwd_bf16 {name} [{label}]", dqkv[..., sl].float(),
                dqkv_p[..., sl].float(), ATTN_REL_L2_BF16))
        errs["bwd"] = max(errs["bwd"], attention_check(
            f"fused_attention_bwd_bf16 dbias [{label}]", dbias, dbias_p))

    def split(t):
        return [t[..., i * Cv:(i + 1) * Cv].reshape(t.shape[0], t.shape[1], Hv, hd)
                .transpose(1, 2) for i in range(3)]

    def library_fwd(t, b):
        q, k, v = split(t)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=b[:, None, None, :].to(bf))

    att = {"fwd": {}, "bwd": {}}
    for label in ("N=25", "N=7, token drop", *LOCAL_CROP_SHAPES):
        qkv, bias_k, dout = inputs[label]
        N = qkv.shape[1]
        xg = qkv.detach().requires_grad_()
        lib_o = library_fwd(xg, bias_k)
        lib_g = dout.reshape(Bv, N, Hv, hd).transpose(1, 2)

        def library_bwd():
            return torch.autograd.grad(lib_o, xg, lib_g, retain_graph=True)

        fwd_bytes = 2 * 4 * Bv * N * Cv + 4 * Bv * N
        bwd_bytes = 2 * 7 * Bv * N * Cv + 4 * 2 * Bv * N
        for kind, fn, plain, nbytes, flops, library in (
                ("fwd", lambda: fa.fused_attention_fwd_cuda(qkv, bias_k, Hv),
                 lambda: fa.fused_attention_fwd_plain(qkv, bias_k, Hv), fwd_bytes,
                 4 * Bv * N * N * Cv, lambda: library_fwd(qkv, bias_k)),
                ("bwd", lambda: fa.fused_attention_bwd_cuda(qkv, bias_k, dout, Hv),
                 lambda: fa.fused_attention_bwd_plain(qkv, bias_k, dout, Hv), bwd_bytes,
                 10 * Bv * N * N * Cv, library_bwd)):
            bound, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
            att[kind][label] = {
                "dtype": "bfloat16",
                "shape": f"qkv {tuple(qkv.shape)} bf16, bias fp32"
                         + (", dout bf16 -> dqkv bf16, dbias fp32" if kind == "bwd"
                            else " -> out bf16"),
                "ms": device_ms(fn, cold=True), "ms_warm": device_ms(fn),
                "plain_ms": device_ms(plain, iters=5), "bound_ms": bound, "bound_by": by,
                "library_ms": device_ms(library)}
            print(f"  fused_attention_{kind}_bf16[{label}]: " + json.dumps(att[kind][label]))
    src = "ssl_audio_tpu_torch/csrc/fused_attention.cu"
    rows.append({"name": "fused_attention_fwd_bf16", "route": "cuda", "source": src,
                 "replaces": "ssl_audio_tpu/ops/fused_attention.py:152",
                 "max_abs_err": errs["fwd"], **att["fwd"]["N=25"],
                 "library_is": "split + transpose of the raw bf16 qkv, "
                               "scaled_dot_product_attention with the additive mask",
                 "token_drop": att["fwd"]["N=7, token drop"],
                 **{key: att["fwd"][label] for key, label in LOCAL_CROP_KEYS.items()}})
    rows.append({"name": "fused_attention_bwd_bf16", "route": "cuda", "source": src,
                 "replaces": "ssl_audio_tpu/ops/fused_attention.py:187",
                 "max_abs_err": errs["bwd"], **att["bwd"]["N=25"],
                 "library_is": "the same yardstick's backward alone",
                 "token_drop": att["bwd"]["N=7, token drop"],
                 **{key: att["bwd"][label] for key, label in LOCAL_CROP_KEYS.items()}})
    return rows


def bf16_serving(mod, model_fp32, bf16_model, cpu_model, audio, per_request: dict,
                 width: int, small: tuple) -> dict:
    """A HEAR model with compute_dtype="bfloat16" beside the same weights in
    fp32 on the card: each request's launches (zeroed just before, read just
    after; exactly per_request[path], every other counter 0), the median of
    3 timed requests in turns (fp32, bf16, bf16, fp32), the bf16 timestamp
    request profiled, the bf16 embeddings against the fp32 ones (recorded)
    and against the bf16 model on the CPU on a small request.  mod: the
    HEAR module (hear.conv or hear.vit); small: (clips, samples) of the
    request held against the CPU."""
    from ssl_audio_tpu_torch.tools.serving import profile

    requests = {m: {"timestamp": (lambda mm=mm: mod.get_timestamp_embeddings(audio, mm)),
                    "scene": (lambda mm=mm: mod.get_scene_embeddings(audio, mm))}
                for m, mm in (("fp32", model_fp32), ("bf16", bf16_model))}
    out = {"launches": {}, "ms": {}, "clips_per_s": {}}
    for fn in requests["bf16"].values():
        fn()                                      # warm-up: cuDNN and cuBLAS plans
    embs = {}
    for path in ("timestamp", "scene"):
        zero_launch_counts()
        embs[path] = requests["bf16"][path]()
        torch.cuda.synchronize()
        counts = out["launches"][path] = launch_counts()
        print(f"  bf16 {path} request launches: {counts}")
        if counts != counts_with(**per_request[path]):
            raise SystemExit(f"bf16 {path} request launched {counts}, expected "
                             f"{per_request[path]}")
    ts_emb = embs["timestamp"][0]
    if ts_emb.dtype != torch.float32 or ts_emb.shape[-1] != width \
            or not (torch.isfinite(ts_emb).all() and torch.isfinite(embs["scene"]).all()):
        raise SystemExit(f"bf16 embeddings: {ts_emb.dtype} {tuple(ts_emb.shape)}, finite?")
    for path in ("timestamp", "scene"):
        times = {"fp32": [], "bf16": []}
        for m in ("fp32", "bf16", "bf16", "fp32"):
            times[m] += wall_ms(requests[m][path], reps=3 if m == "bf16" else 2)
        out["ms"][path] = {m: statistics.median(v) for m, v in times.items()}
        out["clips_per_s"][path] = {m: N_CLIPS / v * 1e3 for m, v in out["ms"][path].items()}
        ref = requests["fp32"][path]()
        ref = ref[0] if path == "timestamp" else ref
        got = embs[path][0] if path == "timestamp" else embs[path]
        out.setdefault("bf16_vs_fp32_rel_l2", {})[path] = float(
            (got.double() - ref.double()).norm() / ref.double().norm())
    prof = profile(requests["bf16"]["timestamp"])
    out["timestamp_profile"] = {
        "wall_ms": prof["wall_ms"], "device_busy_ms": prof["device_busy_ms"],
        "idle_share": prof["idle_share"],
        "device_ms_by_kernel": {k[:90]: v for k, v in prof["device_ms_by_kernel"].items()}}
    small = audio[: small[0], : small[1]]
    out["cpu_check_rel_l2"] = {}
    for name, fn in (("timestamp", lambda m: mod.get_timestamp_embeddings(small, m)[0]),
                     ("scene", lambda m: mod.get_scene_embeddings(small, m))):
        a, b = fn(bf16_model), fn(cpu_model)
        rel = float((a.double() - b.double()).norm() / b.double().norm())
        out["cpu_check_rel_l2"][name] = rel
        check(f"bf16 {name} embeddings card vs CPU, relative L2", rel, BF16_EMB_REL_L2,
              "bf16 roundings that fall on the other side (sums in other orders)")
    return out


def phase_bf16(seed: int, dev: torch.device, smi: str) -> tuple[list[dict], dict]:
    """Phase 11: the bf16 compute mode.  -> (the bf16 kernels' rows, the
    phase's record with its launches per path)."""
    from ssl_audio_tpu_torch.hear import conv as hear_conv
    from ssl_audio_tpu_torch.hear import vit as hear_vit
    from ssl_audio_tpu_torch.hear.utils import frame_starts
    from ssl_audio_tpu_torch.tools.serving import (profile, seeded_clips, seeded_serving_model,
                                                   seeded_vit_serving_model)
    from ssl_audio_tpu_torch.tools.train_profile import seeded_training

    print("phase 11: bf16 compute (--use_fp16, HEAR compute_dtype=\"bfloat16\"): the bf16 "
          "kernels against their plain versions, main --use_fp16, timed steps beside fp32, "
          "card vs CPU, bf16 serving")
    gen = torch.Generator().manual_seed(seed + 11)
    rows = bf16_kernel_rows(gen, dev)
    out = {"card": smi, "launches": {}}

    # (b) the training entry point with --use_fp16, a few steps each
    runs = {"bf16_main_audiontt": (
                ["--dataset", "synthetic_wav", "--model_type", "audiontt", "--use_fp16"],
                {"log_mel_folded": 1, "fused_conv1_fwd_bf16": 2, "fused_conv1_bwd_bf16": 2}),
            "bf16_main_vit": (
                VIT_FLAGS + ["--use_fp16"],
                {"log_mel_folded": 1, "fused_attention_fwd_bf16": 2 * VIT_DEPTH,
                 "fused_attention_bwd_bf16": 2 * VIT_DEPTH})}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as tmp, contextlib.chdir(tmp):
        for path, (flags, per_step) in runs.items():
            steps = 3
            trainer, seconds, counts, lines = run_main(
                flags + ["--epochs", "1", "--synthetic_steps_per_epoch", str(steps),
                         "--seed", str(seed)])
            out["launches"][path] = expect(counts, per_step, steps, f"main {' '.join(flags)}")
            said = [line for line in lines if "encoder compute" in line]
            losses = list(trainer.epoch_losses.values())
            dtypes = {p.dtype for p in trainer.state.modules.parameters()}
            if not said or "encoder compute bfloat16" not in said[0] \
                    or dtypes != {torch.float32} or not all(
                        v == v and abs(v) != float("inf") for v in losses):
                raise SystemExit(f"{path}: {said}, parameters {dtypes}, losses {losses}")
            out[path] = {"flags": flags, "steps": steps, "run_s": seconds, "losses": losses,
                         "launches_per_step": out["launches"][path]}
            print(f"  {path}: " + json.dumps(out[path]))
            del trainer
    torch.cuda.empty_cache()

    # (c) steps on a resident batch of 128 10-s clips, bf16 against fp32 in
    # turns (fp32, bf16, bf16, fp32), each mode's step profiled once
    wavs = seeded_clips(torch.Generator().manual_seed(seed), TRAIN_BATCH, CLIP).to(dev)
    out["steps"] = {}
    for model, kw, kernels in (
            ("audiontt", {}, ("fused_conv1_fwd", "fused_conv1_bwd")),
            ("vit_base", dict(model_type="vit_base", fused_attention=True),
             ("fused_attention_fwd", "fused_attention_bwd"))):
        modes = {m: seeded_training(seed, dev, use_fp16=(m == "bf16"), **kw)
                 for m in ("fp32", "bf16")}
        times = {"fp32": [], "bf16": []}
        for m in ("fp32", "bf16", "bf16", "fp32"):
            _, st, step, g = modes[m]
            times[m] += timed_steps(step, st, wavs, g)[0]
        rec = {"batch": TRAIN_BATCH, "order": "fp32, bf16, bf16, fp32", "launches": {},
               "ms_per_step_median": {m: statistics.median(v) for m, v in times.items()},
               "ms_per_step_min": {m: min(v) for m, v in times.items()}}
        rec["clips_per_s"] = {m: TRAIN_BATCH / v * 1e3
                              for m, v in rec["ms_per_step_median"].items()}
        for m, (_, st, step, g) in modes.items():
            zero_launch_counts()
            step(st, wavs, gen=g)
            torch.cuda.synchronize()
            counts = rec["launches"][m] = launch_counts()
            suffix = "_bf16" if m == "bf16" else ""
            other = "" if m == "bf16" else "_bf16"
            if any(counts[k + suffix] != (2 if model == "audiontt" else 2 * VIT_DEPTH)
                   or counts[k + other] for k in kernels):
                raise SystemExit(f"{model} {m} step launched {counts}")
            prof = profile(lambda: step(st, wavs, gen=g))
            rec[f"profile_{m}"] = {
                "wall_ms": prof["wall_ms"], "device_busy_ms": prof["device_busy_ms"],
                "idle_share": prof["idle_share"],
                "device_ms_by_kernel": {k[:90]: v for k, v in
                                        list(prof["device_ms_by_kernel"].items())[:10]}}
        out["steps"][model] = rec
        print(f"  {model} step, bf16 vs fp32: " + json.dumps(rec))
        del modes
        torch.cuda.empty_cache()

    # (d) a small bf16 step on the card against the same step on the CPU, and
    # against the card's fp32 step
    out["step_checks"] = {}
    for name, overrides, step_kw, zero in (
            ("audiontt", {}, {}, ("encoder.features.0.bias", "encoder.features.4.bias")),
            ("vit_tiny_fused", dict(model_type="vit_tiny", fused_attention=True),
             dict(mask_ratio=0.75), ("encoder.norm.bias",))):
        kw = dict(batch_size=16, use_fp16=True, **overrides)
        why = "bf16 roundings on other sides, amplified by the batch-16 loss"
        out["step_checks"][name] = {
            "card_vs_cpu": card_vs_cpu_step(seed, dev, kw, step_kw, zero, BF16_STEP_LOSS_RTOL,
                                            BF16_STEP_GRAD_RTOL, why),
            "card_bf16_vs_card_fp32": card_vs_cpu_step(
                seed, dev, kw, step_kw, zero, 1.0, 10.0, "recorded, not limited",
                ref=(dev, {"use_fp16": False}), label="card bf16 vs card fp32")}

    # (e) HEAR serving with compute_dtype="bfloat16"
    audio = seeded_clips(torch.Generator().manual_seed(seed + 3), N_CLIPS, CLIP)
    g = torch.Generator().manual_seed(seed + 4)
    fp32 = seeded_serving_model(g, dev)
    kw = dict(fused_conv=True, compute_dtype="bfloat16")
    bf16, cpu = (hear_conv.load_model("", "audiontt", device=d, **kw) for d in (dev, "cpu"))
    for m in (bf16, cpu):
        m.model.load_state_dict(fp32.model.state_dict())
    windows = N_CLIPS * len(frame_starts(CLIP, WINDOW, 50, 16000)[0])
    chunks = -(-windows // CHUNK)
    out["hear_conv"] = bf16_serving(hear_conv, fp32, bf16, cpu, audio, {
        "timestamp": {"log_mel_folded": chunks, "fused_conv1_fwd_bf16": chunks},
        "scene": {"log_mel_folded": 1}}, 3072, (2, 2 * 16000))
    out["launches"].update({f"bf16_hear_{k}": v for k, v in out["hear_conv"]["launches"].items()})
    print("  bf16 HEAR AudioNTT2022: " + json.dumps(out["hear_conv"]))
    del fp32, bf16, cpu
    g = torch.Generator().manual_seed(seed + 5)
    fp32 = seeded_vit_serving_model(g, dev)
    bf16, cpu = (hear_vit.load_model("", "vitc_base", "16x8", compute_dtype="bfloat16", device=d)
                 for d in (dev, "cpu"))
    for m in (bf16, cpu):
        m.model.load_state_dict(fp32.model.state_dict())
    out["hear_vit"] = bf16_serving(hear_vit, fp32, bf16, cpu, audio, {
        "timestamp": {"log_mel_folded": chunks}, "scene": {"log_mel_folded": 1}}, 768,
        (1, 16000))
    out["launches"].update({f"bf16_hear_vit_{k}": v for k, v in out["hear_vit"]["launches"].items()})
    print("  bf16 HEAR vitc_base 16x8: " + json.dumps(out["hear_vit"]))
    del fp32, bf16, cpu
    torch.cuda.empty_cache()
    return rows, out


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
                     global_rtol: float | None = None, ref: tuple = ("cpu", {}),
                     label: str = "card vs CPU", byol: bool = False) -> dict:
    """One small step on the card against the same step on the CPU (plain
    versions): the same seeded weights, the same 16 wavs, the same draws.
    ref: where the reference step runs and the settings it changes (the
    card's fp32 step against its bf16 one: (dev, {"use_fp16": False})).
    zero_grad: parameters whose gradient is mathematically 0 (float noise).
    Limits: the loss (relative), the worst tensor's gradient (relative L2)
    and, if given, all gradients as one vector (relative L2).  byol: the
    BYOL-style step (with --stop_gradient its target moves by the EMA of the
    pre-step online net, equal on both sides: its largest gap after the step
    must stay within EMA_RTOL of its largest value)."""
    from ssl_audio_tpu_torch.tools.serving import seeded_clips
    from ssl_audio_tpu_torch.tools.train_profile import seeded_training
    from ssl_audio_tpu_torch.train.steps import draw_step

    wav_small = seeded_clips(torch.Generator().manual_seed(seed + 7), 16, 2 * 16000)
    runs, targets = [], []
    for where, kw in ((ref[0], {**overrides, **ref[1]}), (dev, overrides)):
        cfg_s, state_s, step_s, _ = seeded_training(seed, where, byol=byol, **kw)
        draws = draw_step(torch.Generator().manual_seed(seed + 9), cfg_s,
                          tuple(wav_small.shape), state_s.modules["encoder"], wav=True,
                          byol=byol)
        loss = float(step_s(state_s, wav_small.to(where), draws=draws.to(where),
                            **step_kwargs)["loss"])
        grads = {k: p.grad.detach().cpu() for k, p in state_s.modules.named_parameters()
                 if p.grad is not None}
        runs.append((loss, grads))
        if byol:
            targets.append({k: p.detach().cpu() for k, p in
                            state_s.modules["target"].named_parameters()})
    (loss_c, grads_c), (loss_d, grads_d) = runs
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
    print(f"  small step (batch 16, {overrides}), {label}: loss {loss_d!r} vs {loss_c!r}; "
          f"gradients worst relative L2 {worst:.2e} ({worst_name}), all at once {overall:.2e}, "
          f"largest single element {worst_max:.1e} of its tensor's largest")
    check(f"train step loss, {label}, relative", loss_err, loss_rtol, why)
    check(f"train step gradients, {label}, relative L2 per tensor", worst, grad_rtol, why)
    if global_rtol is not None:
        check(f"train step gradients, {label}, relative L2 all at once", overall, global_rtol,
              why)
    out = {"loss_rel_err": loss_err, "grad_rel_l2_err": worst, "worst_grad": worst_name,
           "grad_rel_l2_err_all": overall, "grad_max_elem_err": worst_max}
    if targets:
        tc, td = targets
        gaps = {k: float((td[k].double() - v.double()).abs().max() / v.abs().max())
                for k, v in tc.items()}
        out["target_worst"] = max(gaps, key=gaps.get)
        out["target_rel_gap_after_ema"] = gaps[out["target_worst"]]
        print(f"  the target after the EMA, {label}: largest gap {gaps[out['target_worst']]:.2e} "
              f"of its tensor's largest ({out['target_worst']})")
        check(f"BYOL target after the EMA, {label}, relative", out["target_rel_gap_after_ema"],
              EMA_RTOL, "the EMA reads the pre-step parameters, equal on both sides")
    return out


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
    want = counts_with(log_mel_folded=1, fused_conv1_fwd=2, fused_conv1_bwd=2)
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
    want = counts_with(log_mel_folded=1, fused_attention_fwd=2 * VIT_DEPTH,
                       fused_attention_bwd=2 * VIT_DEPTH)
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


def expect(counts: dict, per_unit: dict, units: int, what: str) -> dict:
    """counts must be `units` x per_unit (every other kernel 0) -> the counts
    per unit."""
    want = {k: units * per_unit.get(k, 0) for k in counts}
    if counts != want:
        raise SystemExit(f"{what}: launched {counts}, expected {want}")
    return {k: per_unit.get(k, 0) for k in counts}


def run_main(argv: list[str], entry=None):
    """ssl_audio_tpu_torch.main.main(argv) (or `entry`, e.g. main_bt_byol's)
    in-process, its stdout kept, the counters zeroed just before and read
    just after -> (trainer, seconds, launches, output lines)."""
    from ssl_audio_tpu_torch.main import main as train_main

    train_main = entry or train_main
    out = io.StringIO()
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        trainer = train_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if trainer.device.type != "cuda":
        raise SystemExit(f"main trained on {trainer.device}, not the card")
    return trainer, seconds, launch_counts(), out.getvalue().splitlines()


def state_gap(a, b) -> tuple[float, str]:
    """The largest absolute difference over two train states' modules
    (parameters and running statistics), and the tensor it is in."""
    sa, sb = a.state.modules.state_dict(), b.state.modules.state_dict()
    gaps = {k: float((v.double() - sb[k].double()).abs().max()) for k, v in sa.items()}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def resume_check(path: str, seed: int, flags: list[str], steps: int, per_step: dict,
                 entry=None):
    """Two uninterrupted RESUME_EPOCHS-epoch runs of main (or `entry`) with
    `flags` (of `steps` steps per epoch, each launching `per_step`) and one
    resumed from the first run's model_2.pt (in the working directory) ->
    (the record, the first run's trainer, its last checkpoint)."""
    from ssl_audio_tpu_torch.utils import checkpoint as ckpt_lib

    base = flags + ["--epochs", str(RESUME_EPOCHS), "--synthetic_steps_per_epoch", str(steps),
                    "--seed", str(seed)]
    runs = {}
    for name, extra in (("a", ["--epoch_save_f", "2"]), ("b", ["--epoch_save_f", str(RESUME_EPOCHS)])):
        runs[name] = run_main(base + extra + ["--save_base_dir", f"{path}/{name}"], entry)
        expect(runs[name][2], per_step, RESUME_EPOCHS * steps, f"{path} run {name}")
    (ckpt2,) = glob.glob(f"{path}/a/results/*/*/model_2.pt")
    (ckpt_last,) = glob.glob(f"{path}/a/results/*/*/model_{RESUME_EPOCHS}.pt")
    runs["r"] = run_main(base + ["--epoch_save_f", "2", "--save_base_dir", f"{path}/r",
                                 "--resume_path", ckpt2], entry)
    per_step = expect(runs["r"][2], per_step, (RESUME_EPOCHS - 2) * steps, f"{path} resumed")
    if not any(line.startswith(f"Resumed from {ckpt2} at epoch 3") for line in runs["r"][3]):
        raise SystemExit(f"{path}: the resumed run did not start at epoch 3")
    a, b, r = (runs[k][0] for k in "abr")
    gap_ab, where_ab = state_gap(a, b)
    gap_ar, where_ar = state_gap(a, r)
    losses = {k: runs[k][0].epoch_losses for k in "abr"}
    for k, ls in losses.items():
        if not all(v == v and abs(v) != float("inf") for v in ls.values()):
            raise SystemExit(f"{path} run {k}: non-finite epoch loss {ls}")

    # the checkpoint's size, and one save and one load of it, timed
    timed = "timed.pt"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt_lib.save_checkpoint(timed, a.state, RESUME_EPOCHS + 1,
                             ckpt_lib.encode_rng(a.gen, a.host_rng))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ckpt_lib.load_checkpoint(timed, a.state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    record = {"flags": base, "losses": {k: {str(e): v for e, v in ls.items()}
                                        for k, ls in losses.items()},
              "gap_uninterrupted": gap_ab, "gap_uninterrupted_tensor": where_ab,
              "gap_resumed": gap_ar, "gap_resumed_tensor": where_ar,
              "checkpoint_bytes": os.path.getsize(timed), "save_s": save_s, "load_s": load_s,
              "run_s": {k: runs[k][1] for k in "abr"}, "launches_per_step": per_step}
    print(f"  {path}: " + json.dumps(record))
    os.remove(timed)
    if gap_ab == 0.0:
        if gap_ar != 0.0 or losses["r"] != {e: losses["a"][e] for e in losses["r"]}:
            raise SystemExit(f"{path}: two uninterrupted runs are bit-identical, the resumed "
                             f"one is not (gap {gap_ar} in {where_ar})")
    elif gap_ar > gap_ab:
        raise SystemExit(f"{path}: resumed vs uninterrupted {gap_ar} ({where_ar}) above "
                         f"uninterrupted vs uninterrupted {gap_ab} ({where_ab})")
    return record, a, os.path.abspath(ckpt_last)


def phase_pretraining(seed: int, dev: torch.device, smi: str) -> dict:
    from ssl_audio_tpu_torch.hear import conv as hear_conv
    from ssl_audio_tpu_torch.tools import prove_learning
    from ssl_audio_tpu_torch.tools.serving import seeded_clips

    print("phase 9: pretraining runs through main (AudioNTT2022 at the defaults, ViT-B "
          "--fused_attention AdamW --lr_schedule), checkpoints and resume, HEAR from a "
          "checkpoint, a 3-epoch learning proof")
    out = {"card": smi, "launches": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, contextlib.chdir(tmp):
        for path in PRETRAIN:
            out[path], trainer, ckpt_last = resume_check(path, seed, *PRETRAIN[path])
            out["launches"][path] = out[path]["launches_per_step"]
            if path != "pretrain_audiontt":
                continue
            # HEAR from the checkpoint file against the trainer's encoder in memory
            served = hear_conv.load_model(ckpt_last, fused_conv=True)
            in_memory = hear_conv.load_model("", fused_conv=True)
            in_memory.model.load_state_dict(trainer.state.modules["encoder"].state_dict())
            audio = seeded_clips(torch.Generator().manual_seed(seed), N_CLIPS, CLIP)
            zero_launch_counts()
            emb, _ = hear_conv.get_timestamp_embeddings(audio, served)
            torch.cuda.synchronize()
            launches = launch_counts()
            emb_mem, _ = hear_conv.get_timestamp_embeddings(audio, in_memory)
            out["launches"]["hear_checkpoint_timestamp"] = expect(
                launches, {"log_mel_folded": 7, "fused_conv1_fwd": 7}, 1,
                "the timestamp request from the checkpoint")
            out["hear_checkpoint"] = {"checkpoint": os.path.basename(ckpt_last),
                                      "shape": list(emb.shape),
                                      "max_abs_diff_vs_in_memory": max_err(emb, emb_mem),
                                      "bit_identical": bool(torch.equal(emb, emb_mem))}
            print("  HEAR timestamp request from the checkpoint: "
                  + json.dumps(out["hear_checkpoint"]) + f", launches {launches}")
            if not out["hear_checkpoint"]["bit_identical"]:
                raise SystemExit("the checkpoint's encoder serves other embeddings than "
                                 "the trainer's")
            del trainer, served, in_memory
        torch.cuda.empty_cache()

        zero_launch_counts()
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            record = prove_learning.main(PROOF_FLAGS + ["--seed", str(seed), "--out",
                                                        "proof.json"])
        epochs = record["epochs"]
        for e in epochs:
            if not (0.0 <= e["score"] <= 1.0) or (
                    e["loss"] is not None and not (e["loss"] == e["loss"]
                                                   and abs(e["loss"]) != float("inf"))):
                raise SystemExit(f"learning proof: epoch {e['epoch']} loss {e['loss']} "
                                 f"score {e['score']}")
            if e["epoch"]:
                out["launches"]["proof_step"] = expect(
                    e["train_launches"], PROOF_STEP, record["steps_per_epoch"],
                    f"learning proof epoch {e['epoch']}'s steps")
            out["launches"]["proof_probe"] = expect(e["probe_launches"], PROOF_PROBE, 1,
                                                    f"learning proof probe {e['epoch']}")
        out["proof"] = {"flags": PROOF_FLAGS, "scores": [e["score"] for e in epochs],
                        "losses": [e["loss"] for e in epochs], "learned": record["learned"],
                        "wall_s": record["wall_s"], "ms_per_step": record["ms_per_step"],
                        "probe_s": [e["probe_s"] for e in epochs]}
        print("  learning proof: " + json.dumps(out["proof"]))
    return out


def counts_minus(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after}


def epoch_through_trainer(trainer, epoch: int, profiled: bool = False) -> dict:
    """One epoch of trainer.train_one_epoch with a CUDA event recorded after
    each step: ms per step as the device's time from one step's end to the
    next (median over the epoch, the first step's loader start left out),
    wall ms per step, the Trainer's own data_time / step_time; with
    `profiled`, the device's idle share and the host's largest self times
    (torch.profiler over the epoch)."""
    from ssl_audio_tpu_torch.tools.serving import profile

    step, ends = trainer.train_step, []

    def timed_step(*args, **kwargs):
        out = step(*args, **kwargs)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        return out

    trainer.train_step = timed_step
    prof = None
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if profiled:
            prof = profile(lambda: trainer.train_one_epoch(epoch))
        else:
            trainer.train_one_epoch(epoch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        trainer.train_step = step
    gaps = [a.elapsed_time(b) for a, b in zip(ends, ends[1:])]
    data_s, step_s = trainer.epoch_times[epoch]
    rec = {"steps": len(ends), "ms_per_step_median": statistics.median(gaps),
           "ms_per_step_min": min(gaps), "ms_per_step_max": max(gaps),
           "wall_ms_per_step": wall_s * 1e3 / len(ends), "data_s": data_s, "step_s": step_s,
           "mean_loss": trainer.epoch_losses[epoch]}
    if prof is not None:
        rec.update(idle_share=prof["idle_share"],
                   device_busy_ms_per_step=prof["device_busy_ms"] / len(ends),
                   host_self_ms_by_op=dict(list(prof["host_self_ms_by_op"].items())[:6]))
    return rec


def resident_step_ms(trainer, dev: torch.device) -> dict:
    """The trainer's step on one of its batches resident on the card: host
    ms of TRAIN_STEPS steps after two warm-ups."""
    from ssl_audio_tpu_torch.data.pipeline import DataLoader

    x, _ = next(iter(DataLoader(trainer.dataset, TRAIN_BATCH, num_workers=8, seed=1,
                                log=lambda line: None)))
    times, _ = timed_steps(trainer.train_step, trainer.state, torch.from_numpy(x).to(dev),
                           trainer.gen)
    return {"ms_per_step_median": statistics.median(times), "ms_per_step_min": min(times),
            "ms_per_step_max": max(times)}


def loader_alone(trainer, dev: torch.device) -> dict:
    """An epoch of the trainer's loader with no step: each pinned batch
    copied to the card as the Trainer copies it; ms from one batch to the
    next (median, the first batch's start-up left out).  Beside the step
    through the Trainer, it says whether the loader holds the step back."""
    ends = [time.perf_counter()]
    for x, _ in trainer.loader:
        x.to(dev, non_blocking=True)
        ends.append(time.perf_counter())
    torch.cuda.synchronize()
    gaps = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    return {"batches": len(gaps), "first_ms": gaps[0],
            "ms_per_batch_median": statistics.median(gaps[1:])}


def pinned_ring_check(dataset, dev: torch.device) -> dict:
    """An epoch of the loader's pinned batches, each copied to the card with
    non_blocking=True behind ~25 ms of queued device work (so copies are in
    flight while the producer refills the ring), against the same epoch as
    host arrays: bit-identical."""
    from ssl_audio_tpu_torch.data.pipeline import DataLoader

    def loader(device):
        return DataLoader(dataset, TRAIN_BATCH, num_workers=8, seed=3, device=device,
                          log=lambda line: None)

    got = []
    for x, _ in loader(dev):
        if not x.is_pinned():
            raise SystemExit("the loader gave a batch that is not pinned for the card")
        torch.cuda._sleep(50_000_000)
        got.append(x.to(dev, non_blocking=True))
    want = [x for x, _ in loader(None)]
    torch.cuda.synchronize()
    same = len(got) == len(want) and all(
        np.array_equal(g.cpu().numpy(), w) for g, w in zip(got, want))
    if not same:
        raise SystemExit("pinned batches copied with non_blocking differ from host batches")
    return {"batches": len(got), "bit_identical": same}


def pinned_vs_pageable(trainer, first_epoch: int) -> list[dict]:
    """Four epochs through the Trainer, its loader's batches pinned (A) or
    host arrays copied from pageable memory (B), A B B A."""
    from ssl_audio_tpu_torch.data.pipeline import DataLoader

    pinned = trainer.loader
    pageable = DataLoader(trainer.dataset, TRAIN_BATCH, num_workers=trainer.cfg.num_workers,
                          seed=trainer.cfg.seed, log=lambda line: None)
    runs = []
    try:
        for epoch, (copy, loader) in enumerate((("pinned", pinned), ("pageable", pageable),
                                                ("pageable", pageable), ("pinned", pinned)),
                                               start=first_epoch):
            trainer.loader = loader
            runs.append({"copy": copy, **epoch_through_trainer(trainer, epoch)})
    finally:
        trainer.loader = pinned
    return runs


def run_main_lines(argv: list[str], what: str, want_path: str):
    """run_main, and the loader's line must name the path it took."""
    trainer, seconds, counts, lines = run_main(argv)
    said = [line for line in lines if line.startswith("DataLoader(")]
    if not said or want_path not in said[0] or "pinned for cuda" not in said[0]:
        raise SystemExit(f"{what}: the loader said {said}, expected {want_path!r}, pinned")
    return trainer, seconds, counts, said[0]


def phase_disk(seed: int, dev: torch.device, smi: str, resident_wav_ms: float) -> dict:
    from ssl_audio_tpu_torch import linear as linear_cli
    from ssl_audio_tpu_torch.data import datasets as D
    from ssl_audio_tpu_torch.eval import linear as linear_mod
    from ssl_audio_tpu_torch.ops.mel import MelSpec, log_mel_spectrogram_plain
    from ssl_audio_tpu_torch.tools import wav_to_lms
    from ssl_audio_tpu_torch.tools.bench_pipeline import fabricate_audioset_wav, fabricate_fsd50k
    from ssl_audio_tpu_torch.tools.serving import seeded_clips

    print("phase 10: on-disk data: wav_to_lms, main at the defaults on FSD50K with the per-epoch "
          "probe, audioset_wav (pinned vs pageable), --load_wav, resume, the linear CLI")
    out = {"card": smi, "launches": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_disk_") as tmp, contextlib.chdir(tmp):
        t0 = time.perf_counter()
        fabricate_fsd50k("data", DISK_SPLITS["train"], DISK_FRAMES, seed,
                         n_val=DISK_SPLITS["val"], n_test=DISK_SPLITS["test"],
                         n_classes=DISK_CLASSES, max_labels=DISK_MAX_LABELS, wavs=True)
        fabricate_audioset_wav("data", AUDIOSET_FILES[0], n_balanced=AUDIOSET_FILES[1],
                               seed=seed, stereo_every=8, short_every=16,
                               short_seconds=AUDIOSET_SHORT)
        out["trees"] = {"seconds": time.perf_counter() - t0, "bytes": sum(
            os.path.getsize(os.path.join(r, f)) for r, _d, fs in os.walk("data") for f in fs)}
        print("  trees: " + json.dumps(out["trees"]))

        # (a) the converter over the balanced segments: 10-s, 2.5, 5 and 7.5-s wavs
        in_dir = "data/audioset/balanced_train_segments"
        zero_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            conv = wav_to_lms.main(["--in_dir", in_dir, "--out_dir", "lms_out"])
        torch.cuda.synchronize()
        out["launches"]["convert_group"] = expect(launch_counts(), {"log_mel_folded": 1},
                                                  conv["groups"], "wav_to_lms")
        spec, errs, seen = MelSpec(), {}, set()
        for name in sorted(os.listdir(in_dir)):
            wav = D.load_wav(os.path.join(in_dir, name), spec.sample_rate)
            if len(wav) in seen:
                continue
            seen.add(len(wav))
            got = np.load(os.path.join("lms_out", name[:-4] + ".npy"))
            ref = log_mel_spectrogram_plain(torch.from_numpy(wav)[None], spec)[0].numpy()
            errs[len(wav)] = float(np.abs(got - ref).max())
            check(f"wav_to_lms {len(wav)} samples vs the plain version on the CPU",
                  errs[len(wav)], MEL_ATOL, "three TF32 passes, sums in another order")
        out["convert"] = {**conv, "max_abs_err_by_length": errs}
        print("  (a) wav_to_lms: " + json.dumps(out["convert"]))
        out["convert_mel_row"] = mel_row(seeded_clips(torch.Generator().manual_seed(seed), 64,
                                                      CLIP).to(dev), spec, None,
                                         "folded, converter group")

        # (b) main at the defaults on FSD50K, the per-epoch probe on; each
        # probe's launches are the counters' difference around eval_linear
        probes, real_eval_linear = [], linear_mod.eval_linear

        def counted_eval_linear(*args, **kwargs):
            torch.cuda.synchronize()
            before, t = launch_counts(), time.perf_counter()
            scores = real_eval_linear(*args, **kwargs)
            torch.cuda.synchronize()
            probes.append((counts_minus(launch_counts(), before), time.perf_counter() - t,
                           scores))
            return scores

        linear_mod.eval_linear = counted_eval_linear
        try:
            trainer, run_s, counts, said = run_main_lines(
                ["--dataset", "fsd50k", "--epochs", "2", "--epoch_eval_f", "1",
                 "--save_base_dir", "b", "--seed", str(seed)], "fsd50k", "NativeBatchReader")
        finally:
            linear_mod.eval_linear = real_eval_linear
        if len(probes) != 2 or any(p[0] != probes[0][0] for p in probes):
            raise SystemExit(f"fsd50k: the probes launched {[p[0] for p in probes]}")
        for _c, _s, scores in probes:
            if not 0.0 < scores["score_all"] <= 1.0:
                raise SystemExit(f"fsd50k probe: mAP {scores['score_all']} not in (0, 1]")
        out["launches"]["fsd50k_probe"] = probes[0][0]
        steps = 2 * trainer.niter_per_ep
        out["launches"]["fsd50k_step"] = expect(
            counts_minus(counts, {k: 2 * v for k, v in probes[0][0].items()}),
            STEP_LAUNCHES, steps, "fsd50k steps")
        out["fsd50k"] = {
            "flags": "--dataset fsd50k --epochs 2 --epoch_eval_f 1", "loader": said,
            "steps_per_epoch": trainer.niter_per_ep, "run_s": run_s,
            "epoch_losses": trainer.epoch_losses,
            "probe_s": [p[1] for p in probes], "probe_map": [p[2]["score_all"] for p in probes],
            "probe_map_5": [p[2]["score_5"] for p in probes],
            "pinned_ring": pinned_ring_check(trainer.dataset, dev),
            "abba": pinned_vs_pageable(trainer, 3),
            "loader_alone": loader_alone(trainer, dev),
            "through_trainer_profiled": epoch_through_trainer(trainer, 7, profiled=True),
            "resident": resident_step_ms(trainer, dev),
            "resident_wav_step_phase5_ms": resident_wav_ms}
        print("  (b) fsd50k: " + json.dumps(out["fsd50k"]))
        del trainer

        # (c) audioset_wav: the C++ wav reader and the device frontend; then
        # epochs with the batches pinned (A) and pageable (B), A B B A
        trainer, run_s, counts, said = run_main_lines(
            ["--dataset", "audioset_wav", "--epochs", "1", "--no_eval", "--seed", str(seed)],
            "audioset_wav", "NativeWavReader")
        out["launches"]["audioset_wav_step"] = expect(counts, WAV_STEP_LAUNCHES,
                                                      trainer.niter_per_ep, "audioset_wav steps")
        out["audioset_wav"] = {"loader": said, "steps_per_epoch": trainer.niter_per_ep,
                               "run_s": run_s, "abba": pinned_vs_pageable(trainer, 2),
                               "loader_alone": loader_alone(trainer, dev),
                               "pinned_profiled": epoch_through_trainer(trainer, 6, profiled=True),
                               "resident_wav_step_phase5_ms": resident_wav_ms}
        print("  (c) audioset_wav: " + json.dumps(out["audioset_wav"]))
        del trainer

        # (d) --load_wav on FSD50K: the log-mel of each batch in the loader
        trainer, run_s, counts, said = run_main_lines(
            ["--dataset", "fsd50k", "--load_wav", "--epochs", "1", "--no_eval",
             "--seed", str(seed)], "--load_wav", "load_batch")
        out["launches"]["load_wav_step"] = expect(counts, WAV_STEP_LAUNCHES,
                                                  trainer.niter_per_ep, "--load_wav steps")
        rows = np.arange(16)
        card_x, _ = D.FSD50K(trainer.cfg, split="train", data_dir="data", seed=seed,
                             norm_stats=D.NORM_STATS["fsd50k"]).load_batch(rows)
        cpu_x, _ = D.FSD50K(trainer.cfg.replace(device="cpu"), split="train", data_dir="data",
                            seed=seed, norm_stats=D.NORM_STATS["fsd50k"]).load_batch(rows)
        err = float(np.abs(card_x - cpu_x).max())
        check("--load_wav batch, card vs CPU", err, MEL_ATOL,
              "the log-mel kernel's three TF32 passes, then / std")
        out["load_wav"] = {"loader": said, "steps_per_epoch": trainer.niter_per_ep,
                           "run_s": run_s, "max_abs_err_vs_cpu": err,
                           "through_trainer": epoch_through_trainer(trainer, 2),
                           "loader_alone": loader_alone(trainer, dev),
                           "through_trainer_profiled": epoch_through_trainer(trainer, 3,
                                                                             profiled=True)}
        print("  (d) --load_wav: " + json.dumps(out["load_wav"]))
        del trainer

        # (e) resume on (b)'s path, on a tree of RESUME_TRAIN clips
        os.makedirs("resume")
        with contextlib.chdir("resume"):
            fabricate_fsd50k("data", RESUME_TRAIN, DISK_FRAMES, seed + 1,
                             n_classes=DISK_CLASSES, max_labels=DISK_MAX_LABELS)
            out["resume"], trainer, _ = resume_check(
                "resume_fsd50k", seed, ["--dataset", "fsd50k", "--no_eval"],
                RESUME_TRAIN // TRAIN_BATCH, STEP_LAUNCHES)
            out["launches"]["resume_fsd50k_step"] = out["resume"]["launches_per_step"]
            del trainer
        torch.cuda.empty_cache()

        # (f) the linear CLI on (b)'s last checkpoint
        (ckpt,) = glob.glob("b/results/fsd50k/*/model_2.pt")
        zero_launch_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            scores = linear_cli.main(["--model_file_path", ckpt, "--model_name", "chip_smoke",
                                      "--model_epoch", "2", "--seed", str(seed)])
        torch.cuda.synchronize()
        out["launches"]["linear_cli"] = launch_counts()
        (log,) = glob.glob("logs/linear_eval/fsd50k/chip_smoke/log.csv")
        if not 0.0 < scores["score_all"] <= 1.0 or "linear_score" not in open(log).read():
            raise SystemExit(f"linear CLI: score {scores}, log {open(log).read()!r}")
        out["linear_cli"] = {"checkpoint": os.path.basename(ckpt), "s": time.perf_counter() - t,
                             "map": scores["score_all"], "map_5": scores["score_5"]}
        print("  (f) linear CLI: " + json.dumps(out["linear_cli"]))

        # (g) the bf16 modes on FSD50K: main --use_fp16 --use_fp16_eval with the
        # per-epoch probe in bf16, then the linear CLI --use_fp16_eval on its
        # checkpoint (the probe's 711-frame crops are odd: block 1 is cuDNN's)
        probes.clear()
        linear_mod.eval_linear = counted_eval_linear
        try:
            trainer, run_s, counts, said = run_main_lines(
                ["--dataset", "fsd50k", "--epochs", "1", "--epoch_eval_f", "1", "--use_fp16",
                 "--use_fp16_eval", "--save_base_dir", "g", "--seed", str(seed)],
                "fsd50k bf16", "NativeBatchReader")
        finally:
            linear_mod.eval_linear = real_eval_linear
        if len(probes) != 1 or not 0.0 < probes[0][2]["score_all"] <= 1.0:
            raise SystemExit(f"fsd50k bf16 probe: {[(p[0], p[2]) for p in probes]}")
        out["launches"]["fsd50k_bf16_probe"] = probes[0][0]
        out["launches"]["fsd50k_bf16_step"] = expect(
            counts_minus(counts, probes[0][0]),
            {"fused_conv1_fwd_bf16": 2, "fused_conv1_bwd_bf16": 2}, trainer.niter_per_ep,
            "fsd50k --use_fp16 steps")
        (ckpt,) = glob.glob("g/results/fsd50k/*/model_1.pt")
        zero_launch_counts()
        t = time.perf_counter()
        cli_log = io.StringIO()
        with contextlib.redirect_stdout(cli_log):
            scores = linear_cli.main(["--model_file_path", ckpt, "--model_name", "chip_smoke_bf16",
                                      "--model_epoch", "1", "--use_fp16_eval",
                                      "--seed", str(seed)])
        torch.cuda.synchronize()
        out["launches"]["linear_cli_bf16"] = launch_counts()
        if not 0.0 < scores["score_all"] <= 1.0 or "encoder compute bfloat16" not in \
                cli_log.getvalue():
            raise SystemExit(f"linear CLI --use_fp16_eval: {scores}, {cli_log.getvalue()!r}")
        # a second epoch through the same Trainer, its steps timed on the device
        through_trainer = epoch_through_trainer(trainer, 2)
        out["bf16"] = {"flags": "--dataset fsd50k --epochs 1 --use_fp16 --use_fp16_eval",
                       "run_s": run_s, "epoch_losses": trainer.epoch_losses,
                       "through_trainer": through_trainer,
                       "probe_s": probes[0][1], "probe_map": probes[0][2]["score_all"],
                       "linear_cli_s": time.perf_counter() - t,
                       "linear_cli_map": scores["score_all"]}
        print("  (g) bf16 on FSD50K: " + json.dumps(out["bf16"]))
        del trainer
    return out


# phase 12: --steps_per_dispatch windows as CUDA graphs.  Each
# configuration's epoch at DISPATCH steps a window (an eager warm-up window, a
# captured and replayed one, replayed ones, a tail of single steps) against
# the same epoch at one step a dispatch, from the same seed, bit for bit
DISPATCH = 4
GRAPH_STEPS = 14     # (a)-(d): windows [0-3] eager, [4-7] captured and replayed,
                     # [8-11] replayed (static inputs refilled), tail [12, 13]
GRAPH_WINDOWS = 1    # timed windows per graphed turn: 2 windows, 8 replayed steps
VITB = ["--dataset", "synthetic_wav", "--model_type", "vit_base", "--fused_attention"]
VIT_STEP = {"log_mel_folded": 1, "fused_attention_fwd": 2 * VIT_DEPTH,
            "fused_attention_bwd": 2 * VIT_DEPTH}
GRAPH_CONFIGS = {   # flags, launches per step, timed A B B A
    "a_audiontt_fp32_lars": (["--dataset", "synthetic_wav", "--model_type", "audiontt"],
                             WAV_STEP_LAUNCHES, True),
    "b_audiontt_bf16_lars": (["--dataset", "synthetic_wav", "--model_type", "audiontt",
                              "--use_fp16"],
                             {"log_mel_folded": 1, "fused_conv1_fwd_bf16": 2,
                              "fused_conv1_bwd_bf16": 2}, True),
    "c_vitb_adamw_lr_schedule_key_bias_random_ratio": (
        [*VITB, "--optimizer", "AdamW", "--lr_schedule", "--mask", "--random_mask_ratio",
         "--mask_beta", "0.75"], VIT_STEP, True),
    "d_vitb_bf16_key_bias_random_ratio": (
        [*VITB, "--use_fp16", "--mask", "--random_mask_ratio", "--mask_beta", "0.75"],
        {"log_mel_folded": 1, "fused_attention_fwd_bf16": 2 * VIT_DEPTH,
         "fused_attention_bwd_bf16": 2 * VIT_DEPTH}, True),
    # the sine schedule over 4 epochs of 14 steps, epoch 3: len_keep 18 for
    # the first two windows, 17 for the third and the tail (24 tokens), so the
    # graph of 18 and then a second graph, of 17, are captured
    "e_vitb_token_drop_mask_schedule": (
        [*VITB, "--mask", "--mask_ratio_schedule", "--epochs", "4"], VIT_STEP, False),
}
SCHEDULE_EPOCH, SCHEDULE_STEPS, SCHEDULE_KEYS = 3, 14, [18] * 8 + [17] * 6


def graph_epoch(flags: list[str], n: int, steps: int, epoch: int, seed: int,
                byol: bool = False) -> dict:
    """One epoch of config_from_args(flags) through the Trainer at n steps a
    dispatch: the launches of every dispatch (counters zeroed just before it
    and read just after), what each window did (eager, captured and
    replayed, replayed), the trainer."""
    from ssl_audio_tpu_torch.config import config_from_args
    from ssl_audio_tpu_torch.train.loop import Trainer

    argv = [*flags, "--synthetic_steps_per_epoch", str(steps), "--seed", str(seed),
            "--steps_per_dispatch", str(n)]
    if "--epochs" not in flags:
        argv += ["--epochs", "1"]
    trainer = Trainer(config_from_args(argv), byol=byol, log=lambda line: None)
    dispatches = []

    def counted(fn, kind):
        def run(*args, **kwargs):
            graphs = dict(trainer.multi_step.graphs) if kind == "window" else {}
            zero_launch_counts()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            mode = kind
            if kind == "window":
                now = trainer.multi_step.graphs
                new = [k for k in now if k not in graphs or now[k] is not graphs[k]]
                mode = "captured and replayed" if new else \
                    "replayed" if kwargs.get("len_keep") in now else "eager"
            dispatches.append({"mode": mode, "len_keep": kwargs.get("len_keep"),
                               "launches": launch_counts()})
            return out
        return run

    step = trainer.train_step
    trainer.train_step = counted(step, "step")
    if trainer.multi_step is not None:
        multi = trainer.multi_step
        trainer.multi_step = counted(multi, "window")
        trainer.multi_step.inputs, trainer.multi_step.graphs = multi.inputs, multi.graphs
    t0 = time.perf_counter()
    trainer.train_one_epoch(epoch)
    torch.cuda.synchronize()
    return {"trainer": trainer, "dispatches": dispatches, "epoch_s": time.perf_counter() - t0}


def graphs_vs_eager(name: str, flags: list[str], per_step: dict, seed: int,
                    byol: bool = False) -> dict:
    """(a)-(e): the epoch at DISPATCH steps a window against the same epoch
    one step at a time: every tensor of the train state, the generator and
    the epoch's loss (the monitor's sum over the steps), bit for bit (the
    phase fails otherwise, printing the largest gap per tensor); launches of
    every dispatch: a window DISPATCH x the step's, each single step the
    step's."""
    from ssl_audio_tpu_torch.tools.step_determinism import tensor_gaps, train_state_tensors

    schedule = name.startswith("e_")
    steps, epoch = (SCHEDULE_STEPS, SCHEDULE_EPOCH) if schedule else (GRAPH_STEPS, 1)
    want = counts_with(**per_step)
    runs = {n: graph_epoch(flags, n, steps, epoch, seed, byol) for n in (DISPATCH, 1)}
    graphed, eager = runs[DISPATCH]["trainer"], runs[1]["trainer"]
    for n, run in runs.items():
        for d in run["dispatches"]:
            k = DISPATCH if d["mode"] not in ("step",) else 1
            if d["launches"] != {c: k * v for c, v in want.items()}:
                raise SystemExit(f"{name}: a {d['mode']} dispatch at N = {n} launched "
                                 f"{d['launches']}, expected {k} x {per_step}")
    modes = [(d["mode"], d["len_keep"]) for d in runs[DISPATCH]["dispatches"]]
    expected = ["eager", "captured and replayed",
                "captured and replayed" if schedule else "replayed", "step", "step"]
    if [m for m, _ in modes] != expected:
        raise SystemExit(f"{name}: the epoch's dispatches were {modes}, expected {expected}")
    if schedule:
        keys = [lk for _, lk in modes]
        if keys != [18, 18, 17, 17, 17] or sorted(graphed.multi_step.graphs, key=str) != [17, 18]:
            raise SystemExit(f"{name}: len_keep per dispatch {keys}, graphs "
                             f"{list(graphed.multi_step.graphs)}")
    gaps = tensor_gaps(train_state_tensors(graphed.state), train_state_tensors(eager.state))
    same_gen = torch.equal(graphed.gen.get_state(), eager.gen.get_state())
    lg, le = graphed.epoch_losses[epoch], eager.epoch_losses[epoch]
    rec = {"flags": flags, "epoch": epoch, "steps": steps,
           "dispatches": [f"{m}{'' if lk is None else f' (len_keep {lk})'}" for m, lk in modes],
           "bit_for_bit": not gaps and same_gen and lg == le,
           "epoch_loss": {"graphed": lg, "eager": le}, "generators_equal": same_gen,
           "tensors_differing": len(gaps),
           "largest_gaps": dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:8]),
           "launches_per_replay": {c: v for c, v in next(
               d["launches"] for d in runs[DISPATCH]["dispatches"]
               if d["mode"] != "eager" and d["mode"] != "step").items() if v},
           "launches_per_eager_step": {c: v for c, v in runs[1]["dispatches"][0]["launches"]
                                       .items() if v},
           "capture_s": {str(k): w.capture_s for k, w in graphed.multi_step.graphs.items()},
           "epoch_s": {"graphed": runs[DISPATCH]["epoch_s"], "eager": runs[1]["epoch_s"]}}
    print(f"  ({name[0]}) {json.dumps(rec)}")
    if not rec["bit_for_bit"]:
        raise SystemExit(f"{name}: the graphed epoch is not the eager one bit for bit "
                         f"(generators equal: {same_gen}; the gaps per tensor above)")
    del runs
    return rec


def graphed_vs_eager_time(name: str, flags: list[str], per_step: dict, seed: int,
                          smi: str, byol: bool = False) -> dict:
    """(a)-(d) timed on a batch of 128 seeded 10-s clips resident on the
    card, in turns (A B B A): eager steps (A, TRAIN_STEPS after two warm-ups per
    turn) and graphed windows of DISPATCH steps (B, GRAPH_WINDOWS windows per
    turn after the warm-up window and the capture), ms per step (the median
    over the windows of a window's host-clock ms / DISPATCH), the capture's
    seconds, peak memory and each side's profile (device busy, idle share,
    the port's kernels the device ran: a replay's must be DISPATCH x the
    step's, as the launch counters say, or the phase fails)."""
    from ssl_audio_tpu_torch.config import config_from_args
    from ssl_audio_tpu_torch.tools.serving import profile, seeded_clips
    from ssl_audio_tpu_torch.tools.train_profile import (
        seeded_training,
        step_wall_ms,
        window_runner,
    )
    from ssl_audio_tpu_torch.train.loop import mask_ratio_for_step

    overrides = {k: v for k, v in vars(config_from_args(flags)).items()
                 if k in ("model_type", "fused_attention", "use_fp16", "optimizer", "lr",
                          "lr_schedule", "mask", "random_mask_ratio", "mask_beta", "wd",
                          "stop_gradient", "predictor", "squeeze_excitation", "remat")}
    cfg, state, step, gen = seeded_training(seed, torch.device("cuda"), byol=byol,
                                            **overrides)
    wavs = seeded_clips(torch.Generator().manual_seed(seed), TRAIN_BATCH, CLIP).cuda()
    rng = np.random.default_rng(seed + 17)
    ratios = [mask_ratio_for_step(cfg, None, i, rng, byol) for i in range(TRAIN_STEPS)]
    window_ratios = ratios[:DISPATCH]
    run_window, multi = window_runner(cfg, state, gen, wavs, DISPATCH, window_ratios,
                                      byol=byol)
    turn = iter(range(10 ** 6))

    def eager():
        return step(state, wavs, gen=gen, mask_ratio=ratios[next(turn) % TRAIN_STEPS])

    eager()
    eager()
    times = {"eager": [], "graphed": []}
    # peak device memory above what was allocated when each side started
    # (the train state, the batch and what earlier phases still hold)
    peak, base = {}, {}
    for side in ("eager", "graphed", "graphed", "eager"):
        if side == "eager":
            torch.cuda.reset_peak_memory_stats()
            base.setdefault("eager", torch.cuda.memory_allocated())
            times["eager"] += step_wall_ms(eager, TRAIN_STEPS)
            peak.setdefault("eager", torch.cuda.max_memory_allocated() - base["eager"])
            continue
        if not multi.graphs:
            run_window()                                   # the eager warm-up window
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base["graphed"] = torch.cuda.memory_allocated()
            capture_ms = step_wall_ms(run_window, 1)[0]    # capture + the first replay
        times["graphed"] += [t / DISPATCH for t in step_wall_ms(run_window, GRAPH_WINDOWS)]
        peak["graphed"] = torch.cuda.max_memory_allocated() - base["graphed"]
    (window,) = multi.graphs.values()
    prof_eager, prof_graphed = profile(eager), profile(run_window)
    med = {k: statistics.median(v) for k, v in times.items()}
    rec = {"order": "eager, graphed, graphed, eager", "steps_timed": {
               "eager": len(times["eager"]), "graphed": DISPATCH * len(times["graphed"])},
           "ms_per_step_median": med, "ms_per_step_min": {k: min(v) for k, v in times.items()},
           "clips_per_s": {k: TRAIN_BATCH / v * 1e3 for k, v in med.items()},
           "speedup": med["eager"] / med["graphed"],
           "capture_s": window.capture_s, "first_replay_with_capture_ms": capture_ms,
           "peak_memory_above_start_bytes": peak,
           "allocated_at_start_bytes": base,
           "eager_step_profile": {"wall_ms": prof_eager["wall_ms"],
                                  "device_busy_ms": prof_eager["device_busy_ms"],
                                  "idle_share": prof_eager["idle_share"]},
           "graphed_window_profile": {"wall_ms": prof_graphed["wall_ms"],
                                      "device_busy_ms": prof_graphed["device_busy_ms"],
                                      "idle_share": prof_graphed["idle_share"],
                                      "device_ms_by_kernel": dict(list(
                                          prof_graphed["device_ms_by_kernel"].items())[:6])},
           "card": smi}
    want = counts_with(**per_step)
    seen = {"eager step": prof_eager["launches_seen"], "replay": prof_graphed["launches_seen"]}
    rec["launches_seen_by_profiler"] = seen
    # the profiler has once listed no event of a kernel that ran in a
    # profiled eager resnet18 step (on an H100), whose replays it listed: a
    # disagreement is profiled once more, and fails if it repeats
    again = {"eager step": eager, "replay": run_window}
    for what, k in (("eager step", 1), ("replay", DISPATCH)):
        if counts_with(**seen[what]) != {c: k * v for c, v in want.items()}:
            seen[f"{what}, profiled again"] = profile(again[what])["launches_seen"]
            if counts_with(**seen[f"{what}, profiled again"]) != \
                    {c: k * v for c, v in want.items()}:
                raise SystemExit(f"{name}: the profiler saw the {what} run {seen}, the "
                                 f"launch counters say {k} x {per_step}")
    print(f"  ({name[0]}) time: {json.dumps(rec)}")
    del state, multi, window
    return rec


def profile_dir_trace(seed: int) -> dict:
    """main's --profile_dir at one step a dispatch: a 12-step epoch of the
    defaults traces iterations 10 and 11; the trace must name the log-mel
    kernel (B2) and both fused conv kernels (B1, B4).  Two steps, not one:
    the log-mel kernel is the first launch after the profiler starts, and
    a one-step trace has once missed its events on an H100 (the fused conv
    kernels of the same step were in it)."""
    from ssl_audio_tpu_torch.config import config_from_args
    from ssl_audio_tpu_torch.train.loop import Trainer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        lines = []
        cfg = config_from_args(["--dataset", "synthetic_wav", "--epochs", "1",
                                "--synthetic_steps_per_epoch", "12", "--seed", str(seed),
                                "--profile_dir", tmp])
        Trainer(cfg, log=lines.append).train_one_epoch(1)
        (path,) = glob.glob(os.path.join(tmp, "*.json"))
        text = open(path).read()
        names = {k: k in text for k in ("log_mel_kernel", "fused_conv1_fwd_kernel",
                                        "fused_conv1_bwd_kernel")}
        rec = {"trace": os.path.basename(path), "bytes": len(text), "names": names,
               "said": [line for line in lines if "trace" in line]}
    print(f"  --profile_dir: {json.dumps(rec)}")
    if not all(names.values()):
        raise SystemExit(f"the --profile_dir trace misses kernels: {names}")
    return rec


def phase_graphs(seed: int, smi: str) -> dict:
    """Phase 12: --steps_per_dispatch as CUDA graphs through the Trainer."""
    import gc

    from ssl_audio_tpu_torch.train.loop import token_drop_len_keep
    from ssl_audio_tpu_torch.utils.schedules import sine_scheduler_increase

    print(f"phase 12: --steps_per_dispatch {DISPATCH}, a window of steps as one CUDA graph, "
          "against one step a dispatch; full width, batch 128, raw 10-s clips in")
    sched = sine_scheduler_increase(0.3, 4, SCHEDULE_STEPS)
    keys = [token_drop_len_keep(VIT_TOKENS - 1, r) for r in
            sched[(SCHEDULE_EPOCH - 1) * SCHEDULE_STEPS:SCHEDULE_EPOCH * SCHEDULE_STEPS]]
    if keys != SCHEDULE_KEYS:
        raise SystemExit(f"(e): the schedule's len_keep per step is {keys}")
    out = {"launches": {}, "card": smi}
    for name, (flags, per_step, timed) in GRAPH_CONFIGS.items():
        out[name] = graphs_vs_eager(name, flags, per_step, seed)
        gc.collect()
        torch.cuda.empty_cache()
        if timed:
            out[name]["time"] = graphed_vs_eager_time(name, flags, per_step, seed, smi)
            gc.collect()
            torch.cuda.empty_cache()
        out["launches"][f"graph_{name}"] = counts_with(**{
            k: v // DISPATCH for k, v in out[name]["launches_per_replay"].items()})
    out["profile_dir"] = profile_dir_trace(seed)
    return out


# phase 13: the BYOL-style variant (main_bt_byol) and the reproduce chain.
# Launches per step: the online net's two passes and the target's two (block
# 1 forward 4 times, 48 attention forwards for ViT-B); backward through the
# online net only with --stop_gradient, through both without it
BYOL_FLAGS = ["--dataset", "synthetic_wav", "--model_type", "audiontt", "--stop_gradient",
              "--predictor"]
BYOL_STEP = {"log_mel_folded": 1, "fused_conv1_fwd": 4, "fused_conv1_bwd": 2}
BYOL_BY_GRADIENT_STEP = {"log_mel_folded": 1, "fused_conv1_fwd": 4, "fused_conv1_bwd": 4}
BYOL_VIT_FLAGS = [*VITB, "--stop_gradient", "--predictor", "--mask", "--random_mask_ratio",
                  "--optimizer", "AdamW", "--lr_schedule"]
BYOL_VIT_STEP = {"log_mel_folded": 1, "fused_attention_fwd": 4 * VIT_DEPTH,
                 "fused_attention_bwd": 2 * VIT_DEPTH}
BYOL_BF16_STEP = {"log_mel_folded": 1, "fused_conv1_fwd_bf16": 4, "fused_conv1_bwd_bf16": 2}
BYOL_EPOCH_STEPS = 3
BYOL_TIMED_STEPS = 4   # per turn, A B B A: 8 timed steps of each side
EMA_RTOL = 1e-6        # the BYOL target after one step, card vs CPU: the EMA of equal values
CHAIN_TASKS = ("esc50-v2.0.0-full", "speech_commands-v0.0.2-5h")


@contextlib.contextmanager
def steps_counted(per_step: dict, what: str, factory: str = "make_byol_train_step"):
    """Inside: every step the Trainer makes by `factory` (its BYOL steps, or
    with "make_train_step" its Barlow Twins steps) has its launches counted
    (read just before and just after the step, the device synchronised);
    each must be per_step, checked on leaving."""
    from ssl_audio_tpu_torch.train import loop

    make = getattr(loop, factory)
    seen = []

    def counted_factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def counted(*a, **kw):
            before = launch_counts()
            out = step(*a, **kw)
            torch.cuda.synchronize()
            seen.append(counts_minus(launch_counts(), before))
            return out
        return counted

    setattr(loop, factory, counted_factory)
    try:
        yield seen
    finally:
        setattr(loop, factory, make)
    want = counts_with(**per_step)
    bad = [c for c in seen if c != want]
    if not seen or bad:
        raise SystemExit(f"{what}: {len(bad)} of {len(seen)} steps launched other than "
                         f"{per_step}: {bad[:2]}")
    print(f"  {what}: each of {len(seen)} steps launched {per_step}")


def byol_vs_bt_time(name: str, flags: list[str], seed: int, smi: str) -> dict:
    """The BYOL step of config_from_args(flags) against the Barlow Twins step
    of the same configuration, on one batch of 128 seeded 10-s clips resident
    on the card, in turns (A B B A, BYOL_TIMED_STEPS each after two warm-ups
    per side): ms per step, clips/s, one profiled step of each (device busy,
    idle share) and each side's peak memory above what was allocated when it
    started."""
    import gc

    from ssl_audio_tpu_torch.config import config_from_args
    from ssl_audio_tpu_torch.tools.serving import profile, seeded_clips
    from ssl_audio_tpu_torch.tools.train_profile import seeded_training, step_wall_ms

    overrides = {k: v for k, v in vars(config_from_args(flags)).items()
                 if k in ("model_type", "fused_attention", "optimizer", "lr", "lr_schedule",
                          "mask", "random_mask_ratio", "wd", "stop_gradient", "predictor")}
    wavs = seeded_clips(torch.Generator().manual_seed(seed), TRAIN_BATCH, CLIP).cuda()
    ratio = 0.5 if overrides.get("mask") else 0.0     # masked steps, the teacher's or online
    sides, peak, times, prof = {}, {}, {"bt": [], "byol": []}, {}
    for side in ("bt", "byol"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cfg, state, step, gen = seeded_training(seed, torch.device("cuda"),
                                                byol=side == "byol", **overrides)
        run = (lambda st=state, sp=step, g=gen: sp(st, wavs, gen=g, mask_ratio=ratio))
        run()
        run()
        torch.cuda.synchronize()
        peak[side] = torch.cuda.max_memory_allocated() - base
        sides[side] = run
    for side in ("bt", "byol", "byol", "bt"):
        times[side] += step_wall_ms(sides[side], BYOL_TIMED_STEPS)
    for side in ("bt", "byol"):
        p = profile(sides[side])
        prof[side] = {"wall_ms": p["wall_ms"], "device_busy_ms": p["device_busy_ms"],
                      "idle_share": p["idle_share"], "launches_seen": p["launches_seen"]}
    med = {k: statistics.median(v) for k, v in times.items()}
    rec = {"flags": flags, "mask_ratio": ratio, "order": "bt, byol, byol, bt",
           "steps_timed": {k: len(v) for k, v in times.items()},
           "ms_per_step_median": med, "ms_per_step_min": {k: min(v) for k, v in times.items()},
           "clips_per_s": {k: TRAIN_BATCH / v * 1e3 for k, v in med.items()},
           "byol_over_bt": med["byol"] / med["bt"], "profile": prof,
           "peak_memory_bytes": peak, "card": smi}
    print(f"  ({name}) BYOL vs Barlow Twins step: {json.dumps(rec)}")
    del sides
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def reproduce_chain(seed: int) -> dict:
    """(h): the reproduce chain on a tree written in a temporary directory
    (64 one-second dev clips, 16 eval clips, two HEAR tasks of 6 + 3 clips):
    convert -> pretrain (1 epoch of 2 steps at batch 32) -> probe -> HEAR ->
    aggregate, each stage's seconds and launches (counters zeroed just
    before it, read just after); every score must lie in [0, 1]."""
    from ssl_audio_tpu_torch.tools import reproduce

    stages = {}

    def counted(name, fn):
        def run(*args):
            zero_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            stages[name] = {"s": time.perf_counter() - t0,
                            "launches": {k: v for k, v in launch_counts().items() if v}}
            return out
        return run

    originals = {n: getattr(reproduce, f"stage_{n}") for n in reproduce.ALL_STAGES}
    log = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chain_") as tmp, contextlib.chdir(tmp):
        reproduce.fabricate_tree(tmp, n_dev=64, n_eval=16, tasks=CHAIN_TASKS, seed=seed)
        for n, fn in originals.items():
            setattr(reproduce, f"stage_{n}", counted(n, fn))
        try:
            with contextlib.redirect_stdout(log):
                results = reproduce.main([
                    "--root", tmp, "--work_dir", "out", "--epochs", "1", "--batch_size", "32",
                    "--epoch_save_f", "1", "--name", "chain", "--no_eval",
                    "--extra_pretrain_args", "--seed", str(seed)])
        finally:
            for n, fn in originals.items():
                setattr(reproduce, f"stage_{n}", fn)
    groups = results["hear"]["audiontt_chain"]
    scores = [v for g in groups.values() for v in g.values()] + \
        [results["linear"]["score_all"], *results["linear"]["score_5"][:1]]
    rec = {"stages": stages, "results_json": groups,
           "linear": {k: (list(v) if isinstance(v, tuple) else v)
                      for k, v in results["linear"].items()}}
    print(f"  (h) reproduce chain: {json.dumps(rec)}")
    if not all(0.0 <= v <= 1.0 for v in scores):
        raise SystemExit(f"(h): a score outside [0, 1]: {scores}")
    if set(groups["environmental"]) != {CHAIN_TASKS[0], "AVERAGE"} or \
            set(groups["speech"]) != {CHAIN_TASKS[1], "AVERAGE"}:
        raise SystemExit(f"(h): results.json groups {groups}")
    if stages["convert"]["launches"] != {"log_mel_folded": 2}:
        raise SystemExit(f"(h): the converter launched {stages['convert']['launches']}, "
                         "expected one log-mel launch per split (one length group each)")
    want = {"fused_conv1_fwd": 4, "fused_conv1_bwd": 4}
    if stages["pretrain"]["launches"] != want:
        raise SystemExit(f"(h): pretraining's 2 steps launched "
                         f"{stages['pretrain']['launches']}, expected {want}")
    return rec


def phase_byol(seed: int, dev: torch.device, smi: str) -> dict:
    """Phase 13: main_bt_byol (a)-(e), the BYOL step card vs CPU (f), BYOL
    against Barlow Twins timed (g) and the reproduce chain (h)."""
    import gc

    from ssl_audio_tpu_torch import main_bt_byol

    print("phase 13: the BYOL-style variant (main_bt_byol: online and target nets, EMA "
          "target) at full width, batch 128, raw 10-s clips in, and the reproduce chain")
    out = {"card": smi, "launches": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_byol_") as tmp, contextlib.chdir(tmp):
        # (a): the defaults with --stop_gradient --predictor, 3 epochs of 3 steps,
        # twice and once resumed from model_2.pt
        with steps_counted(BYOL_STEP, "(a)"):
            out["a_resume"], trainer, _ = resume_check("byol_audiontt", seed, BYOL_FLAGS,
                                                       BYOL_EPOCH_STEPS, BYOL_STEP,
                                                       main_bt_byol.main)
        if not any(k.startswith("target.") for k in trainer.state.state_dict()["model"]):
            raise SystemExit("(a): the BYOL train state holds no target")
        out["launches"]["byol_step"] = counts_with(**BYOL_STEP)
        del trainer
        gc.collect()
        # (b) without --stop_gradient, (c) ViT-B, (e) --use_fp16: one epoch each
        for key, flags, per_step in (
                ("b_by_gradient", [f for f in BYOL_FLAGS if f != "--stop_gradient"],
                 BYOL_BY_GRADIENT_STEP),
                ("c_vitb", BYOL_VIT_FLAGS, BYOL_VIT_STEP),
                ("e_bf16", BYOL_FLAGS + ["--use_fp16"], BYOL_BF16_STEP)):
            with steps_counted(per_step, f"({key[0]})"):
                trainer, seconds, _, _ = run_main(
                    flags + ["--epochs", "1", "--synthetic_steps_per_epoch",
                             str(BYOL_EPOCH_STEPS), "--seed", str(seed), "--save_base_dir", key],
                    main_bt_byol.main)
            loss = trainer.epoch_losses[1]
            if loss != loss or abs(loss) == float("inf"):
                raise SystemExit(f"({key[0]}): the epoch's mean loss is {loss}")
            out[key] = {"flags": flags, "steps": BYOL_EPOCH_STEPS, "seconds": seconds,
                        "mean_loss": loss, "launches_per_step": per_step}
            out["launches"][f"byol_{key}"] = counts_with(**per_step)
            print(f"  ({key[0]}) {json.dumps(out[key])}")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    # (d): 14 steps at 4 a dispatch against one a dispatch, bit for bit; a
    # replay's launches against the profiler's kernel events
    out["d_graphs"] = graphs_vs_eager("d_byol_graphs", BYOL_FLAGS, BYOL_STEP, seed, byol=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["d_graphs"]["time"] = graphed_vs_eager_time("d_byol_graphs", BYOL_FLAGS, BYOL_STEP,
                                                    seed, smi, byol=True)
    out["launches"]["byol_graphed_step"] = counts_with(**{
        k: v // DISPATCH for k, v in out["d_graphs"]["launches_per_replay"].items()})
    gc.collect()
    torch.cuda.empty_cache()
    # (f): a batch-16 BYOL step, card vs CPU
    out["f_cpu_check"] = {
        "audiontt": card_vs_cpu_step(
            seed, dev, dict(batch_size=16, stop_gradient=True, predictor=True), {},
            ("encoder.features.0.bias", "encoder.features.4.bias"), STEP_LOSS_RTOL,
            STEP_GRAD_RTOL, "pool and ReLU decisions flip on 1e-7 input differences",
            label="BYOL card vs CPU", byol=True),
        "vit_tiny_fused": card_vs_cpu_step(
            seed, dev, dict(model_type="vit_tiny", fused_attention=True, batch_size=16,
                            stop_gradient=True, predictor=True, mask=True),
            dict(mask_ratio=0.5), ("encoder.norm.bias",), STEP_LOSS_RTOL, VIT_FUSED_GRAD_RTOL,
            "bf16 roundings flipped by 1e-7 differences, amplified", VIT_FUSED_GLOBAL_RTOL,
            label="BYOL card vs CPU", byol=True)}
    # (g): BYOL against Barlow Twins, timed
    out["g_time"] = {"audiontt": byol_vs_bt_time("g audiontt", BYOL_FLAGS, seed, smi),
                     "vitb": byol_vs_bt_time("g vitb", BYOL_VIT_FLAGS, seed, smi)}
    # (h): the reproduce chain
    out["h_chain"] = reproduce_chain(seed)
    for stage in ("convert", "pretrain", "probe", "hear"):
        out["launches"][f"reproduce_{stage}"] = counts_with(
            **out["h_chain"]["stages"][stage]["launches"])
    return out


# phase 14: the rest of the encoder zoo (SE blocks, --remat, the ResNets).
# Launches per step: a ResNet runs no hand-written kernel but the log-mel;
# SE follows the fused block 1, so AudioNTT's counts stand; under --remat
# every ViT block that takes a gradient runs its attention forward twice
# (forward and recompute in the backward), the backward once
ZOO_SE = ["--dataset", "synthetic_wav", "--model_type", "audiontt", "--squeeze_excitation"]
ZOO_RN50R = ["--dataset", "synthetic_wav", "--model_type", "resnet50_ReGP_NRF"]
ZOO_RN18 = ["--dataset", "synthetic_wav", "--model_type", "resnet18"]
ZOO_REMAT = [*VITB, "--remat", "--optimizer", "AdamW", "--mask", "--mask_ratio", "0.75",
             "--no_token_drop"]
ZOO_RESNET_STEP = {"log_mel_folded": 1}
ZOO_REMAT_STEP = {"log_mel_folded": 1, "fused_attention_fwd": 4 * VIT_DEPTH,
                  "fused_attention_bwd": 2 * VIT_DEPTH}
ZOO_REMAT_BF16_STEP = {"log_mel_folded": 1, "fused_attention_fwd_bf16": 4 * VIT_DEPTH,
                       "fused_attention_bwd_bf16": 2 * VIT_DEPTH}
ZOO_EPOCH_STEPS = 2
ZOO_PROBE_SPLITS = {"train": 128, "val": 32, "test": 32}   # the per-epoch probe's tree
ZOO_TIMED_STEPS = 4      # per turn, A B B A: 8 timed steps a side
REMAT_RTOL = 1e-6        # remat against no remat: the same kernels on the same values
ZOO_BF16_RTOL = 2e-2     # bf16 HEAR embeddings against fp32, relative L2 (the CPU tests' ceiling)
HEAR_RESNETS = ("resnet50", "resnet50_ReGP_NRF")


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms inside.  At its default choice two
    eager runs of a ResNet step part at batch 128 (resnet50_ReGP_NRF: 4
    epochs of 3 steps apart by 18.2 in a running variance, losses by 1-4 %;
    PR 13, call 1): the weight-gradient algorithms it picks for some of the
    ResNets' convolutions sum in no fixed order.  Bit-for-bit checks of the
    ResNets run under this, as the card tests' do."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def conv_unit_flops(model: torch.nn.Module, unit: torch.Tensor) -> float:
    """FLOPs of one forward of a conv encoder on a batch-1 unit: 2 x the
    multiply-adds of every Conv2d and Linear, from the forward's shapes."""
    macs = []

    def conv(mod, inp, out):
        macs.append(out.numel() * mod.in_channels // mod.groups * mod.weight[0, 0].numel())

    def linear(mod, inp, out):
        macs.append(out.numel() * mod.in_features)

    hooks = [m.register_forward_hook(conv if isinstance(m, torch.nn.Conv2d) else linear)
             for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model(unit)
    finally:
        for h in hooks:
            h.remove()
    return 2.0 * sum(macs)


def zoo_epoch(flags: list[str], per_step: dict, what: str, seed: int, entry=None,
              factory: str = "make_train_step") -> dict:
    """One ZOO_EPOCH_STEPS-step epoch of main (or `entry`) in-process, every
    step's launches counted (each must be per_step); whatever the run
    launched besides its steps (the per-epoch probe) is returned beside
    them."""
    with steps_counted(per_step, what, factory) as seen:
        trainer, seconds, total, lines = run_main(
            flags + ["--epochs", "1", "--synthetic_steps_per_epoch", str(ZOO_EPOCH_STEPS),
                     "--seed", str(seed), "--save_base_dir",
                     what.strip("()").replace(" ", "_")], entry)
    loss = trainer.epoch_losses[1]
    if loss != loss or abs(loss) == float("inf"):
        raise SystemExit(f"{what}: the epoch's mean loss is {loss}")
    besides = {k: total[k] - sum(c[k] for c in seen) for k in total}
    rec = {"flags": flags, "steps": len(seen), "seconds": seconds, "mean_loss": loss,
           "launches_per_step": per_step,
           "launches_besides_the_steps": {k: v for k, v in besides.items() if v},
           "probe": [line for line in lines if "score" in line.lower()][-2:]}
    print(f"  {what} {json.dumps(rec)}")
    del trainer
    return rec


def turns_time(name: str, sides: dict, seed: int, smi: str) -> dict:
    """The steps of `sides` (label -> seeded_training overrides) on one batch
    of 128 seeded 10-s clips resident on the card, in turns (the labels in
    order, then reversed: A B B A for two), ZOO_TIMED_STEPS steps a turn
    after two warm-ups each: ms per step (median, min), clips/s, one
    profiled step of each (device busy, idle share) and each side's peak
    memory above what was allocated when its state was made."""
    import gc

    from ssl_audio_tpu_torch.tools.serving import profile, seeded_clips
    from ssl_audio_tpu_torch.tools.train_profile import seeded_training, step_wall_ms

    wavs = seeded_clips(torch.Generator().manual_seed(seed), TRAIN_BATCH, CLIP).cuda()
    runs, peak, times, prof = {}, {}, {k: [] for k in sides}, {}
    for label, overrides in sides.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cfg, state, step, gen = seeded_training(seed, torch.device("cuda"), **overrides)
        ratio = 0.75 if overrides.get("mask") else 0.0
        run = (lambda st=state, sp=step, g=gen, r=ratio: sp(st, wavs, gen=g, mask_ratio=r))
        run()
        run()
        torch.cuda.synchronize()
        peak[label] = torch.cuda.max_memory_allocated() - base
        runs[label] = run
    order = list(sides) + list(sides)[::-1]
    for label in order:
        times[label] += step_wall_ms(runs[label], ZOO_TIMED_STEPS)
    for label in sides:
        p = profile(runs[label])
        prof[label] = {"wall_ms": p["wall_ms"], "device_busy_ms": p["device_busy_ms"],
                       "idle_share": p["idle_share"], "launches_seen": p["launches_seen"],
                       "top_kernels_ms": {k[:80]: v for k, v in
                                          list(p["device_ms_by_kernel"].items())[:4]}}
    med = {k: statistics.median(v) for k, v in times.items()}
    rec = {"order": ", ".join(order), "steps_timed": {k: len(v) for k, v in times.items()},
           "ms_per_step_median": med, "ms_per_step_min": {k: min(v) for k, v in times.items()},
           "clips_per_s": {k: TRAIN_BATCH / v * 1e3 for k, v in med.items()},
           "profile": prof, "peak_memory_above_start_bytes": peak, "card": smi}
    print(f"  (g) {name}: {json.dumps(rec)}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def remat_equality(seed: int, dev: torch.device) -> dict:
    """(d): one step of ViT-B --fused_attention with and without --remat from
    the same seeded state and draws on a resident batch of 128: the losses
    and every gradient, the largest relative gap printed; each must stay
    within REMAT_RTOL."""
    from ssl_audio_tpu_torch.tools.serving import seeded_clips
    from ssl_audio_tpu_torch.tools.train_profile import seeded_training
    from ssl_audio_tpu_torch.train.steps import draw_step

    wavs = seeded_clips(torch.Generator().manual_seed(seed), TRAIN_BATCH, CLIP).to(dev)
    runs = []
    for remat in (False, True):
        cfg, state, step, _ = seeded_training(seed, dev, model_type="vit_base",
                                              fused_attention=True, optimizer="AdamW",
                                              mask=True, remat=remat)
        draws = draw_step(torch.Generator(device=dev).manual_seed(seed + 9), cfg,
                          tuple(wavs.shape), state.modules["encoder"], dev, wav=True)
        zero_launch_counts()
        loss = float(step(state, wavs, draws=draws, mask_ratio=0.75)["loss"])
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        grads = {k: p.grad.detach().clone() for k, p in state.modules.named_parameters()
                 if p.grad is not None}
        runs.append((loss, grads, launches))
        del state
    (l0, g0, c0), (l1, g1, c1) = runs
    gaps = {k: float((g1[k].double() - g.double()).norm() / max(g.double().norm(), 1e-30))
            for k, g in g0.items()}
    worst = max(gaps, key=gaps.get)
    rec = {"loss": {"no_remat": l0, "remat": l1}, "loss_rel_gap": abs(l1 - l0) / abs(l0),
           "worst_grad": worst, "worst_grad_rel_l2": gaps[worst],
           "grads_bit_for_bit": all(torch.equal(g1[k], g) for k, g in g0.items()),
           "launches": {"no_remat": c0, "remat": c1}}
    print(f"  (d) remat against no remat, one step: {json.dumps(rec)}")
    check("remat vs no remat, loss, relative", rec["loss_rel_gap"], REMAT_RTOL,
          "the same kernels on the same values")
    check("remat vs no remat, gradients, worst relative L2", gaps[worst], REMAT_RTOL,
          "the same kernels on the same values")
    if counts_with(**c1) != counts_with(**ZOO_REMAT_STEP) or set(g0) != set(g1):
        raise SystemExit(f"(d): the remat step launched {c1}, expected {ZOO_REMAT_STEP}")
    return rec


def hear_resnets(seed: int, dev: torch.device, smi: str, ckpt: str, encoder) -> dict:
    """(f): hear.conv.load_model("", resnet50 / resnet50_ReGP_NRF): phase 4's
    timestamp and scene requests (launches, shapes, finite), a small request
    against the CPU, the same requests in bf16 against fp32, ms per request,
    clips/s and the share of the fp32 operation bound; then the timestamp
    request from (b)'s checkpoint against a wrapper handed the trainer's
    encoder in memory, bit for bit."""
    from ssl_audio_tpu_torch.hear import conv as hear_conv
    from ssl_audio_tpu_torch.tools.serving import profile, seeded_clips

    audio = seeded_clips(torch.Generator().manual_seed(seed), N_CLIPS, CLIP)
    small = audio[:2, :16000]
    out = {"launches": {}}
    for mt in HEAR_RESNETS:
        model = hear_conv.load_model("", mt, fused_conv=True)
        bf16 = hear_conv.load_model("", mt, compute_dtype="bfloat16")
        requests = {
            "timestamp": lambda m: hear_conv.get_timestamp_embeddings(audio, m)[0],
            "scene": lambda m: hear_conv.get_scene_embeddings(audio, m)}
        rec = {}
        for path, request in requests.items():
            request(model)                               # warm-up: cuDNN's plans
            zero_launch_counts()
            emb = request(model)
            torch.cuda.synchronize()
            launches = launch_counts()
            windows = emb.shape[0] * (emb.shape[1] if emb.dim() == 3 else 1)
            chunks = -(-windows // CHUNK) if path == "timestamp" else 1
            out["launches"][f"hear_{mt}_{path}"] = expect(
                launches, {"log_mel_folded": chunks}, 1, f"(f) {mt} {path}")
            if emb.shape[-1] != model.embed_dim or not torch.isfinite(emb).all():
                raise SystemExit(f"(f) {mt} {path}: {tuple(emb.shape)}, finite "
                                 f"{bool(torch.isfinite(emb).all())}")
            emb16 = request(bf16)
            rel16 = float((emb16.double() - emb.double()).norm() / emb.double().norm())
            check(f"(f) {mt} {path} bf16 vs fp32, relative L2", rel16, ZOO_BF16_RTOL,
                  "bf16 roundings through the conv stack (the CPU tests' ceiling)")
            times = wall_ms(lambda: request(model))
            # the work: one forward per 96-frame window, or per whole clip
            frames = 96 if path == "timestamp" else model.mel.num_frames(CLIP)
            flops = windows * conv_unit_flops(model.model,
                                              torch.zeros(1, 1, 64, frames, device=dev))
            prof = profile(lambda: request(model))
            med = statistics.median(times)
            rec[path] = {"shape": list(emb.shape), "ms_per_request_median": med,
                         "ms_per_request": times, "clips_per_s": N_CLIPS / med * 1e3,
                         "bf16_rel_l2_vs_fp32": rel16, "unit_forwards": windows,
                         "tflop": flops / 1e12, "fp32_bound_ms": flops / PEAK_FP32_FLOPS * 1e3,
                         "bound_share": flops / PEAK_FP32_FLOPS * 1e3 / med,
                         "device_busy_ms": prof["device_busy_ms"],
                         "idle_share": prof["idle_share"],
                         "top_kernels_ms": {k[:80]: v for k, v in
                                            list(prof["device_ms_by_kernel"].items())[:4]}}
            print(f"  (f) {mt} {path}: {json.dumps(rec[path])}")
        cpu = hear_conv.load_model("", mt, device="cpu")
        cpu.model.load_state_dict(model.model.state_dict())
        for path, fn in (("timestamp", lambda m: hear_conv.get_timestamp_embeddings(small, m)[0]),
                         ("scene", lambda m: hear_conv.get_scene_embeddings(small, m))):
            a, b = fn(model), fn(cpu)
            rec[f"{path}_cpu_check"] = max_err(a, b) / float(b.abs().max())
            check(f"(f) {mt} {path} embeddings card vs CPU, / max|emb|",
                  rec[f"{path}_cpu_check"], EMB_RTOL, "fp32 sums in another order")
        out[mt] = dict(rec, card=smi)
        del model, bf16, cpu
        torch.cuda.empty_cache()
    # the timestamp request from (b)'s checkpoint against the trainer's encoder
    served = hear_conv.load_model(ckpt, "resnet50_ReGP_NRF")
    in_memory = hear_conv.load_model("", "resnet50_ReGP_NRF")
    in_memory.model.load_state_dict(encoder.state_dict())
    emb, _ = hear_conv.get_timestamp_embeddings(audio, served)
    emb_mem, _ = hear_conv.get_timestamp_embeddings(audio, in_memory)
    out["from_checkpoint"] = {"checkpoint": os.path.basename(ckpt), "shape": list(emb.shape),
                              "bit_identical": bool(torch.equal(emb, emb_mem))}
    print(f"  (f) timestamp request from the checkpoint: {json.dumps(out['from_checkpoint'])}")
    if not out["from_checkpoint"]["bit_identical"]:
        raise SystemExit("(f): the checkpoint's ResNet serves other embeddings than the "
                         "trainer's")
    return out


def phase_zoo(seed: int, dev: torch.device, smi: str) -> dict:
    """Phase 14: AudioNTT2022 with SE blocks, the ResNets and ViT-B --remat
    through main, main_bt_byol, checkpoints and resume, graphs, card vs CPU
    steps, HEAR serving and A B B A timings."""
    import gc

    from ssl_audio_tpu_torch import main_bt_byol
    from ssl_audio_tpu_torch.tools.bench_pipeline import fabricate_fsd50k

    print("phase 14: the rest of the encoder zoo (AudioNTT2022 --squeeze_excitation, "
          "resnet18 / resnet50 / resnet50_ReGP_NRF, ViT-B --remat) at full width, batch 128, "
          "raw 10-s clips in")
    out = {"card": smi, "launches": {}, "seconds": {}}
    t0 = time.perf_counter()

    def lap(part):
        out["seconds"][part] = time.perf_counter() - t0 - sum(out["seconds"].values())

    se_step = counts_with(**WAV_STEP_LAUNCHES)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp, contextlib.chdir(tmp):
        # (a) SE at the defaults, an epoch with the per-epoch probe (FSD50K's
        # 711-frame crops are odd: the probe's block 1 is the plain one), then
        # an epoch under --use_fp16
        fabricate_fsd50k("data", ZOO_PROBE_SPLITS["train"], DISK_FRAMES, seed,
                         n_val=ZOO_PROBE_SPLITS["val"], n_test=ZOO_PROBE_SPLITS["test"],
                         n_classes=DISK_CLASSES, max_labels=DISK_MAX_LABELS)
        out["a_se"] = zoo_epoch(ZOO_SE, WAV_STEP_LAUNCHES, "(a)", seed)
        if out["a_se"]["launches_besides_the_steps"]:
            raise SystemExit(f"(a): the probe launched {out['a_se']['launches_besides_the_steps']}"
                             ", expected nothing (odd 711-frame crops, log-mels in)")
        out["launches"]["zoo_se_step"] = se_step
        out["launches"]["zoo_se_probe"] = counts_with()
        out["a_se_bf16"] = zoo_epoch(
            ZOO_SE + ["--use_fp16", "--no_eval"],
            {"log_mel_folded": 1, "fused_conv1_fwd_bf16": 2, "fused_conv1_bwd_bf16": 2},
            "(a bf16)", seed)
        out["launches"]["zoo_se_bf16_step"] = counts_with(
            log_mel_folded=1, fused_conv1_fwd_bf16=2, fused_conv1_bwd_bf16=2)
        lap("a")
        gc.collect()
        torch.cuda.empty_cache()
        # (b) resnet50_ReGP_NRF at the defaults: resume (bit for bit under
        # deterministic cuDNN); resnet18, resnet18 BYOL
        with steps_counted(ZOO_RESNET_STEP, "(b)", "make_train_step"), deterministic_cudnn():
            out["b_resume"], trainer, ckpt_last = resume_check(
                "zoo_resnet50_regp", seed, ZOO_RN50R + ["--no_eval"], ZOO_EPOCH_STEPS,
                ZOO_RESNET_STEP)
        out["launches"]["zoo_resnet50_regp_step"] = counts_with(**ZOO_RESNET_STEP)
        encoder = trainer.state.modules["encoder"]
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        out["b_resnet18"] = zoo_epoch(ZOO_RN18 + ["--no_eval"], ZOO_RESNET_STEP, "(b resnet18)",
                                      seed)
        out["b_resnet18_byol"] = zoo_epoch(
            ZOO_RN18 + ["--no_eval", "--stop_gradient", "--predictor"], ZOO_RESNET_STEP,
            "(b resnet18 BYOL)", seed, main_bt_byol.main, "make_byol_train_step")
        out["launches"]["zoo_resnet18_step"] = counts_with(**ZOO_RESNET_STEP)
        out["launches"]["zoo_resnet18_byol_step"] = counts_with(**ZOO_RESNET_STEP)
        lap("b")
        gc.collect()
        torch.cuda.empty_cache()
        # (f) HEAR ResNets, and the request from (b)'s checkpoint
        out["f_hear"] = hear_resnets(seed, dev, smi, ckpt_last, encoder)
        out["launches"].update({k: counts_with(**v)
                                for k, v in out["f_hear"].pop("launches").items()})
        lap("f")
        del encoder
        gc.collect()
        torch.cuda.empty_cache()
    # (c) graphs: SE and resnet18 at 4 a dispatch against one a dispatch (SE's
    # graph is phase 12's (a) with SE: resnet18 alone is timed, its replay's
    # kernel events against 4x the step's counters); ViT-B remat.  resnet18's
    # bit-for-bit epochs under deterministic cuDNN
    for key, flags, per_step, timed in (("c_se", ZOO_SE, WAV_STEP_LAUNCHES, False),
                                        ("c_resnet18", ZOO_RN18, ZOO_RESNET_STEP, True),
                                        ("c_vitb_remat", ZOO_REMAT, ZOO_REMAT_STEP, False)):
        with deterministic_cudnn() if key == "c_resnet18" else contextlib.nullcontext():
            out[key] = graphs_vs_eager(key, flags, per_step, seed)
        gc.collect()
        torch.cuda.empty_cache()
        if timed:
            out[key]["time"] = graphed_vs_eager_time(key, flags, per_step, seed, smi)
            gc.collect()
            torch.cuda.empty_cache()
        out["launches"][f"zoo_graph_{key[2:]}"] = counts_with(**{
            k: v // DISPATCH for k, v in out[key]["launches_per_replay"].items()})
    lap("c")
    # (d) ViT-B --fused_attention --remat: an epoch through the Trainer, fp32
    # and bf16 (key bias at 0.75), and remat against no remat on one step
    _, launches, out["d_remat_epoch"] = entry_epoch(ZOO_REMAT, counts_with(**ZOO_REMAT_STEP),
                                                    seed)
    out["launches"]["zoo_vitb_remat_step"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    _, launches, out["d_remat_bf16_epoch"] = entry_epoch(
        ZOO_REMAT + ["--use_fp16"], counts_with(**ZOO_REMAT_BF16_STEP), seed)
    out["launches"]["zoo_vitb_remat_bf16_step"] = launches
    gc.collect()
    torch.cuda.empty_cache()
    out["d_remat_equality"] = remat_equality(seed, dev)
    lap("d")
    gc.collect()
    torch.cuda.empty_cache()
    # (e) batch-16 steps, card vs CPU
    out["e_cpu_check"] = {
        "audiontt_se": card_vs_cpu_step(
            seed, dev, dict(batch_size=16, squeeze_excitation=True), {},
            ("encoder.features.0.bias", "encoder.features.5.bias"), STEP_LOSS_RTOL,
            STEP_GRAD_RTOL, "pool and ReLU decisions flip on 1e-7 input differences"),
        "resnet18_regp_nrf": card_vs_cpu_step(
            seed, dev, dict(batch_size=16, model_type="resnet18_ReGP_NRF"), {}, (),
            STEP_LOSS_RTOL, STEP_GRAD_RTOL,
            "pool and ReLU decisions flip on 1e-7 input differences"),
        "vit_tiny_fused_remat": card_vs_cpu_step(
            seed, dev, dict(model_type="vit_tiny", fused_attention=True, remat=True,
                            batch_size=16, mask=True), dict(mask_ratio=0.75),
            ("encoder.norm.bias",), STEP_LOSS_RTOL, VIT_FUSED_GRAD_RTOL,
            "bf16 roundings flipped by 1e-7 differences, amplified", VIT_FUSED_GLOBAL_RTOL)}
    lap("e")
    # (g) timed, A B B A
    out["g_time"] = {
        "se": turns_time("SE against no SE", {
            "audiontt": {}, "audiontt_se": dict(squeeze_excitation=True)}, seed, smi),
        "resnets": turns_time("the ResNets beside AudioNTT2022", {
            "audiontt": {}, "resnet18": dict(model_type="resnet18"),
            "resnet50": dict(model_type="resnet50"),
            "resnet50_ReGP_NRF": dict(model_type="resnet50_ReGP_NRF")}, seed, smi),
        "remat": turns_time("ViT-B remat against no remat", {
            "vitb": dict(model_type="vit_base", fused_attention=True, optimizer="AdamW"),
            "vitb_remat": dict(model_type="vit_base", fused_attention=True, optimizer="AdamW",
                               remat=True)}, seed, smi)}
    lap("g")
    print(f"  phase 14 seconds by part: {json.dumps(out['seconds'])}")
    return out


DP_FLAGS = ["--dataset", "synthetic_wav", "--epochs", "1", "--synthetic_steps_per_epoch", "8",
            "--epoch_save_f", "1", "--no_eval"]
DP_GRAPHED = ["--steps_per_dispatch", "4"]
DP_BYOL = ["--stop_gradient", "--predictor"]     # main_bt_byol's run in (a)
DP_RTOL = 1e-4       # two ranks against one process: loss, and the parameters after the step as
                     # one vector (relative L2); the batch sums are taken in another order
DP_FUSED_LOSS_RTOL = 1e-3   # the loss with the fused attention: the ranks' GEMMs over fewer rows
                     # round otherwise in fp32, and the kernels' bf16 operands turn that into
                     # ~1e-4 of the loss (vit_tiny at 16 on an H100: 2.6e-4, its fp32
                     # einsum form 2e-6); the card-vs-CPU step's limit
DP_TIMED_STEPS = 8   # (c): timed steps a side, eager, and in windows of 4
DP_RUNS = {          # (b): overrides of train_profile's configuration, global batch, launches,
                     # the loss's tolerance
    "dp_audiontt": ({}, 128, WAV_STEP_LAUNCHES, DP_RTOL),
    "dp_vitb": (dict(model_type="vit_base", fused_attention=True, mask=True, mask_ratio=0.75,
                     token_drop=False), 32, VIT_STEP, DP_FUSED_LOSS_RTOL),
}


def start_torchrun(args: list[str], log: str):
    """`python -m torch.distributed.run --nproc_per_node 1 <args>` started in
    the working directory (the repository on its path), its stdout and
    stderr into `log`.out / `log`.err -> the process."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    with open(f"{log}.out", "w") as out, open(f"{log}.err", "w") as err:
        return subprocess.Popen([sys.executable, "-m", "torch.distributed.run",
                                 "--nproc_per_node", "1", "--master_addr", "127.0.0.1",
                                 "--master_port", str(port), *args],
                                stdout=out, stderr=err, env=env)


def finish_torchrun(proc, log: str, what: str, timeout: int = 300) -> list[str]:
    """Wait for a start_torchrun process -> its stdout lines; the phase fails
    with its output when it does (a process past `timeout` is killed)."""
    import subprocess

    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "killed at its time limit"
    with open(f"{log}.out") as f:
        lines = f.read().splitlines()
    if rc != 0:
        with open(f"{log}.err") as f:
            err = f.read()
        raise SystemExit(f"phase 15: {what} failed ({rc}):\n" + "\n".join(lines[-40:])
                         + "\n" + err[-6000:])
    return lines


def tree_gaps(a, b, path: str = "") -> list[str]:
    """The paths at which two checkpoint trees differ (tensors bit for bit)."""
    if isinstance(a, torch.Tensor):
        return [] if isinstance(b, torch.Tensor) and torch.equal(a, b) else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [path]
        return [g for k in a for g in tree_gaps(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [path]
        return [g for i, (x, y) in enumerate(zip(a, b)) for g in tree_gaps(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


WS1_RUNS = {"eager": ("main", [*DP_FLAGS]), "graphed": ("main", [*DP_FLAGS, *DP_GRAPHED]),
            "byol": ("main_bt_byol", [*DP_FLAGS, *DP_BYOL])}


def start_world_size_1() -> dict:
    """(a): main --distributed under torchrun at world size 1 (NCCL), eager
    and graphed, and main_bt_byol --distributed, all started at once in the
    working directory -> {name: process}."""
    return {name: start_torchrun(["-m", f"ssl_audio_tpu_torch.{entry}", "--distributed",
                                  *flags, "--save_base_dir", f"dist_{name}", "--name",
                                  f"dist_{name}"], f"dist_{name}")
            for name, (entry, flags) in WS1_RUNS.items()}


def world_size_1_alone() -> dict:
    """(a): each entry point alone, in this process -> {name: run_main's result}."""
    from ssl_audio_tpu_torch.main_bt_byol import main as byol_main

    return {name: run_main([*flags, "--save_base_dir", f"one_{name}", "--name", f"one_{name}"],
                           byol_main if entry == "main_bt_byol" else None)
            for name, (entry, flags) in WS1_RUNS.items()}


def finish_world_size_1(procs: dict, one: dict) -> dict:
    """(a): the torchrun runs against the runs alone: the checkpoints
    (parameters, running statistics, optimizer, mixup bank, step,
    generators; the BYOL target) bit for bit, and the logged losses (the
    first step's, eagerly) and the epoch's loss line."""
    def ran(kind, name):
        (ck,) = glob.glob(f"{kind}_{name}/results/synthetic_wav/*/model_1.pt")
        (log,) = glob.glob(f"logs/training/synthetic_wav/*_{kind}_{name}*/log.csv")
        with open(log) as f:
            losses = [line.split(",")[5] for line in f if line.startswith("epoch,")]
        return torch.load(ck, map_location="cpu", weights_only=True), losses

    out = {}
    for name, (entry, _) in WS1_RUNS.items():
        lines = finish_torchrun(procs[name], f"dist_{name}", f"{entry} --distributed {name}")
        (dist_ck, dist_loss), (one_ck, one_loss) = ran("dist", name), ran("one", name)
        epoch = [next(x for x in ls if x.startswith("Epoch [1/1]")).split(" data_time")[0]
                 for ls in (lines, one[name][3])]
        gaps = tree_gaps(dist_ck, one_ck)
        print(f"  (a) {name}: {entry} --distributed (NCCL, world size 1) against {entry} "
              f"alone: {len(gaps)} checkpoint entries differ; logged losses {dist_loss} / "
              f"{one_loss}; {epoch[0]} / {epoch[1]}")
        if gaps or dist_loss != one_loss or epoch[0] != epoch[1]:
            raise SystemExit(f"phase 15 (a) {name}: the world-size-1 run departs from one "
                             f"process: {gaps[:8]}")
        out[name] = {"checkpoint_entries_differing": 0,
                     "logged_losses": [float(x) for x in dist_loss], "epoch_line": epoch[0]}
    return out


def phase_dp(seed: int, dev: torch.device, smi: str) -> dict:
    """Phase 15: data-parallel pretraining (--distributed).  (a) main under
    torchrun at world size 1 (NCCL), eager and with --steps_per_dispatch 4
    (its all-reduces captured in the graph), and main_bt_byol
    --stop_gradient --predictor, against each alone, bit for bit; (b) one step of AudioNTT2022 (global batch 128) and of ViT-B
    --fused_attention (32) on two gloo ranks sharing the card against one
    process on the global batch (DP_RTOL; the fused attention's loss
    DP_FUSED_LOSS_RTOL), the ranks bit for bit, each rank's launches
    counted; (c) ms per step under torchrun at world size 1 against one
    process, eager and graphed."""
    import gc

    from ssl_audio_tpu_torch.tools import data_parallel

    print("phase 15: data parallel (--distributed)")
    out = {"launches": {}, "seconds": {}}
    t0 = time.perf_counter()
    runs = {name: (overrides, batch) for name, (overrides, batch, _, _) in DP_RUNS.items()}
    one = {}

    def meanwhile():
        """(a)'s runs alone, then (b)'s one-process references."""
        one.update(world_size_1_alone())
        refs = {}
        for name, (overrides, batch) in runs.items():
            refs[name] = data_parallel.one_process_step(seed, overrides, batch)
            gc.collect()
            torch.cuda.empty_cache()
        return refs

    with tempfile.TemporaryDirectory() as work, contextlib.chdir(work):
        # (a) and (b) at once, neither of them timed: (a)'s torchrun processes
        # and (b)'s two gloo ranks on the card beside this process, which
        # makes (a)'s runs alone and (b)'s references meanwhile
        procs = start_world_size_1()
        ranks, refs = data_parallel.two_ranks_on_one_card(seed, runs, meanwhile=meanwhile)
        out["a_world_size_1"] = finish_world_size_1(procs, one)
        del one
        gc.collect()
        torch.cuda.empty_cache()
        out["seconds"]["a_b"] = time.perf_counter() - t0
        # (c) the step under torchrun at world size 1 against one process, alone on the card
        t1 = time.perf_counter()
        proc = start_torchrun(["-m", "ssl_audio_tpu_torch.tools.data_parallel", "--distributed",
                               "--seed", str(seed), "--steps", str(DP_TIMED_STEPS),
                               "--out", "dp.json"], "dp_timed")
        finish_torchrun(proc, "dp_timed", "the timed steps under torchrun")
        with open("dp.json") as f:
            dist = json.load(f)
    alone = data_parallel.timed(seed, DP_TIMED_STEPS, 4)
    out["c_time"] = {"card": smi, "world_size_1_nccl": dist, "one_process": alone}
    for k in ("eager", "graphed"):
        print(f"  (c) {k}: {dist[k + '_ms_per_step_median']:.3f} ms a step under torchrun "
              f"(NCCL, world size 1) against {alone[k + '_ms_per_step_median']:.3f} ms in one "
              f"process (batch {alone['global_batch']}; {smi})")
    out["seconds"]["c"] = time.perf_counter() - t1
    gc.collect()
    torch.cuda.empty_cache()
    # (b) two gloo ranks on the one card against one process
    out["b_two_ranks"] = {}
    for name, (_, batch, want, loss_rtol) in DP_RUNS.items():
        (r0, r1), ref = ranks[name], refs[name]
        same = r0["loss"] == r1["loss"] and r0["params_sha256"] == r1["params_sha256"]
        loss_err = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
        ref_step = (ref["params"] - ref["params_before"]).double()
        param_err = float((r0["params"].double() - ref["params"].double()).norm()
                          / ref["params"].double().norm())
        step_err = float((r0["params"].double() - ref["params_before"].double() - ref_step)
                         .norm() / ref_step.norm())
        out["b_two_ranks"][name] = {
            "global_batch": batch, "rows_per_rank": batch // 2, "loss": r0["loss"],
            "loss_one_process": ref["loss"], "loss_rel_err": loss_err,
            "params_rel_l2": param_err, "step_taken_rel_l2": step_err,
            "ranks_bit_for_bit": same, "launches_rank0": r0["launches"],
            "launches_rank1": r1["launches"], "launches_one_process": ref["launches"]}
        print(f"  (b) {name}: two gloo ranks x {batch // 2} rows on the card against one "
              f"process on {batch}: loss {r0['loss']:.6f} / {ref['loss']:.6f} (rel "
              f"{loss_err:.2e}), parameters rel L2 {param_err:.2e} (the step taken "
              f"{step_err:.2e}), ranks bit for bit {same}")
        for who, r in (("rank 0", r0), ("rank 1", r1), ("one process", ref)):
            expect(r["launches"], want, 1, f"phase 15 (b) {name} {who}")
        if not same or loss_err > loss_rtol or param_err > DP_RTOL:
            raise SystemExit(f"phase 15 (b) {name}: two ranks depart from one process")
        out["launches"][name] = r0["launches"]
    del ranks, refs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase 15 seconds by part: {json.dumps(out['seconds'])}")
    return out


# phase 16: the legacy DINO and BYOL-A families (main_pretrain --method
# dino|byola) at full width, batch 128, log-mels in.  Launches per step: the
# student's (online) two global views and the teacher's (target) two in
# train mode, the backward through the student's only; DINO ViT-B with two
# 16x16 local crops runs the student on four views (the locals at one patch
# + CLS, N = 2) and the teacher on two
LEGACY_BASE = ["--dataset", "synthetic", "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
               "--num_workers", "4"]
LEGACY_RUNS = {
    "dino_audiontt": (["--method", "dino", "--model_type", "audiontt"],
                      {"fused_conv1_fwd": 4, "fused_conv1_bwd": 2}),
    "dino_vitb_multicrop": (["--method", "dino", "--model_type", "vit_base",
                             "--fused_attention", "--local_crops_number", "2"],
                            {"fused_attention_fwd": 6 * VIT_DEPTH,
                             "fused_attention_bwd": 4 * VIT_DEPTH}),
    "byola_audiontt_bf16": (["--method", "byola", "--model_type", "audiontt", "--use_fp16"],
                            {"fused_conv1_fwd_bf16": 4, "fused_conv1_bwd_bf16": 2})}
LEGACY_EPOCH_STEPS = 3
LEGACY_TIMED_STEPS = 8
# the attention forwards of a DINO ViT-B multi-crop step by sequence length:
# the student's two global views and the teacher's two at 24 patches + CLS,
# the student's two local crops at N = 2
LEGACY_VIT_N = {VIT_TOKENS: 4 * VIT_DEPTH, 2: 2 * VIT_DEPTH}


@contextlib.contextmanager
def legacy_steps_counted(per_step: dict, what: str):
    """Inside: every step main_pretrain's LegacyTrainer makes
    (train/legacy_steps.py make_dino_train_step / make_byola_train_step) has
    the counters zeroed just before it and read just after (the device
    synchronised); each must be per_step, checked on leaving."""
    from ssl_audio_tpu_torch.train import legacy_steps

    makers = {n: getattr(legacy_steps, n) for n in ("make_dino_train_step",
                                                    "make_byola_train_step")}
    seen = []

    def counted_factory(make):
        def factory(*args, **kwargs):
            step = make(*args, **kwargs)

            def counted(*a, **kw):
                zero_launch_counts()
                out = step(*a, **kw)
                torch.cuda.synchronize()
                seen.append(launch_counts())
                return out
            return counted
        return factory

    for n, make in makers.items():
        setattr(legacy_steps, n, counted_factory(make))
    try:
        yield seen
    finally:
        for n, make in makers.items():
            setattr(legacy_steps, n, make)
    want = counts_with(**per_step)
    bad = [c for c in seen if c != want]
    if not seen or bad:
        raise SystemExit(f"{what}: {len(bad)} of {len(seen)} steps launched other than "
                         f"{per_step}: {bad[:2]}")
    print(f"  {what}: each of {len(seen)} steps launched {per_step}")


def attention_lengths(trainer) -> tuple[dict, list]:
    """Forward pre-hooks on every attention module of the student and the
    teacher: -> (a count of their inputs' sequence lengths, the hooks)."""
    from ssl_audio_tpu_torch.models.vit import AttentionKBiasZero

    seen: dict = {}
    hooks = []
    for m in trainer.state.modules.modules():
        if isinstance(m, AttentionKBiasZero):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, args: seen.__setitem__(args[0].shape[1],
                                                   seen.get(args[0].shape[1], 0) + 1)))
    return seen, hooks


def legacy_resident_time(trainer, seed: int, smi: str) -> dict:
    """The trainer's step on one seeded log-mel batch resident on the card:
    two warm-ups, LEGACY_TIMED_STEPS timed (median ms, clips/s), one step
    profiled (device busy, idle share)."""
    from ssl_audio_tpu_torch.tools.serving import profile
    from ssl_audio_tpu_torch.tools.train_profile import step_wall_ms

    cfg = trainer.cfg
    batch = torch.randn(TRAIN_BATCH, 1, cfg.n_mels, cfg.crop_frames,
                        generator=torch.Generator().manual_seed(seed + 3)).cuda()
    args = ((0.04, 0.998) if trainer.method == "dino" else ())

    def run():
        return trainer.step(trainer.state, batch, *args, gen=trainer.gen)

    losses = [float(run()["loss"]) for _ in range(2)]
    times = step_wall_ms(run, LEGACY_TIMED_STEPS)
    p = profile(run)
    if not all(v == v and abs(v) != float("inf") for v in losses):
        raise SystemExit(f"non-finite loss among {losses}")
    med = statistics.median(times)
    return {"ms_per_step_median": med, "ms_per_step_min": min(times),
            "steps_timed": len(times), "clips_per_s": TRAIN_BATCH / med * 1e3,
            "profile": {"wall_ms": p["wall_ms"], "device_busy_ms": p["device_busy_ms"],
                        "idle_share": p["idle_share"], "launches_seen": p["launches_seen"]},
            "card": smi}


def legacy_card_vs_cpu(seed: int, dev: torch.device, method: str, overrides: dict,
                       zero_grad: tuple, grad_rtol: float, why: str,
                       global_rtol: float | None = None) -> dict:
    """One batch-16 legacy step on the card against the same step on the CPU
    (plain versions): the same seeded weights, batch and draws.  Limits: the
    loss (STEP_LOSS_RTOL, relative), the worst gradient tensor (relative L2)
    and, if given, all gradients at once; the target after the EMA and the
    DINO centre within EMA_RTOL (the EMA of the updated parameters: Adam's
    first step, ~lr sign(g), moves an element whose gradient is float noise
    by up to 2 lr the other way, so the online parameters are not held)."""
    from ssl_audio_tpu_torch.config import default_config
    from ssl_audio_tpu_torch.train import legacy_steps

    batch = torch.randn(16, 1, 64, TRAIN_FRAMES, generator=torch.Generator().manual_seed(seed + 7))
    runs = []
    for where in ("cpu", dev):
        # no warm-up: the first step's lr is not 0, so the target's EMA moves
        cfg = default_config(method=method, dataset="synthetic", batch_size=16,
                             device=str(where), seed=seed, warmup_epochs=0, **overrides)
        state = legacy_steps.init_legacy_state(cfg, torch.Generator().manual_seed(seed), method,
                                               niter_per_ep=4, device=where)
        draws = legacy_steps.draw_legacy_step(torch.Generator().manual_seed(seed + 9), cfg,
                                              tuple(batch.shape), state.modules["encoder"])
        if method == "dino":
            step = legacy_steps.make_dino_train_step(cfg)
            m = step(state, batch.to(where), 0.04, 0.996, draws=draws.to(where))
        else:
            m = legacy_steps.make_byola_train_step(cfg)(state, batch.to(where),
                                                        draws=draws.to(where))
        grads = {f"{name}.{k}": p.grad.detach().cpu() for name, m in state.modules.items()
                 if name != "target" for k, p in m.named_parameters() if p.grad is not None}
        target = {k: p.detach().cpu() for k, p in state.modules["target"].named_parameters()}
        center = None if state.center is None else state.center.cpu()
        runs.append((float(m["loss"]), grads, target, center))
    (loss_c, grads_c, tgt_c, ctr_c), (loss_d, grads_d, tgt_d, ctr_d) = runs
    loss_err = abs(loss_d - loss_c) / abs(loss_c)
    worst, worst_name, sq_diff, sq_ref = 0.0, "", 0.0, 0.0
    for k, g in grads_c.items():
        if k in zero_grad or not g.any():
            continue
        diff = grads_d[k].double() - g.double()
        rel = float(diff.norm() / g.double().norm())
        sq_diff += float(diff.norm()) ** 2
        sq_ref += float(g.double().norm()) ** 2
        if rel > worst:
            worst, worst_name = rel, k
    overall = (sq_diff / sq_ref) ** 0.5
    gaps = {k: float((tgt_d[k].double() - v.double()).abs().max() / v.abs().max().clamp_min(1e-30))
            for k, v in tgt_c.items() if v.any()}
    tgt_worst = max(gaps, key=gaps.get)
    label = f"{method} {overrides}, card vs CPU"
    print(f"  small step (batch 16, {label}): loss {loss_d!r} vs {loss_c!r}; gradients worst "
          f"relative L2 {worst:.2e} ({worst_name}), all at once {overall:.2e}; target after "
          f"the EMA largest gap {gaps[tgt_worst]:.2e} ({tgt_worst})")
    check(f"legacy step loss, {label}, relative", loss_err, STEP_LOSS_RTOL, why)
    check(f"legacy step gradients, {label}, relative L2 per tensor", worst, grad_rtol, why)
    if global_rtol is not None:
        check(f"legacy step gradients, {label}, relative L2 all at once", overall, global_rtol,
              why)
    out = {"loss_rel_err": loss_err, "grad_rel_l2_err": worst, "worst_grad": worst_name,
           "grad_rel_l2_err_all": overall, "target_worst": tgt_worst,
           "target_rel_gap_after_ema": gaps[tgt_worst]}
    if ctr_c is not None:
        out["center_rel_err"] = float((ctr_d - ctr_c).abs().max() / ctr_c.abs().max())
        check(f"DINO centre, {label}, / max|centre|", out["center_rel_err"], STEP_LOSS_RTOL,
              "the teacher's outputs: fp32 through the encoder in another order")
    return out


def legacy_probe(ckpt: str, seed: int, dev: torch.device) -> dict:
    """(a)'s checkpoint through the linear CLI's model loader (a Barlow Twins
    state whose encoder load_encoder_checkpoint grafts from the legacy
    file), scored by eval_linear over phase 8's seeded loaders; the
    grafted encoder must equal the trainer's."""
    from ssl_audio_tpu_torch.config import default_config
    from ssl_audio_tpu_torch.data.datasets import SyntheticLMS
    from ssl_audio_tpu_torch.data.pipeline import DataLoader
    from ssl_audio_tpu_torch.eval.linear import eval_linear, make_embedding_forward
    from ssl_audio_tpu_torch.linear import load_model

    cfg = default_config(dataset="synthetic", seed=seed)
    encoder = load_model(cfg, ckpt)
    loaders = [DataLoader(SyntheticLMS(cfg, length=n, n_classes=EVAL_CLASSES, seed=i),
                          batch_size=cfg.batch_size, shuffle=False, drop_last=False,
                          num_workers=4)
               for i, n in enumerate(EVAL_ITEMS.values())]
    forward = make_embedding_forward(cfg, encoder)
    forward(torch.zeros(2, 1, 64, 96, device=dev))     # warm-up
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = eval_linear(forward, *loaders, max_iter=EVAL_MAX_ITER, device=dev)
    torch.cuda.synchronize()
    rec = {"score_all_map": scores["score_all"], "score_5_map_mean_std": list(scores["score_5"]),
           "eval_linear_s": time.perf_counter() - t0, "launches": launch_counts()}
    if not 0.0 < rec["score_all_map"] <= 1.0:
        raise SystemExit(f"(d) legacy checkpoint probe: score {rec['score_all_map']}")
    return rec, encoder


def phase_legacy(seed: int, dev: torch.device, smi: str) -> dict:
    """Phase 16: (a)-(c) main_pretrain's LegacyTrainer for each LEGACY_RUNS
    entry (one epoch of LEGACY_EPOCH_STEPS steps, each step's launches
    counted; (a) through run_legacy, its checkpoint written), then timed on a
    resident batch; (d) (a)'s checkpoint scored through
    load_encoder_checkpoint; (e) small steps card vs CPU."""
    import gc

    from ssl_audio_tpu_torch import main_pretrain

    print("phase 16: the legacy DINO and BYOL-A families (main_pretrain --method dino|byola) "
          "at full width, batch 128, log-mels in")
    out = {"card": smi, "launches": {}, "seconds": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_legacy_") as tmp, contextlib.chdir(tmp):
        for key, (flags, per_step) in LEGACY_RUNS.items():
            t0 = time.perf_counter()
            cfg, method = main_pretrain.config_for(
                flags + LEGACY_BASE + ["--synthetic_steps_per_epoch", str(LEGACY_EPOCH_STEPS),
                                       "--seed", str(seed)])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            log = io.StringIO()
            with legacy_steps_counted(per_step, f"({key})"), contextlib.redirect_stdout(log):
                if key == "dino_audiontt":
                    trainer = main_pretrain.run_legacy(cfg, method)
                else:
                    trainer = main_pretrain.LegacyTrainer(cfg, method)
                    lengths, hooks = attention_lengths(trainer)
                    trainer.fit()
                    for h in hooks:
                        h.remove()
            if trainer.device.type != "cuda":
                raise SystemExit(f"({key}) trained on {trainer.device}, not the card")
            lines = [ln for ln in log.getvalue().splitlines()
                     if ln.startswith(f"[{method}] epoch")]
            if len(lines) != 1 or not lines[0].startswith(f"[{method}] epoch 1/1 loss="):
                raise SystemExit(f"({key}): the epoch lines {lines}")
            rec = {"flags": flags, "steps": LEGACY_EPOCH_STEPS,
                   "mean_loss": trainer.epoch_losses[1], "launches_per_step": per_step,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated() - base}
            if key == "dino_vitb_multicrop":
                want = {n: LEGACY_EPOCH_STEPS * c for n, c in LEGACY_VIT_N.items()}
                if lengths != want:
                    raise SystemExit(f"({key}): attention forwards by sequence length "
                                     f"{lengths}, expected {want}")
                rec["attention_forwards_by_n"] = {str(n): c for n, c in lengths.items()}
            out["launches"][f"legacy_{key}"] = counts_with(**per_step)
            if key == "dino_audiontt":
                ckpt = os.path.join(tmp, "results", "synthetic", "dino_audiontt", "model_1.pt")
                probe, encoder = legacy_probe(ckpt, seed, dev)
                want = trainer.state.modules["encoder"].state_dict()
                if not all(torch.equal(v, want[k]) for k, v in encoder.state_dict().items()):
                    raise SystemExit("(d): the grafted encoder is not the trainer's")
                out["d_probe"] = probe
                out["launches"]["legacy_probe"] = probe["launches"]
                print(f"  (d) the DINO checkpoint through load_encoder_checkpoint: "
                      f"{json.dumps(probe)}")
                del encoder
            # the resident batch's steps move the state on: after the checkpoint's check
            rec["time"] = legacy_resident_time(trainer, seed, smi)
            out[key] = rec
            out["seconds"][key] = time.perf_counter() - t0
            print(f"  ({key}) {json.dumps(rec)}")
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["e_cpu_check"] = {
        "dino_audiontt": legacy_card_vs_cpu(
            seed, dev, "dino", dict(dino_out_dim=1024), ("encoder.features.0.bias",
                                                         "encoder.features.4.bias"),
            STEP_GRAD_RTOL, "pool and ReLU decisions flip on 1e-7 input differences"),
        "dino_vit_tiny_multicrop_fused": legacy_card_vs_cpu(
            seed, dev, "dino", dict(model_type="vit_tiny", fused_attention=True,
                                    local_crops_number=2, dino_out_dim=1024), (),
            VIT_FUSED_GRAD_RTOL, "bf16 roundings flipped by 1e-7 differences, amplified",
            VIT_FUSED_GLOBAL_RTOL)}
    out["seconds"]["e_cpu_check"] = time.perf_counter() - t0
    print(f"  phase 16 seconds by part: {json.dumps(out['seconds'])}")
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
    t11 = time.perf_counter()
    bf16_rows, bf16 = phase_bf16(args.seed, dev, smi)
    print(f"  phase 11: {time.perf_counter() - t11:.1f} s")
    t9 = time.perf_counter()
    pretraining = phase_pretraining(args.seed, dev, smi)
    print(f"  phase 9: {time.perf_counter() - t9:.1f} s")
    t10 = time.perf_counter()
    disk = phase_disk(args.seed, dev, smi, training["ms_per_step_median"])
    print(f"  phase 10: {time.perf_counter() - t10:.1f} s")
    t12 = time.perf_counter()
    graphs = phase_graphs(args.seed, smi)
    print(f"  phase 12: {time.perf_counter() - t12:.1f} s")
    t13 = time.perf_counter()
    byol = phase_byol(args.seed, dev, smi)
    print(f"  phase 13: {time.perf_counter() - t13:.1f} s")
    t14 = time.perf_counter()
    zoo = phase_zoo(args.seed, dev, smi)
    print(f"  phase 14: {time.perf_counter() - t14:.1f} s")
    t15 = time.perf_counter()
    dp = phase_dp(args.seed, dev, smi)
    print(f"  phase 15: {time.perf_counter() - t15:.1f} s")
    t16 = time.perf_counter()
    legacy = phase_legacy(args.seed, dev, smi)
    print(f"  phase 16: {time.perf_counter() - t16:.1f} s")
    next(k for k in kernels if k["name"] == "log_mel_folded")["converter_shape"] = \
        disk["convert_mel_row"]
    # launches on the main paths, per path (timestamp request, scene request,
    # one AudioNTT train step, one ViT-B train step, the ViT timestamp and
    # scene requests, eval_linear with each encoder; phase 9: one step of
    # each pretraining run, the timestamp request from a checkpoint, one
    # step and one probe of the learning proof; phase 10: one wav_to_lms
    # group, one step and one probe of main on FSD50K, one audioset_wav step,
    # one --load_wav step, one step of the resumed FSD50K run, the linear
    # CLI's probe, (g) one --use_fp16 step and its bf16 probe, the linear
    # CLI --use_fp16_eval; phase 11: one step of main --use_fp16 for
    # AudioNTT2022 and for ViT-B, the bf16 HEAR requests of both models;
    # phase 12: a graphed step of each configuration; phase 13: one BYOL step
    # of each main_bt_byol run, a graphed BYOL step, and the reproduce chain's
    # convert, pretrain, probe and HEAR stages; phase 14: one step of each
    # new encoder's runs, the SE run's probe, a graphed step of each, the
    # HEAR ResNet requests; phase 15: rank 0's step of each two-rank run;
    # phase 16: one step of DINO AudioNTT2022, of DINO ViT-B with two local
    # crops and of BYOL-A --use_fp16, and the DINO checkpoint's probe) and
    # in all
    kernels += bf16_rows
    by_path = {**serving["launches"], "train": training["launches"],
               "train_vit": training_vit["launches"], **serving_vit["launches"],
               **evaluation["launches"], **pretraining["launches"], **disk["launches"],
               **bf16["launches"], **graphs["launches"], **byol["launches"],
               **zoo["launches"], **dp["launches"], **legacy["launches"]}
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
