"""How far two fp32 runs of one Barlow Twins training step may differ: the
gradients' sensitivity to tiny input differences, and the card against the
CPU.

    python3 -m ssl_audio_tpu_torch.tools.grad_sensitivity --device cpu
    python3 -m ssl_audio_tpu_torch.tools.grad_sensitivity            # on the card
    ... [--model_type vit_tiny [--fused_attention] [--mask_ratio 0.75]]

One step at full width (batch 16 by default, seeded weights, seeded 2-s
clips, the same draws every time), of AudioNTT2022 or, with --model_type, a
ViT (the teacher masked by key bias at --mask_ratio).  With --device cpu: the step's gradients
for the wavs against the gradients for the wavs plus noise of 1e-7 and 1e-6
of their peak.  On the card: the card's gradients against the CPU's (plain
versions) for the same wavs.  Per comparison it prints the largest relative
L2 difference over the parameter tensors and the largest single-element
difference relative to its tensor's largest value (parameters whose
gradient is zero plus float noise are left out: conv biases before a batch
norm, a ViT's final LayerNorm bias before the projector's).  AudioNTT's
pool and ReLU decisions are discrete, so a difference in the seventh digit
of the input flips a few of them: single elements move by percents while
the tensors' L2 error stays around 1e-3..1e-2.  The fused attention rounds
its operands to bf16, where a seventh-digit difference flips a rounding the
same way.  chip_smoke.py's tolerances for its card-against-CPU steps come
from these numbers.
"""
from __future__ import annotations

import argparse
import json
import statistics

import torch

from ssl_audio_tpu_torch.tools.serving import SAMPLE_RATE, seeded_clips
from ssl_audio_tpu_torch.tools.train_profile import seeded_training
from ssl_audio_tpu_torch.train.steps import draw_step
from ssl_audio_tpu_torch.utils import resolve_device

ZERO_GRADIENT = ("encoder.features.0.bias", "encoder.features.4.bias", "encoder.norm.bias")


def step_gradients(seed: int, batch: int, device, wavs: torch.Tensor, overrides=None,
                   mask_ratio: float = 0.0) -> dict:
    """Gradients (float64, on the CPU) of one step from seeded weights and draws."""
    cfg, state, step, _ = seeded_training(seed, device, batch_size=batch, **(overrides or {}))
    draws = draw_step(torch.Generator().manual_seed(seed + 9), cfg, tuple(wavs.shape),
                      state.modules["encoder"], wav=True)
    step(state, wavs.to(device), draws=draws.to(device), mask_ratio=mask_ratio)
    return {k: p.grad.detach().double().cpu() for k, p in state.modules.named_parameters()
            if p.grad is not None}


def difference(a: dict, b: dict) -> dict:
    """Largest and median per-tensor relative L2, the relative L2 of all
    gradients as one vector, and the largest single-element difference
    (relative to its tensor's largest value) of b from a."""
    rel, elem, sq_diff, sq_ref = [], 0.0, 0.0, 0.0
    for k, g in a.items():
        if k in ZERO_GRADIENT:
            continue
        diff = b[k] - g
        rel.append(float(diff.norm() / g.norm()))
        elem = max(elem, float(diff.abs().max() / g.abs().max()))
        sq_diff += float(diff.norm()) ** 2
        sq_ref += float(g.norm()) ** 2
    return {"rel_l2": max(rel), "rel_l2_median": statistics.median(rel),
            "rel_l2_all": (sq_diff / sq_ref) ** 0.5, "max_element": elem}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help='"cuda" by default; "cpu" for the CPU study')
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--model_type", default="audiontt")
    ap.add_argument("--fused_attention", action="store_true")
    ap.add_argument("--mask_ratio", type=float, default=0.0)
    args = ap.parse_args()
    device = resolve_device(args.device)
    overrides = {}
    if args.model_type != "audiontt":
        overrides = dict(model_type=args.model_type, fused_attention=args.fused_attention)

    def grads(seed, where, wavs):
        return step_gradients(seed, args.batch, where, wavs, overrides, args.mask_ratio)

    for seed in args.seeds:
        wavs = seeded_clips(torch.Generator().manual_seed(seed + 7), args.batch,
                            2 * SAMPLE_RATE)
        base = grads(seed, "cpu", wavs)
        row = {"seed": seed, "batch": args.batch, "device": str(device), **overrides,
               "mask_ratio": args.mask_ratio}
        if device.type == "cpu":
            noise = torch.randn(wavs.shape, generator=torch.Generator().manual_seed(5))
            for eps in (1e-7, 1e-6):
                other = grads(seed, "cpu", wavs + eps * float(wavs.abs().max()) * noise)
                row[f"perturbed_{eps:g}"] = difference(base, other)
        else:
            row["card"] = torch.cuda.get_device_name(0)
            row["card_vs_cpu"] = difference(base, grads(seed, device, wavs))
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
