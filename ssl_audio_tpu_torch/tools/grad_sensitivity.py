"""How far two fp32 runs of one Barlow Twins training step may differ: the
gradients' sensitivity to tiny input differences, and the card against the
CPU.

    python3 -m ssl_audio_tpu_torch.tools.grad_sensitivity --device cpu
    python3 -m ssl_audio_tpu_torch.tools.grad_sensitivity            # on the card

One step at full width (batch 16 by default, seeded weights, seeded 2-s
clips, the same draws every time).  With --device cpu: the step's gradients
for the wavs against the gradients for the wavs plus noise of 1e-7 and 1e-6
of their peak.  On the card: the card's gradients against the CPU's (plain
versions) for the same wavs.  Per comparison it prints the largest relative
L2 difference over the parameter tensors and the largest single-element
difference relative to its tensor's largest value (conv biases before a
batch norm are left out: their gradient is zero plus float noise).  The
step's pool and ReLU decisions are discrete, so a difference in the seventh
digit of the input flips a few of them: single elements move by percents
while the tensors' L2 error stays around 1e-3..1e-2.  chip_smoke.py's
tolerance for its card-against-CPU step comes from these numbers.
"""
from __future__ import annotations

import argparse
import json

import torch

from ssl_audio_tpu_torch.tools.serving import SAMPLE_RATE, seeded_clips
from ssl_audio_tpu_torch.tools.train_profile import seeded_training
from ssl_audio_tpu_torch.train.steps import draw_step
from ssl_audio_tpu_torch.utils import resolve_device

ZERO_GRADIENT = ("encoder.features.0.bias", "encoder.features.4.bias")


def step_gradients(seed: int, batch: int, device, wavs: torch.Tensor) -> dict:
    """Gradients (float64, on the CPU) of one step from seeded weights and draws."""
    cfg, state, step, _ = seeded_training(seed, device, batch_size=batch)
    draws = draw_step(torch.Generator().manual_seed(seed + 9), cfg, tuple(wavs.shape),
                      2048, wav=True)
    step(state, wavs.to(device), draws=draws.to(device))
    return {k: p.grad.detach().double().cpu() for k, p in state.modules.named_parameters()}


def difference(a: dict, b: dict) -> dict:
    """Largest per-tensor relative L2 and single-element differences of b from a."""
    worst_l2 = worst_elem = 0.0
    for k, g in a.items():
        if k in ZERO_GRADIENT:
            continue
        diff = b[k] - g
        worst_l2 = max(worst_l2, float(diff.norm() / g.norm()))
        worst_elem = max(worst_elem, float(diff.abs().max() / g.abs().max()))
    return {"rel_l2": worst_l2, "max_element": worst_elem}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help='"cuda" by default; "cpu" for the CPU study')
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args()
    device = resolve_device(args.device)
    for seed in args.seeds:
        wavs = seeded_clips(torch.Generator().manual_seed(seed + 7), args.batch,
                            2 * SAMPLE_RATE)
        base = step_gradients(seed, args.batch, "cpu", wavs)
        row = {"seed": seed, "batch": args.batch, "device": str(device)}
        if device.type == "cpu":
            noise = torch.randn(wavs.shape, generator=torch.Generator().manual_seed(5))
            for eps in (1e-7, 1e-6):
                other = step_gradients(seed, args.batch, "cpu",
                                       wavs + eps * float(wavs.abs().max()) * noise)
                row[f"perturbed_{eps:g}"] = difference(base, other)
        else:
            row["card"] = torch.cuda.get_device_name(0)
            row["card_vs_cpu"] = difference(base, step_gradients(seed, args.batch, device, wavs))
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
