"""Seeded HEAR serving setup of the port, the card's timing helpers, and a
device-time profile of its requests on the card.

    python3 -m ssl_audio_tpu_torch.tools.serving [--seed 0] [--clips 16]

Builds AudioNTT2022 at full width (64 mels, d = 3072, fp32, fused_conv=True)
with random weights from a torch.Generator, answers one warm-up timestamp
and scene request for `clips` seeded 10-s clips, then profiles one of each
with torch.profiler and prints, per request, the wall time, the device time
by kernel (largest first) and the device's idle share (1 - device busy /
wall).  chip_smoke.py uses the same setup for its serving phase.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

SAMPLE_RATE = 16000


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds per call, CUDA events around `iters` calls
    after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def seeded_clips(gen: torch.Generator, n: int, samples: int) -> torch.Tensor:
    """(n, samples) float32 clips: three tones of random pitch plus noise,
    amplitude ~0.3, drawn from `gen`."""
    t = torch.arange(samples, dtype=torch.float64) / SAMPLE_RATE
    freqs = 100.0 + 4000.0 * torch.rand(n, 3, 1, generator=gen, dtype=torch.float64)
    tones = torch.sin(2 * torch.pi * freqs * t).sum(1) * 0.1
    noise = 0.1 * torch.randn(n, samples, generator=gen, dtype=torch.float64)
    return (tones + noise).float()


def seeded_serving_model(gen: torch.Generator, device="cuda"):
    """hear.conv.load_model("", "audiontt", fused_conv=True) with weights
    redrawn from `gen`: lecun-normal kernels, BatchNorm scales around 1 with
    a quarter negative, random shifts and running statistics."""
    from ssl_audio_tpu_torch.hear import conv as hear_conv
    from ssl_audio_tpu_torch.models.audiontt import init_weights_

    model = hear_conv.load_model("", "audiontt", fused_conv=True, device=device)
    net = model.model.cpu()
    init_weights_(net, gen)
    with torch.no_grad():
        for bn in (net.features[1], net.features[5]):
            c = bn.num_features
            bn.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=gen))
            bn.weight[: c // 4] *= -1.0
            bn.bias.copy_(0.2 * torch.randn(c, generator=gen))
            bn.running_mean.copy_(0.5 * torch.randn(c, generator=gen))
            bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    net.to(model.device).eval()
    return model


def profile(fn) -> dict:
    """Wall ms of one call of fn (ending in a synchronise), device ms by
    kernel name and the device's idle share, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + dev_us / 1e3
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "device_ms_by_kernel": dict(top[:15])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clips", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile is a device measurement")
    from ssl_audio_tpu_torch.hear import conv as hear_conv

    smi = smi_line()
    gen = torch.Generator().manual_seed(args.seed)
    model = seeded_serving_model(gen)
    audio = seeded_clips(gen, args.clips, 10 * SAMPLE_RATE)
    requests = {
        "timestamp": lambda: hear_conv.get_timestamp_embeddings(audio, model),
        "scene": lambda: hear_conv.get_scene_embeddings(audio, model),
    }
    for fn in requests.values():
        fn()                                    # warm-up: kernel build, cuDNN plans
    for name, fn in requests.items():
        print(json.dumps({"request": name, "clips": args.clips, "card": smi,
                          **profile(fn)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
