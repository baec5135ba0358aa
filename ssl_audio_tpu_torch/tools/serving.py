"""Seeded HEAR serving setup of the port, the card's timing helpers, and a
device-time profile of its requests on the card.

    python3 -m ssl_audio_tpu_torch.tools.serving [--seed 0] [--clips 16] [--timed N]

Also the card's timing helpers: cuda_ms (events around back-to-back calls),
device_ms (each call timed on the device alone, warm or with L2 flushed
between calls) and host_ms (the host's enqueue time per call).

Builds AudioNTT2022 at full width (64 mels, d = 3072, fp32, fused_conv=True)
with random weights from a torch.Generator, answers one warm-up timestamp
and scene request for `clips` seeded 10-s clips, then profiles one of each
with torch.profiler and prints, per request, the wall time, the device time
by kernel (largest first) and the device's idle share (1 - device busy /
wall).  With --timed N it times N requests of each kind instead (host clock
around each, ending in a synchronise; three warm-ups) and prints their
median and minimum: an A/B of two checkouts runs this file with each
checkout's root first on PYTHONPATH, `PYTHONPATH=<root> python3
<this file> --timed 15`, in turns.  chip_smoke.py uses the same setup for
its serving phase, and seeded_vit_serving_model (vitc_base 16x8) for its
ViT serving phase.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
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
    """Mean milliseconds per call, CUDA events around `iters` calls after 3
    warm-up calls.  Where a call's host work outlasts its kernels this times
    the host: use device_ms for short kernels."""
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


_sleep_cycles_per_ms: list[float] = []
_L2_FLUSH_BYTES = 128 << 20          # well above the H100's 50 MB L2


def _cycles_per_ms() -> float:
    """torch.cuda._sleep's spin cycles per device millisecond (measured once)."""
    if not _sleep_cycles_per_ms:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(5_000_000)
        end.record()
        end.synchronize()
        _sleep_cycles_per_ms.append(5_000_000 / start.elapsed_time(end))
    return _sleep_cycles_per_ms[0]


def _queued(fn, iters: int, flush: torch.Tensor | None) -> tuple[float, float]:
    """Enqueue `iters` calls behind a spin kernel that outlasts the host's
    enqueueing, each call between its own pair of CUDA events (after an L2
    flush if `flush` is given).  -> (device ms per call: the mean of the
    pairs, host ms per call: the enqueueing's wall time)."""
    t0 = time.perf_counter()
    fn()
    if flush is not None:
        flush.zero_()
    guess_ms = (time.perf_counter() - t0) * 1e3 * iters
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for attempt in range(4):
        asleep = torch.cuda.Event(enable_timing=True)
        awake = torch.cuda.Event(enable_timing=True)
        asleep.record()
        torch.cuda._sleep(int(_cycles_per_ms() * (2 * guess_ms + 1)))
        awake.record()
        t0 = time.perf_counter()
        for start, end in pairs:
            if flush is not None:
                flush.zero_()
            start.record()
            fn()
            end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms < asleep.elapsed_time(awake):      # the queue never ran dry
            break
        guess_ms = 2 * host_ms
    else:
        raise RuntimeError("the device caught up with the host: not a device time")
    return sum(s.elapsed_time(e) for s, e in pairs) / iters, host_ms / iters


def device_ms(fn, iters: int = 20, cold: bool = False) -> float:
    """Device milliseconds per call: after 3 warm-up calls, `iters` calls
    queued behind a spin kernel (torch.cuda._sleep) long enough that the host
    has enqueued them all before the device starts, each timed by its own
    pair of CUDA events; so the host's per-call work is not in the time.
    cold=True writes 128 MB between calls, so each call finds its inputs
    out of the 50 MB L2 (as a training step does), outside the events."""
    for _ in range(3):
        fn()
    flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda") if cold else None
    return _queued(fn, iters, flush)[0]


def host_ms(fn, iters: int = 20) -> float:
    """The host's milliseconds per call while the device is busy behind a
    spin kernel: the wrapper's own work (argument checks, allocation,
    launch), without waiting on the device."""
    for _ in range(3):
        fn()
    return _queued(fn, iters, None)[1]


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


def seeded_vit_serving_model(gen: torch.Generator, device="cuda"):
    """hear.vit.load_model() (vitc_base, 16x8 patches) with weights redrawn
    from `gen` (the JAX module's initialisers) and the ConvStem's BatchNorm
    scales, shifts and running statistics drawn from `gen`."""
    from ssl_audio_tpu_torch.hear import vit as hear_vit
    from ssl_audio_tpu_torch.models.vit import init_vit_weights_

    model = hear_vit.load_model(device=device)
    net = model.model.cpu()
    init_vit_weights_(net, gen)
    with torch.no_grad():
        for bn in net.modules():
            if isinstance(bn, torch.nn.modules.batchnorm._BatchNorm):
                c = bn.num_features
                bn.weight.copy_(1.0 + 0.3 * torch.randn(c, generator=gen))
                bn.bias.copy_(0.2 * torch.randn(c, generator=gen))
                bn.running_mean.copy_(0.5 * torch.randn(c, generator=gen))
                bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
    net.to(model.device).eval()
    return model


def short_kernel_name(name: str) -> str:
    """A profiler kernel name without its return type, namespaces' anonymity,
    template arguments and parameters: "fused_conv1_fwd_kernel",
    "fused_conv::reduce_columns_kernel", "at::native::reduce_kernel"."""
    name = name.replace("(anonymous namespace)::", "")
    return re.match(r"(?:void\s+)?([\w:]*)", name).group(1) or name


# the port's kernels by the launch counter of their wrapper (ops.launch_counts)
_COUNTERS = (("log_mel_kernel<true", "log_mel_folded"), ("log_mel_kernel<false", "log_mel_unfolded"),
             ("fused_conv1_fwd_kernel<", "fused_conv1_fwd"),
             ("fused_conv1_bwd_kernel<", "fused_conv1_bwd"),
             ("fused_conv1_dx_kernel", "fused_conv1_dx"),
             ("fused_attention_fwd_kernel<", "fused_attention_fwd"),
             ("fused_attention_bwd_kernel<", "fused_attention_bwd"))


def launches_seen(calls_by_kernel: dict) -> dict[str, int]:
    """The port's kernel launches among a profile's kernel events (kernel
    name -> calls), under ops.launch_counts()'s keys: what the device ran,
    to hold the wrappers' counters against."""
    out: dict[str, int] = {}
    for name, calls in calls_by_kernel.items():
        for pattern, counter in _COUNTERS:
            if pattern in name:
                args = name[name.index(pattern) + len(pattern):].split(">")[0]
                key = counter + ("_bf16" if "bfloat16" in args else "")
                out[key] = out.get(key, 0) + calls
    return out


def per_launch_ms(fn) -> dict:
    """Device ms of each kernel one call of fn launches, by short name
    (torch.profiler, after one call outside the trace)."""
    fn()
    out: dict[str, float] = {}
    for name, ms in profile(fn)["device_ms_by_kernel"].items():
        key = short_kernel_name(name)
        out[key] = out.get(key, 0.0) + ms
    return out


def profile(fn) -> dict:
    """Wall ms of one call of fn (ending in a synchronise), device ms by
    kernel name, the device's idle share, the host's own ms by operation
    (CPU self time: where the host spends a host-bound call) and the port's
    kernel launches the device ran (launches_seen), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, calls, host = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU and e.self_cpu_time_total > 0:
            host[e.key] = e.self_cpu_time_total / 1e3
        dev_us = getattr(e, "self_device_time_total", 0.0)
        # a user annotation (Optimizer.step#...) repeats its kernels' time
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            by_kernel[e.key] = by_kernel.get(e.key, 0.0) + dev_us / 1e3
            calls[e.key] = calls.get(e.key, 0) + e.count
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    top_host = sorted(host.items(), key=lambda kv: -kv[1])
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "device_ms_by_kernel": dict(top[:15]),
            "host_self_ms_by_op": dict(top_host[:12]), "launches_seen": launches_seen(calls)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clips", type=int, default=16)
    ap.add_argument("--timed", type=int, default=0,
                    help="time this many requests of each kind instead of profiling one")
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
    if args.timed:
        import ssl_audio_tpu_torch

        out = {"package": ssl_audio_tpu_torch.__file__, "clips": args.clips, "card": smi}
        for name, fn in requests.items():
            for _ in range(3):
                fn()
            times = []
            for _ in range(args.timed):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[name] = {"median_ms": statistics.median(times), "min_ms": min(times)}
        print(json.dumps(out))
        return 0
    for fn in requests.values():
        fn()                                    # warm-up: kernel build, cuDNN plans
    for name, fn in requests.items():
        print(json.dumps({"request": name, "clips": args.clips, "card": smi,
                          **profile(fn)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
