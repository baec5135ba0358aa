#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ssl_audio_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. builds every CUDA kernel from csrc/ with nvcc (one process per source,
     all at once) and prints the build seconds and ptxas register reports;
  3. holds each kernel against its plain PyTorch version on the card at the
     serving path's shapes, with the tolerances below, and times kernel,
     plain version and the PyTorch library yardstick with CUDA events;
  4. serving: AudioNTT2022 at full width (64 mels, d = 3072, fp32,
     fused_conv=True) with seeded random weights answers a timestamp request
     and a scene request for 16 seeded 10-s clips through the HEAR API; the
     kernels' launch counters are zeroed just before each request and read
     just after it, and a small request is held against the same model on
     the CPU.
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

# H100 SXM data sheet (dense, no sparsity): fp32 outside the tensor cores
# and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# tolerances, each with its reason
MEL_ATOL = 1e-4      # log-mel: fp32 FMA sums of 200-1023 terms in another order than cuBLAS
CONV_ATOL = 1e-4     # pooled conv values O(1-10): cuDNN's fp32 algorithm rounds otherwise
STATS_RTOL = 1e-4    # s1, s2: 3.1e6-term fp32 sums in another order
EMB_RTOL = 1e-3      # embeddings / max|embedding|: fp32 through four layers, card vs CPU

CHUNK = 512          # the HEAR pipeline's BATCH_SIZE: one kernel launch's batch
WINDOW = 15200       # 0.95 s at 16 kHz: one timestamp window
N_CLIPS = 16         # clips per serving request
CLIP = 160000        # 10 s at 16 kHz: one scene clip


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def check(name: str, err: float, tol: float, why: str) -> None:
    ok = err <= tol
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.0e}: {why}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: error {err} above {tol}")


def launch_counts() -> dict[str, int]:
    """Every kernel instantiation's launch counter."""
    from ssl_audio_tpu_torch.ops.fused_conv import fused_conv1_fwd_cuda
    from ssl_audio_tpu_torch.ops.mel_kernel import log_mel_cuda

    return {"log_mel_folded": log_mel_cuda.launches["folded"],
            "log_mel_unfolded": log_mel_cuda.launches["unfolded"],
            "fused_conv1_fwd": fused_conv1_fwd_cuda.launches}


def zero_launch_counts() -> None:
    from ssl_audio_tpu_torch.ops.fused_conv import fused_conv1_fwd_cuda
    from ssl_audio_tpu_torch.ops.mel_kernel import log_mel_cuda

    for key in log_mel_cuda.launches:
        log_mel_cuda.launches[key] = 0
    fused_conv1_fwd_cuda.launches = 0


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
          "fp32 DFT sums in another order")
    ops = kernel_operands(spec, fold)
    nbytes = 4 * (wav.numel() + out.numel() + ops.basis_c.size
                  + ops.basis_s.size + ops.fb.size)
    bound, by = bound_ms(B * spec.num_frames(L) * ops.flops_per_frame(), nbytes)
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
           "bound_ms": bound, "bound_by": by, "library_ms": cuda_ms(library),
           "shape": f"{B} x {L} samples -> {tuple(out.shape)}"}
    print(f"  log_mel[{label}]: " + json.dumps(row))
    return row


def phase_kernels(gen: torch.Generator, dev: torch.device) -> list[dict]:
    from ssl_audio_tpu_torch.ops import no_tf32
    from ssl_audio_tpu_torch.ops.fused_conv import (
        fused_conv1_bn_relu_pool_eval, fused_conv1_fwd_cuda,
        fused_conv1_fwd_plain)
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
    train_err = 0.0
    for label, fold in (("train_spec_folded", None), ("train_spec_unfolded", False)):
        spec = MelSpec(win_length=1024)
        err = max_err(log_mel_cuda(wav, spec, fold=fold),
                      log_mel_spectrogram_plain(wav, spec, fold=fold))
        check(f"log_mel[{label}] ({CHUNK} x {WINDOW})", err, MEL_ATOL,
              "fp32 DFT sums in another order")
        train_err = max(train_err, err)

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
    sel_p, s1_p, s2_p = fused_conv1_fwd_plain(x, wk, bias, gamma)
    ev = fused_conv1_bn_relu_pool_eval(x[..., None], kernel_hwio, bias, gamma,
                                       beta, mean, var)

    def plain_eval():
        sp, _, _ = fused_conv1_fwd_plain(x, wk, bias, gamma)
        return torch.relu(gamma * (sp - mean) * torch.rsqrt(var + 1e-5) + beta)

    ev_p = plain_eval()
    torch.cuda.synchronize()
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
    bound, by = bound_ms(conv_flops, conv_bytes)
    conv_row = {
        "max_abs_err": max(conv_err, max_err(sel, sel_p)),
        "shape": f"{(B, H, W)} -> {tuple(ev.shape)}, eval epilogue fused",
        "library_max_abs_err": lib_conv_err,
        "ms": cuda_ms(lambda: fused_conv1_bn_relu_pool_eval(
            x[..., None], kernel_hwio, bias, gamma, beta, mean, var)),
        "plain_ms": cuda_ms(plain_eval), "bound_ms": bound, "bound_by": by,
        "library_ms": cuda_ms(library_conv),
        "stats_mode_ms": cuda_ms(lambda: fused_conv1_fwd_cuda(x, wk, bias, gamma)),
        "stats_mode_plain_ms": cuda_ms(lambda: fused_conv1_fwd_plain(x, wk, bias, gamma)),
    }
    print("  fused_conv1_fwd[eval]: " + json.dumps(conv_row))
    return [
        {"name": "log_mel", "route": "cuda",
         "source": "ssl_audio_tpu_torch/csrc/log_mel.cu",
         "replaces": "ssl_audio_tpu/ops/mel_pallas.py:185",
         **mel_rows["folded"],
         "max_abs_err": max(mel_rows["folded"]["max_abs_err"],
                            mel_rows["unfolded"]["max_abs_err"],
                            mel_rows["scene_shape"]["max_abs_err"], train_err),
         "train_spec_max_abs_err": train_err,
         "scene_shape": mel_rows["scene_shape"],
         "unfolded": {"replaces": "ssl_audio_tpu/ops/mel_pallas.py:139",
                      **mel_rows["unfolded"]}},
        {"name": "fused_conv1_fwd", "route": "cuda",
         "source": "ssl_audio_tpu_torch/csrc/fused_conv_fwd.cu",
         "replaces": "ssl_audio_tpu/ops/fused_conv.py:186", **conv_row},
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

    def wall_ms(fn, reps: int = 3) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    ts_ms = wall_ms(requests["timestamp"])
    sc_ms = wall_ms(requests["scene"])
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
    # launches on the main path, per request path and in all; the top-level
    # log_mel entry is the folded instantiation, the serving spec's
    entries = [(k, "log_mel_folded" if k["name"] == "log_mel" else k["name"])
               for k in kernels]
    entries += [(k["unfolded"], "log_mel_unfolded") for k in kernels if "unfolded" in k]
    for entry, counter in entries:
        entry["launches_by_path"] = {p: c[counter] for p, c in serving["launches"].items()}
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
