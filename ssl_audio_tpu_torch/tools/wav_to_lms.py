"""Offline wav -> log-mel `.npy` converter (port of tools/wav_to_lms.py;
reference old/data_manager/wav_to_lms.py:42-108): the pre-computed
spectrograms that the `.npy` datasets read.

    python -m ssl_audio_tpu_torch.tools.wav_to_lms \\
        --in_dir data/FSD50K/FSD50K.dev_audio --out_dir data/FSD50K_lms/FSD50K.dev_audio

Host threads decode the wavs (ssl_audio_tpu_torch.data.datasets.load_wav);
the log-mel of a group runs on --device (the card by default, through the
log-mel kernel; "cpu" takes the plain version).  Files are grouped by exact
length, since the log-mel of a zero-padded wav differs near its end (the
reflect pad moves), so one group of up to --batch_size files is one log-mel
launch; a file longer than --batch_seconds is cut to it.  Each output keeps
its wav's path relative to --in_dir, with `.npy` for `.wav`.  `--fast` is
accepted for the JAX flag surface: the port's log-mel is exact fp32 either
way (ops/mel.py).
"""
from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def main(argv=None) -> dict:
    """-> {"files", "groups" (log-mel launches), "seconds", "clips_per_s",
    "device"}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--in_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--n_fft", type=int, default=1024)
    p.add_argument("--win_length", type=int, default=1024)
    p.add_argument("--hop_length", type=int, default=160)
    p.add_argument("--n_mels", type=int, default=64)
    p.add_argument("--f_min", type=int, default=60)
    p.add_argument("--f_max", type=int, default=7800)
    p.add_argument("--batch_seconds", type=float, default=10.0,
                   help="longer files are cut to this length")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--fast", action="store_true", default=False,
                   help="accepted for the JAX flag surface; the result is the same")
    p.add_argument("--device", type=str, default=None,
                   help='"cuda" by default; "cpu" runs the plain PyTorch path')
    args = p.parse_args(argv)

    from ssl_audio_tpu_torch.data.datasets import load_wav
    from ssl_audio_tpu_torch.ops.mel import MelSpec, log_mel_spectrogram
    from ssl_audio_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    spec = MelSpec(sample_rate=args.sample_rate, n_fft=args.n_fft,
                   win_length=args.win_length, hop_length=args.hop_length,
                   n_mels=args.n_mels, f_min=float(args.f_min), f_max=float(args.f_max))
    files = []
    for root, _dirs, names in os.walk(args.in_dir):
        for f in names:
            if f.lower().endswith(".wav"):
                files.append(os.path.join(root, f))
    os.makedirs(args.out_dir, exist_ok=True)
    cap = int(args.batch_seconds * args.sample_rate)
    groups: dict[int, list] = {}
    done = launches = 0

    def flush(length: int) -> None:
        nonlocal done, launches
        group = groups.pop(length, None)
        if not group:
            return
        paths, wavs = zip(*group)
        batch = torch.from_numpy(np.stack(wavs)).to(device)
        lms = log_mel_spectrogram(batch, spec).cpu().numpy()
        launches += 1
        for path, one in zip(paths, lms):
            rel = os.path.relpath(path, args.in_dir)
            out = os.path.join(args.out_dir, os.path.splitext(rel)[0] + ".npy")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            np.save(out, one)
        done += len(paths)
        if done % 1024 < args.batch_size:
            print(f"{done}/{len(files)}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.workers) as pool:
        for path, wav in zip(files, pool.map(lambda f: load_wav(f, args.sample_rate), files)):
            wav = wav[:cap]
            groups.setdefault(len(wav), []).append((path, wav))
            if len(groups[len(wav)]) == args.batch_size:
                flush(len(wav))
        for length in list(groups):
            flush(length)
    seconds = time.perf_counter() - t0
    print(f"Converted {done} files -> {args.out_dir} ({launches} log-mel launches, "
          f"{seconds:.2f} s on {device})")
    return {"files": done, "groups": launches, "seconds": seconds,
            "clips_per_s": done / seconds if seconds else None, "device": str(device)}


if __name__ == "__main__":
    main()
