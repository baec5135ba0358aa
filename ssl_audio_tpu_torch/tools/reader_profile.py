"""Where the C++ batch readers' time goes on the machine this runs on.

    python3 -m ssl_audio_tpu_torch.tools.reader_profile [--batches 4] [--seed 0]

Fabricates the FSD50K tree of chip_smoke.py phase 10 (896 dev clips, 30-3000
frames) and its AudioSet wav tree in a temporary directory, then reads
batches of 128 random files: by NativeBatchReader at 1 to 128 threads; by
np.load (one read a file), by 64 whole-row preads a file (the reader's
reads) and by 64 preads of the 96-frame window only, the last three on 20
Python threads (pread and np.load release the interpreter lock); by
NativeWavReader at 1 and 20 threads; and one epoch of the DataLoader alone
on the C++ path.  Prints one JSON line of milliseconds per batch (each a
list over --batches batches) and the host's name.  Host work only: it needs
no card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import platform
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BATCH = 128
ROWS, FRAMES = 64, 96


def _ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _row_reads(path: str, window: bool, rng: np.random.Generator) -> int:
    """Each of the 64 rows of a (64, T) float32 `.npy` by its own pread: the
    whole row, or its 96-frame window from a random start."""
    arr = np.load(path, mmap_mode="r")
    T, off = arr.shape[1], arr.offset
    start = int(rng.integers(0, T - FRAMES)) if window and T > FRAMES else 0
    width = min(T, FRAMES) if window else T
    fd = os.open(path, os.O_RDONLY)
    try:
        return sum(len(os.pread(fd, 4 * width, off + 4 * (r * T + start)))
                   for r in range(ROWS))
    finally:
        os.close(fd)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ssl_audio_tpu_torch.config import default_config
    from ssl_audio_tpu_torch.data import datasets as D
    from ssl_audio_tpu_torch.data.native_loader import NativeBatchReader, NativeWavReader
    from ssl_audio_tpu_torch.data.pipeline import DataLoader
    from ssl_audio_tpu_torch.tools.bench_pipeline import fabricate_audioset_wav, fabricate_fsd50k

    out: dict = {"host": platform.platform(), "cpus": os.cpu_count(), "batch": BATCH}
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="reader_profile_") as tmp, contextlib.chdir(tmp):
        fabricate_fsd50k("data", 768, (30, 3000), args.seed, n_val=128, n_classes=200,
                         max_labels=3)
        fabricate_audioset_wav("data", 512, n_balanced=256, seed=args.seed, stereo_every=8,
                               short_every=16, short_seconds=(2.5, 5.0, 7.5))
        cfg = default_config(dataset="fsd50k")
        ds = D.FSD50K(cfg, split="train_val", norm_stats=D.NORM_STATS["fsd50k"],
                      data_dir="data")
        wds = D.AudioSetWav(cfg, base_dir="data/audioset")
        with ThreadPoolExecutor(20) as pool:
            for b in range(args.batches):
                paths, _ = ds.batch_paths(rng.permutation(len(ds))[:BATCH])
                out.setdefault("npy_mb_per_batch", []).append(
                    sum(os.path.getsize(p) for p in paths) / 1e6)
                for n in (1, 8, 20, 40, 128):
                    reader = NativeBatchReader(ROWS, FRAMES, 0.0, 1.0, n_threads=n)
                    out.setdefault(f"npy_reader_{n}_threads_ms", []).append(
                        _ms(lambda: reader.read(paths, seed=b)))
                out.setdefault("np_load_20_threads_ms", []).append(
                    _ms(lambda: list(pool.map(np.load, paths))))
                out.setdefault("row_preads_20_threads_ms", []).append(
                    _ms(lambda: list(pool.map(lambda p: _row_reads(p, False, rng), paths))))
                out.setdefault("window_preads_20_threads_ms", []).append(
                    _ms(lambda: list(pool.map(lambda p: _row_reads(p, True, rng), paths))))
                wpaths, _ = wds.batch_paths(rng.permutation(len(wds))[:BATCH])
                for n in (1, 20):
                    reader = NativeWavReader(wds.unit_length, cfg.sample_rate, n_threads=n)
                    out.setdefault(f"wav_reader_{n}_threads_ms", []).append(
                        _ms(lambda: reader.read(wpaths, seed=b)))
        loader = DataLoader(ds, BATCH, num_workers=20, seed=args.seed, log=lambda line: None)
        ends = [time.perf_counter()]
        for _batch in loader:
            ends.append(time.perf_counter())
        out["loader_alone_npy_ms"] = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
