"""The input pipeline on an on-disk dataset (port of tools/bench_pipeline.py):
fabricate an FSD50K-layout `.npy` tree (or an AudioSet-layout wav tree with
--wav), train on it through the Trainer, and print each epoch's seconds
waiting for batches and seconds in steps (the Trainer's data_time /
step_time).  fabricate_cifar10 writes a CIFAR-10 tree.

    python -m ssl_audio_tpu_torch.tools.bench_pipeline --n_files 2048 --epochs 2 \\
        --batch 128 [--wav] [--device cpu]

The fabricators write the layouts the datasets read (data/datasets.py) and
the JAX package's tests and tools fabricate, from a seed; chip_smoke.py and
the tests use them too.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import tempfile
from typing import Sequence, Union

import numpy as np

FSD50K_MEAN, FSD50K_STD = -4.950, 5.855


def _write_wav(path: str, samples: np.ndarray, sr: int) -> None:
    from scipy.io import wavfile

    wavfile.write(path, sr, samples)


def _noise_pcm(rng: np.random.Generator, n: int, channels: int = 1) -> np.ndarray:
    shape = (n, channels) if channels > 1 else (n,)
    return (rng.standard_normal(shape, dtype=np.float32) * 3000).astype(np.int16)


def fabricate_fsd50k(root: str, n_files: int, frames: Union[int, Sequence[int]] = 300,
                     seed: int = 0, n_val: int = 0, n_test: int = 0, n_classes: int = 10,
                     max_labels: int = 1, wavs: bool = False, sr: int = 16000,
                     hop: int = 160) -> None:
    """An FSD50K tree under root: FSD50K/FSD50K.ground_truth/vocabulary.csv
    (a header, then n_classes rows), dev.csv (n_files "train" rows, then
    n_val "val" rows: fname, display names, mids, split; no header) and,
    with n_test, eval.csv (fname, display names, mids); each clip's log-mel
    (64, T) float32 at FSD50K's statistics under FSD50K_lms/, T = `frames`
    or drawn from [frames[0], frames[1]]; 1..max_labels distinct classes per
    clip.  With `wavs`, each clip also as a 16-bit mono wav of (T - 1) * hop
    samples under FSD50K/FSD50K.{dev,eval}_audio/."""
    rng = np.random.default_rng(seed)
    gt = os.path.join(root, "FSD50K/FSD50K.ground_truth")
    os.makedirs(gt, exist_ok=True)
    with open(os.path.join(gt, "vocabulary.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["index", "display", "mids"])
        for i in range(n_classes):
            w.writerow([i, f"c{i}", f"/m/{i}"])

    def clips(sub: str, names: list, splits: list) -> list:
        lms_dir = os.path.join(root, "FSD50K_lms", sub)
        wav_dir = os.path.join(root, "FSD50K", sub)
        os.makedirs(lms_dir, exist_ok=True)
        if wavs:
            os.makedirs(wav_dir, exist_ok=True)
        rows = []
        for name, split in zip(names, splits):
            T = frames if isinstance(frames, int) else int(rng.integers(frames[0], frames[1] + 1))
            lms = rng.standard_normal((64, T), dtype=np.float32) * FSD50K_STD + FSD50K_MEAN
            np.save(os.path.join(lms_dir, f"{name}.npy"), lms)
            if wavs:
                _write_wav(os.path.join(wav_dir, f"{name}.wav"), _noise_pcm(rng, (T - 1) * hop),
                           sr)
            k = int(rng.integers(1, max_labels + 1))
            cls = rng.choice(n_classes, size=k, replace=False)
            row = [name, ",".join(f"c{c}" for c in cls), ",".join(f"/m/{c}" for c in cls)]
            rows.append(row + ([split] if split else []))
        return rows

    dev = clips("FSD50K.dev_audio", [f"f{i}" for i in range(n_files + n_val)],
                ["train"] * n_files + ["val"] * n_val)
    with open(os.path.join(gt, "dev.csv"), "w", newline="") as f:
        csv.writer(f).writerows(dev)
    if n_test:
        test = clips("FSD50K.eval_audio", [f"e{i}" for i in range(n_test)], [None] * n_test)
        with open(os.path.join(gt, "eval.csv"), "w", newline="") as f:
            csv.writer(f).writerows(test)


def fabricate_audioset_wav(root: str, n_files: int, seconds: float = 10.0, sr: int = 16000,
                           seed: int = 0, n_balanced: int = 0, n_eval: int = 0,
                           n_classes: int = 10, stereo_every: int = 0, short_every: int = 0,
                           short_seconds: Sequence[float] = (2.5,)) -> None:
    """An AudioSet wav tree under root/audioset: class_labels_indices.csv
    (index, mid, display_name), and the unbalanced / balanced / eval segment
    CSVs (fname, '#'-joined mids, directory) with n_files / n_balanced /
    n_eval 16-bit wavs of `seconds` each.  Every stereo_every-th file is
    stereo; every short_every-th is short, its length taken in turn from
    short_seconds."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "audioset")
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "class_labels_indices.csv"), "w") as f:
        f.write("index,mid,display_name\n")
        for i in range(n_classes):
            f.write(f"{i},/m/{i},c{i}\n")
    k = 0
    for ident, count, prefix in (("unbalanced_train_segments", n_files, "u"),
                                 ("balanced_train_segments", n_balanced, "b"),
                                 ("eval_segments", n_eval, "e")):
        os.makedirs(os.path.join(base, ident), exist_ok=True)
        with open(os.path.join(base, f"{ident}-downloaded.csv"), "w") as f:
            for i in range(count):
                k += 1
                secs = seconds
                if short_every and k % short_every == 0:
                    secs = short_seconds[(k // short_every) % len(short_seconds)]
                channels = 2 if stereo_every and k % stereo_every == 0 else 1
                _write_wav(os.path.join(base, ident, f"{prefix}{i}.wav"),
                           _noise_pcm(rng, int(secs * sr), channels), sr)
                labels = "#".join(f"/m/{c}" for c in sorted({i % n_classes,
                                                              (i * 7 + 3) % n_classes}))
                f.write(f"{prefix}{i},{labels},{ident}\n")


def fabricate_cifar10(root: str, rows: int = 10000, seed: int = 0) -> None:
    """A CIFAR-10 tree under root in the published python-pickle layout:
    cifar-10-batches-py/data_batch_1..5 and test_batch, `rows` images each
    ({b"data": (rows, 3072) uint8, channel-major, b"labels": [int]}, as
    data/cifar10.py reads them); an image of class c is noise about a
    colour of its own, so a kNN over the pixels finds the class."""
    import pickle

    rng = np.random.default_rng(seed)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    colours = rng.integers(40, 216, (10, 3, 1, 1))
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        labels = rng.integers(0, 10, rows)
        noise = rng.integers(-40, 41, (rows, 3, 32, 32))
        data = np.clip(colours[labels] + noise, 0, 255).astype(np.uint8).reshape(rows, 3072)
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": data, b"labels": labels.tolist()}, f)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", type=str, default="audiontt")
    p.add_argument("--mask", action="store_true", default=False)
    p.add_argument("--n_files", type=int, default=2000)
    p.add_argument("--frames", type=int, nargs="+", default=[300],
                   help="frames per clip, or the range they are drawn from")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--wav", action="store_true", default=False,
                   help="AudioSet wav tree, the C++ wav reader and the device frontend")
    p.add_argument("--device", type=str, default=None)
    args = p.parse_args(argv)

    from ssl_audio_tpu_torch.config import default_config
    from ssl_audio_tpu_torch.train.loop import Trainer

    tmp = args.data_dir or tempfile.mkdtemp(prefix="pipe_bench_")
    if args.wav:
        print(f"fabricating {args.n_files} 10-s wavs under {tmp} ...")
        fabricate_audioset_wav(tmp, args.n_files)
    else:
        print(f"fabricating {args.n_files} lms files under {tmp} ...")
        frames = args.frames[0] if len(args.frames) == 1 else tuple(args.frames[:2])
        fabricate_fsd50k(tmp, args.n_files, frames)
    cfg = default_config(model_type=args.model, dataset="audioset_wav" if args.wav else "fsd50k",
                         batch_size=args.batch, epochs=args.epochs,
                         num_workers=args.num_workers, no_eval=True, mask=args.mask,
                         mask_ratio=0.3 if args.mask else 0.0, device=args.device)
    trainer = Trainer(cfg, data_dir=tmp)
    records = []
    for ep in range(1, args.epochs + 1):
        trainer.train_one_epoch(ep)
        data_s, step_s = trainer.epoch_times[ep]
        records.append({"epoch": ep, "steps": trainer.niter_per_ep, "data_s": data_s,
                        "step_s": step_s, "ms_per_step": (data_s + step_s)
                        / trainer.niter_per_ep * 1e3, "device": str(trainer.device)})
        print(json.dumps(records[-1]))
    return records


if __name__ == "__main__":
    main()
