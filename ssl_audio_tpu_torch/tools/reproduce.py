"""The quality-reproduction chain of the port (the JAX package's
tools/reproduce.py; reference readme protocol, hear/extract_results.py:12-90):
one script running

    wav tree -> tools.wav_to_lms          (offline log-mel conversion)
             -> main                      (Barlow Twins pretraining; main_pretrain
                                           for --method dino / byola)
             -> linear                    (FSD50K linear probe + low-shot)
             -> HEAR scene embeddings + a probe score per task
             -> hear.extract_results      (18-task aggregation -> results.json)

Every stage calls the port's entry point a user would run by hand; the
script only wires paths between them.  It runs on the card unless
`--device cpu` is given.

Layout expected under --root (the reference's own data layout):
    data/FSD50K/FSD50K.dev_audio/*.wav        } 16 kHz wavs
    data/FSD50K/FSD50K.eval_audio/*.wav       }
    data/FSD50K/FSD50K.ground_truth/{dev.csv,eval.csv,vocabulary.csv}
    hear_tasks/<task>/{train,test}/*.wav + <task>/labels.json   (optional)

The `hear` stage scores each task with the MLP probe over scene embeddings
("internal probe protocol") and writes heareval-layout score files; for
official HEAR 2021 numbers run the external heareval harness against the
port's hear.conv / hear.vit and point --hear_scores_dir at its output: the
aggregation reads either.

Usage:
    python -m ssl_audio_tpu_torch.tools.reproduce --root . --model_type audiontt \\
        --epochs 100 --batch_size 256 --name repro
    python -m ssl_audio_tpu_torch.tools.reproduce --root . --stages probe,hear,aggregate \\
        --ckpt results/fsd50k/<run>/model_100.pt

--method dino and byola pretrain the legacy families through main_pretrain
(a configuration they cannot run raises before any stage writes); the
later stages read the checkpoint's encoder as they read a Barlow Twins one.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np

ALL_STAGES = ("convert", "pretrain", "probe", "hear", "aggregate")


def _device_args(args) -> list:
    return [] if args.device is None else ["--device", args.device]


def stage_convert(args) -> None:
    """wav -> log-mel .npy for the FSD50K dev and eval sets
    (tools/wav_to_lms.py)."""
    from ssl_audio_tpu_torch.tools import wav_to_lms

    for sub in ("FSD50K.dev_audio", "FSD50K.eval_audio"):
        in_dir = os.path.join("data", "FSD50K", sub)
        out_dir = os.path.join("data", "FSD50K_lms", sub)
        if not os.path.isdir(in_dir):
            print(f"[convert] {in_dir} absent: skipped")
            continue
        print(f"[convert] {in_dir} -> {out_dir}")
        wav_to_lms.main(["--in_dir", in_dir, "--out_dir", out_dir]
                        + (["--fast"] if args.fast_mel else []) + _device_args(args))


def legacy_pretrain_argv(args) -> list:
    """main_pretrain's arguments for a dino / byola pretrain stage on FSD50K."""
    return ["--method", args.method, "--dataset", "fsd50k", "--model_type", args.model_type,
            "--epochs", str(args.epochs), "--batch_size", str(args.batch_size),
            "--no_eval"] + _device_args(args) + args.extra_pretrain_args


def stage_pretrain(args) -> str:
    """Pretrain through the family's entry point -> the path of the last
    epoch's checkpoint: main for Barlow Twins on FSD50K, model_{epochs}.pt
    under results/fsd50k/{model_type}_{name}*; main_pretrain for dino /
    byola, results/fsd50k/{method}_{model_type}/model_{epochs}.pt.  The
    probe and HEAR stages read any family's encoder
    (utils/checkpoint.py load_encoder_checkpoint)."""
    if args.method != "barlow":
        from ssl_audio_tpu_torch import main_pretrain

        argv = legacy_pretrain_argv(args)
        print(f"[pretrain] main_pretrain {' '.join(argv)}")
        main_pretrain.main(argv)
        ckpt = os.path.join("results", "fsd50k", f"{args.method}_{args.model_type}",
                            f"model_{args.epochs}.pt")
        if not os.path.isfile(ckpt):
            raise FileNotFoundError(f"pretrain produced no checkpoint {ckpt}")
        print(f"[pretrain] checkpoint: {ckpt}")
        return ckpt
    from ssl_audio_tpu_torch import main as main_mod

    argv = [
        "--dataset", "fsd50k", "--model_type", args.model_type,
        "--epochs", str(args.epochs), "--batch_size", str(args.batch_size),
        "--name", args.name, "--epoch_save_f", str(args.epoch_save_f),
    ] + _device_args(args)
    if args.no_eval:
        argv.append("--no_eval")
    argv += args.extra_pretrain_args
    print(f"[pretrain] main {' '.join(argv)}")
    main_mod.main(argv)
    pattern = os.path.join("results", "fsd50k", f"{args.model_type}_{args.name}*",
                           f"model_{args.epochs}.pt")
    ckpts = sorted(glob.glob(pattern), key=os.path.getmtime)
    if not ckpts:
        raise FileNotFoundError(f"pretrain produced no checkpoint matching {pattern}")
    print(f"[pretrain] checkpoint: {ckpts[-1]}")
    return ckpts[-1]


def stage_probe(args, ckpt: str) -> dict:
    """The FSD50K linear probe and the 5-per-class low-shot score through
    linear; the scores also go to <work_dir>/linear_scores.json."""
    from ssl_audio_tpu_torch import linear as linear_mod

    argv = [
        "--dataset", "fsd50k", "--model_type", args.model_type,
        "--model_file_path", ckpt, "--model_name", args.name,
        "--model_epoch", str(args.epochs),
        "--batch_size", str(args.batch_size),
    ] + _device_args(args)
    print(f"[probe] linear {' '.join(argv)}")
    scores = linear_mod.main(argv)
    out = {k: ([float(x) for x in v] if isinstance(v, (tuple, list)) else float(v))
           for k, v in scores.items()}
    with open(os.path.join(args.work_dir, "linear_scores.json"), "w") as f:
        json.dump(out, f, indent=2)
    return scores


def _load_task_clips(task_dir: str, split: str, sample_rate: int):
    """(clips float32 (N, T_max) zero-padded, labels list, fnames) of one
    split of an internal-protocol task."""
    from scipy.io import wavfile

    with open(os.path.join(task_dir, "labels.json")) as f:
        labels = json.load(f)[split]
    fnames = sorted(labels)
    wavs = []
    for fname in fnames:
        sr, wav = wavfile.read(os.path.join(task_dir, split, fname))
        if sr != sample_rate:
            raise ValueError(f"{fname}: sample rate {sr}, the model takes {sample_rate}")
        if wav.dtype == np.int16:
            wav = wav.astype(np.float32) / 32768.0
        wav = wav.astype(np.float32)
        if wav.ndim == 2:
            wav = wav.mean(axis=1)
        wavs.append(wav)
    t_max = max(len(w) for w in wavs)
    clips = np.zeros((len(wavs), t_max), np.float32)
    for i, w in enumerate(wavs):
        clips[i, : len(w)] = w
    return clips, [labels[f] for f in fnames], fnames


def stage_hear(args, ckpt: str) -> str:
    """Scene embeddings of every task's clips through the HEAR API (the
    checkpoint's encoder), the MLP probe per task, and a heareval-layout
    score file per task (test.predicted-scores.json) -> the run's scores
    directory."""
    import torch

    from ssl_audio_tpu_torch.eval.mlp_clf import MLPClassifier

    if "vit" in args.model_type:
        from ssl_audio_tpu_torch.hear import vit as hear_mod

        model = hear_mod.load_model(ckpt, args.model_type, args.patch_size, device=args.device)
    else:
        from ssl_audio_tpu_torch.hear import conv as hear_mod

        model = hear_mod.load_model(ckpt, args.model_type, fast_mel=args.fast_mel,
                                    device=args.device)
    sr = int(model.sample_rate)

    run_dir = os.path.join(args.hear_scores_dir, f"{args.model_type}_{args.name}",
                           f"model_{args.epochs}")
    task_dirs = sorted(glob.glob(os.path.join(args.hear_tasks_dir, "*", "labels.json")))
    if not task_dirs:
        print(f"[hear] no task dirs under {args.hear_tasks_dir}: skipped")
        return run_dir
    for labels_path in task_dirs:
        task_dir = os.path.dirname(labels_path)
        task = os.path.basename(task_dir)
        emb, y = {}, {}
        for split in ("train", "test"):
            clips, labels, _ = _load_task_clips(task_dir, split, sr)
            e = hear_mod.get_scene_embeddings(torch.from_numpy(clips), model)
            emb[split] = e.detach().cpu().numpy()
            y[split] = labels
        classes = sorted(set(y["train"]) | set(y["test"]))
        to_idx = {c: i for i, c in enumerate(classes)}
        clf = MLPClassifier(hidden_layer_sizes=args.probe_hidden, max_iter=args.probe_iters,
                            early_stopping=False, device=args.device)
        clf.fit(emb["train"], np.asarray([to_idx[c] for c in y["train"]]))
        score = float(clf.score(emb["test"], np.asarray([to_idx[c] for c in y["test"]])))
        out_dir = os.path.join(run_dir, task)
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "test.predicted-scores.json"), "w") as f:
            json.dump({"test": {"test_score": score}, "protocol": "internal-probe"}, f,
                      indent=2)
        print(f"[hear] {task}: {score:.4f}")
    return run_dir


def stage_aggregate(args) -> dict:
    """The 18-task grouping and averages into <work_dir>/results.json."""
    from ssl_audio_tpu_torch.hear.extract_results import extract_all

    out_path = os.path.join(args.work_dir, "results.json")
    scores = extract_all(args.hear_scores_dir, out_path)
    print(f"[aggregate] {out_path}: {json.dumps(scores, indent=2)[:400]}")
    return scores


def fabricate_tree(root: str, n_dev: int = 64, n_eval: int = 16, tasks=(), n_train: int = 6,
                   n_test: int = 3, n_classes: int = 3, seconds: float = 1.0,
                   seed: int = 0) -> str:
    """Writes a tree the chain reads under `root`: FSD50K (n_dev dev clips,
    every fifth in the val split, and n_eval eval clips, one label of
    n_classes each) and one internal-protocol HEAR task per name in `tasks`
    (n_train / n_test clips, two classes), every clip `seconds` of seeded
    noise at 16 kHz, int16.  -> root."""
    import csv

    from scipy.io import wavfile

    rng = np.random.default_rng(seed)

    def write_wav(path):
        wav = rng.standard_normal(int(16000 * seconds)) * 0.05
        wavfile.write(path, 16000, (wav * 32767).astype(np.int16))

    base = os.path.join(root, "data", "FSD50K")
    gt, dev, ev = (os.path.join(base, d) for d in
                   ("FSD50K.ground_truth", "FSD50K.dev_audio", "FSD50K.eval_audio"))
    for d in (gt, dev, ev):
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(gt, "vocabulary.csv"), "w") as f:
        csv.writer(f).writerows([["index", "display", "mids"]]
                                + [[i, f"c{i}", f"/m/{i}"] for i in range(n_classes)])
    rows = {"dev": [], "eval": []}
    for i in range(n_dev):
        write_wav(os.path.join(dev, f"d{i}.wav"))
        c = i % n_classes
        rows["dev"].append([f"d{i}", f"c{c}", f"/m/{c}", "val" if i % 5 == 4 else "train"])
    for i in range(n_eval):
        write_wav(os.path.join(ev, f"e{i}.wav"))
        rows["eval"].append([f"e{i}", f"c{i % n_classes}", f"/m/{i % n_classes}"])
    for split, r in rows.items():
        with open(os.path.join(gt, f"{split}.csv"), "w") as f:
            csv.writer(f).writerows(r)
    for task in tasks:
        tdir = os.path.join(root, "hear_tasks", task)
        labels = {"train": {}, "test": {}}
        for split, n in (("train", n_train), ("test", n_test)):
            os.makedirs(os.path.join(tdir, split), exist_ok=True)
            for i in range(n):
                write_wav(os.path.join(tdir, split, f"{split}{i}.wav"))
                labels[split][f"{split}{i}.wav"] = f"class{i % 2}"
        with open(os.path.join(tdir, "labels.json"), "w") as f:
            json.dump(labels, f)
    return root


def main(argv=None) -> dict:
    """-> {"linear": the probe's scores, "hear": the aggregated scores,
    "timings_s": seconds per stage} for the stages run."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default=".", help="dir containing data/FSD50K")
    p.add_argument("--work_dir", default="reproduce_out")
    p.add_argument("--stages", default=",".join(ALL_STAGES))
    p.add_argument("--model_type", default="audiontt")
    p.add_argument("--method", default="barlow", choices=["barlow", "dino", "byola"],
                   help="SSL family of the pretrain stage")
    p.add_argument("--patch_size", default="16x16")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--epoch_save_f", type=int, default=20)
    p.add_argument("--name", default="repro")
    p.add_argument("--ckpt", default="", help="skip pretrain, use this checkpoint")
    p.add_argument("--no_eval", action="store_true", default=False,
                   help="disable the per-epoch FSD50K probe during pretrain")
    p.add_argument("--fast_mel", action="store_true", default=False)
    p.add_argument("--hear_tasks_dir", default="hear_tasks")
    p.add_argument("--hear_scores_dir", default="",
                   help="heareval-layout scores dir (default <work_dir>/hear_scores)")
    p.add_argument("--probe_hidden", type=lambda s: tuple(
        int(x) for x in s.split(",") if x), default=(1024,))
    p.add_argument("--probe_iters", type=int, default=500)
    p.add_argument("--device", type=str, default=None,
                   help='"cuda" by default; "cpu" runs every stage on the plain PyTorch path')
    p.add_argument("--extra_pretrain_args", nargs=argparse.REMAINDER, default=[])
    args = p.parse_args(argv)
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    unknown = set(stages) - set(ALL_STAGES)
    if unknown:
        raise SystemExit(f"unknown stages {unknown}; pick from {ALL_STAGES}")
    if args.method != "barlow" and "pretrain" in stages:
        # a legacy run that cannot start raises before any stage writes
        from ssl_audio_tpu_torch.main_pretrain import config_for, require_legacy_runnable

        require_legacy_runnable(*config_for(legacy_pretrain_argv(args)))

    os.chdir(args.root)
    args.work_dir = os.path.abspath(args.work_dir)
    os.makedirs(args.work_dir, exist_ok=True)
    if not args.hear_scores_dir:
        args.hear_scores_dir = os.path.join(args.work_dir, "hear_scores")

    ckpt = args.ckpt
    results, timings = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        timings[name] = time.perf_counter() - t0
        print(f"[timing] {name}: {timings[name]:.1f}s")
        return out

    if "convert" in stages:
        timed("convert", lambda: stage_convert(args))
    if "pretrain" in stages:
        ckpt = timed("pretrain", lambda: stage_pretrain(args))
    if "probe" in stages:
        if not ckpt:
            raise SystemExit("probe stage needs --ckpt (or run pretrain)")
        results["linear"] = timed("probe", lambda: stage_probe(args, ckpt))
    if "hear" in stages:
        if not ckpt:
            raise SystemExit("hear stage needs --ckpt (or run pretrain)")
        timed("hear", lambda: stage_hear(args, ckpt))
    if "aggregate" in stages:
        results["hear"] = timed("aggregate", lambda: stage_aggregate(args))
    results["timings_s"] = timings
    print(f"[done] artifacts in {args.work_dir}")
    return results


if __name__ == "__main__":
    main()
