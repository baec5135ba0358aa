"""Seeded Barlow Twins training setup of the port, and a device-time profile
of its step on the card.

    python3 -m ssl_audio_tpu_torch.tools.train_profile [--seed 0] [--steps 10]
        [--model_type vit_base [--fused_attention] [--mask_ratio 0.75 [--token_drop]]]
        [--dataset synthetic_multicue] [--optimizer Adam --lr 1e-3] [--loop 30]
        [--steps_per_dispatch 4]

Builds a pretraining configuration at full width with weights drawn from a
seed, and one batch of 128 seeded 10-s clips resident on the card: by
default the default one (AudioNTT2022, 64 mels, d = 3072, projector 3072 ->
8192 -> 256, batch 128, crop_frames 96, fp32, LARS, block 1 through the
fused kernels); with --model_type a ViT (AdamW, projector from its width,
attention through the kernels with --fused_attention, the teacher masked at
--mask_ratio, by token drop with --token_drop, else by key bias).  After two
warm-up steps it times `steps` steps with the host clock (each ending in a
synchronise), then profiles one step with torch.profiler and prints the
device time by kernel (largest first), the device's idle share (1 - device
busy / wall) and the kernels' launch counts for that step.  chip_smoke.py
uses the same setup for its training phases.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ssl_audio_tpu_torch.ops import launch_counts, zero_launch_counts
from ssl_audio_tpu_torch.tools.serving import SAMPLE_RATE, profile, seeded_clips, smi_line
from ssl_audio_tpu_torch.train.loop import token_drop_len_keep

CLIP_SECONDS = 10


def train_config(**overrides):
    """What `python -m ssl_audio_tpu_torch.main --dataset synthetic_wav` runs."""
    from ssl_audio_tpu_torch.config import default_config

    return default_config(**{"dataset": "synthetic_wav", **overrides})


def seeded_training(seed: int, device, byol: bool = False, world_scale: float = 1.0,
                    **overrides):
    """-> (cfg, state, train_step, gen): the train state with weights drawn
    from `seed`, the step (over the device frontend for a wav dataset, with
    the loss's world_scale), and the generator on `device` the step's random
    numbers come from.  byol: the BYOL-style state (a target network) and
    step of main_bt_byol."""
    from ssl_audio_tpu_torch.train.state import init_train_state
    from ssl_audio_tpu_torch.train.steps import (
        make_byol_train_step,
        make_device_frontend,
        make_train_step,
    )

    cfg = train_config(seed=seed, **overrides)
    state = init_train_state(cfg, torch.Generator().manual_seed(seed), byol=byol, device=device)
    frontend = make_device_frontend(cfg, (0.0, 1.0)) if cfg.dataset.endswith("_wav") else None
    step = (make_byol_train_step if byol else make_train_step)(cfg, world_scale=world_scale,
                                                               frontend=frontend)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    return cfg, state, step, gen


class CachedItems:
    """A dataset's items, made once: __getitem__ is a list lookup."""

    def __init__(self, dataset):
        self.items = [dataset[i] for i in range(len(dataset))]
        self.label_num = dataset.label_num
        self.returns_wav = getattr(dataset, "returns_wav", False)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx):
        return self.items[idx]


def window_runner(cfg, state, gen, wavs: torch.Tensor, n_steps: int, ratios=None,
                  len_keep=None, byol: bool = False, world_scale: float = 1.0):
    """-> (run_window, multi_step): run_window() takes one window of n_steps
    steps on the resident batch `wavs` (raw wav when cfg's dataset is a wav
    one) through make_multi_train_step, every step on the same batch (copied
    once into each of the graph's batch slots), with the teacher's mask
    ratios `ratios` (n_steps,) and the window's len_keep.  On the card its
    first call runs the window eagerly, its second captures the graph and
    replays it, every later one replays it; it returns the window's
    metrics.  byol: windows of the BYOL-style step (`state` must hold a
    target); world_scale: the loss's."""
    from ssl_audio_tpu_torch.train.steps import (
        init_monitor,
        make_device_frontend,
        make_multi_train_step,
    )

    frontend = make_device_frontend(cfg, (0.0, 1.0)) if cfg.dataset.endswith("_wav") else None
    multi = make_multi_train_step(cfg, n_steps, world_scale=world_scale, frontend=frontend,
                                  byol=byol)
    batches = multi.inputs(tuple(wavs.shape), wavs.device) if wavs.is_cuda else \
        torch.empty(n_steps, *wavs.shape)
    batches.copy_(wavs.expand(n_steps, *wavs.shape))
    ratios = np.zeros(n_steps, np.float32) if ratios is None else np.asarray(ratios, np.float32)

    def run_window():
        return multi(state, batches, ratios, init_monitor(wavs.device), len_keep=len_keep,
                     gen=gen)[0]

    return run_window, multi


def step_wall_ms(run_step, steps: int) -> list[float]:
    """Host-clock milliseconds of `steps` calls, each ending in a synchronise."""
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--model_type", default="audiontt")
    ap.add_argument("--fused_attention", action="store_true")
    ap.add_argument("--mask_ratio", type=float, default=0.0)
    ap.add_argument("--token_drop", action="store_true")
    ap.add_argument("--dataset", default="synthetic_wav",
                    choices=["synthetic_wav", "synthetic_multicue"])
    ap.add_argument("--optimizer", default=None, choices=["LARS", "Adam", "AdamW", "SGD"])
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--loop", type=int, default=0)
    ap.add_argument("--loop_cached", action="store_true")
    ap.add_argument("--steps_per_dispatch", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the profile is a device measurement")
    dev = torch.device("cuda")
    smi = smi_line()
    overrides = dict(dataset=args.dataset, optimizer=args.optimizer, lr=args.lr)
    if args.model_type != "audiontt":
        overrides.update(model_type=args.model_type, fused_attention=args.fused_attention)
    if args.mask_ratio > 0:
        overrides.update(mask=True, mask_ratio=args.mask_ratio, token_drop=args.token_drop)
    cfg, state, step, gen = seeded_training(args.seed, dev, **overrides)
    if args.dataset == "synthetic_wav":
        wavs = seeded_clips(torch.Generator().manual_seed(args.seed), cfg.batch_size,
                            CLIP_SECONDS * SAMPLE_RATE).to(dev)
    else:
        from ssl_audio_tpu_torch.data.datasets import SyntheticMultiCue

        ds = SyntheticMultiCue(cfg, length=cfg.batch_size, seed=args.seed)
        wavs = torch.from_numpy(np.stack([ds[i][0] for i in range(len(ds))])).to(dev)
    masking = {}
    if args.mask_ratio > 0:
        gh, gw = state.modules["encoder"].grid_size()
        masking = dict(mask_ratio=args.mask_ratio, len_keep=token_drop_len_keep(
            gh * gw, args.mask_ratio) if args.token_drop else None)

    def run_step():
        return step(state, wavs, gen=gen, **masking)

    for _ in range(2):                          # warm-up: kernel build, cuDNN plans
        run_step()
    torch.cuda.reset_peak_memory_stats()
    times = step_wall_ms(run_step, args.steps)
    eager_peak = torch.cuda.max_memory_allocated()
    median = statistics.median(times)
    print(json.dumps({"what": "train step", "model_type": cfg.model_type,
                      "dataset": cfg.dataset, "optimizer": cfg.optimizer,
                      "fused_attention": bool(cfg.fused_attention), **masking,
                      "batch": cfg.batch_size, "card": smi,
                      "steps": args.steps, "ms_per_step_median": median,
                      "ms_per_step_min": min(times), "ms_per_step_max": max(times),
                      "clips_per_s": cfg.batch_size / median * 1e3,
                      "peak_memory_bytes": eager_peak}))
    zero_launch_counts()
    prof = profile(run_step)
    print(json.dumps({"what": "train step profile", "card": smi,
                      "launches": launch_counts(), **prof}))
    if args.steps_per_dispatch > 1:
        n = args.steps_per_dispatch
        run_window, multi = window_runner(cfg, state, gen, wavs, n,
                                          [args.mask_ratio] * n, masking.get("len_keep"))
        torch.cuda.reset_peak_memory_stats()
        run_window()                            # eagerly: the graph's warm-up
        run_window()                            # capture, then the first replay
        windows = step_wall_ms(run_window, max(args.steps // n, 1))
        per_step = [t / n for t in windows]
        zero_launch_counts()
        prof = profile(run_window)
        print(json.dumps({"what": f"graphed train steps ({n} a window)", "card": smi,
                          "windows": len(windows),
                          "ms_per_step_median": statistics.median(per_step),
                          "ms_per_step_min": min(per_step), "ms_per_step_max": max(per_step),
                          "clips_per_s": cfg.batch_size / statistics.median(per_step) * 1e3,
                          "capture_s": next(iter(multi.graphs.values())).capture_s,
                          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                          "eager_peak_memory_bytes": eager_peak,
                          "launches_per_replay": launch_counts(), **prof}))
    if args.loop:
        from ssl_audio_tpu_torch.train.loop import Trainer

        from ssl_audio_tpu_torch.train.loop import get_train_dataset

        loop_cfg = cfg.replace(epochs=2, synthetic_steps_per_epoch=args.loop)
        dataset = get_train_dataset(loop_cfg)
        if args.loop_cached:
            dataset = CachedItems(dataset)
        trainer = Trainer(loop_cfg, dataset=dataset, log=lambda line: None)
        trainer.train_one_epoch(1)                # warm-up epoch
        prof = profile(lambda: trainer.train_one_epoch(2))
        print(json.dumps({"what": f"{args.loop}-step epoch through the Trainer profile",
                          "items": "made before the epoch" if args.loop_cached
                          else "made by the loader's threads beside the steps",
                          "dataset": cfg.dataset, "optimizer": cfg.optimizer,
                          "num_workers": cfg.num_workers, "card": smi,
                          "ms_per_step": prof["wall_ms"] / args.loop, **prof}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
