"""Data-parallel pretraining steps on the card: per-step times under a
process group, and two ranks on one card held against one process.

    torchrun --nproc_per_node N -m ssl_audio_tpu_torch.tools.data_parallel \\
        [--distributed] [--seed 0] [--steps 12] [--steps_per_dispatch 4] [--out FILE]

times the default pretraining step (AudioNTT2022 at full width, LARS, a
seeded global batch of 128 10-s clips resident on the card, each of the W
ranks holding its B / W rows) with the host clock, each step ending in a
synchronise: eagerly, and in graphed windows of --steps_per_dispatch steps
(NCCL's all-reduces captured in the graph).  Without --distributed the
same steps run in one process on the whole batch.  Rank 0 prints one JSON
line (and writes it to --out).

`two_ranks_on_one_card(...)` runs a step of each given configuration on two
gloo ranks that share one card (NCCL refuses two ranks on one device; gloo
takes CUDA tensors): the real kernels run on each rank's rows with the
cross-rank sums between their launches; each rank's loss, launch counts
and parameters come back to be held against `one_process_step(...)` on the
global batch, which the caller may run meanwhile.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import statistics
import tempfile
from types import SimpleNamespace

import torch

from ssl_audio_tpu_torch import parallel
from ssl_audio_tpu_torch.ops import launch_counts, zero_launch_counts
from ssl_audio_tpu_torch.tools.serving import SAMPLE_RATE, seeded_clips, smi_line
from ssl_audio_tpu_torch.utils import resolve_device
from ssl_audio_tpu_torch.tools.train_profile import (
    CLIP_SECONDS,
    seeded_training,
    step_wall_ms,
    window_runner,
)


def rank_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows of a global batch (all of it outside a
    process group)."""
    B = t.shape[0] // parallel.world_size()
    return t[parallel.rank() * B:(parallel.rank() + 1) * B]


def global_clips(seed: int, n: int, device) -> torch.Tensor:
    return seeded_clips(torch.Generator().manual_seed(seed), n,
                        CLIP_SECONDS * SAMPLE_RATE).to(device)


def timed(seed: int, steps: int, steps_per_dispatch: int) -> dict:
    """ms per step of the default pretraining step in this process's group
    (or alone), eager and in graphed windows."""
    dev = torch.device("cuda", torch.cuda.current_device())
    world = float(parallel.world_size())
    cfg, state, step, gen = seeded_training(seed, dev, world_scale=world)
    wavs = rank_rows(global_clips(seed, cfg.batch_size, dev))
    for _ in range(2):                          # warm-up: cuDNN plans, NCCL's communicator
        step(state, wavs, gen=gen)
    eager = step_wall_ms(lambda: step(state, wavs, gen=gen), steps)
    n = steps_per_dispatch
    run_window, multi = window_runner(cfg, state, gen, wavs, n, world_scale=world)
    run_window()                                # eagerly: the graph's warm-up
    run_window()                                # capture, then the first replay
    windows = [t / n for t in step_wall_ms(run_window, max(steps // n, 1))]
    return {"world_size": parallel.world_size(), "backend": (
                torch.distributed.get_backend() if parallel.is_distributed() else None),
            "global_batch": cfg.batch_size, "rows_per_rank": wavs.shape[0],
            "eager_ms_per_step_median": statistics.median(eager), "eager_ms": eager,
            "graphed_ms_per_step_median": statistics.median(windows), "graphed_ms": windows,
            "steps_per_dispatch": n,
            "capture_s": next(iter(multi.graphs.values())).capture_s}


# ------------------------------------------------- two ranks on one card

def _flat_params(state) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).float().cpu() for p in state.modules.parameters()])


def digest(t: torch.Tensor) -> str:
    """sha256 of a host tensor's bytes: equal digests, equal bits."""
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_once(seed: int, overrides: dict, global_batch: int, world_scale: float,
              device=None) -> dict:
    """One step of the seeded pretraining configuration (train_profile's,
    with `overrides`) on this process's rows of a seeded global batch of
    `global_batch` 10-s clips, the launch counters zeroed just before it and
    read just after -> {"loss", "launches", "params" (flat, on the host),
    "params_before" (the same, before the step)}.  device: the card unless
    "cpu" is asked for (the plain versions: rehearsals)."""
    dev = resolve_device(device)
    cfg, state, step, gen = seeded_training(seed, dev, world_scale=world_scale,
                                            batch_size=global_batch, **overrides)
    wavs = rank_rows(global_clips(seed, global_batch, dev))
    masking = {"mask_ratio": cfg.mask_ratio} if cfg.mask else {}
    before = _flat_params(state)
    _sync(dev)
    zero_launch_counts()
    metrics = step(state, wavs, gen=gen, **masking)
    _sync(dev)
    launches = launch_counts()
    return {"loss": float(metrics["loss"]), "launches": launches,
            "params": _flat_params(state), "params_before": before}


def one_process_step(seed: int, overrides: dict, global_batch: int, world: int = 2,
                     device=None) -> dict:
    """step_once in this process (no process group) on the whole global
    batch, with the loss's world_scale of a `world`-rank run."""
    if parallel.is_distributed():
        raise RuntimeError("one_process_step runs outside a process group")
    return step_once(seed, overrides, global_batch, float(world), device)


def _two_rank_main(rank: int, port: int, path: str, out_dir: str) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE="2", LOCAL_RANK="0")      # both ranks on card 0
    job = torch.load(path, weights_only=False)
    device = job["device"] or "cuda"
    parallel.init_distributed(SimpleNamespace(distributed=True, device=device), backend="gloo")
    out = {}
    try:
        for name, (overrides, global_batch) in job["runs"].items():
            r = step_once(job["seed"], overrides, global_batch, 2.0, device)
            r["params_sha256"] = digest(r["params"])
            del r["params_before"]
            if rank:                        # rank 1's parameters travel as their digest
                del r["params"]
            out[name] = r
            gc.collect()
            if device != "cpu":
                torch.cuda.empty_cache()
    finally:
        parallel.destroy()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def two_ranks_on_one_card(seed: int, runs: dict, device=None, meanwhile=None):
    """step_once of each run {name: (overrides, global batch)} on two gloo
    ranks sharing card 0 (torch.multiprocessing spawn), while this process
    calls `meanwhile()` -> ({name: [rank 0's result, rank 1's]}, what
    meanwhile returned).  Rank 1's result holds its parameters' digest, not
    the parameters.  device "cpu": both ranks on the CPU."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as out_dir:
        path = os.path.join(out_dir, "job.pt")
        torch.save({"seed": seed, "runs": runs, "device": device}, path)
        ctx = mp.spawn(_two_rank_main, args=(port, path, out_dir), nprocs=2, join=False)
        try:
            other = meanwhile() if meanwhile is not None else None
        finally:
            while not ctx.join():
                pass
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    return {name: [ranks[0][name], ranks[1][name]] for name in runs}, other


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--steps_per_dispatch", type=int, default=4)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the times are device measurements")
    parallel.init_distributed(SimpleNamespace(distributed=args.distributed, device=None))
    lead = parallel.rank() == 0
    try:
        result = {"card": smi_line(), "distributed": args.distributed,
                  **timed(args.seed, args.steps, args.steps_per_dispatch)}
    finally:
        parallel.destroy()
    if lead:
        print(json.dumps(result))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
