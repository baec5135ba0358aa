"""The training loop: dataset selection, the epoch loop, checkpoints and
resume, the per-epoch evaluation hook and logging (port of
ssl_audio_tpu/train/loop.py around the eager step of train/steps.py).

Ported: every dataset of the JAX loop but cifar10 (get_train_dataset, read
under `data_dir` as the JAX Trainer does), Trainer, train_one_epoch (each
batch copied to the card from the loader's pinned slots with
non_blocking=True), fit (checkpoints every epoch_save_f epochs and at the
last, deterministic resume, eval_fn every epoch_eval_f epochs and at the
last), the CSV log, the ViT teacher's masking per step
(mask_ratio_for_step: a fixed ratio, a random one, or the sine schedule;
token drop with a static len_keep), --steps_per_dispatch N
(_train_one_epoch_multi: windows of N steps through
train/steps.py make_multi_train_step, a CUDA graph per window on the card)
and --profile_dir (a torch.profiler trace of steps 10-20 of epoch 1, at
--steps_per_dispatch 1 only, as in JAX) and the BYOL-style variant
(Trainer(cfg, byol=True): both paths through the BYOL step).

Data parallel (parallel/, --distributed under torchrun): cfg.batch_size is
the global batch, each rank's loader yields its B / W rows of it, the steps
take the global batch's statistics and one gradient, and rank 0 alone
writes the checkpoints, the CSV log and wandb and runs the per-epoch probe;
every rank resumes from the same file.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ssl_audio_tpu_torch import parallel
from ssl_audio_tpu_torch.config import require_supported
from ssl_audio_tpu_torch.data import datasets as D
from ssl_audio_tpu_torch.data.pipeline import DataLoader
from ssl_audio_tpu_torch.train.state import init_train_state, is_vit
from ssl_audio_tpu_torch.train.steps import (
    init_monitor,
    make_device_frontend,
    make_byol_train_step,
    make_multi_train_step,
    make_train_step,
)
from ssl_audio_tpu_torch.utils import checkpoint as ckpt_lib
from ssl_audio_tpu_torch.utils import resolve_device
from ssl_audio_tpu_torch.utils.logging_utils import make_csv_logger
from ssl_audio_tpu_torch.utils.schedules import sine_scheduler_increase

LOG_EVERY = 50          # steps between fetches of the device-side monitor
LOG_EVERY_DISPATCH = 10  # windows between fetches at --steps_per_dispatch > 1
PROFILE_STEPS = (10, 20)  # --profile_dir traces these iterations of epoch 1


class _ConcatDataset:
    """The items of `parts` one after the other (the label size the largest
    part's)."""

    def __init__(self, parts):
        self.parts = parts
        self.offsets = np.cumsum([0] + [len(p) for p in parts])
        self.label_num = max(getattr(p, "label_num", 0) for p in parts)

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, idx):
        part = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        return self.parts[part][idx - int(self.offsets[part])]


def get_train_dataset(cfg, data_dir: str = "data"):
    """The training set of cfg.dataset (reference get_data, main.py:257-311),
    the on-disk ones under `data_dir`.  --load_wav's log-mel runs on
    cfg.device (None = the card)."""
    ds, seed = cfg.dataset, cfg.seed
    length = cfg.synthetic_steps_per_epoch * cfg.batch_size

    def fsd50k(norm=D.NORM_STATS["fsd50k"]):
        return D.FSD50K(cfg, split="train_val", norm_stats=norm, data_dir=data_dir, seed=seed)

    def librispeech(**kw):
        return D.LibriSpeech(cfg, norm_stats=D.NORM_STATS["librispeech"], data_dir=data_dir,
                             seed=seed, **kw)

    def audioset():
        return D.AudioSet(cfg, norm_stats=D.NORM_STATS["audioset"], data_dir=data_dir, seed=seed)

    if ds == "fsd50k":
        return fsd50k(None if cfg.pre_norm else D.NORM_STATS["fsd50k"])
    if ds == "librispeech":
        return librispeech()
    if ds == "fsd50k+librispeech":
        return _ConcatDataset([fsd50k(), librispeech()])
    if ds == "audioset":
        return audioset()
    if ds == "audioset+librispeech":
        return _ConcatDataset([audioset(), librispeech(n_dummy=527)])
    if ds == "audioset_wav":
        return D.AudioSetWav(cfg, base_dir=os.path.join(data_dir, "audioset"),
                             balanced_only=cfg.audioset_balanced_only,
                             twohundredk_only=cfg.audioset_200k_only, seed=seed)
    if ds == "nsynth":
        return D.NSynthHEAR(cfg, split="train", norm_stats=D.NORM_STATS["nsynth"],
                            data_dir=data_dir, seed=seed)
    if ds == "synthetic":
        return D.SyntheticLMS(cfg, length=length, seed=seed)
    if ds == "synthetic_multicue":
        return D.SyntheticMultiCue(cfg, length=length, seed=seed)
    if ds == "synthetic_wav":
        return D.SyntheticWav(cfg, length=length, seed=seed)
    if ds == "cifar10":
        raise NotImplementedError("dataset 'cifar10' is not ported yet")
    raise ValueError(f"Unsupported dataset {ds}")


def mask_ratio_for_step(cfg, schedule, iteration: int, rng: np.random.Generator,
                        byol: bool = False) -> float:
    """The teacher's mask ratio at `iteration` (reference main.py:72-81): 0
    without --mask; the schedule's value with --mask_ratio_schedule; with
    --random_mask_ratio U(0.05, mask_beta) with probability 1/2, else 0;
    otherwise --mask_ratio.  byol (the online net's ratio, reference
    main_bt_byol.py:68-75): no schedule, and --random_mask_ratio draws
    U(0.02, 0.2)."""
    if not cfg.mask:
        return 0.0
    if schedule is not None and not byol:
        return float(schedule[min(iteration, len(schedule) - 1)])
    if cfg.random_mask_ratio:
        lo, hi = (0.02, 0.2) if byol else (0.05, cfg.mask_beta)
        if rng.random() > 0.5:
            return float(rng.uniform(lo, hi))
        return 0.0
    return float(cfg.mask_ratio)


def token_drop_len_keep(n_tokens: int, mask_ratio: float) -> Optional[int]:
    """floor(L * (1 - r)) of the Python float, as the reference's
    int(L * (1 - r)); None at ratio 0, where every token is kept."""
    if mask_ratio <= 0:
        return None
    lk = int(np.floor(n_tokens * (1.0 - float(mask_ratio))))
    return lk if lk < n_tokens else None


class Trainer:
    """cfg.device None = the card: without one the Trainer raises unless
    cfg.device is "cpu".  byol: the BYOL-style variant (main_bt_byol: the
    target network in the state, make_byol_train_step, the online net's
    mask ratios).  `log` takes every log line (stdout by default);
    with `log_dir` the step and score lines also go to log_dir/log.csv, and
    with `wandb_run` (utils.logging_utils.WandbRun) the losses to wandb.
    An on-disk dataset is read under `data_dir`.  epoch_losses maps each
    epoch this Trainer ran to its mean loss, epoch_times to its seconds
    waiting for batches and its seconds in steps."""

    def __init__(self, cfg, byol: bool = False, dataset=None, log=print,
                 log_dir: Optional[str] = None, wandb_run=None, data_dir: str = "data"):
        require_supported(cfg)
        self.cfg = cfg
        self.byol = byol
        self.log = log
        # in a process group rank 0 alone writes the logs, checkpoints and probe
        self.lead = parallel.rank() == 0
        self.logger = make_csv_logger(log_dir) if log_dir and self.lead else None
        self.wandb_run = wandb_run if self.lead else None
        self.epoch_losses: dict[int, float] = {}
        self.epoch_times: dict[int, tuple[float, float]] = {}
        self.device = resolve_device(cfg.device)
        self.dataset = dataset if dataset is not None else get_train_dataset(cfg, data_dir)
        # cfg.batch_size is the global batch: each of W ranks loads its
        # contiguous B / W rows of every batch (JAX train/loop.py:117-133)
        world = parallel.world_size()
        if cfg.batch_size % world:
            raise ValueError(f"--batch_size {cfg.batch_size} must divide across the "
                             f"{world} processes")
        self.loader = DataLoader(self.dataset, cfg.batch_size // world, shuffle=True,
                                 drop_last=True, num_workers=cfg.num_workers,
                                 seed=cfg.seed, device=self.device, log=log,
                                 process_index=parallel.rank(), process_count=world)
        self.niter_per_ep = len(self.loader)
        self.state = init_train_state(
            cfg, torch.Generator().manual_seed(cfg.seed),
            niter_per_ep=self.niter_per_ep, byol=byol, device=self.device)
        frontend = None
        if getattr(self.dataset, "returns_wav", False):
            # end-to-end mode: raw waveforms in, log-mel and crop on the device
            stats = D.NORM_STATS.get(cfg.dataset.split("+")[0].split("_")[0], (0.0, 1.0))
            frontend = make_device_frontend(cfg, stats)
        step_factory = make_byol_train_step if byol else make_train_step
        # the reference's world_size multiplier on the correlation (JAX
        # train/loop.py: the data-axis size)
        self.train_step = step_factory(cfg, world_scale=float(world), frontend=frontend)
        self.multi_step = None
        if int(cfg.steps_per_dispatch) > 1:
            self.multi_step = make_multi_train_step(cfg, int(cfg.steps_per_dispatch),
                                                    world_scale=float(world),
                                                    frontend=frontend, byol=byol)
        self._profiler = None
        # the step's random numbers are drawn on the device
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.mask_schedule = None
        if cfg.mask_ratio_schedule:
            self.mask_schedule = sine_scheduler_increase(
                final_value=cfg.mask_beta, epochs=cfg.epochs, niter_per_ep=self.niter_per_ep,
                warmup_epochs=int(cfg.epochs / 5), warmup_value=0)
        self.host_rng = np.random.default_rng(cfg.seed + 17)
        # token drop: a masked ViT teacher runs on 1 + len_keep tokens
        self._token_L = None
        if is_vit(cfg) and cfg.mask and cfg.token_drop:
            gh, gw = self.state.modules["encoder"].grid_size()
            self._token_L = gh * gw

    def _static_len_keep(self, mask_ratio: float) -> Optional[int]:
        """The token-drop count for a step, or None for key-bias masking:
        None without token drop and with --random_mask_ratio (the JAX package
        keeps one compiled shape there)."""
        if not self._token_L or self.cfg.random_mask_ratio:
            return None
        return token_drop_len_keep(self._token_L, mask_ratio)

    def _check_monitor(self, monitor) -> float:
        """Fetch the device-side monitor; abort on any non-finite loss since
        the last fetch.  Returns the summed loss."""
        if not bool(monitor["finite"]):
            self.log("Loss is not finite. Stopping training")
            sys.exit(1)
        return float(monitor["loss_sum"])

    def _start_trace(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=acts)
        self._profiler.start()

    def _stop_trace(self, first: int, last: int) -> None:
        """Stop the trace and write it: profile_dir/trace_steps_{first}-{last}.json
        (chrome trace format), iterations first..last of epoch 1."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir, f"trace_steps_{first}-{last}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        self.log(f"profiler trace written to {path}")

    def _finish_epoch(self, epoch: int, monitor, t_data: float, t_step: float) -> float:
        """The epoch-end fetch (it covers every step since the last one):
        the mean loss over the epoch's steps, the epoch's log line."""
        loss_sum = self._check_monitor(monitor)
        n_steps = int(monitor["count"])
        avg = loss_sum / max(n_steps, 1)
        self.log(f"Epoch [{epoch}/{self.cfg.epochs}] loss={avg:.4f} "
                 f"data_time={t_data:.1f}s step_time={t_step:.1f}s "
                 f"({n_steps * self.cfg.batch_size / max(t_data + t_step, 1e-9):.0f} "
                 f"samples/s) on {self.device}")
        self.epoch_losses[epoch] = avg
        self.epoch_times[epoch] = (t_data, t_step)
        return avg

    def _train_one_epoch_multi(self, epoch: int) -> float:
        """--steps_per_dispatch N > 1 (JAX Trainer._train_one_epoch_multi):
        windows of N steps through the multi step, the mask ratio per step
        (drawn on the host per iteration), the token-drop len_keep once per
        window from its first ratio, a window's last steps that do not fill
        it (the epoch's tail) through the single step.  On the card each
        batch is copied from the loader's pinned slot into the graph's
        batch buffer as it arrives; the monitor is fetched every
        LOG_EVERY_DISPATCH windows, with a CSV line of the window's mean
        data and step times."""
        cfg = self.cfg
        spd = int(cfg.steps_per_dispatch)
        self.loader.set_epoch(epoch)
        if cfg.profile_dir and epoch == 1:
            self.log("WARNING: --profile_dir is only supported with --steps_per_dispatch 1 "
                     "(the trace brackets individual step dispatches); no trace will be "
                     "captured.")
        cuda = self.device.type == "cuda"
        monitor = init_monitor(self.device)
        t_data = t_step = win_data = win_step = 0.0
        tflag = time.time()
        buf, ratios = [], []
        dispatches = 0

        def flush(monitor):
            nonlocal dispatches, win_data, win_step
            len_keep = self._static_len_keep(ratios[0])
            if len(ratios) == spd:
                batches = buf[0] if cuda else torch.from_numpy(np.stack(buf))
                metrics, monitor = self.multi_step(self.state, batches, ratios, monitor,
                                                   len_keep=len_keep, gen=self.gen)
                last_loss = metrics["loss"][-1]
            else:       # the epoch's tail: single steps, the same math
                for i, mr in enumerate(ratios):
                    batch = buf[0][i] if cuda else torch.from_numpy(buf[i])
                    metrics, monitor = self.train_step(self.state, batch, gen=self.gen,
                                                       monitor=monitor, mask_ratio=mr,
                                                       len_keep=len_keep)
                last_loss = metrics["loss"]
            dispatches += 1
            if dispatches % LOG_EVERY_DISPATCH == 0:
                self._check_monitor(monitor)
                self._record("epoch,{},step,{},loss,{},data_time,{:.4f},step_time,{:.4f}".format(
                    epoch, dispatches * spd, float(last_loss), win_data / LOG_EVERY_DISPATCH,
                    win_step / LOG_EVERY_DISPATCH))
                win_data = win_step = 0.0
            return monitor

        for it, (batch, _labels) in enumerate(self.loader):
            dt_i = time.time() - tflag
            t_data += dt_i
            win_data += dt_i
            iteration = self.niter_per_ep * (epoch - 1) + it
            ratios.append(mask_ratio_for_step(cfg, self.mask_schedule, iteration,
                                              self.host_rng, self.byol))
            tflag = time.time()
            if cuda:
                # into the graph's batch buffer from the loader's pinned slot:
                # queued behind the last replay, not waited for
                batch = torch.as_tensor(batch)
                if not buf:
                    buf.append(self.multi_step.inputs(tuple(batch.shape), self.device))
                buf[0][len(ratios) - 1].copy_(batch, non_blocking=True)
            else:
                buf.append(batch)
            if len(ratios) == spd:
                monitor = flush(monitor)
                buf, ratios = [], []
            st_i = time.time() - tflag
            t_step += st_i
            win_step += st_i
            tflag = time.time()
        if ratios:
            tflag = time.time()
            monitor = flush(monitor)
            t_step += time.time() - tflag
        return self._finish_epoch(epoch, monitor, t_data, t_step)

    def train_one_epoch(self, epoch: int) -> float:
        cfg = self.cfg
        if self.multi_step is not None:
            return self._train_one_epoch_multi(epoch)
        self.loader.set_epoch(epoch)
        monitor = init_monitor(self.device)
        t_data = t_step = 0.0
        tflag = time.time()
        first = min(PROFILE_STEPS[0], self.niter_per_ep - 1)
        for it, (batch, _labels) in enumerate(self.loader):
            dt_i = time.time() - tflag
            t_data += dt_i
            iteration = self.niter_per_ep * (epoch - 1) + it
            # --profile_dir: a torch.profiler trace of steps 10-20 of epoch 1
            # (rank 0's, in a process group)
            if cfg.profile_dir and epoch == 1 and self.lead:
                if iteration == first:
                    self._start_trace()
                elif iteration == PROFILE_STEPS[1] and self._profiler is not None:
                    self._stop_trace(first, iteration - 1)
            tflag = time.time()
            # from the loader's pinned slot on the card: queued, not waited for
            batch = torch.as_tensor(batch).to(self.device, non_blocking=True)
            mask_ratio = mask_ratio_for_step(cfg, self.mask_schedule, iteration, self.host_rng,
                                             self.byol)
            metrics, monitor = self.train_step(self.state, batch, gen=self.gen,
                                               monitor=monitor, mask_ratio=mask_ratio,
                                               len_keep=self._static_len_keep(mask_ratio))
            if it % LOG_EVERY == 0:
                # sampled sync point: one fetch covers every step since the last
                self._check_monitor(monitor)
                loss_val = float(metrics["loss"])
                self._record("epoch,{},step,{},loss,{},data_time,{:.4f},step_time,{:.4f}".format(
                    epoch, iteration, loss_val, dt_i, time.time() - tflag))
                if self.wandb_run is not None:
                    self.wandb_run.log({"Loss": loss_val})
            t_step += time.time() - tflag
            tflag = time.time()
        # a trace started near a short first epoch's end is stopped here, so
        # it is always written
        if self._profiler is not None:
            self._stop_trace(first, self.niter_per_ep - 1)
        return self._finish_epoch(epoch, monitor, t_data, t_step)

    def _record(self, line: str) -> None:
        """A metrics line: to the log, and to the CSV log where there is one."""
        self.log(line)
        if self.logger is not None:
            self.logger.info(line)

    def fit(self, ckpt_path: Optional[str] = None, resume_path: Optional[str] = None,
            eval_fn: Optional[Callable] = None):
        """Epochs 1..cfg.epochs, or from the epoch a checkpoint at
        `resume_path` names.  With `ckpt_path`, writes
        ckpt_path/model_{epoch}.pt every epoch_save_f epochs and at the last
        one; unless cfg.no_eval, calls eval_fn(state, epoch) every
        epoch_eval_f epochs and at the last one and logs what it returns.

        A resume restores the train state, then the device generator and the
        host generator (after the modules were built, which drew from a
        generator of their own); the loader's shuffle is seeded by the epoch,
        so the resumed epochs replay an uninterrupted run's randomness."""
        cfg = self.cfg
        start_epoch = 1
        if resume_path:
            _, start_epoch, rng = ckpt_lib.load_checkpoint(resume_path, self.state)
            if rng is None:
                raise ValueError(f"{resume_path} holds no generator states: it is not "
                                 "a training checkpoint")
            self.gen, self.host_rng = ckpt_lib.decode_rng(rng, self.device)
            self.log(f"Resumed from {resume_path} at epoch {start_epoch}")

        for epoch in range(start_epoch, cfg.epochs + 1):
            self.train_one_epoch(epoch)
            last = epoch == cfg.epochs
            if ckpt_path and (epoch % cfg.epoch_save_f == 0 or last):
                path = os.path.join(ckpt_path, f"model_{epoch}.pt")
                ckpt_lib.save_checkpoint(path, self.state, epoch + 1,
                                         ckpt_lib.encode_rng(self.gen, self.host_rng))
                self.log(f"Saved checkpoint {path}")
            if not cfg.no_eval and (epoch % cfg.epoch_eval_f == 0 or last):
                # rank 0 alone probes (JAX loop.py:451-466); the others wait
                if eval_fn and self.lead:
                    scores = eval_fn(self.state, epoch)
                    if scores:
                        self._record("epoch,{},step,{},linear_score,{}".format(
                            epoch, self.niter_per_ep * epoch, scores))
                parallel.barrier()
        return self.state
