"""The training loop: dataset selection, the epoch loop and logging (port of
ssl_audio_tpu/train/loop.py around the eager step of train/steps.py).

Ported: the synthetic datasets, Trainer, train_one_epoch, fit.  Not yet:
checkpoints and resume, the per-epoch evaluation hook, the profiler trace,
multi-step dispatch and the on-disk datasets; their settings raise
NotImplementedError (config.require_supported) when the Trainer is built.
"""
from __future__ import annotations

import sys
import time

import torch

from ssl_audio_tpu_torch.config import require_supported
from ssl_audio_tpu_torch.data import datasets as D
from ssl_audio_tpu_torch.data.pipeline import DataLoader
from ssl_audio_tpu_torch.train.state import init_train_state
from ssl_audio_tpu_torch.train.steps import (
    init_monitor,
    make_device_frontend,
    make_train_step,
)
from ssl_audio_tpu_torch.utils import resolve_device

LOG_EVERY = 50          # steps between fetches of the device-side monitor


def get_train_dataset(cfg):
    length = cfg.synthetic_steps_per_epoch * cfg.batch_size
    if cfg.dataset == "synthetic":
        return D.SyntheticLMS(cfg, length=length, seed=cfg.seed)
    if cfg.dataset == "synthetic_wav":
        return D.SyntheticWav(cfg, length=length, seed=cfg.seed)
    raise NotImplementedError(
        f"dataset {cfg.dataset!r} is not ported yet (synthetic, synthetic_wav)")


class Trainer:
    """cfg.device None = the card: without one the Trainer raises unless
    cfg.device is "cpu"."""

    def __init__(self, cfg, dataset=None, log=print):
        require_supported(cfg)
        self.cfg = cfg
        self.log = log
        self.device = resolve_device(cfg.device)
        self.dataset = dataset if dataset is not None else get_train_dataset(cfg)
        self.loader = DataLoader(self.dataset, cfg.batch_size, shuffle=True,
                                 drop_last=True, num_workers=cfg.num_workers,
                                 seed=cfg.seed)
        self.niter_per_ep = len(self.loader)
        self.state = init_train_state(
            cfg, torch.Generator().manual_seed(cfg.seed),
            niter_per_ep=self.niter_per_ep, device=self.device)
        frontend = None
        if getattr(self.dataset, "returns_wav", False):
            # end-to-end mode: raw waveforms in, log-mel and crop on the device
            stats = D.NORM_STATS.get(cfg.dataset.split("+")[0].split("_")[0], (0.0, 1.0))
            frontend = make_device_frontend(cfg, stats)
        self.train_step = make_train_step(cfg, world_scale=1.0, frontend=frontend)
        # the step's random numbers are drawn on the device
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)

    def _check_monitor(self, monitor) -> float:
        """Fetch the device-side monitor; abort on any non-finite loss since
        the last fetch.  Returns the summed loss."""
        if not bool(monitor["finite"]):
            self.log("Loss is not finite. Stopping training")
            sys.exit(1)
        return float(monitor["loss_sum"])

    def train_one_epoch(self, epoch: int) -> float:
        cfg = self.cfg
        self.loader.set_epoch(epoch)
        monitor = init_monitor(self.device)
        t_data = t_step = 0.0
        tflag = time.time()
        for it, (batch, _labels) in enumerate(self.loader):
            dt_i = time.time() - tflag
            t_data += dt_i
            tflag = time.time()
            batch = torch.from_numpy(batch).to(self.device)
            metrics, monitor = self.train_step(self.state, batch, gen=self.gen,
                                               monitor=monitor)
            if it % LOG_EVERY == 0:
                # sampled sync point: one fetch covers every step since the last
                self._check_monitor(monitor)
                self.log("epoch,{},step,{},loss,{},data_time,{:.4f},step_time,{:.4f}".format(
                    epoch, self.niter_per_ep * (epoch - 1) + it,
                    float(metrics["loss"]), dt_i, time.time() - tflag))
            t_step += time.time() - tflag
            tflag = time.time()
        loss_sum = self._check_monitor(monitor)
        avg = loss_sum / max(int(monitor["count"]), 1)
        self.log(f"Epoch [{epoch}/{cfg.epochs}] loss={avg:.4f} "
                 f"data_time={t_data:.1f}s step_time={t_step:.1f}s "
                 f"({self.niter_per_ep * cfg.batch_size / max(t_data + t_step, 1e-9):.0f} "
                 f"samples/s) on {self.device}")
        return avg

    def fit(self):
        for epoch in range(1, self.cfg.epochs + 1):
            self.train_one_epoch(epoch)
        return self.state
