"""The Barlow Twins training step (port of ssl_audio_tpu/train/steps.py:
init_monitor, make_device_frontend, make_train_step).

One call = one iteration: [raw wav -> cropped, normalised log-mel] -> two
augmented views -> teacher and student forwards -> Barlow Twins loss ->
backward -> optimizer update.  It runs eagerly.  Every random number of a
step (crop starts, augmentation parameters, dropout keep masks) is drawn
up front into a StepDraws from a torch.Generator, or handed in by the
caller, so two implementations can be stepped on the same draws.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import torch

from ssl_audio_tpu_torch.augment.transforms import (
    PairDraws,
    apply_pair_views,
    draw_pair_views,
)
from ssl_audio_tpu_torch.models.audiontt import DROPOUT_RATE
from ssl_audio_tpu_torch.objectives.barlow import barlow_twins_loss
from ssl_audio_tpu_torch.ops import no_tf32
from ssl_audio_tpu_torch.ops.mel import MelSpec, log_mel_spectrogram_cropped
from ssl_audio_tpu_torch.train.state import TrainState


def init_monitor(device) -> dict:
    """Device-side training monitor: a running finite flag, a loss sum and a
    step count.  The step folds every loss into it on the device; the loop
    fetches it once per logging interval, not once per step, so a NaN at any
    step since the last fetch shows at the next one."""
    return {"finite": torch.ones((), dtype=torch.bool, device=device),
            "loss_sum": torch.zeros((), device=device),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _fold_monitor(monitor: dict, loss: torch.Tensor) -> dict:
    return {"finite": monitor["finite"] & torch.isfinite(loss),
            "loss_sum": monitor["loss_sum"] + loss,
            "count": monitor["count"] + 1}


def crop_start_bound(cfg, n_samples: int) -> int:
    """Exclusive upper bound of the frontend's crop starts: the valid starts
    are 0 .. n_frames - crop_frames, both ends included (the reference's
    random.randint); 1 for a clip shorter than crop_frames."""
    n_frames = MelSpec.from_config(cfg).num_frames(n_samples)
    return max(n_frames - cfg.crop_frames + 1, 1)


def make_device_frontend(cfg, norm_stats):
    """-> frontend(wavs (B, L), starts (B,) int) -> normalised log-mel crops
    (B, 1, n_mels, crop_frames) on wavs' device.  Only the cropped frames are
    transformed: the log-mel kernel takes the per-clip starts.  A clip
    shorter than crop_frames is padded with zeros in the log domain, before
    the normalisation, as in the JAX package."""
    spec = MelSpec.from_config(cfg)
    mean, std = norm_stats

    def frontend(wavs: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        n_frames = spec.num_frames(wavs.shape[-1])
        out_frames = min(cfg.crop_frames, n_frames)
        lms = log_mel_spectrogram_cropped(wavs, spec, starts, out_frames,
                                          fast=cfg.fast_mel)[:, None]
        if n_frames < cfg.crop_frames:
            lms = torch.nn.functional.pad(lms, (0, cfg.crop_frames - n_frames))
        return (lms - mean) / std

    return frontend


def _to_device(obj, device):
    """obj with every tensor in it (tuples, lists, dataclasses) on `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _to_device(getattr(obj, f.name), device)
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_device(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_device(v, device) for v in obj)
    return obj


@dataclass
class StepDraws:
    """Every random number of one step."""
    starts: Optional[torch.Tensor]     # (B,) frontend crop starts; None for log-mel batches
    views: PairDraws
    dropout: List[torch.Tensor]        # per encoder forward: keep mask (B, T/4, hidden)

    def to(self, device) -> "StepDraws":
        """The same draws on another device (to step two devices alike)."""
        return _to_device(self, device)


def draw_step(gen: torch.Generator, cfg, batch_shape, hidden: int, device=None,
              wav: bool = False) -> StepDraws:
    """Draw a step's random numbers from `gen` (a generator on `device`).
    batch_shape: (B, L) raw wavs when `wav`, else (B, 1, n_mels, crop_frames)."""
    B = batch_shape[0]
    starts = None
    if wav:
        starts = torch.randint(0, crop_start_bound(cfg, batch_shape[-1]), (B,),
                               generator=gen, device=device, dtype=torch.int32)
    lms_shape = (B, 1, cfg.n_mels, cfg.crop_frames)
    frames = [cfg.crop_frames // 4] * 2 + [cfg.local_crops_size[1] // 4] * cfg.local_crops_number
    dropout = [torch.rand(B, t, hidden, generator=gen, device=device) >= DROPOUT_RATE
               for t in frames]
    return StepDraws(starts, draw_pair_views(gen, cfg, lms_shape, device), dropout)


def make_train_step(cfg, world_scale: float = 1.0, frontend=None):
    """-> train_step(state, batch, gen=None, draws=None, monitor=None) ->
    metrics, or (metrics, monitor) when a monitor is passed.

    batch: (B, 1, n_mels, crop_frames) normalised log-mels, or raw (B, L)
    wavs when `frontend` (make_device_frontend) is given.  The step updates
    `state` in place (parameters, running statistics, optimizer momentum,
    mixup bank, step count).  Randomness: `draws`, or drawn from `gen`."""
    if cfg.use_fp16:
        raise NotImplementedError(
            "--use_fp16 (bf16 autocast of the encoder) is not ported yet")

    def train_step(state: TrainState, batch: torch.Tensor, gen=None,
                   draws: Optional[StepDraws] = None, monitor=None):
        mods = state.modules
        encoder, head, predictor = mods["encoder"], mods["head"], mods["predictor"]
        mods.train()
        if draws is None:
            draws = draw_step(gen, cfg, tuple(batch.shape), encoder.fc[0].out_features,
                              batch.device, wav=frontend is not None)
        with torch.no_grad():
            if frontend is not None:
                batch = frontend(batch, draws.starts)
            views = apply_pair_views(batch, state.aug, cfg, draws.views)

        # cuDNN's TF32 flag is read when a kernel is chosen: the backward
        # convolutions run inside loss.backward(), so it stays in the context
        with no_tf32():
            # teacher: first global view, head + predictor
            t_z = predictor(head(encoder(views[0], draws.dropout[0])))
            # student: second global view + locals
            student_zs = []
            for v, mask in zip(views[1:], draws.dropout[1:]):
                s_z = head(encoder(v, mask))
                student_zs.append(s_z.detach() if cfg.stop_gradient else s_z)
            loss = barlow_twins_loss(student_zs, [t_z], lmbda=cfg.lmbda, alpha=cfg.alpha,
                                     HSIC=cfg.HSIC, world_scale=world_scale)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        loss = loss.detach()
        metrics = {"loss": loss, "bt_loss": loss, "recon_loss": torch.zeros_like(loss)}
        if monitor is None:
            return metrics
        return metrics, _fold_monitor(monitor, loss)

    return train_step
