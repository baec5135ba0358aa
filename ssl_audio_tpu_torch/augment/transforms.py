"""Two global (+ N local) views of a batch of log-mel clips on the device
(port of ssl_audio_tpu/augment/transforms.py, the AudioPairTransform
equivalent).

Per view: global = [mixup] -> [Gaussian noise] -> [random resize crop] ->
[linear fader], toggled by cfg.mixup / Gnoise / RRC / RLF; local = a random
resize crop to local_crops_size with scales (0.05, 0.6).

The mixup bank receives each input once per step: view 1 mixes against the
bank as it was and then writes the batch, view 2 mixes against the updated
bank.  The state is updated in place.  `draw_pair_views` draws every random
parameter of a step from a torch.Generator; `apply_pair_views` is
deterministic in them, so a test can inject another framework's draws.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from ssl_audio_tpu_torch.augment import augmentations as A

GLOBAL_SCALES = dict(freq_scale=(0.6, 1.5), time_scale=(0.6, 1.5))
LOCAL_SCALES = dict(freq_scale=(0.05, 0.6), time_scale=(0.05, 0.6))
GNOISE_RATIO = 0.2


@dataclass
class AugmentState:
    mixup: Optional[A.MixupState]
    running_norm: Optional[A.RunningNormState] = None

    def state_dict(self) -> dict:
        """Tensors and ints only (None where a part is off)."""
        return {name: None if part is None else part.state_dict()
                for name, part in (("mixup", self.mixup), ("running_norm", self.running_norm))}

    def tensors(self) -> list:
        """Every tensor of the state (the bank, its count and position, the
        running norm's), to broadcast or compare."""
        return [t for part in (self.mixup, self.running_norm) if part is not None
                for t in vars(part).values() if isinstance(t, torch.Tensor)]

    def load_state_dict(self, sd: dict) -> None:
        for name, part in (("mixup", self.mixup), ("running_norm", self.running_norm)):
            if (part is None) != (sd[name] is None):
                raise ValueError(f"augmentation state {name!r}: the checkpoint has "
                                 f"{'none' if sd[name] is None else 'one'}, this run "
                                 f"{'none' if part is None else 'one'}")
            if part is not None:
                part.load_state_dict(sd[name])


def init_augment_state(cfg, sample_shape: Tuple[int, ...] = None,
                       device=None) -> AugmentState:
    """sample_shape defaults to (1, n_mels, crop_frames).  --dataset
    cifar10 keeps no state: its views (augment/cifar.py) use neither the
    mixup bank nor the running norm."""
    if cfg.dataset == "cifar10":
        return AugmentState(mixup=None)
    if sample_shape is None:
        sample_shape = (1, cfg.n_mels, cfg.crop_frames)
    mix = None
    if cfg.mixup:
        # the ring buffer takes one whole batch per step: a batch larger
        # than the bank would overwrite its own rows within one write
        if cfg.batch_size > cfg.mixup_n_memory:
            raise ValueError(
                f"--mixup_n_memory ({cfg.mixup_n_memory}) must be >= "
                f"--batch_size ({cfg.batch_size}): the on-device mixup ring "
                f"buffer writes one whole batch per step")
        mix = A.init_mixup_state(cfg.mixup_n_memory, sample_shape, device)
    rn = A.init_running_norm_state((1, 1, 1, 1), device) if cfg.pre_norm else None
    return AugmentState(mixup=mix, running_norm=rn)


@dataclass
class GlobalDraws:
    """The random parameters of one global view; a field is None where its
    augmentation is off.  mix = (alpha, u) with u ~ U(0, 1) per sample: the
    bank index floor(u * count) is taken when the view is applied, because
    view 2 sees the count view 1's write leaves."""
    mix: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    boxes: Optional[A.CropBoxes] = None
    fader: Optional[torch.Tensor] = None


@dataclass
class PairDraws:
    globals: List[GlobalDraws]
    local_boxes: List[A.CropBoxes] = field(default_factory=list)


def draw_pair_views(gen: torch.Generator, cfg, shape, device=None) -> PairDraws:
    """Every random parameter of make_pair_views for a batch of `shape`
    (B, 1, n_mels, crop_frames), drawn from `gen` (a generator on `device`)."""
    B = shape[0]
    views = []
    for _ in range(2):
        d = GlobalDraws()
        if cfg.mixup:
            d.mix = (cfg.mixup_ratio * torch.rand(B, 1, 1, 1, generator=gen, device=device),
                     torch.rand(B, generator=gen, device=device))
        if cfg.Gnoise:
            d.noise = A.draw_gaussian_noise(gen, shape, GNOISE_RATIO, device)
        if cfg.RRC:
            d.boxes = A.draw_crop_boxes(gen, B, shape[-2:], tuple(cfg.virtual_crop_scale),
                                        device=device, **GLOBAL_SCALES)
        if cfg.RLF:
            d.fader = A.draw_fader(gen, B, device=device)
        views.append(d)
    local = [A.draw_crop_boxes(gen, B, shape[-2:], (1.0, 1.0), device=device, **LOCAL_SCALES)
             for _ in range(cfg.local_crops_number)]
    return PairDraws(globals=views, local_boxes=local)


def _global_view(x: torch.Tensor, state: AugmentState, cfg, d: GlobalDraws,
                 update_bank: bool) -> torch.Tensor:
    out = x
    if cfg.mixup:
        alpha, u = d.mix
        out = A.apply_mixup(out, state.mixup, alpha, A.bank_index(u, state.mixup.count),
                            update_bank)
    if cfg.Gnoise:
        out = A.apply_gaussian_noise(out, *d.noise)
    if cfg.RRC:
        out = A.resize_bicubic_crop(out, d.boxes, (cfg.n_mels, cfg.crop_frames),
                                    tuple(cfg.virtual_crop_scale))
    if cfg.RLF:
        out = A.apply_linear_fader(out, d.fader)
    return out


def apply_pair_views(lms: torch.Tensor, state: AugmentState, cfg,
                     draws: PairDraws) -> List[torch.Tensor]:
    """[g1, g2, l1..lN] from lms (B, 1, n_mels, crop_frames) and the drawn
    parameters; updates `state` (mixup bank, running norm) in place."""
    if cfg.pre_norm and state.running_norm is not None:
        lms = A.running_norm(lms, state.running_norm,
                             max_update=getattr(cfg, "pre_norm_max_update", 409660),
                             dim=(0, 1, 2, 3))
    views = [_global_view(lms, state, cfg, draws.globals[0], update_bank=True),
             _global_view(lms, state, cfg, draws.globals[1], update_bank=False)]
    for boxes in draws.local_boxes:
        views.append(A.resize_bicubic_crop(lms, boxes, tuple(cfg.local_crops_size),
                                           (1.0, 1.0)))
    if cfg.post_norm:
        views = [A.normalize_batch(v) for v in views]
    return views


def make_pair_views(gen: torch.Generator, lms: torch.Tensor, state: AugmentState,
                    cfg) -> List[torch.Tensor]:
    """Draw and apply: the trainer's entry point."""
    draws = draw_pair_views(gen, cfg, tuple(lms.shape), lms.device)
    return apply_pair_views(lms, state, cfg, draws)
