"""Training steps of the legacy pretraining families (port of
ssl_audio_tpu/train/legacy_steps.py; main_pretrain --method dino|byola).

make_dino_train_step: DINO.  The student (the online encoder and DINOHead)
takes every view in order, the two global views and then the local crops,
its BatchNorm running statistics chained view by view; the teacher (the
target stack) takes the two global views in train mode with no gradient,
chaining the target's running statistics; the centred, sharpened
cross-entropy (objectives/dino.py); after the optimizer step the target
moves to m * target + (1 - m) * params over every parameter, m the
per-iteration teacher momentum, and the new centre is stored.

make_byola_train_step: BYOL-A.  Online encoder -> projector -> predictor on
view 1, then view 2; the target's encoder -> projector on view 1, then view
2, with no gradient; the symmetric normalised MSE (objectives/byol.py);
after the optimizer step the target moves by an EMA of the updated online
parameters with the constant --moving_average_decay.

Quirks of the JAX steps that the port copies:
- one draw for every encoder forward of a step: JAX hands every
  encoder.apply the same rngs dict, so AudioNTT2022's dropout mask (and a
  ViT's DropPath masks) are the same in the student's and the teacher's
  forwards (draw_legacy_step draws one set; the Barlow Twins step draws one
  per forward);
- the teacher (target) runs in train mode: batch statistics, and its
  running statistics move;
- a ViT runs at mask ratio 0 (no masking) and takes its CLS token;
- no gradient clipping (the reference's legacy loop clips none; JAX's
  clip_grad defaults to None and no caller sets it).

The optimizers are the legacy trainers' own (train/optim.py
make_legacy_optimizer): AdamW with cosine lr and weight-decay schedules for
DINO, Adam at a constant lr for BYOL-A, and no frozen parameter (the JAX
legacy optimizer trains a ViT's patch projection too).  With --use_fp16 the
encoder forwards run in bf16 over bf16 copies of the fp32 masters
(train/state.py encoder_forward); heads, losses and optimizer stay fp32.

The input is normalised log-mel batches (B, 1, n_mels, crop_frames), as
the JAX loop feeds the loader's batches straight into the views.

Data parallel (parallel/, --distributed under torchrun), as the Barlow
Twins step (train/steps.py): in a process group `batch` is this rank's B / W
rows of the global batch; the step draws the global batch's random numbers
and keeps its rows, every BatchNorm (the teacher's and the target's
included, in the fused block too) takes the global batch's statistics, the
loss and the DINO centre are means over the global batch, and the gradients
are averaged over ranks before the optimizer step.  The EMA follows the
step on every rank, so the targets stay one replica.  The JAX steps run
the same on the global batch under GSPMD.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ssl_audio_tpu_torch import parallel
from ssl_audio_tpu_torch.augment.transforms import draw_pair_views, init_augment_state
from ssl_audio_tpu_torch.config import require_supported
from ssl_audio_tpu_torch.models.audiontt import DROPOUT_RATE, AudioNTT2022, init_weights_
from ssl_audio_tpu_torch.models.batchnorm import BatchNorm1d
from ssl_audio_tpu_torch.models.resnet import ResNet, init_resnet_weights_
from ssl_audio_tpu_torch.models.vit import MaskedAutoencoderViT, init_vit_weights_
from ssl_audio_tpu_torch.objectives.byol import byol_symmetric_loss
from ssl_audio_tpu_torch.objectives.dino import DINOHead, dino_loss, init_dino_head_
from ssl_audio_tpu_torch.ops import no_tf32
from ssl_audio_tpu_torch.train.optim import make_legacy_optimizer
from ssl_audio_tpu_torch.train.state import TrainState, build_encoder, encoder_forward
from ssl_audio_tpu_torch.train.steps import StepDraws, _views, ema_update_
from ssl_audio_tpu_torch.utils import resolve_device

METHODS = ("dino", "byola")


class MLPHead(nn.Module):
    """BYOL-A projector / predictor: Linear - BatchNorm (flax semantics,
    momentum 0.9) - ReLU - Linear, both Linears with bias (byol_pytorch.py
    MLP, the JAX _MLPHead), under the upstream names net.{0,1,3}."""

    def __init__(self, in_dim: int, hidden_dim: int = 4096, out_dim: int = 256):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(in_dim, hidden_dim), BatchNorm1d(hidden_dim),
                                 nn.ReLU(), nn.Linear(hidden_dim, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


@dataclass
class LegacyState(TrainState):
    """A TrainState whose modules are "encoder", "head" (DINOHead or the
    BYOL-A projector), "predictor" (BYOL-A only) and "target", a copy of
    those made at init that takes no gradient; with the DINO centre (1,
    dino_out_dim), which travels in state_dict() beside the rest."""
    center: Optional[torch.Tensor] = None

    def online(self) -> nn.ModuleList:
        """The online modules, in the target's order (the EMA pairs them)."""
        return nn.ModuleList([m for name, m in self.modules.items() if name != "target"])

    def state_dict(self) -> dict:
        return {**super().state_dict(), "center": self.center}

    def load_state_dict(self, sd: dict) -> None:
        super().load_state_dict(sd)
        if self.center is not None:
            self.center.copy_(sd["center"])


def require_legacy_supported(cfg, method: str) -> None:
    """Raise before any work on what the legacy families cannot run here:
    a setting not ported yet (config.py unsupported_settings) or multi-crop
    DINO on AudioNTT2022."""
    if method not in METHODS:
        raise ValueError(f"no legacy family {method!r} (one of {', '.join(METHODS)})")
    require_supported(cfg)
    if method == "dino" and cfg.model_type == "audiontt" and cfg.local_crops_number:
        raise ValueError(
            f"--method dino --model_type audiontt --local_crops_number "
            f"{cfg.local_crops_number}: AudioNTT2022's fc is sized for {cfg.n_mels} mel "
            f"bins, so the student cannot take {cfg.local_crops_size[0]}x"
            f"{cfg.local_crops_size[1]} local crops (the JAX step fails on the shape); "
            "multi-crop DINO runs on a ViT")


def init_legacy_state(cfg, generator: torch.Generator, method: str, niter_per_ep: int = 100,
                      device=None) -> LegacyState:
    """The encoder and the family's heads with the JAX package's
    initialisers drawn from `generator` (a CPU generator), a target copy,
    the family's optimizer, the augmentation state and (DINO) a zero
    centre, on `device` (None = the card; without one this raises unless
    the caller asks for "cpu")."""
    require_legacy_supported(cfg, method)
    device = resolve_device(device)
    encoder, feature_dim = build_encoder(cfg)
    if isinstance(encoder, AudioNTT2022):
        init_weights_(encoder, generator)
    else:
        (init_resnet_weights_ if isinstance(encoder, ResNet) else init_vit_weights_)(
            encoder, generator)
    modules = nn.ModuleDict({"encoder": encoder})
    if method == "dino":
        # hidden and bottleneck widths stay the head's defaults (2048 / 256):
        # the reference trainer sets only out_dim
        modules["head"] = init_dino_head_(DINOHead(feature_dim, cfg.dino_out_dim), generator)
    else:
        modules["head"] = init_weights_(MLPHead(feature_dim, cfg.proj_dim, cfg.proj_size),
                                        generator)
        modules["predictor"] = init_weights_(
            MLPHead(cfg.proj_size, cfg.proj_dim, cfg.proj_size), generator)
    online = list(modules.parameters())
    modules["target"] = copy.deepcopy(nn.ModuleDict(dict(modules.items())))
    modules["target"].requires_grad_(False)
    modules.to(device)
    optimizer, scheduler = make_legacy_optimizer(cfg, method, online, niter_per_ep)
    center = (torch.zeros(1, cfg.dino_out_dim, device=device) if method == "dino" else None)
    aug = init_augment_state(cfg, device=device)
    # in a process group every rank starts from rank 0's replica
    parallel.broadcast_([*modules.parameters(), *modules.buffers(), *aug.tensors()])
    return LegacyState(cfg=cfg, step=0, modules=modules, optimizer=optimizer,
                       scheduler=scheduler, aug=aug, center=center)


def draw_legacy_step(gen: torch.Generator, cfg, batch_shape, encoder, device=None) -> StepDraws:
    """A legacy step's random numbers from `gen`: the views' parameters,
    then one set for every encoder forward of the step (AudioNTT2022's
    dropout keep mask for the global views' frames; a ViT's DropPath keep
    masks per block where its rate is above 0; nothing for a ResNet).
    batch_shape: the global batch's in a process group (_prepare)."""
    B = batch_shape[0]
    views = draw_pair_views(gen, cfg, tuple(batch_shape), device)
    dropout = drop_path = None
    if isinstance(encoder, MaskedAutoencoderViT):
        if encoder.spec.drop_path_rate > 0:
            drop_path = [[torch.rand(2, B, generator=gen, device=device) >= blk.drop_path.rate
                          if blk.drop_path.rate > 0 else None for blk in encoder.blocks]]
    elif isinstance(encoder, AudioNTT2022):
        hidden = encoder.fc[0].out_features
        dropout = [torch.rand(B, cfg.crop_frames // 4, hidden, generator=gen,
                              device=device) >= DROPOUT_RATE]
    return StepDraws(None, views, dropout, None, drop_path)


def _encode(run_encoder, draws: StepDraws, v: torch.Tensor, vit: bool) -> torch.Tensor:
    """One encoder forward on view v with the step's one set of draws."""
    if vit:
        return run_encoder(v, drop_keep=None if draws.drop_path is None else draws.drop_path[0])
    return run_encoder(v) if draws.dropout is None else run_encoder(v, draws.dropout[0])


def _prepare(cfg, state: LegacyState, batch, gen, draws):
    """-> (draws, views, vit): the step's draws (drawn from `gen` unless
    given; the global batch's, of which train/steps.py _views keeps this
    rank's rows) and its augmented views; the mixup bank advances."""
    state.modules.train()
    encoder = state.modules["encoder"]
    if draws is None:
        draws = draw_legacy_step(gen, cfg, (parallel.batch_count(batch.shape[0]),
                                            *batch.shape[1:]), encoder, batch.device)
    draws, views = _views(cfg, state, batch, gen, draws, None)
    return draws, views, isinstance(encoder, MaskedAutoencoderViT)


def _update(state: LegacyState, loss: torch.Tensor, step_size: float) -> dict:
    """The optimizer (and schedule) step on the gradients of `loss`
    (averaged over ranks in a process group), then the target's EMA towards
    the updated online parameters."""
    parallel.all_reduce_grads_(state.optimizer)
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1
    with torch.no_grad():
        ema_update_(state.modules["target"], state.online(), step_size)
    return {"loss": loss.detach()}


def make_dino_train_step(cfg):
    """-> step(state, batch, teacher_temp, teacher_momentum, *, gen=None,
    draws=None) -> {"loss"}: one DINO iteration on `batch`, updating
    `state` in place.  teacher_temp and teacher_momentum are this
    iteration's values of the schedules (main_pretrain); the centre and the
    target move after the optimizer step."""

    def step(state: LegacyState, batch: torch.Tensor, teacher_temp: float,
             teacher_momentum: float, *, gen: Optional[torch.Generator] = None,
             draws: Optional[StepDraws] = None) -> dict:
        draws, views, vit = _prepare(cfg, state, batch, gen, draws)
        mods = state.modules
        encoder, head, target = mods["encoder"], mods["head"], mods["target"]
        with no_tf32():
            run = encoder_forward(cfg, encoder)
            student = [head(_encode(run, draws, v, vit)) for v in views]
            with torch.no_grad():
                run_target = encoder_forward(cfg, target["encoder"])
                teacher = [target["head"](_encode(run_target, draws, v, vit))
                           for v in views[:2]]
            loss, center = dino_loss(student, teacher, state.center, float(teacher_temp))
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        # 1 - m in fp32, as the JAX step takes it from its fp32 momentum
        step_size = float(np.float32(1.0) - np.float32(teacher_momentum))
        metrics = _update(state, loss, step_size)
        state.center.copy_(center)
        return metrics

    return step


def make_byola_train_step(cfg):
    """-> step(state, batch, *, gen=None, draws=None) -> {"loss"}: one
    BYOL-A iteration on `batch`, updating `state` in place."""
    step_size = 1.0 - float(cfg.moving_average_decay)

    def step(state: LegacyState, batch: torch.Tensor, *,
             gen: Optional[torch.Generator] = None,
             draws: Optional[StepDraws] = None) -> dict:
        draws, views, vit = _prepare(cfg, state, batch, gen, draws)
        mods = state.modules
        encoder, head, predictor, target = (mods["encoder"], mods["head"], mods["predictor"],
                                            mods["target"])
        with no_tf32():
            run = encoder_forward(cfg, encoder)
            online = [predictor(head(_encode(run, draws, v, vit))) for v in views[:2]]
            with torch.no_grad():
                run_target = encoder_forward(cfg, target["encoder"])
                tgt = [target["head"](_encode(run_target, draws, v, vit)) for v in views[:2]]
            loss = byol_symmetric_loss(online[0], tgt[1], online[1], tgt[0])
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        return _update(state, loss, step_size)

    return step
