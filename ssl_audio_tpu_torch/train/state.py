"""Train state: everything a step carries (port of
ssl_audio_tpu/train/state.py).

The JAX package threads parameters, batch statistics, optimizer state and
the augmentation state through a pure step function as one pytree.  Here
the modules own their parameters and running statistics, the optimizer its
momentum, and a step updates all of them in place; TrainState is the one
handle on them, and state_dict() / load_state_dict() carry all of it
through a checkpoint.

The BYOL variant (byol=True, ssl_audio_tpu/train/state.py:121-185) adds a
"target" ModuleDict (encoder, head, predictor) beside the online modules,
deep-copied from them after init, so its parameters and running statistics
travel in state_dict()["model"] as target.encoder.* and so on.

In a process group (parallel/) init_train_state broadcasts rank 0's
parameters, buffers and augmentation state, so every rank starts from one
replica; the steps keep them equal (one gradient, global statistics).  With
--stop_gradient the target takes no gradient and sits in no optimizer
group (the step moves it by an EMA of the online net); without it one
optimizer spans both stacks.

With cfg.use_fp16 a step runs the encoder in bf16 (encoder_forward): bf16
copies of the fp32 master parameters and a bf16 input, the outputs cast
back to fp32 for the head, predictor and loss, which stay fp32 (JAX
Modules.apply_encoder, ssl_audio_tpu/train/state.py:81-101).  The running
statistics are fp32 buffers throughout, the optimizer updates the fp32
masters and a checkpoint holds them: its format does not change.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ssl_audio_tpu_torch import parallel
from ssl_audio_tpu_torch.augment.transforms import AugmentState, init_augment_state
from ssl_audio_tpu_torch.models.audiontt import AudioNTT2022, init_weights_
from ssl_audio_tpu_torch.models.heads import BarlowTwinsHead, BarlowTwinsPredictor
from ssl_audio_tpu_torch.models.precision import bf16_params, forward_bf16
from ssl_audio_tpu_torch.models.resnet import (
    FACTORIES,
    MODEL_TYPES as RESNETS,
    ResNet,
    init_resnet_weights_,
)
from ssl_audio_tpu_torch.models.vit import get_mae_vit, init_vit_weights_
from ssl_audio_tpu_torch.train import optim as optim_lib
from ssl_audio_tpu_torch.utils import resolve_device


@dataclass
class TrainState:
    cfg: object
    step: int
    modules: nn.ModuleDict            # "encoder", "head", "predictor" (+ "target" for BYOL)
    optimizer: torch.optim.Optimizer
    scheduler: Optional[object]       # LR factor schedule of AdamW/Adam/SGD; LARS carries its own
    aug: AugmentState
    # bumped by load_state_dict, which replaces the optimizer's state tensors:
    # a CUDA graph captured before then reads stale ones (train/steps.py)
    version: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.modules.parameters()).device

    @property
    def lr_schedule(self) -> optim_lib.LRSchedule:
        """The device LR schedule the step reads and advances: LARS's own,
        or the scheduler's of AdamW/Adam/SGD."""
        return (self.scheduler or self.optimizer).schedule

    def host_counters(self) -> tuple[int, int]:
        """The counters a step advances on the host: (step, the LR
        schedule's count).  Their device counterparts advance on the
        device."""
        return self.step, self.lr_schedule.count

    def set_host_counters(self, counters: tuple[int, int]) -> None:
        self.step, self.lr_schedule.count = counters

    def advance_host(self, n: int) -> None:
        """n steps taken on the device by a replayed CUDA graph, which
        advanced the device counters itself: the host counters follow."""
        self.set_host_counters(tuple(c + n for c in self.host_counters()))

    def state_dict(self) -> dict:
        """Everything a step reads and updates: "model" (the modules under
        the reference's parameter names: encoder.*, head.*, predictor.*, and
        a BYOL state's target.encoder.*, target.head.*, target.predictor.*),
        "optimizer" (momentum or moments, and LARS's step count),
        "scheduler" (None for LARS), "augment" (the mixup bank with its
        count and position, the running norm) and "step".  Tensors, ints,
        floats and containers only; the tensors are this state's own, on its
        device."""
        return {"model": self.modules.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": None if self.scheduler is None else self.scheduler.state_dict(),
                "augment": self.aug.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        """Copies a state_dict() into this state, in place, on its device.
        Raises where the checkpoint was written by another configuration
        (names, shapes, optimizer groups or augmentation parts differ)."""
        self.modules.load_state_dict(sd["model"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        if (self.scheduler is None) != (sd["scheduler"] is None):
            raise ValueError("the checkpoint's LR scheduler does not match this "
                             f"run's ({self.cfg.optimizer})")
        if self.scheduler is not None:
            self.scheduler.load_state_dict(sd["scheduler"])
        self.aug.load_state_dict(sd["augment"])
        self.step = int(sd["step"])
        self.version += 1


def is_vit(cfg) -> bool:
    return "vit" in cfg.model_type


def encoder_forward(cfg, encoder: nn.Module):
    """-> fn(x, *args, **kwargs): the encoder's forward for one step.  With
    cfg.use_fp16, over bf16 copies of the fp32 master parameters taken now
    (gradients flow back through the cast into the masters), x cast to bf16
    and the outputs to fp32; else the encoder itself."""
    if not cfg.use_fp16:
        return encoder
    params = bf16_params(encoder)
    return lambda x, *args, **kwargs: forward_bf16(encoder, params, x, *args, **kwargs)


def build_encoder(cfg) -> tuple[nn.Module, int]:
    """-> (encoder, feature_dim), the JAX build_encoder's routing
    (models/wrapper.py).  --dataset cifar10: the ViT family over (32, 32)
    RGB images without a decoder (config.require_supported refuses another
    encoder).  AudioNTT2022: --squeeze_excitation, fused_conv /
    pool_reorder None = on (the fused block computes the same function on
    the CPU and on the card).  The four ResNet types: the factories'
    defaults (deep stem, plain projections).  The ViT family (vit_* and the
    conv-stem vitc_*): the (n_mels, crop_frames) grid, the decoder when
    masked_recon, --remat, fused attention only with --fused_attention (None
    = off, as in JAX).  As in JAX, --squeeze_excitation applies to
    AudioNTT2022 only and --remat to the ViT family only; the other encoders
    ignore them."""
    cifar = cfg.dataset == "cifar10"
    if is_vit(cfg):
        if cfg.layout_barrier:
            raise NotImplementedError("--layout_barrier (an XLA layout option) is not "
                                      "ported yet")
        # CIFAR-10: (32, 32) RGB images, no decoder (JAX models/wrapper.py:95-103)
        enc = get_mae_vit(cfg.model_type.split("_")[-1], cfg.patch_size,
                          cfg.model_type.startswith("vitc"),
                          img_size=(32, 32) if cifar else (cfg.n_mels, cfg.crop_frames),
                          in_chans=3 if cifar else 1,
                          use_decoder=cfg.masked_recon and not cifar,
                          use_learned_pos_embd=cfg.use_learned_pos_embd,
                          fused_attention=bool(cfg.fused_attention), remat=bool(cfg.remat))
        return enc, enc.embed_dim
    if cfg.model_type in RESNETS:
        enc = FACTORIES[cfg.model_type]()
        return enc, enc.embed_dim
    if cfg.model_type != "audiontt":
        raise NotImplementedError(f"Model type {cfg.model_type} is not supported")
    if cfg.n_mels != 64:
        raise ValueError(f"n_mels must be 64 to use the AudioNTT encoder "
                         f"(n_mels set to {cfg.n_mels})")
    enc = AudioNTT2022(
        n_mels=cfg.n_mels,
        fused_conv=cfg.fused_conv is None or bool(cfg.fused_conv),
        pool_reorder=cfg.pool_reorder is None or bool(cfg.pool_reorder),
        squeeze_excitation=bool(cfg.squeeze_excitation))
    return enc, enc.embed_dim


def init_train_state(cfg, generator: torch.Generator, niter_per_ep: int = 100,
                     byol: bool = False, device=None) -> TrainState:
    """Modules with the JAX package's initialisers drawn from `generator` (a
    CPU generator, so the same seed gives the same weights on any device),
    moved to `device`, their optimizer and the augmentation state.  A
    non-conv-stem ViT's patch projection is frozen (requires_grad False).
    byol: a "target" copy of the three modules besides (see the module's
    docstring).  device None = the card: without one this raises unless the
    caller asks for "cpu"."""
    device = resolve_device(device)
    encoder, feature_dim = build_encoder(cfg)
    modules = nn.ModuleDict({
        "encoder": encoder,
        "head": BarlowTwinsHead(feature_dim, cfg.projector_n_hidden_layers,
                                cfg.projector_hidden_dim, cfg.projector_out_dim),
        "predictor": BarlowTwinsPredictor(cfg.projector_out_dim, use=cfg.predictor),
    })
    if isinstance(encoder, AudioNTT2022):
        init_weights_(modules, generator)
    else:
        init = init_resnet_weights_ if isinstance(encoder, ResNet) else init_vit_weights_
        init(encoder, generator)
        init_weights_(nn.ModuleList([modules["head"], modules["predictor"]]), generator)
    # frozen parameters take no gradient, so the optimizer never sees them
    frozen = optim_lib.frozen_param_names(cfg, modules.named_parameters())
    for name, p in modules.named_parameters():
        if name in frozen:
            p.requires_grad_(False)
    if byol:
        # the target starts as the online net (JAX state.py:158-162)
        modules["target"] = copy.deepcopy(nn.ModuleDict(dict(modules.items())))
        if cfg.stop_gradient:
            modules["target"].requires_grad_(False)
    modules.to(device)
    optimizer, scheduler = optim_lib.make_optimizer(cfg, modules.parameters(), niter_per_ep)
    aug = init_augment_state(cfg, device=device)
    # in a process group every rank starts from rank 0's replica
    parallel.broadcast_([*modules.parameters(), *modules.buffers(), *aug.tensors()])
    return TrainState(cfg=cfg, step=0, modules=modules, optimizer=optimizer,
                      scheduler=scheduler, aug=aug)
