"""Supervised linear evaluation and finetuning on labelled audio (port of
ssl_audio_tpu/eval/finetune.py; reference old/evaluate/linear.py
LinearTrainer and finetune.py FinetuneTrainer): a linear head on a frozen
or trainable encoder, sigmoid BCE (multi-label) or softmax CE, optional
mixup and SpecAugment, scored by mAP (eval/stats.py) or accuracy.

A step's order is JAX's: mixup, then the frequency mask, then the time
mask, then the forward.  In finetune steps the encoder is in train mode
(BatchNorm statistics move, AudioNTT2022's dropout is live); in linear mode,
and in every prediction, it is in eval mode.  Every random number of a step
is drawn up front into a ClassifierDraws (mixup's from a CPU generator,
the masks' and the encoder's from the device's), or handed in, so a test
can give both packages the same draws.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssl_audio_tpu_torch.augment import spec_augment
from ssl_audio_tpu_torch.eval.stats import mean_average_precision
from ssl_audio_tpu_torch.models.audiontt import DROPOUT_RATE, AudioNTT2022
from ssl_audio_tpu_torch.models.vit import MaskedAutoencoderViT
from ssl_audio_tpu_torch.ops import no_tf32
from ssl_audio_tpu_torch.train.state import encoder_forward


@dataclass
class ClassifierDraws:
    """One step's random numbers; None where the step does not draw them.
    mixup: (lambda, permutation); freq, time: (width, u) per sample;
    dropout: AudioNTT2022's keep mask (B, T/4, hidden); drop_keep: a ViT's
    DropPath keep masks, per block (2, B) or None."""
    mixup: Optional[Tuple[float, torch.Tensor]] = None
    freq: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    time: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    dropout: Optional[torch.Tensor] = None
    drop_keep: Optional[list] = None


def draw_classifier_step(gen: torch.Generator, host_gen: torch.Generator, encoder: nn.Module,
                         shape, finetune: bool, mixup_alpha: Optional[float],
                         specaug: bool) -> ClassifierDraws:
    """The draws of one step on a batch of `shape` (B, 1, F, T): mixup's
    from `host_gen` (CPU), the rest from `gen` (a generator on the
    encoder's device)."""
    B, T = shape[0], shape[-1]
    device = next(encoder.parameters()).device
    d = ClassifierDraws()
    if mixup_alpha:
        d.mixup = spec_augment.draw_mixup(host_gen, B, mixup_alpha)
    if specaug:
        d.freq = spec_augment.draw_band(gen, B, 8, device)
        d.time = spec_augment.draw_band(gen, B, 20, device)
    if finetune and isinstance(encoder, AudioNTT2022):
        d.dropout = torch.rand(B, T // 4, encoder.fc[0].out_features, generator=gen,
                               device=device) >= DROPOUT_RATE
    elif finetune and isinstance(encoder, MaskedAutoencoderViT) \
            and encoder.spec.drop_path_rate > 0:
        d.drop_keep = [torch.rand(2, B, generator=gen, device=device) >= blk.drop_path.rate
                       if blk.drop_path.rate > 0 else None for blk in encoder.blocks]
    return d


def init_head(feature_dim: int, n_classes: int, generator: torch.Generator) -> nn.Linear:
    """The linear head: weight U(-1/sqrt(D), 1/sqrt(D)) drawn from
    `generator` as JAX's (D, C) kernel, bias 0."""
    head = nn.Linear(feature_dim, n_classes)
    bound = 1.0 / math.sqrt(feature_dim)
    with torch.no_grad():
        w = torch.rand(feature_dim, n_classes, generator=generator) * (2 * bound) - bound
        head.weight.copy_(w.T)
        head.bias.zero_()
    return head


def _snapshot(head: nn.Module, encoder: nn.Module, finetune: bool) -> dict:
    """CPU copies of what a best epoch keeps: the head's state, and with
    finetune the encoder's parameters and its running statistics
    (encoder_batch_stats), as JAX keeps its trainable tree."""
    out = {"head": {k: v.detach().cpu().clone() for k, v in head.state_dict().items()}}
    if finetune:
        out["encoder"] = {k: v.detach().cpu().clone() for k, v in encoder.named_parameters()}
        out["encoder_batch_stats"] = {k: v.detach().cpu().clone()
                                      for k, v in encoder.named_buffers()}
    return out


def make_classifier_step(cfg, encoder: nn.Module, head: nn.Module,
                         optimizer: torch.optim.Optimizer, finetune: bool,
                         mixup_alpha: Optional[float], specaug: bool,
                         single_label: bool) -> Callable:
    """-> step(x, y, draws) -> loss (a 0-d tensor): one optimizer step of the
    head (and, finetuning, the encoder) on the batch with its draws."""
    def encode(x, draws: ClassifierDraws):
        run = encoder_forward(cfg, encoder)
        if isinstance(encoder, MaskedAutoencoderViT):
            return run(x, mean_pool=cfg.use_mean_pool, drop_keep=draws.drop_keep)
        if isinstance(encoder, AudioNTT2022):
            return run(x, draws.dropout)
        return run(x)

    def step(x: torch.Tensor, y: torch.Tensor, draws: ClassifierDraws) -> torch.Tensor:
        encoder.train(finetune)
        with torch.no_grad():
            if mixup_alpha:
                x, y = spec_augment.mixup_batch(x, y, mixup_alpha, draws=draws.mixup)
            if specaug:
                x = spec_augment.freq_mask(x, draws.freq)
                x = spec_augment.time_mask(x, draws.time)
        with no_tf32():
            if finetune:
                feat = encode(x, draws)
            else:
                with torch.no_grad():
                    feat = encode(x, draws)
            logits = head(feat)
            if single_label:
                loss = -(y * F.log_softmax(logits, dim=-1)).sum(-1).mean()
            else:
                loss = F.binary_cross_entropy_with_logits(logits, y)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train_classifier(cfg, encoder: nn.Module, train_loader, val_loader, n_classes: int,
                     epochs: int = 10, lr: float = 1e-3, finetune: bool = False,
                     mixup_alpha: Optional[float] = 0.2, specaug: bool = False,
                     seed: int = 0, single_label: bool = False,
                     head: Optional[nn.Linear] = None, draws=None):
    """-> (best, best score): `best` holds CPU copies of the best epoch's
    head state ("head"), and with finetune its encoder parameters
    ("encoder") and running statistics ("encoder_batch_stats"); the best
    epoch is the last of the highest val scores (>=, as JAX).

    finetune=False: the encoder frozen in eval mode, Adam(lr) over the head
    (LinearTrainer); finetune=True: Adam(lr) over the head and every
    encoder parameter (a ViT's patch projection too), the encoder in train
    mode in its steps (FinetuneTrainer).  The encoder runs on its own
    device; cfg.use_fp16 runs it in bf16 over copies of its fp32
    parameters, as JAX's apply_encoder.  head: the initial head (else
    init_head from seed).  draws: a callable (epoch, step, x) ->
    ClassifierDraws to replay another implementation's randomness (else
    drawn from generators seeded by seed).  The encoder keeps the trained
    weights of the last epoch."""
    device = next(encoder.parameters()).device
    if head is None:
        head = init_head(encoder.embed_dim, n_classes, torch.Generator().manual_seed(seed))
    head = head.to(device)
    flags = {n: p.requires_grad for n, p in encoder.named_parameters()}
    encoder.requires_grad_(finetune)
    params = list(head.parameters()) + (list(encoder.parameters()) if finetune else [])
    optimizer = torch.optim.Adam(params, lr=lr)
    step = make_classifier_step(cfg, encoder, head, optimizer, finetune, mixup_alpha, specaug,
                                single_label)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    host_gen = torch.Generator().manual_seed(seed + 2)
    mode = "finetune" if finetune else "linear"

    @torch.no_grad()
    def predict(x):
        encoder.eval()
        with no_tf32():
            feat = encoder_forward(cfg, encoder)(
                x, **({"mean_pool": cfg.use_mean_pool}
                      if isinstance(encoder, MaskedAutoencoderViT) else {}))
            return head(feat)

    def evaluate() -> float:
        outs, tgts = [], []
        for x, y in val_loader:
            outs.append(predict(torch.as_tensor(np.asarray(x)).to(device)).cpu().numpy())
            tgts.append(np.asarray(y))
        out, tgt = np.concatenate(outs), np.concatenate(tgts)
        if single_label:
            return float((out.argmax(-1) == tgt.argmax(-1)).mean())
        return mean_average_precision(1 / (1 + np.exp(-out)), tgt)

    best, best_score = _snapshot(head, encoder, finetune), -np.inf
    try:
        for epoch in range(epochs):
            for it, (x, y) in enumerate(train_loader):
                x = torch.as_tensor(np.asarray(x)).to(device, non_blocking=True)
                y = torch.as_tensor(np.asarray(y), dtype=torch.float32).to(device,
                                                                            non_blocking=True)
                d = (draws(epoch, it, x) if draws is not None else
                     draw_classifier_step(gen, host_gen, encoder, tuple(x.shape), finetune,
                                          mixup_alpha, specaug))
                step(x, y, d)
            score = evaluate()
            if score >= best_score:
                best, best_score = _snapshot(head, encoder, finetune), score
            print(f"[{mode}] epoch {epoch + 1}/{epochs} "
                  f"val={'acc' if single_label else 'mAP'} {score:.4f}")
    finally:
        for n, p in encoder.named_parameters():
            p.requires_grad_(flags[n])
    return best, best_score

