"""Optimizers and parameter grouping (port of ssl_audio_tpu/train/optim.py).

Grouping rule: parameters with ndim == 1 are "biases" (no weight decay, no
LARS adaptation, lr_biases); everything else is "weights".  Frozen
parameters (frozen_param_names) take neither update nor decay: the train
state turns their gradient off and the optimizer never holds them.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch


def lr_factor_fn(cfg, niter_per_ep: int) -> Callable[[int], float]:
    """Per-step LR factor.  With --lr_schedule, the reference's
    warmup + cosine factor (peak batch_size / 128, floor 0.001 x); otherwise
    constant 1."""
    if not cfg.lr_schedule:
        return lambda step: 1.0
    max_steps = cfg.epochs * niter_per_ep * 1.25
    warmup_steps = int(cfg.epochs / 100) * niter_per_ep
    base_lr = cfg.batch_size / 128

    def factor(step: int) -> float:
        if warmup_steps > 0 and step < warmup_steps:
            return base_lr * step / warmup_steps
        q = 0.5 * (1 + math.cos(math.pi * (step - warmup_steps) / (max_steps - warmup_steps)))
        return base_lr * q + (base_lr * 0.001) * (1 - q)

    return factor


class LARS(torch.optim.Optimizer):
    """The reference's LARS with weight_decay_filter and
    lars_adaptation_filter both on: 1-D parameters skip the weight decay and
    the trust ratio and use lr_biases.  Per step and parameter p with
    gradient g and momentum buffer mu:

        dp = g                      (1-D)   |   dp = g + wd * p, then
                                            |   dp *= eta |p| / |dp| where
                                            |   both norms are > 0
        mu = momentum * mu + dp
        p -= lr(p) * factor(step) * mu

    factor_fn maps the number of steps taken so far to the LR factor.  The
    count travels in state_dict() beside the momentum, so a resumed run
    continues its schedule where it stopped."""

    def __init__(self, params: Iterable, lr_weights: float, lr_biases: float,
                 factor_fn: Callable[[int], float] = lambda step: 1.0,
                 weight_decay: float = 0.0, momentum: float = 0.9,
                 eta: float = 0.001):
        defaults = dict(lr_weights=lr_weights, lr_biases=lr_biases,
                        weight_decay=weight_decay, momentum=momentum, eta=eta)
        super().__init__(params, defaults)
        self.factor_fn = factor_fn
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        f = self.factor_fn(self.count)
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                is_bias = p.ndim == 1
                dp = p.grad
                if not is_bias:
                    dp = dp.add(p, alpha=group["weight_decay"])
                    p_norm = torch.linalg.vector_norm(p)
                    u_norm = torch.linalg.vector_norm(dp)
                    q = torch.where((p_norm > 0.0) & (u_norm > 0.0),
                                    group["eta"] * p_norm / u_norm,
                                    torch.ones_like(p_norm))
                    dp = dp * q
                state = self.state[p]
                if "mu" not in state:
                    state["mu"] = torch.zeros_like(p)
                mu = state["mu"].mul_(group["momentum"]).add_(dp)
                lr = group["lr_biases"] if is_bias else group["lr_weights"]
                p.add_(mu, alpha=-lr * f)
        self.count += 1

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)


def frozen_param_names(cfg, named_params) -> set[str]:
    """Names of the parameters that must not be updated: the patch
    projection of a ViT without the conv stem (a random projection, frozen;
    reference mae.py:190-192)."""
    if "vit" not in cfg.model_type or cfg.model_type.startswith("vitc"):
        return set()
    return {name for name, _ in named_params if "patch_embed" in name}


def _decay_groups(params: Iterable, weight_decay: float):
    """ndim > 1 decayed, 1-D parameters not (the reference's
    get_param_groups)."""
    params = list(params)
    return [{"params": [p for p in params if p.ndim > 1], "weight_decay": weight_decay},
            {"params": [p for p in params if p.ndim <= 1], "weight_decay": 0.0}]


def make_optimizer(cfg, params: Iterable, niter_per_ep: int):
    """-> (optimizer, scheduler or None).  LARS carries its LR factor
    itself; AdamW/Adam/SGD get a LambdaLR with the same factor, stepped once
    per training step."""
    params = [p for p in params if p.requires_grad]
    factor = lr_factor_fn(cfg, niter_per_ep)
    if cfg.optimizer == "LARS":
        return LARS(params, lr_weights=cfg.lr_weights, lr_biases=cfg.lr_biases,
                    factor_fn=factor, weight_decay=cfg.wd), None
    if cfg.optimizer not in ("AdamW", "Adam", "SGD"):
        raise ValueError(f"Unknown optimizer {cfg.optimizer}")
    if cfg.lr is None:
        raise ValueError(f"--optimizer {cfg.optimizer} needs --lr (only LARS has "
                         "model-conditional learning-rate defaults for a conv encoder)")
    if cfg.optimizer == "AdamW":
        # optax.adamw defaults: b1 0.9, b2 0.999, eps 1e-8
        opt = torch.optim.AdamW(_decay_groups(params, cfg.wd), lr=cfg.lr)
    elif cfg.optimizer == "Adam":
        opt = torch.optim.Adam(params, lr=cfg.lr)
    else:
        opt = torch.optim.SGD(params, lr=cfg.lr)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)
