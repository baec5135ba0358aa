"""Optimizers and parameter grouping (port of ssl_audio_tpu/train/optim.py).

Grouping rule: parameters with ndim == 1 are "biases" (no weight decay, no
LARS adaptation, lr_biases); everything else is "weights".  Frozen
parameters (frozen_param_names) take neither update nor decay: the train
state turns their gradient off and the optimizer never holds them.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
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


class LRSchedule:
    """lr_factor_fn on the device: its value at every step of the run
    (`n_steps`; a step past the end takes the last value) in an fp32 table,
    as JAX's optax schedule computes it in fp32, read at a device step
    counter that advance() increments in place.  A step captured in a CUDA
    graph therefore reads and advances the schedule at every replay.
    `count` is the same counter on the host; a replay of n captured steps
    advances it by n (train/steps.py)."""

    def __init__(self, factor_fn: Callable[[int], float], n_steps: int, device=None):
        self.factor_fn = factor_fn
        self.table = torch.tensor([factor_fn(s) for s in range(max(int(n_steps), 1))],
                                  dtype=torch.float32, device=device)
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        self.count = 0

    def factor(self) -> torch.Tensor:
        """The factor at the current step: a 0-d fp32 tensor on the device."""
        i = self.counter.clamp(max=self.table.numel() - 1)
        return self.table.index_select(0, i.reshape(1)).reshape(())

    def advance(self) -> None:
        self.counter.add_(1)
        self.count += 1

    def set_count(self, count: int) -> None:
        self.count = int(count)
        self.counter.fill_(self.count)


class LARS(torch.optim.Optimizer):
    """The reference's LARS with weight_decay_filter and
    lars_adaptation_filter both on: 1-D parameters skip the weight decay and
    the trust ratio and use lr_biases.  Per step and parameter p with
    gradient g and momentum buffer mu:

        dp = g                      (1-D)   |   dp = g + wd * p, then
                                            |   dp *= eta |p| / |dp| where
                                            |   both norms are > 0
        mu = momentum * mu + dp
        p -= (lr(p) * factor(step)) * mu

    factor_fn maps the number of steps taken so far to the LR factor; the
    step reads it from an LRSchedule over `n_steps` steps, on the device, so
    a step reads nothing from the host and captures into a CUDA graph.  The
    count travels in state_dict() beside the momentum, so a resumed run
    continues its schedule where it stopped."""

    def __init__(self, params: Iterable, lr_weights: float, lr_biases: float,
                 factor_fn: Callable[[int], float] = lambda step: 1.0,
                 weight_decay: float = 0.0, momentum: float = 0.9,
                 eta: float = 0.001, n_steps: int = 1):
        defaults = dict(lr_weights=lr_weights, lr_biases=lr_biases,
                        weight_decay=weight_decay, momentum=momentum, eta=eta)
        super().__init__(params, defaults)
        device = self.param_groups[0]["params"][0].device
        self.schedule = LRSchedule(factor_fn, n_steps, device)

    @property
    def factor_fn(self) -> Callable[[int], float]:
        return self.schedule.factor_fn

    @property
    def count(self) -> int:
        return self.schedule.count

    @torch.no_grad()
    def step(self, closure=None):
        f = self.schedule.factor()
        for group in self.param_groups:
            # the JAX update, -(lr * f) * mu, in fp32: its step size once per
            # group and kind, then one product and one add per parameter
            neg_lr = {kind: -(group[kind] * f) for kind in ("lr_weights", "lr_biases")}
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
                p.add_(mu * neg_lr["lr_biases" if is_bias else "lr_weights"])
        self.schedule.advance()

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        self.schedule.set_count(state_dict.pop("count"))
        super().load_state_dict(state_dict)


class SGD(torch.optim.Optimizer):
    """optax.sgd: p -= lr * g, no momentum.  Each group's lr is a 0-d tensor
    on the parameters' device (torch's SGD reads a tensor lr on the host,
    which a CUDA graph cannot capture)."""

    def __init__(self, params: Iterable, lr):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            neg_lr = -group["lr"]
            for p in group["params"]:
                if p.grad is not None:
                    p.add_(p.grad * neg_lr)


class DeviceLR:
    """The LR schedule of AdamW / Adam / SGD: before each step, every
    group's lr tensor holds lr * factor(step), read from an LRSchedule on
    the device and written in place, so a captured step sets it at every
    replay.  The scheduler's interface and LambdaLR's state_dict() format
    (last_epoch = the steps taken, base_lrs, _last_lr), so a checkpoint of
    a LambdaLR loads."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: LRSchedule,
                 base_lr: float):
        self.optimizer = optimizer
        self.schedule = schedule
        self.base_lrs = [float(base_lr)] * len(optimizer.param_groups)
        self._write_lrs()

    @property
    def last_epoch(self) -> int:
        return self.schedule.count

    def _write_lrs(self) -> None:
        f = self.schedule.factor()
        for group, base in zip(self.optimizer.param_groups, self.base_lrs):
            group["lr"].copy_(f * base)

    def step(self) -> None:
        """After the optimizer's step: on to the next step's learning rates."""
        self.schedule.advance()
        self._write_lrs()

    def get_last_lr(self) -> list[float]:
        return [base * self.schedule.factor_fn(self.last_epoch) for base in self.base_lrs]

    def state_dict(self) -> dict:
        n = self.last_epoch
        return {"base_lrs": list(self.base_lrs), "last_epoch": n, "_step_count": n + 1,
                "_get_lr_called_within_step": False, "_last_lr": self.get_last_lr(),
                "lr_lambdas": [None] * len(self.base_lrs)}

    def load_state_dict(self, state_dict: dict) -> None:
        self.base_lrs = [float(b) for b in state_dict["base_lrs"]]
        self.schedule.set_count(state_dict["last_epoch"])
        self._write_lrs()


def _own_lr_tensors(optimizer: torch.optim.Optimizer, capturable: bool):
    """A load_state_dict post-hook: a loaded state dict brings its own group
    values (a float lr from a checkpoint of a LambdaLR-driven optimizer, its
    `capturable`); put back this optimizer's lr tensors, which the schedule
    writes and a captured step reads, and, where it captures, Adam's step
    counts on the parameters' device."""
    lrs = [g["lr"] for g in optimizer.param_groups]

    def hook(opt):
        for group, lr in zip(opt.param_groups, lrs):
            group["lr"] = lr
            if "capturable" in group:
                group["capturable"] = capturable
        if capturable:
            for p, st in opt.state.items():
                if torch.is_tensor(st.get("step")):
                    st["step"] = st["step"].to(p.device, torch.float32)

    optimizer.register_load_state_dict_post_hook(hook)


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
    """-> (optimizer, scheduler or None).  The LR factor is an LRSchedule
    over the run's cfg.epochs * niter_per_ep steps on the parameters'
    device: LARS carries it itself; AdamW/Adam/SGD take their lr as a tensor
    that a DeviceLR sets before every step.  On a CUDA device AdamW and
    Adam are capturable (their step counts on the device), so every step
    can be captured in a CUDA graph, and the eager step runs the same
    arithmetic as a graphed one."""
    params = [p for p in params if p.requires_grad]
    factor = lr_factor_fn(cfg, niter_per_ep)
    n_steps = cfg.epochs * niter_per_ep if cfg.lr_schedule else 1
    if cfg.optimizer == "LARS":
        return LARS(params, lr_weights=cfg.lr_weights, lr_biases=cfg.lr_biases,
                    factor_fn=factor, weight_decay=cfg.wd, n_steps=n_steps), None
    if cfg.optimizer not in ("AdamW", "Adam", "SGD"):
        raise ValueError(f"Unknown optimizer {cfg.optimizer}")
    if cfg.lr is None:
        raise ValueError(f"--optimizer {cfg.optimizer} needs --lr (only LARS has "
                         "model-conditional learning-rate defaults for a conv encoder)")
    device = params[0].device
    capturable = device.type == "cuda"
    groups = _decay_groups(params, cfg.wd) if cfg.optimizer == "AdamW" else [{"params": params}]
    for group in groups:
        group["lr"] = torch.tensor(float(cfg.lr), device=device)
    if cfg.optimizer == "AdamW":
        # optax.adamw defaults: b1 0.9, b2 0.999, eps 1e-8
        opt = torch.optim.AdamW(groups, capturable=capturable)
    elif cfg.optimizer == "Adam":
        opt = torch.optim.Adam(groups, capturable=capturable)
    else:
        opt = SGD(groups, lr=groups[0]["lr"])
    _own_lr_tensors(opt, capturable)
    return opt, DeviceLR(opt, LRSchedule(factor, n_steps, device), cfg.lr)


def legacy_cosine_factor(base_value: float, final_value: float, epochs: int,
                         niter_per_ep: int, warmup_epochs: int = 0,
                         start_warmup_value: float = 0.0) -> Callable[[int], float]:
    """The legacy trainers' per-iteration cosine schedule as a function of
    the step, in the JAX function's fp32 arithmetic
    (ssl_audio_tpu/train/optim.py legacy_cosine_factor): step i of the
    warm-up gets start + (base - start) * i / (warmup_iters - 1), as
    np.linspace does (utils/schedules.py cosine_scheduler), then
    final + (base - final) / 2 * (1 + cos(pi j / span)); steps past the
    budget keep final_value."""
    f32 = np.float32
    warmup_iters = int(warmup_epochs * niter_per_ep)
    span = max(int(epochs * niter_per_ep) - warmup_iters, 1)
    half_range, final = f32(0.5 * (base_value - final_value)), f32(final_value)

    def factor(step: int) -> float:
        s = f32(step)
        if s < warmup_iters:
            if warmup_iters <= 1:
                return float(f32(start_warmup_value))
            return float(f32(start_warmup_value) + f32(base_value - start_warmup_value)
                         * (s / f32(warmup_iters - 1)))
        j = np.clip(s - f32(warmup_iters), f32(0), f32(span))
        # the cosine of the fp32 argument rounded to fp32 (XLA's fp32 cos,
        # a polynomial of its own, lands within one ulp of it)
        cos = f32(np.cos(np.float64(f32(np.pi) * j / f32(span))))
        return float(final + half_range * (f32(1) + cos))

    return factor


class LegacySchedule:
    """The DINO recipe's schedules on the host: before each step every
    group's lr is lr_fn(count) and each decayed group's weight_decay
    wd_fn(count), written as floats (optax.inject_hyperparams reads its
    schedules at the update's count); step() moves on to the next.  The
    count travels in state_dict()."""

    def __init__(self, optimizer: torch.optim.Optimizer, lr_fn: Callable[[int], float],
                 wd_fn: Callable[[int], float]):
        self.optimizer, self.lr_fn, self.wd_fn = optimizer, lr_fn, wd_fn
        self.count = 0
        self._write()

    def _write(self) -> None:
        lr, wd = self.lr_fn(self.count), self.wd_fn(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
            if group["decay"]:
                group["weight_decay"] = wd

    def step(self) -> None:
        self.count += 1
        self._write()

    def state_dict(self) -> dict:
        return {"count": self.count}

    def load_state_dict(self, state_dict: dict) -> None:
        self.count = int(state_dict["count"])
        self._write()


def make_legacy_optimizer(cfg, method: str, params: Iterable, niter_per_ep: int):
    """-> (optimizer, scheduler or None): the legacy trainers' own
    optimizers (JAX make_legacy_optimizer), not the Barlow Twins recipe.

    dino: AdamW (b1 0.9, b2 0.999, eps 1e-8) with the lr base_lr *
    batch_size / 256 on a cosine to final_lr after warmup_epochs of linear
    warm-up (step 0 has lr 0), and the weight decay on a cosine from wd to
    final_wd, on ndim > 1 parameters only (a LegacySchedule writes both
    every step).  byola: Adam at the constant lr base_lr over every
    parameter.  The defaults (5e-4, 0.04 -> 0.4; 3e-4) are setup_model_defaults'
    method recipes, for a configuration made without them."""
    params = [p for p in params if p.requires_grad]
    if method == "byola":
        lr = cfg.base_lr if cfg.base_lr is not None else 3.0e-4
        return torch.optim.Adam(params, lr=lr), None
    if method != "dino":
        raise ValueError(f"no legacy optimizer for method {method!r}")
    base = cfg.base_lr if cfg.base_lr is not None else 5.0e-4
    # the linear scaling rule of the reference, on the global batch
    lr_fn = legacy_cosine_factor(base * cfg.batch_size / 256.0, cfg.final_lr, cfg.epochs,
                                 niter_per_ep, warmup_epochs=cfg.warmup_epochs)
    wd_fn = legacy_cosine_factor(cfg.wd if cfg.wd is not None else 0.04,
                                 cfg.final_wd if cfg.final_wd is not None else 0.4,
                                 cfg.epochs, niter_per_ep)
    groups = _decay_groups(params, 0.0)
    groups[0]["decay"], groups[1]["decay"] = True, False
    opt = torch.optim.AdamW(groups, lr=0.0)
    return opt, LegacySchedule(opt, lr_fn, wd_fn)
