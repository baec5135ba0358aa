"""The Barlow Twins training steps (port of ssl_audio_tpu/train/steps.py:
init_monitor, make_device_frontend, make_train_step, make_byol_train_step,
make_multi_train_step).

One call = one iteration: [raw wav -> cropped, normalised log-mel] -> two
augmented views -> teacher and student forwards -> Barlow Twins loss (+ the
masked-reconstruction loss of a ViT with masked_recon) -> backward ->
optimizer update.  It runs eagerly.  Every random number of a step (crop
starts, augmentation parameters, AudioNTT's dropout keep masks, a ViT's
token-mask noise and DropPath keep masks; a ResNet draws none of its own)
is drawn up front into a StepDraws from a torch.Generator, or handed in by
the caller, so two implementations can be stepped on the same draws.

For a ViT the teacher view is masked at the step's mask_ratio (key-bias
masking, or token drop with a static len_keep; train/loop.py picks both per
step) and the students are not, as in the JAX step.  The BYOL-style step
(make_byol_train_step, main_bt_byol) runs an online net on both global
views, masked, and a target net on every view, unmasked; its target is an
EMA of the online net (--stop_gradient) or trains beside it.

With --use_fp16 the encoder forwards run in bf16 over bf16 copies of the
fp32 master parameters, taken once per step (train/state.py
encoder_forward); the frontend, the views, the heads, the loss and the
optimizer stay fp32.

--steps_per_dispatch N (make_multi_train_step): a window of N steps is one
CUDA graph on the card, the counterpart of JAX's lax.scan over N steps.
Everything a step reads or advances is device state (the LR schedule's
counter, the mixup ring's count and position, the running norm, the
generator the draws come from, a ViT teacher's mask ratio as a tensor), so a
replay takes N real steps.  On the CPU the same function runs the N steps
eagerly, in order.

Data parallel (parallel/): in a process group `batch` is this rank's B / W
rows of the global batch; the step draws the global batch's random numbers
and keeps its rows, every batch reduction (BatchNorm, the fused block, the
loss, the mixup bank) is global, the loss is the same on every rank and
carries world_scale = W (the Trainer passes it), and the gradients are
averaged over ranks in one flat all-reduce before the optimizer step; a
captured window holds those all-reduces (NCCL) like the rest.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from ssl_audio_tpu_torch.augment.cifar import (
    CifarPairDraws,
    apply_cifar_pair_views,
    draw_cifar_pair_views,
)
from ssl_audio_tpu_torch.augment.transforms import (
    PairDraws,
    apply_pair_views,
    draw_pair_views,
)
from ssl_audio_tpu_torch.models.audiontt import DROPOUT_RATE, AudioNTT2022
from ssl_audio_tpu_torch.models.vit import MaskedAutoencoderViT
from ssl_audio_tpu_torch.objectives.barlow import barlow_twins_loss
from ssl_audio_tpu_torch import ops, parallel
from ssl_audio_tpu_torch.ops import no_tf32
from ssl_audio_tpu_torch.ops.mel import MelSpec, log_mel_spectrogram_cropped
from ssl_audio_tpu_torch.train.state import TrainState, encoder_forward


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


def _map_tensors(obj, fn):
    """obj with fn applied to every tensor in it (tuples, lists,
    dataclasses)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _map_tensors(getattr(obj, f.name), fn)
                            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_tensors(v, fn) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_tensors(v, fn) for v in obj)
    return obj


@dataclass
class StepDraws:
    """Every random number of one step; per encoder forward where a list
    (teacher view, student view, local crops; for BYOL the two online
    passes, then the target's: pass_sizes)."""
    starts: Optional[torch.Tensor]     # (B,) frontend crop starts; None for log-mel batches
    views: Union[PairDraws, CifarPairDraws]     # the audio pair's, or CIFAR-10's
    dropout: Optional[List[torch.Tensor]] = None    # AudioNTT: keep masks (B, T/4, hidden);
                                                    # None for a ResNet (no dropout)
    noise: Optional[List[torch.Tensor]] = None      # ViT: token-mask noise (B, L)
    # ViT with DropPath: per view, per block, keep masks (2, B), None at rate 0
    drop_path: Optional[List[List[Optional[torch.Tensor]]]] = None

    def to(self, device) -> "StepDraws":
        """The same draws on another device (to step two devices alike)."""
        return _map_tensors(self, lambda t: t.to(device))

    def rows(self, lo: int, hi: int) -> "StepDraws":
        """The draws of rows lo..hi-1 of the batch (a rank's share of the
        global batch's draws): every tensor's first axis, a DropPath keep
        mask's second."""
        out = _map_tensors(dataclasses.replace(self, drop_path=None), lambda t: t[lo:hi])
        if self.drop_path is not None:
            out.drop_path = [[None if k is None else k[:, lo:hi] for k in view]
                             for view in self.drop_path]
        return out


def pass_sizes(cfg, byol: bool = False) -> list:
    """The (n_mels, frames) input of each encoder forward of a step, in the
    order of their draws: the two global views and the local crops; for
    BYOL the online passes over the two global views first (JAX's
    _view_rngs(ks, 0), (ks, 1)), then the target's over every view
    (_view_rngs(ks, 2 + i)).  CIFAR-10's pair is two 32 x 32 views and no
    local crops (JAX Modules.make_views)."""
    if cfg.dataset == "cifar10":
        views = [(32, 32)] * 2
    else:
        views = [(cfg.n_mels, cfg.crop_frames)] * 2 + \
            [tuple(cfg.local_crops_size)] * cfg.local_crops_number
    return views[:2] + views if byol else views


def draw_step(gen: torch.Generator, cfg, batch_shape, encoder, device=None,
              wav: bool = False, byol: bool = False) -> StepDraws:
    """Draw a step's random numbers from `gen` (a generator on `device`) for
    `encoder`, one set per encoder forward (pass_sizes).  batch_shape: (B, L)
    raw wavs when `wav`, (B, 32, 32, 3) images for cifar10, else (B, 1,
    n_mels, crop_frames)."""
    B = batch_shape[0]
    starts = None
    if wav:
        starts = torch.randint(0, crop_start_bound(cfg, batch_shape[-1]), (B,),
                               generator=gen, device=device, dtype=torch.int32)
    lms_shape = (B, 1, cfg.n_mels, cfg.crop_frames)
    sizes = pass_sizes(cfg, byol)
    dropout = noise = drop_path = None
    if isinstance(encoder, MaskedAutoencoderViT):
        ph, pw = encoder.spec.patch_size
        noise = [torch.rand(B, (f // ph) * (t // pw), generator=gen, device=device)
                 for f, t in sizes]
        if encoder.spec.drop_path_rate > 0:
            drop_path = [[torch.rand(2, B, generator=gen, device=device) >= blk.drop_path.rate
                          if blk.drop_path.rate > 0 else None for blk in encoder.blocks]
                         for _ in sizes]
    elif isinstance(encoder, AudioNTT2022):
        hidden = encoder.fc[0].out_features
        dropout = [torch.rand(B, t // 4, hidden, generator=gen, device=device) >= DROPOUT_RATE
                   for _, t in sizes]
    views = (draw_cifar_pair_views(gen, B, device) if cfg.dataset == "cifar10"
             else draw_pair_views(gen, cfg, lms_shape, device))
    return StepDraws(starts, views, dropout, noise, drop_path)


def _views(cfg, state: TrainState, batch: torch.Tensor, gen, draws: Optional[StepDraws],
           frontend, byol: bool = False):
    """-> (draws, views): the step's draws (drawn from `gen` unless given)
    and its augmented views of `batch` (through `frontend` first when
    given; a batch of uint8 images through the CIFAR pair for cifar10);
    the mixup bank advances.  The draws are the global batch's:
    in a process group `batch` is this rank's B rows, every rank draws the
    W B rows' numbers from the same generator and keeps its own rows, so a
    run of W ranks takes the draws of one process on the global batch."""
    B = batch.shape[0]
    if draws is None:
        draws = draw_step(gen, cfg, (parallel.batch_count(B), *batch.shape[1:]),
                          state.modules["encoder"], batch.device, wav=frontend is not None,
                          byol=byol)
    lo = parallel.rank() * B
    draws = draws.rows(lo, lo + B)
    with torch.no_grad():
        if frontend is not None:
            batch = frontend(batch, draws.starts)
        if cfg.dataset == "cifar10":
            views = apply_cifar_pair_views(batch, draws.views)
        else:
            views = apply_pair_views(batch, state.aug, cfg, draws.views)
    return draws, views


def _encode(cfg, vit: bool, run_encoder, draws: StepDraws, i: int, v: torch.Tensor,
            masking=None):
    """Encoder forward i of a step on view v with its draws: AudioNTT's
    dropout mask, or a ViT's token-mask noise and DropPath masks and, for a
    masked pass, `masking` (mask_ratio, len_keep, masked_recon); a ResNet's
    pass takes none."""
    if not vit:
        return run_encoder(v) if draws.dropout is None else run_encoder(v, draws.dropout[i])
    return run_encoder(v, mean_pool=cfg.use_mean_pool, noise=draws.noise[i],
                       drop_keep=None if draws.drop_path is None else draws.drop_path[i],
                       **(masking or {}))


def _finish(state: TrainState, loss, bt, recon, monitor):
    """The gradients' mean over ranks (in a process group), the optimizer
    and scheduler step after the backward, the step count, the metrics (and
    the monitor folded with the loss when given).  The loss and its terms
    are the global batch's, the same on every rank."""
    parallel.all_reduce_grads_(state.optimizer)
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1
    loss = loss.detach()
    metrics = {"loss": loss, "bt_loss": bt.detach(), "recon_loss": recon.detach()}
    if monitor is None:
        return metrics
    return metrics, _fold_monitor(monitor, loss)


def make_train_step(cfg, world_scale: float = 1.0, frontend=None):
    """-> train_step(state, batch, gen=None, draws=None, monitor=None,
    mask_ratio=0.0, len_keep=None) -> metrics, or (metrics, monitor) when a
    monitor is passed.

    batch: (B, 1, n_mels, crop_frames) normalised log-mels, or raw (B, L)
    wavs when `frontend` (make_device_frontend) is given.  The step updates
    `state` in place (parameters, running statistics, optimizer momentum,
    mixup bank, step count).  Randomness: `draws`, or drawn from `gen`.
    mask_ratio, len_keep: a ViT teacher's masking (train/loop.py)."""

    def train_step(state: TrainState, batch: torch.Tensor, gen=None,
                   draws: Optional[StepDraws] = None, monitor=None,
                   mask_ratio: float = 0.0, len_keep: Optional[int] = None):
        mods = state.modules
        encoder, head, predictor = mods["encoder"], mods["head"], mods["predictor"]
        mods.train()
        draws, views = _views(cfg, state, batch, gen, draws, frontend)
        vit = isinstance(encoder, MaskedAutoencoderViT)
        masking = dict(mask_ratio=mask_ratio, len_keep=len_keep, masked_recon=cfg.masked_recon)

        # cuDNN's TF32 flag is read when a kernel is chosen: the backward
        # convolutions run inside loss.backward(), so it stays in the context
        with no_tf32():
            run_encoder = encoder_forward(cfg, encoder)
            # teacher: first global view, masked (a ViT), head + predictor
            t_out = _encode(cfg, vit, run_encoder, draws, 0, views[0], masking)
            recon = torch.zeros((), device=batch.device)
            if vit and cfg.masked_recon:
                t_out, recon = t_out
            t_z = predictor(head(t_out))
            # student: second global view + locals, unmasked
            student_zs = []
            for i, v in enumerate(views[1:], start=1):
                s_z = head(_encode(cfg, vit, run_encoder, draws, i, v))
                student_zs.append(s_z.detach() if cfg.stop_gradient else s_z)
            bt = barlow_twins_loss(student_zs, [t_z], lmbda=cfg.lmbda, alpha=cfg.alpha,
                                   HSIC=cfg.HSIC, world_scale=world_scale)
            loss = bt + recon
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        return _finish(state, loss, bt, recon, monitor)

    return train_step


def ema_update_(target: nn.Module, online: nn.Module, step_size: float) -> None:
    """target <- step_size * online + (1 - step_size) * target, in place,
    parameter by parameter (optax.incremental_update: the two products
    rounded to fp32 and then added; 1 - step_size taken in Python double).
    Buffers (BatchNorm running statistics) are left alone."""
    tgt = [p.detach() for p in target.parameters()]
    new = [p.detach() for p in online.parameters()]
    torch._foreach_mul_(tgt, 1.0 - step_size)
    torch._foreach_add_(tgt, torch._foreach_mul(new, step_size))


def make_byol_train_step(cfg, world_scale: float = 1.0, frontend=None):
    """The BYOL-style step (JAX make_byol_train_step, train/steps.py:192-302;
    reference main_bt_byol.py:40-166), with make_train_step's signature.

    The online encoder and head take both global views, masked as a ViT
    teacher is (mask_ratio, len_keep); the predictor runs once over their
    concatenation (BatchNorm over 2B rows); the target's encoder and head
    take every view, unmasked, in train mode (its running statistics move;
    its predictor is never applied); the loss pairs each online view with
    the other view's target.  With --masked_recon the recon loss is the mean
    of the two online passes'.

    --stop_gradient: the target runs under torch.no_grad() and, after the
    backward and before the optimizer step, moves to an EMA of the pre-step
    online parameters, decay cfg.moving_average_decay (a constant).
    Otherwise the target trains by gradient under the same optimizer, and
    every parameter the loss does not reach (the target's predictor, a
    target decoder) gets a zero gradient first, as JAX's grads tree holds
    zeros there: LARS and AdamW still move it by their weight decay."""
    step_size = 1.0 - float(cfg.moving_average_decay)

    def train_step(state: TrainState, batch: torch.Tensor, gen=None,
                   draws: Optional[StepDraws] = None, monitor=None,
                   mask_ratio: float = 0.0, len_keep: Optional[int] = None):
        mods = state.modules
        encoder, head, predictor, target = (mods["encoder"], mods["head"], mods["predictor"],
                                            mods["target"])
        mods.train()
        draws, views = _views(cfg, state, batch, gen, draws, frontend, byol=True)
        vit = isinstance(encoder, MaskedAutoencoderViT)
        masking = dict(mask_ratio=mask_ratio, len_keep=len_keep, masked_recon=cfg.masked_recon)

        with no_tf32():
            run_online = encoder_forward(cfg, encoder)
            recon = torch.zeros((), device=batch.device)
            online = []
            for i, v in enumerate(views[:2]):
                out = _encode(cfg, vit, run_online, draws, i, v, masking)
                if vit and cfg.masked_recon:
                    out, rl = out
                    recon = recon + rl / 2.0
                online.append(head(out))
            online = list(predictor(torch.cat(online)).chunk(2))
            with torch.no_grad() if cfg.stop_gradient else contextlib.nullcontext():
                run_target = encoder_forward(cfg, target["encoder"])
                target_zs = [target["head"](_encode(cfg, vit, run_target, draws, 2 + i, v))
                             for i, v in enumerate(views)]
            bt = barlow_twins_loss(online, target_zs[:2], lmbda=cfg.lmbda, alpha=cfg.alpha,
                                   HSIC=cfg.HSIC, world_scale=world_scale)
            loss = bt + recon
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if cfg.stop_gradient:
            with torch.no_grad():
                ema_update_(target, nn.ModuleList([encoder, head, predictor]), step_size)
        else:
            for group in state.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
        return _finish(state, loss, bt, recon, monitor)

    return train_step


MAX_GRAPHS = 2      # captured windows kept, one per token-drop len_keep (the
                    # sine schedule only moves forward: the last two suffice)


@dataclass
class _Window:
    """One captured window of N steps: the graph, the monitor it starts
    from (a static input), its stacked metrics and final monitor (static
    outputs), the kernel launches its capture saw and the host seconds the
    capture took."""
    graph: object
    monitor_in: dict
    metrics: dict
    monitor_out: dict
    launches: dict
    capture_s: float


def _stack(metrics: list) -> dict:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def make_multi_train_step(cfg, n_steps: int, world_scale: float = 1.0, frontend=None,
                          byol: bool = False):
    """-> multi_step(state, batches (N, B, ...), mask_ratios (N,), monitor,
    len_keep=None, *, gen) -> (metrics stacked (N,), monitor): N training
    steps in one dispatch (--steps_per_dispatch, JAX's make_multi_train_step).
    Step i runs on batches[i] with the teacher's mask ratio mask_ratios[i]
    (host numbers, drawn by the loop; the model gets each as a 0-d fp32
    tensor, so every step of a window has its own ratio, as JAX's traced
    ratios) and the window's static token-drop count len_keep.  Every random number comes
    from `gen`, in order.

    On the CPU the N steps run eagerly, in order: the plain version.  On the
    card the window is a CUDA graph.  The first full window after the
    function is made, after the state was loaded (TrainState.version) or
    with another generator runs eagerly: it builds what a capture must not
    allocate from the host (the kernels, the mel tables, the optimizer's
    moments, cuDNN's plans).  Every later window replays the graph of its
    len_keep, captured on first use (at most MAX_GRAPHS kept).  A capture
    runs no kernel, so a captured window is then replayed to take its
    steps.  Before a replay the batches, ratios and monitor are copied into
    the graph's static inputs on the current stream (multi_step.inputs
    hands out the batches' buffer, which the loop fills straight from the
    loader's pinned slots); after it the host counters advance by N
    (TrainState.advance_host) and the kernels' launch counters by what the
    capture saw.  A failed capture raises: nothing falls back to eager
    windows.  byol: windows of make_byol_train_step (the EMA's in-place
    updates are captured with the rest)."""
    factory = make_byol_train_step if byol else make_train_step
    step = factory(cfg, world_scale=world_scale, frontend=frontend)
    graphs: "OrderedDict[Optional[int], _Window]" = OrderedDict()
    static = {"batches": None, "ratios": None, "owner": None}

    def ratio(ratios: torch.Tensor, i: int):
        # a model without masking keeps the unmasked path of a Python 0
        return ratios[i] if cfg.mask else 0.0

    def run_eagerly(state, batches, ratios, monitor, len_keep, gen):
        metrics = []
        for i in range(n_steps):
            m, monitor = step(state, batches[i], gen=gen, monitor=monitor,
                              mask_ratio=ratio(ratios, i), len_keep=len_keep)
            metrics.append(m)
        return _stack(metrics), monitor

    def inputs(batch_shape, device) -> torch.Tensor:
        """The (N, *batch_shape) device buffer every graph reads its batches
        from (a new shape or device drops the graphs)."""
        shape, device = (n_steps, *batch_shape), torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        buf = static["batches"]
        if buf is None or tuple(buf.shape) != shape or buf.device != device:
            graphs.clear()
            buf = static["batches"] = torch.empty(shape, device=device)
            static["ratios"] = torch.zeros(n_steps, device=device)
        return buf

    def capture(state, monitor, len_keep, gen) -> _Window:
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError("this torch cannot register a generator with a CUDA graph: "
                               "--steps_per_dispatch > 1 needs it on the card")
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        monitor_in = {k: v.clone() for k, v in monitor.items()}
        host, launches = state.host_counters(), ops.launch_counts()
        # thread_local: the loader's producer thread may wait on events and
        # pin memory while this thread captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            metrics, monitor_out = run_eagerly(state, static["batches"], static["ratios"],
                                               monitor_in, len_keep, gen)
        # the capture ran the step's Python N times and launched nothing
        state.set_host_counters(host)
        seen = ops.launch_counts()
        ops.set_launch_counts(launches)
        return _Window(graph, monitor_in, metrics, monitor_out,
                       {k: seen[k] - launches[k] for k in seen}, time.perf_counter() - t0)

    def multi_step(state, batches, mask_ratios, monitor, len_keep: Optional[int] = None, *,
                   gen: torch.Generator):
        if batches.shape[0] != n_steps or len(mask_ratios) != n_steps:
            raise ValueError(f"a window is {n_steps} batches and ratios, got "
                             f"{batches.shape[0]} and {len(mask_ratios)}")
        ratios = torch.from_numpy(np.asarray(mask_ratios, np.float32))
        if batches.device.type != "cuda":
            return run_eagerly(state, batches, ratios, monitor, len_keep, gen)
        buf = inputs(batches.shape[1:], batches.device)
        if batches.data_ptr() != buf.data_ptr():
            buf.copy_(batches)
        static["ratios"].copy_(ratios.pin_memory(), non_blocking=True)
        owner = (id(state), state.version, id(gen))
        if static["owner"] != owner:
            # another state, a loaded one or another generator: the graphs
            # read stale tensors; warm up again, eagerly
            graphs.clear()
            static["owner"] = owner
            return run_eagerly(state, buf, static["ratios"], monitor, len_keep, gen)
        window = graphs.pop(len_keep, None)
        if window is None:
            window = capture(state, monitor, len_keep, gen)
        graphs[len_keep] = window
        while len(graphs) > MAX_GRAPHS:
            graphs.popitem(last=False)
        for k, v in monitor.items():
            window.monitor_in[k].copy_(v)
        window.graph.replay()
        state.advance_host(n_steps)
        ops.add_launch_counts(window.launches)
        return ({k: v.clone() for k, v in window.metrics.items()},
                {k: v.clone() for k, v in window.monitor_out.items()})

    multi_step.inputs = inputs
    multi_step.graphs = graphs
    return multi_step
