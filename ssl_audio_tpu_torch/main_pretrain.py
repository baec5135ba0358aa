"""Pretraining by objective family (the root main_pretrain.py of the JAX
package; reference old/main_pretrain.py):

    python -m ssl_audio_tpu_torch.main_pretrain --method dino --dataset synthetic \\
        --model_type audiontt --epochs 1 --batch_size 128

--method barlow   the Barlow Twins Trainer (as main), checkpoints under
                  results/{dataset}/barlow_{model_type}
--method dino     DINO: EMA teacher, centred and sharpened cross-entropy,
                  multi-crop on a ViT (--local_crops_number)
--method byola    BYOL-A: online projector and predictor against an EMA
                  target projector, symmetric normalised MSE

dino and byola run the legacy trainers' own recipes (config.py
setup_model_defaults(method=...)): the teacher temperature per epoch
(warm-up from --warmup_teacher_temp over --warmup_teacher_temp_epochs), the
teacher momentum per iteration on a cosine from --momentum_teacher to 1,
and one checkpoint, results/{dataset}/{method}_{model_type}/model_{epochs}.pt
(the port's format; linear, the HEAR wrappers and the eval stack read its
encoder through utils/checkpoint.py load_encoder_checkpoint).
`--resume_path FILE.pt` continues from a checkpoint of the same flags, one
converted from a JAX run's (tools/convert_checkpoint.py --to pt) included.  Each epoch
prints `[{method}] epoch e/E loss=...` (the epoch's last step) and a
non-finite loss at any step raises.

Their input is log-mel batches, as in JAX, which feeds the loader's
batches straight into the views: a dataset of raw waveforms
(synthetic_wav, audioset_wav) raises ValueError before any work.  Runs on
the card; without one it raises unless `--device cpu` is given.
`--config FILE.yaml` reads settings from a yaml file first (the legacy
recipes' keys: config.py parse_config); flags on the command line win.

Data parallel, as main: one process per GPU under torchrun,

    torchrun --nproc_per_node N -m ssl_audio_tpu_torch.main_pretrain \\
        --method dino --distributed ...

`--batch_size` is the global batch (each rank loads its B / N rows), the
steps take the global batch's statistics, loss and DINO centre
(train/legacy_steps.py), and rank 0 alone prints, writes the checkpoint and
runs eval_fn.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ssl_audio_tpu_torch import parallel
from ssl_audio_tpu_torch.config import (
    Config,
    build_argparser,
    parse_config,
    require_supported,
    setup_model_defaults,
)
from ssl_audio_tpu_torch.utils.checkpoint import save_checkpoint

WAV_DATASETS = ("synthetic_wav", "audioset_wav")


def require_legacy_runnable(cfg, method: str) -> None:
    """Raise before any work where a dino / byola run cannot start: a part
    not ported yet, multi-crop DINO on AudioNTT2022
    (train/legacy_steps.py require_legacy_supported), or a dataset of raw
    waveforms."""
    from ssl_audio_tpu_torch.train.legacy_steps import require_legacy_supported

    require_legacy_supported(cfg, method)
    if cfg.dataset in WAV_DATASETS:
        raise ValueError(
            f"--method {method} takes log-mel batches (the loader's batches go straight "
            f"into the views, as in JAX); --dataset {cfg.dataset} yields raw waveforms: "
            "pick a log-mel dataset (synthetic, synthetic_multicue, fsd50k, audioset, ...)")


class LegacyTrainer:
    """The legacy families' epoch loop (JAX main_pretrain.run_legacy): the
    loader over `dataset` (the configured one by default), the state, the
    step and its schedules.  epoch_losses maps each epoch run to the mean
    of its steps' losses.  In a process group cfg.batch_size is the global
    batch: each rank's loader yields its B / W rows of it (JAX
    train/loop.py), and rank 0 alone prints and runs eval_fn; with
    cfg.distributed outside a process group it raises
    (parallel.require_joined)."""

    def __init__(self, cfg, method: str, dataset=None):
        from ssl_audio_tpu_torch.data.pipeline import DataLoader
        from ssl_audio_tpu_torch.objectives.dino import teacher_temp_schedule
        from ssl_audio_tpu_torch.train import legacy_steps
        from ssl_audio_tpu_torch.train.loop import get_train_dataset
        from ssl_audio_tpu_torch.utils import resolve_device
        from ssl_audio_tpu_torch.utils.schedules import cosine_scheduler

        require_legacy_runnable(cfg, method)
        parallel.require_joined(cfg)
        self.cfg, self.method = cfg, method
        self.device = resolve_device(cfg.device)
        self.lead = parallel.rank() == 0
        world = parallel.world_size()
        if cfg.batch_size % world:
            raise ValueError(f"--batch_size {cfg.batch_size} must divide across the "
                             f"{world} processes")
        dataset = dataset if dataset is not None else get_train_dataset(cfg)
        self.loader = DataLoader(dataset, cfg.batch_size // world, num_workers=cfg.num_workers,
                                 seed=cfg.seed, device=self.device,
                                 log=print if self.lead else (lambda *a, **k: None),
                                 process_index=parallel.rank(), process_count=world)
        self.niter_per_ep = len(self.loader)
        self.state = legacy_steps.init_legacy_state(
            cfg, torch.Generator().manual_seed(cfg.seed), method,
            niter_per_ep=self.niter_per_ep, device=self.device)
        if method == "dino":
            self.step = legacy_steps.make_dino_train_step(cfg)
            # the teacher temperature per epoch, the momentum per global iteration
            self.temp = teacher_temp_schedule(
                cfg.warmup_teacher_temp, cfg.teacher_temp,
                min(cfg.warmup_teacher_temp_epochs, cfg.epochs), cfg.epochs)
            self.momentum = cosine_scheduler(cfg.momentum_teacher, 1.0, cfg.epochs,
                                             self.niter_per_ep)
        else:
            self.step = legacy_steps.make_byola_train_step(cfg)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.epoch_losses: dict[int, float] = {}

    def train_one_epoch(self, epoch: int) -> float:
        """-> the epoch's last loss; raises if any step's loss is not
        finite (the losses stay on the device until the epoch's end)."""
        self.loader.set_epoch(epoch)
        losses = []
        for i, (lms, _y) in enumerate(self.loader):
            batch = torch.as_tensor(lms).to(self.device, non_blocking=True)
            if self.method == "dino":
                it = (epoch - 1) * self.niter_per_ep + i
                m = self.step(self.state, batch, np.float32(self.temp[epoch - 1]),
                              np.float32(self.momentum[it]), gen=self.gen)
            else:
                m = self.step(self.state, batch, gen=self.gen)
            losses.append(m["loss"])
        vals = torch.stack(losses).cpu().numpy() if losses else np.array([np.nan])
        if not np.isfinite(vals).all():
            raise FloatingPointError(f"[{self.method}] epoch {epoch}: non-finite loss "
                                     f"{vals.tolist()}")
        self.epoch_losses[epoch] = float(vals.mean())
        return float(vals[-1])

    def fit(self, eval_fn=None, resume_path: str = ""):
        """Epochs 1..cfg.epochs, each with its line, or from the epoch a
        checkpoint at `resume_path` names (the state restored, and the
        step's generator where the file holds one: a file that
        tools/convert_checkpoint.py made from a JAX checkpoint does, this
        trainer's own final file does not); unless cfg.no_eval,
        eval_fn(state, epoch) every epoch_eval_f epochs and at the last."""
        from ssl_audio_tpu_torch.utils.checkpoint import decode_rng, load_checkpoint

        cfg = self.cfg
        start = 1
        if resume_path:
            _, start, rng = load_checkpoint(resume_path, self.state)
            if rng is not None:
                self.gen = decode_rng(rng, self.device)[0]
            if self.lead:
                print(f"Resumed from {resume_path} at epoch {start}")
        for epoch in range(start, cfg.epochs + 1):
            loss = self.train_one_epoch(epoch)
            if self.lead:
                print(f"[{self.method}] epoch {epoch}/{cfg.epochs} loss={loss:.4f}")
            last = epoch == cfg.epochs
            if eval_fn and not cfg.no_eval and (epoch % cfg.epoch_eval_f == 0 or last):
                if self.lead:
                    with parallel.local_only():
                        eval_fn(self.state, epoch)
                parallel.barrier()
        return self.state


def run_legacy(cfg, method: str, dataset=None):
    """dino / byola: the epochs, their lines and the one checkpoint ->
    the LegacyTrainer.  With cfg.distributed it joins torchrun's process
    group first and leaves it at the end."""
    from ssl_audio_tpu_torch.parallel import init_distributed

    require_legacy_runnable(cfg, method)        # before the process group
    init_distributed(cfg)
    try:
        trainer = LegacyTrainer(cfg, method, dataset)
        say = print if trainer.lead else (lambda *a, **k: None)
        world = parallel.world_size()
        ranks = f" ({world} ranks x {cfg.batch_size // world})" if parallel.is_distributed() \
            else ""
        say(f"[{method}] {cfg.model_type} on {cfg.dataset}: {cfg.epochs} epochs x "
            f"{trainer.niter_per_ep} steps, batch {cfg.batch_size}{ranks}, {cfg.optimizer}, "
            f"device {trainer.device}, encoder compute "
            f"{'bfloat16' if cfg.use_fp16 else 'float32'}")
        trainer.fit(resume_path=cfg.resume_path)
        path = os.path.join(cfg.save_base_dir,
                            f"results/{cfg.dataset}/{method}_{cfg.model_type}",
                            f"model_{cfg.epochs}.pt")
        # epoch: where a resumed run would start; rank 0 writes, the others wait
        save_checkpoint(path, trainer.state, cfg.epochs + 1)
        say(f"Saved {path}")
    finally:
        if cfg.distributed:
            parallel.destroy()
    return trainer


def config_for(argv=None) -> tuple[Config, str]:
    """CLI (and --config's yaml) -> (Config with the method's recipe and
    the model defaults, method)."""
    parser = build_argparser()
    parser.add_argument("--method", type=str, default="barlow",
                        choices=["barlow", "dino", "byola"])
    args, fields = parse_config(parser, argv)
    cfg = setup_model_defaults(Config(**fields),
                               method=None if args.method == "barlow" else args.method)
    return cfg, args.method


def main(argv=None):
    cfg, method = config_for(argv)
    if method == "barlow":
        from ssl_audio_tpu_torch.parallel import init_distributed
        from ssl_audio_tpu_torch.train.loop import Trainer

        require_supported(cfg)
        init_distributed(cfg)
        trainer = Trainer(cfg)
        ckpt = os.path.join(cfg.save_base_dir, f"results/{cfg.dataset}/barlow_{cfg.model_type}")
        os.makedirs(ckpt, exist_ok=True)
        trainer.fit(ckpt_path=ckpt)
        return trainer
    return run_legacy(cfg, method)


if __name__ == "__main__":
    main()
