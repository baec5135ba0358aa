"""Barlow Twins pretraining entry point of the port (the root main.py of the
JAX package).

    python -m ssl_audio_tpu_torch.main --dataset fsd50k --epochs 100

Same CLI flags and defaults (AudioNTT2022 on FSD50K, LARS, fp32).  Runs on
the card; without one it raises unless `--device cpu` is given (the plain
PyTorch path, for checks at small sizes).  The on-disk datasets are read
under `data/` in the working directory, as in JAX; `--dataset
synthetic_wav` needs no data.

As in JAX, a run writes its checkpoints to
`{--save_base_dir}/results/{dataset}/{save_name}/model_{epoch}.pt` (every
`--epoch_save_f` epochs and at the last one) and its CSV log to
`logs/training/{dataset}/{save_name}/log.csv` under the working directory;
`--resume_path <model_{e}.pt>` continues a run from the epoch after e with
its generators, bit for bit where the device is deterministic.  A
checkpoint's encoder serves through `hear.conv.load_model(path)` (AudioNTT)
and `hear.vit.load_model(path, model_type, ...)` (the ViT family), and is
probed by `python -m ssl_audio_tpu_torch.linear`.  The per-epoch FSD50K
probe (every `--epoch_eval_f` epochs and at the last one) reads
`data/FSD50K`: without it the run says "Epoch eval disabled" and trains on,
as the JAX main does.  `--steps_per_dispatch N` takes N steps a dispatch,
one CUDA graph per window on the card (eager windows with `--device cpu`);
`--profile_dir DIR` writes a torch.profiler trace of steps 10-20 of the
first epoch into DIR (at one step a dispatch only, as in JAX).

Data parallel: one process per GPU under torchrun,

    torchrun --nproc_per_node N -m ssl_audio_tpu_torch.main --distributed ...

(`--device cpu` joins over gloo).  `--batch_size` is the global batch, the
run equals one process on that batch (ssl_audio_tpu_torch/parallel), and
rank 0 alone writes the checkpoints and logs, prints and probes.
`--data_axis_size` is 0 or the number of processes.
"""
from __future__ import annotations

import datetime
import os

from ssl_audio_tpu_torch import parallel
from ssl_audio_tpu_torch.config import config_from_args, require_supported
from ssl_audio_tpu_torch.parallel import init_distributed
from ssl_audio_tpu_torch.train.loop import Trainer
from ssl_audio_tpu_torch.utils.logging_utils import WandbRun


def pretrain(argv=None, byol: bool = False):
    """The pretraining run of main (byol=False) and of main_bt_byol
    (byol=True: the BYOL-style variant, save names
    {model_type}_byol_{epochs}_epochs or {model_type}_byol_{name}) -> the
    Trainer after fit."""
    cfg = config_from_args(argv)
    require_supported(cfg)          # before anything is written
    if cfg.resume_path and not os.path.isfile(cfg.resume_path):
        raise FileNotFoundError(f"--resume_path {cfg.resume_path}: no such checkpoint file")
    init_distributed(cfg)
    lead = parallel.rank() == 0     # in a process group rank 0 alone writes and prints
    say = print if lead else (lambda *a, **k: None)

    timestamp = datetime.datetime.now().strftime("%H:%M_%h%d")
    kind = f"{cfg.model_type}_byol" if byol else cfg.model_type
    save_name = (
        f"{kind}_{cfg.epochs}_epochs" if cfg.name == "" else f"{kind}_{cfg.name}"
    ) + timestamp
    log_dir = f"logs/training/{cfg.dataset}/{save_name}/"
    ckpt_path = os.path.join(cfg.save_base_dir, f"results/{cfg.dataset}/{save_name}")
    wandb_run = eval_fn = None
    if lead:
        wandb_run = WandbRun(project=f"Pre-training {cfg.dataset}", config=cfg,
                             name=save_name)
        os.makedirs(ckpt_path, exist_ok=True)
        if not cfg.no_eval and cfg.dataset not in ("synthetic",):
            from ssl_audio_tpu_torch.eval.linear import make_epoch_eval_fn

            try:
                eval_fn = make_epoch_eval_fn(cfg, wandb_run=wandb_run)
            except (FileNotFoundError, NotImplementedError) as e:
                print(f"Epoch eval disabled: {e}")

    trainer = Trainer(cfg, byol=byol, log=say, log_dir=log_dir, wandb_run=wandb_run)
    variant = (f"BYOL-style, target {'EMA' if cfg.stop_gradient else 'by gradient'}, "
               if byol else "")
    ranks = (f" ({parallel.world_size()} ranks x {cfg.batch_size // parallel.world_size()})"
             if parallel.is_distributed() else "")
    say(f"training {cfg.model_type} ({variant}{cfg.optimizer}) on {cfg.dataset}: "
        f"{cfg.epochs} epochs x "
        f"{trainer.niter_per_ep} steps, batch {cfg.batch_size}{ranks}, "
        f"{cfg.steps_per_dispatch} step(s) a dispatch, "
        f"device {trainer.device}, encoder compute {'bfloat16' if cfg.use_fp16 else 'float32'}"
        f" (probe {'bfloat16' if cfg.use_fp16_eval else 'float32'}); "
        f"checkpoints in {ckpt_path}, log in {log_dir}")
    trainer.fit(ckpt_path=ckpt_path, resume_path=cfg.resume_path, eval_fn=eval_fn)
    if wandb_run is not None:
        wandb_run.finish()
    if cfg.distributed:
        parallel.destroy()
    return trainer


def main(argv=None):
    return pretrain(argv)


if __name__ == "__main__":
    main()
