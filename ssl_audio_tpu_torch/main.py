"""Barlow Twins pretraining entry point of the port (the root main.py of the
JAX package).

    python -m ssl_audio_tpu_torch.main --dataset synthetic_wav \\
        --model_type audiontt --epochs 1 --synthetic_steps_per_epoch 20

Same CLI flags.  Runs on the card; without one it raises unless
`--device cpu` is given (the plain PyTorch path, for checks at small sizes).
Nothing is saved and nothing is evaluated yet: checkpoints, resume and the
per-epoch evaluation are not ported, and the synthetic datasets have
nothing to evaluate on.
"""
from __future__ import annotations

from ssl_audio_tpu_torch.config import config_from_args
from ssl_audio_tpu_torch.train.loop import Trainer


def main(argv=None):
    cfg = config_from_args(argv)
    trainer = Trainer(cfg)
    print(f"training {cfg.model_type} on {cfg.dataset}: {cfg.epochs} epochs x "
          f"{trainer.niter_per_ep} steps, batch {cfg.batch_size}, {cfg.optimizer}, "
          f"device {trainer.device}; no checkpoints, no per-epoch evaluation")
    trainer.fit()


if __name__ == "__main__":
    main()
