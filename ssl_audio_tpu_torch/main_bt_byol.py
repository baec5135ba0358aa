"""BYOL-style Barlow Twins pretraining entry point of the port (the root
main_bt_byol.py of the JAX package; reference main_bt_byol.py).

    python -m ssl_audio_tpu_torch.main_bt_byol --dataset fsd50k --epochs 100 \\
        --stop_gradient --predictor

Separate online and target stacks (encoder, head, predictor): the online
net takes both global views, masked, the predictor runs over both at once,
the target takes every view, unmasked.  With --stop_gradient the target is
an EMA of the online net (decay --moving_average_decay, a constant), taken
before each optimizer step; without it the target trains by gradient under
the same optimizer.  With --mask --random_mask_ratio the online ratio is
U(0.02, 0.2) with probability 1/2 (no schedule).

Everything else is main's: the flags and defaults, the card unless
`--device cpu`, checkpoints `model_{epoch}.pt` under
`{--save_base_dir}/results/{dataset}/{model_type}_byol_{epochs}_epochs<time>/`
(or `{model_type}_byol_{name}<time>` with --name) holding the target and
the optimizer too, the CSV log under `logs/training/`, --resume_path,
--steps_per_dispatch N (one CUDA graph per window on the card) and the
per-epoch FSD50K probe, which also scores the target encoder
("teacher_score_all").  `hear.conv.load_model`, `hear.vit.load_model` and
`ssl_audio_tpu_torch.linear` read a checkpoint's online encoder.
"""
from __future__ import annotations

from ssl_audio_tpu_torch.main import pretrain


def main(argv=None):
    return pretrain(argv, byol=True)


if __name__ == "__main__":
    main()
