"""Supervised evaluation entry of the port (the root evaluate.py of the JAX
package): a linear probe or a full finetune of a pretrained encoder on a
labelled dataset (reference old/evaluate/linear.py and finetune.py, the
AudioSet-20k protocol).

    python -m ssl_audio_tpu_torch.evaluate --mode finetune --dataset fsd50k \\
        --model_type audiontt --model_file_path results/fsd50k/<run>/model_100.pt \\
        --eval_epochs 10 --specaug --eval_mixup 0.2

Datasets, read under `data/`: fsd50k (train against val), audioset (the
balanced train segments against the eval segments), synthetic (seeded
random log-mels, no data).  The encoder is grafted from the checkpoint by
utils.checkpoint.load_encoder_checkpoint, so a legacy DINO / BYOL-A
checkpoint loads too, and so does a directory the JAX package wrote (Orbax);
an empty path evaluates the seeded initial weights.
Same config flags as main, plus --mode, --model_file_path, --eval_epochs,
--eval_lr, --specaug and --eval_mixup; it runs on the card unless
`--device cpu` is given.  Prints "<mode> best val score: <score>".
"""
from __future__ import annotations

import torch

from ssl_audio_tpu_torch.config import (
    Config,
    build_argparser,
    parse_config,
    require_supported,
    setup_model_defaults,
)


def eval_datasets(cfg, data_dir: str = "data"):
    """(train, val, single_label) of cfg.dataset for the supervised
    evaluation (JAX evaluate.py): FSD50K train / val; AudioSet's training
    segments / its eval segments (never the training set itself);
    SyntheticLMS."""
    from ssl_audio_tpu_torch.data import datasets as D

    if cfg.dataset == "fsd50k":
        norm = D.NORM_STATS["fsd50k"]
        return (D.FSD50K(cfg, split="train", norm_stats=norm, data_dir=data_dir),
                D.FSD50K(cfg, split="val", norm_stats=norm, data_dir=data_dir), False)
    if cfg.dataset == "audioset":
        norm = D.NORM_STATS["audioset"]
        return (D.AudioSet(cfg, norm_stats=norm, data_dir=data_dir),
                D.AudioSet(cfg, norm_stats=norm, data_dir=data_dir, test=True), False)
    if cfg.dataset == "synthetic":
        return (D.SyntheticLMS(cfg, length=cfg.synthetic_steps_per_epoch * cfg.batch_size),
                D.SyntheticLMS(cfg, length=4 * cfg.batch_size, seed=cfg.seed + 1), False)
    raise ValueError(f"unsupported eval dataset {cfg.dataset}")


def main(argv=None) -> float:
    parser = build_argparser()
    parser.add_argument("--mode", type=str, default="linear", choices=["linear", "finetune"])
    parser.add_argument("--model_file_path", type=str, default="")
    parser.add_argument("--eval_epochs", type=int, default=10)
    parser.add_argument("--eval_lr", type=float, default=1e-3)
    parser.add_argument("--specaug", action="store_true", default=False)
    parser.add_argument("--eval_mixup", type=float, default=0.0)
    args, fields = parse_config(parser, argv)
    cfg = setup_model_defaults(Config(**fields))
    require_supported(cfg)          # before any work

    from ssl_audio_tpu_torch.data.pipeline import DataLoader
    from ssl_audio_tpu_torch.eval.finetune import train_classifier
    from ssl_audio_tpu_torch.train.state import init_train_state
    from ssl_audio_tpu_torch.utils import checkpoint as ckpt_lib

    train_ds, val_ds, single_label = eval_datasets(cfg)
    train_loader = DataLoader(train_ds, cfg.batch_size, num_workers=cfg.num_workers)
    val_loader = DataLoader(val_ds, cfg.batch_size, shuffle=False, drop_last=False,
                            num_workers=cfg.num_workers)
    state = init_train_state(cfg, torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    if args.model_file_path:
        # the encoder grafted: legacy DINO / BYOL-A checkpoints load too
        ckpt_lib.load_encoder_checkpoint(args.model_file_path, state)
    encoder = state.modules["encoder"]
    print(f"{args.mode} evaluation of {cfg.model_type} on {cfg.dataset}: "
          f"{args.eval_epochs} epochs x {len(train_loader)} steps, batch {cfg.batch_size}, "
          f"device {next(encoder.parameters()).device}, encoder compute "
          f"{'bfloat16' if cfg.use_fp16 else 'float32'}")
    _, score = train_classifier(
        cfg, encoder, train_loader, val_loader, n_classes=train_ds.label_num,
        epochs=args.eval_epochs, lr=args.eval_lr, finetune=args.mode == "finetune",
        mixup_alpha=args.eval_mixup or None, specaug=args.specaug, single_label=single_label)
    print(f"{args.mode} best val score: {score:.4f}")
    return score


if __name__ == "__main__":
    main()
