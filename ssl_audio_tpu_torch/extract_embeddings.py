"""Batch embedding extraction of the port (the root extract_embeddings.py of
the JAX package): a dataset split -> `<out_prefix>_X.npy` (embeddings) and
`<out_prefix>_y.npy` (labels), for downstream probes.

    python -m ssl_audio_tpu_torch.extract_embeddings --dataset fsd50k --split test \\
        --model_type audiontt --model_file_path results/<run>/model_100.pt \\
        --out_prefix emb/fsd50k_test

Datasets, read under `data/`: fsd50k (--split train|train_val|val|test, crops
of --eval_crop_frames frames, 711 by default), audioset, synthetic.  The
encoder is grafted from the checkpoint (utils.checkpoint.
load_encoder_checkpoint) and run through eval/linear.py
make_embedding_forward (ViTs unit by unit); it runs on the card unless
`--device cpu` is given.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ssl_audio_tpu_torch.config import (
    Config,
    build_argparser,
    parse_config,
    require_supported,
    setup_model_defaults,
)


def main(argv=None):
    parser = build_argparser()
    parser.add_argument("--model_file_path", type=str, default="")
    parser.add_argument("--split", type=str, default="test",
                        choices=["train", "train_val", "val", "test"])
    parser.add_argument("--out_prefix", type=str, required=True)
    parser.add_argument("--eval_crop_frames", type=int, default=711)
    args, fields = parse_config(parser, argv)
    cfg = setup_model_defaults(Config(**fields))
    require_supported(cfg)          # before any work

    from ssl_audio_tpu_torch.data import datasets as D
    from ssl_audio_tpu_torch.data.pipeline import DataLoader
    from ssl_audio_tpu_torch.eval.encode import extract_embeddings
    from ssl_audio_tpu_torch.eval.linear import make_embedding_forward
    from ssl_audio_tpu_torch.train.state import init_train_state
    from ssl_audio_tpu_torch.utils import checkpoint as ckpt_lib

    if cfg.dataset == "fsd50k":
        ds = D.FSD50K(cfg, split=args.split, norm_stats=D.NORM_STATS["fsd50k"],
                      crop_frames=args.eval_crop_frames)
    elif cfg.dataset == "audioset":
        ds = D.AudioSet(cfg, norm_stats=D.NORM_STATS["audioset"])
    elif cfg.dataset == "synthetic":
        ds = D.SyntheticLMS(cfg, length=cfg.synthetic_steps_per_epoch * cfg.batch_size)
    else:
        raise ValueError(f"unsupported dataset {cfg.dataset}")

    loader = DataLoader(ds, cfg.batch_size, shuffle=False, drop_last=False,
                        num_workers=cfg.num_workers)
    state = init_train_state(cfg, torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    if args.model_file_path:
        # the encoder grafted: legacy DINO / BYOL-A checkpoints load too
        ckpt_lib.load_encoder_checkpoint(args.model_file_path, state)
    encoder = state.modules["encoder"]
    X, y = extract_embeddings(make_embedding_forward(cfg, encoder), loader,
                              next(encoder.parameters()).device)
    os.makedirs(os.path.dirname(args.out_prefix) or ".", exist_ok=True)
    np.save(args.out_prefix + "_X.npy", X)
    np.save(args.out_prefix + "_y.npy", y)
    print(f"saved {X.shape} embeddings -> {args.out_prefix}_X.npy / _y.npy")
    return X, y


if __name__ == "__main__":
    main()
