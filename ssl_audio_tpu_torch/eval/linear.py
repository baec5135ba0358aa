"""Linear probe evaluation (port of ssl_audio_tpu/eval/linear.py; reference
linear.py and main.py:198-237 eval_linear).

Embeddings for train / val / test (ViTs through the batched unit splitter
of encode.py), the MLP probe fit on them and scored (accuracy or mAP), and
the 5-per-class low-shot protocol; the FSD50K eval loaders and the
per-epoch FSD50K probe of main.py.
"""
from __future__ import annotations

import functools
import time
from typing import Callable

import torch
from torch import nn

from ssl_audio_tpu_torch.data import datasets as D
from ssl_audio_tpu_torch.data.pipeline import DataLoader
from ssl_audio_tpu_torch.eval.encode import encode_vit, extract_embeddings
from ssl_audio_tpu_torch.eval.low_shot import eval_linear_low_shot
from ssl_audio_tpu_torch.eval.mlp_clf import MLPClassifier
from ssl_audio_tpu_torch.models.precision import bf16_params, forward_bf16
from ssl_audio_tpu_torch.models.vit import MaskedAutoencoderViT


def make_embedding_forward(cfg, encoder: nn.Module) -> Callable:
    """(B, 1, F, T) -> (B, D) embedding function of `encoder` (built by
    train.state.build_encoder, or a TrainState's modules["encoder"]): each
    call runs it in eval mode under torch.no_grad() on its own device and
    puts its train / eval mode back afterwards.

    ViTs: per-unit CLS (or dense tokens without cfg.use_cls) averaged over
    cfg.crop_frames-frame units; conv encoders: the pooled forward.

    cfg.use_fp16_eval: the forward runs in bf16 over bf16 copies of the
    encoder's parameters taken here, once (JAX eval/linear.py:30-39), its
    running statistics fp32, each unit or batch cast to bf16 and the
    embeddings returned in fp32."""
    params = bf16_params(encoder, detach=True) if cfg.use_fp16_eval else None

    def apply(x, **kwargs):
        if params is None:
            return encoder(x, **kwargs)
        return forward_bf16(encoder, params, x, **kwargs)

    def run(fn, x):
        was_training = encoder.training
        encoder.eval()
        try:
            with torch.no_grad():
                return fn(x.to(next(encoder.parameters()).device))
        finally:
            encoder.train(was_training)

    if isinstance(encoder, MaskedAutoencoderViT):
        def unit_apply(xu, return_all):
            return apply(xu, return_all=return_all)

        def vit_forward(x):
            return encode_vit(unit_apply, x, unit_frames=cfg.crop_frames,
                              use_cls=cfg.use_cls, patch_fbins=encoder.grid_size()[0],
                              embed_d=encoder.embed_dim)

        return lambda x: run(vit_forward, x)
    return lambda x: run(apply, x)


def eval_linear(forward: Callable, train_loader, val_loader, test_loader,
                max_iter: int = 500, low_shot: bool = True, device=None) -> dict:
    """reference main.py:198-237; the embeddings and the probe on `device`
    (the card unless the caller asks for another)."""
    print("Extracting embeddings")
    t0 = time.time()
    X_train, y_train = extract_embeddings(forward, train_loader, device)
    X_val, y_val = extract_embeddings(forward, val_loader, device)
    X_test, y_test = extract_embeddings(forward, test_loader, device)
    print(f"Done\tTime elapsed = {time.time() - t0:.2f}s")

    print("Fitting linear classifier")
    t0 = time.time()
    clf = MLPClassifier(hidden_layer_sizes=(1024,), max_iter=max_iter,
                        early_stopping=True, n_iter_no_change=20, device=device)
    clf.fit(X_train, y_train, X_val=X_val, y_val=y_val)
    score_all = clf.score(X_test, y_test)
    print(f"Done\tTime elapsed = {time.time() - t0:.2f}s")

    results = {"score_all": score_all}
    if low_shot:
        print("Performing linear evaluation with 5 examples per class")
        results["score_5"] = eval_linear_low_shot(
            X_train, y_train, X_val, y_val, X_test, y_test, n=5, max_iter=max_iter,
            device=device)
    return results


def get_fsd50k_eval_loaders(cfg, data_dir="data", crop_frames=711):
    """(train, val, test) loaders of FSD50K under `data_dir` with
    `crop_frames`-frame crops and the FSD50K statistics (reference
    main.py:240-254).  FileNotFoundError without the data."""
    norm = D.NORM_STATS["fsd50k"]
    mk = functools.partial(DataLoader, batch_size=cfg.batch_size, shuffle=False,
                           drop_last=False, num_workers=cfg.num_workers)
    return tuple(mk(D.FSD50K(cfg, split=split, norm_stats=norm, crop_frames=crop_frames,
                             data_dir=data_dir))
                 for split in ("train", "val", "test"))


def make_epoch_eval_fn(cfg, data_dir="data", wandb_run=None):
    """The per-epoch FSD50K probe (reference main.py:497-519): eval_fn(state,
    epoch) -> eval_linear's scores for the state's encoder, on the
    encoder's device.  A BYOL state's target encoder is probed too, without
    the low-shot protocol, its score returned as "teacher_score_all" (JAX
    eval/linear.py:133-160; reference main_bt_byol.py:519-527).  The loaders
    are built here, so a missing FSD50K raises FileNotFoundError before
    training starts."""
    loaders = get_fsd50k_eval_loaders(cfg, data_dir)

    def eval_fn(state, epoch):
        encoder = state.modules["encoder"]
        device = next(encoder.parameters()).device
        scores = eval_linear(make_embedding_forward(cfg, encoder), *loaders, device=device)
        if "target" in state.modules:
            target = make_embedding_forward(cfg, state.modules["target"]["encoder"])
            scores["teacher_score_all"] = eval_linear(target, *loaders, low_shot=False,
                                                      device=device)["score_all"]
        if wandb_run is not None:
            wandb_run.log({"FSD50K score (100%)": scores["score_all"],
                           "FSD50K score (5pC) (mean)": scores.get("score_5", (None,))[0]})
        return scores

    return eval_fn
