"""Linear probe evaluation (port of ssl_audio_tpu/eval/linear.py; reference
linear.py and main.py:198-237 eval_linear).

Embeddings for train / val / test (ViTs through the batched unit splitter
of encode.py), the MLP probe fit on them and scored (accuracy or mAP), and
the 5-per-class low-shot protocol.  The FSD50K loaders and the per-epoch
hook wait for the on-disk datasets and checkpoints, and raise.
"""
from __future__ import annotations

import time
from typing import Callable

import torch
from torch import nn

from ssl_audio_tpu_torch.eval.encode import encode_vit, extract_embeddings
from ssl_audio_tpu_torch.eval.low_shot import eval_linear_low_shot
from ssl_audio_tpu_torch.eval.mlp_clf import MLPClassifier
from ssl_audio_tpu_torch.models.vit import MaskedAutoencoderViT


def make_embedding_forward(cfg, encoder: nn.Module) -> Callable:
    """(B, 1, F, T) -> (B, D) embedding function of `encoder` (built by
    train.state.build_encoder, or a TrainState's modules["encoder"]): each
    call runs it in eval mode under torch.no_grad() on its own device and
    puts its train / eval mode back afterwards.

    ViTs: per-unit CLS (or dense tokens without cfg.use_cls) averaged over
    cfg.crop_frames-frame units; conv encoders: the pooled forward."""
    if cfg.use_fp16_eval:
        raise NotImplementedError("--use_fp16_eval (bf16 embedding extraction) "
                                  "is not ported yet")
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
            return encoder(xu, return_all=return_all)

        def vit_forward(x):
            return encode_vit(unit_apply, x, unit_frames=cfg.crop_frames,
                              use_cls=cfg.use_cls, patch_fbins=encoder.grid_size()[0],
                              embed_d=encoder.embed_dim)

        return lambda x: run(vit_forward, x)
    return lambda x: run(encoder, x)


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
    raise NotImplementedError("the FSD50K eval loaders need the on-disk datasets, "
                              "which are not ported yet")


def make_epoch_eval_fn(cfg, data_dir="data", wandb_run=None):
    raise NotImplementedError("the per-epoch FSD50K probe needs the on-disk datasets "
                              "and checkpoints, which are not ported yet")
