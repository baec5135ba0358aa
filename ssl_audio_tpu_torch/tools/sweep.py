"""The hyperparameter sweep's per-epoch objective (port of CLASSES,
get_eval_loaders and probe_score of the root run_hyperparameter_sweep.py;
reference sweep.py:165-275): embeddings of the eval splits through the
encoder, then a pure linear readout (the MLP probe with no hidden layer, 100
epochs, early stopping) or the weighted-cosine kNN, scored on the test
split.  The sweep's search loop is not ported yet.

The JAX tools set CLASSES[...] on the imported module at run time; here the
class count is an argument of probe_score.
"""
from __future__ import annotations

import functools

from torch import nn

from ssl_audio_tpu_torch.data import datasets as D
from ssl_audio_tpu_torch.data.pipeline import DataLoader
from ssl_audio_tpu_torch.eval.encode import extract_embeddings
from ssl_audio_tpu_torch.eval.knn import eval_knn
from ssl_audio_tpu_torch.eval.linear import make_embedding_forward
from ssl_audio_tpu_torch.eval.mlp_clf import MLPClassifier

# number of probe classes per dataset (reference sweep.py:48-51)
CLASSES = dict(fsd50k=200, nsynth=88, synthetic=8)


def get_eval_loaders(cfg, data_dir="data"):
    """Transform-free (train, val, test) loaders of the probe data
    (reference get_nsynth_50h / get_fsd50k, sweep.py:369-437): NSynth's
    train / valid / test, FSD50K's train / val / test under `data_dir`, or
    the no-data `synthetic` splits."""
    mk = functools.partial(DataLoader, batch_size=cfg.batch_size, shuffle=False,
                           drop_last=False, num_workers=cfg.num_workers)
    if cfg.dataset == "nsynth":
        norm = D.NORM_STATS["nsynth"]
        return tuple(mk(D.NSynthHEAR(cfg, split=s, norm_stats=norm, data_dir=data_dir))
                     for s in ("train", "valid", "test"))
    if cfg.dataset == "fsd50k":
        norm = D.NORM_STATS["fsd50k"]
        return tuple(mk(D.FSD50K(cfg, split=s, norm_stats=norm, data_dir=data_dir))
                     for s in ("train", "val", "test"))
    if cfg.dataset != "synthetic":
        raise ValueError(f"sweep does not support --dataset {cfg.dataset}")
    n = CLASSES["synthetic"]
    return tuple(mk(D.SyntheticLMS(cfg, length=ln, n_classes=n, seed=sd))
                 for ln, sd in ((96, 990), (48, 991), (48, 992)))


def probe_score(cfg, encoder: nn.Module, eval_loaders, n_classes: int,
                eval_mode: str = "linear", init_params=None) -> float:
    """The probe's test score (accuracy for integer labels, macro mAP for
    one-hot ones, as the JAX probe) on embeddings of `encoder` (a
    TrainState's modules["encoder"]); the embeddings and the probe run on
    the encoder's device.  init_params: the probe's starting weights (a state
    dict of its nn.Sequential), to start where another framework's probe
    starts; None draws them from the probe's seed."""
    device = next(encoder.parameters()).device
    forward = make_embedding_forward(cfg, encoder)
    train_loader, val_loader, test_loader = eval_loaders
    if eval_mode == "knn":
        top1, _ = eval_knn(forward, train_loader, test_loader, n_classes, device=device)
        return top1 / 100.0
    X_train, y_train = extract_embeddings(forward, train_loader, device)
    X_val, y_val = extract_embeddings(forward, val_loader, device)
    X_test, y_test = extract_embeddings(forward, test_loader, device)
    clf = MLPClassifier(hidden_layer_sizes=(), max_iter=100, early_stopping=True,
                        n_iter_no_change=10, device=device)
    clf.fit(X_train, y_train, X_val=X_val, y_val=y_val, init_params=init_params)
    return clf.score(X_test, y_test)
