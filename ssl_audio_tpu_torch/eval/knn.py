"""Weighted-cosine kNN monitor (port of ssl_audio_tpu/eval/knn.py;
reference utils.py:192-235 eval_knn): k = 200, temperature 0.5,
exp-scaled similarity votes; and the multi-label kNN mAP."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ssl_audio_tpu_torch.eval.stats import average_precision
from ssl_audio_tpu_torch.utils import resolve_device


def knn_predict(features: torch.Tensor, bank: torch.Tensor, bank_labels: torch.Tensor,
                n_classes: int, k: int = 200, temperature: float = 0.5) -> torch.Tensor:
    """(B, D) queries against an (N, D) bank with (N,) int labels -> class
    scores (B, n_classes): the exp(similarity / temperature) of the k most
    similar bank entries, summed per label."""
    f = features / features.norm(dim=1, keepdim=True).clamp_min(1e-12)
    b = bank / bank.norm(dim=1, keepdim=True).clamp_min(1e-12)
    sim = f @ b.T                                                    # (B, N)
    w, idx = torch.topk(sim, min(k, bank.shape[0]), dim=1)
    w = torch.exp(w / temperature)
    onehot = F.one_hot(bank_labels[idx].long(), n_classes).to(w.dtype)   # (B, k, C)
    return (onehot * w[..., None]).sum(dim=1)


def eval_knn(forward, memory_loader, test_loader, n_classes: int, k: int = 200,
             temperature: float = 0.5, device=None) -> tuple[float, float]:
    """(top1, top5) accuracy in percent; the bank and the votes on `device`
    (the card unless the caller asks for another)."""
    device = resolve_device(device)

    def embed(x):
        return forward(torch.as_tensor(np.asarray(x)).to(device))

    feats, labels = [], []
    for x, y in memory_loader:
        feats.append(embed(x))
        labels.append(np.asarray(y))
    bank = torch.cat(feats)
    bank_labels = np.concatenate(labels).astype(np.int64)
    if bank_labels.ndim == 2:                              # one-hot -> index
        bank_labels = bank_labels.argmax(-1)
    bank_labels = torch.from_numpy(bank_labels).to(device)

    total = top1 = top5 = 0
    for x, y in test_loader:
        y = np.asarray(y)
        if y.ndim == 2:
            y = y.argmax(-1)
        scores = knn_predict(embed(x), bank, bank_labels, n_classes, k,
                             temperature).cpu().numpy()
        order = np.argsort(-scores, axis=1)
        total += len(y)
        top1 += (order[:, 0] == y).sum()
        top5 += (order[:, :5] == y[:, None]).any(axis=1).sum()
    return 100.0 * top1 / total, 100.0 * top5 / total


def knn_map(features: np.ndarray, labels: np.ndarray, bank: np.ndarray,
            bank_labels: np.ndarray, k: int = 200, temperature: float = 0.5) -> float:
    """Multi-label kNN mAP (reference old/utils/knn_metric.py:23-97): class
    scores are the similarity-weighted votes of the k nearest bank entries'
    multi-hot labels, scored by macro average precision over the classes
    that have a positive."""
    f = features / np.linalg.norm(features, axis=1, keepdims=True).clip(1e-12)
    b = bank / np.linalg.norm(bank, axis=1, keepdims=True).clip(1e-12)
    sim = f @ b.T
    k = min(k, bank.shape[0])
    idx = np.argpartition(-sim, k - 1, axis=1)[:, :k]
    w = np.exp(np.take_along_axis(sim, idx, axis=1) / temperature)     # (B, k)
    votes = np.einsum("bk,bkc->bc", w, bank_labels[idx])                # (B, C)
    keep = labels.sum(axis=0) > 0
    return average_precision(labels[:, keep], votes[:, keep])
