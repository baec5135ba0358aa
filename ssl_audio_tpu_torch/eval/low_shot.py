"""Low-shot linear evaluation (port of ssl_audio_tpu/eval/low_shot.py;
reference utils.py:238-275 eval_linear_low_shot): three disjoint
n-per-class subsets filled greedily in sample order, each fit and scored,
their mean and std returned."""
from __future__ import annotations

from itertools import chain
from typing import Tuple

import numpy as np

from ssl_audio_tpu_torch.eval.mlp_clf import MLPClassifier


def low_shot_subsets(y_train: np.ndarray, n: int) -> Tuple[np.ndarray, ...]:
    subset_1, subset_2, subset_3 = {}, {}, {}
    for idx, label in enumerate(y_train):
        classes = np.nonzero(label)[0] if label.ndim else [int(label)]
        for c in classes:
            subset_1.setdefault(c, [])
            subset_2.setdefault(c, [])
            subset_3.setdefault(c, [])
            if len(subset_1[c]) < n:
                subset_1[c].append(idx)
            elif len(subset_2[c]) < n:
                subset_2[c].append(idx)
            elif len(subset_3[c]) < n:
                subset_3[c].append(idx)

    def flat(s):
        return np.unique(list(chain.from_iterable(s.values())))

    return flat(subset_1), flat(subset_2), flat(subset_3)


def eval_linear_low_shot(X_train, y_train, X_val, y_val, X_test, y_test, n: int = 5,
                         max_iter: int = 500, device=None) -> Tuple[float, float]:
    subsets = low_shot_subsets(np.asarray(y_train), n)
    clf = MLPClassifier(hidden_layer_sizes=(1024,), max_iter=max_iter,
                        early_stopping=True, n_iter_no_change=20, device=device)
    scores = []
    for sub in subsets:
        if len(sub) == 0:
            continue
        clf.fit(X_train[sub], y_train[sub], X_val=X_val, y_val=y_val)
        scores.append(clf.score(X_test, y_test))
    return float(np.mean(scores)), float(np.std(scores))
