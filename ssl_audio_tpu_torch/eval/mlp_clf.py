"""sklearn-style MLP probe (port of ssl_audio_tpu/eval/mlp_clf.py;
reference utils/torch_mlp_clf.py).

StandardScaler on the features; single-label (softmax cross-entropy,
accuracy) or multi-label (sigmoid cross-entropy, macro mAP) from y.ndim;
Adam (lr 1e-3, eps 1e-8) with the L2 term alpha * w added to the gradient
(optax.add_decayed_weights before optax.adam, which is torch's Adam
weight_decay); batch min(200, n); early stopping that restores the best
parameters.  The validation split and every epoch's batch order come from
np.random.default_rng(random_state), as in JAX.  The initial weights are
U(-1/sqrt(in), 1/sqrt(in)) from a torch.Generator seeded with random_state
(jax.random's draws cannot be reproduced); fit(..., init_params=) starts
from given weights instead.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import numpy as np
import torch
from scipy.special import expit as _sigmoid
from torch import nn

from ssl_audio_tpu_torch.eval.stats import average_precision
from ssl_audio_tpu_torch.utils import resolve_device


class _ScalerState:
    def __init__(self, X: np.ndarray):
        self.mean = X.mean(axis=0)
        self.std = X.std(axis=0)
        self.std[self.std == 0] = 1.0

    def __call__(self, X: np.ndarray) -> np.ndarray:
        return ((X - self.mean) / self.std).astype(np.float32)


def _init_mlp(sizes, generator: torch.Generator) -> nn.Sequential:
    """Linear layers with ReLU between them, weights and biases drawn
    U(-1/sqrt(in), 1/sqrt(in)) from `generator`."""
    layers = []
    for i, o in zip(sizes[:-1], sizes[1:]):
        lin = nn.Linear(i, o)
        bound = 1.0 / np.sqrt(i)
        with torch.no_grad():
            lin.weight.copy_((torch.rand(o, i, generator=generator) * 2 - 1) * bound)
            lin.bias.copy_((torch.rand(o, generator=generator) * 2 - 1) * bound)
        layers += [lin, nn.ReLU()]
    return nn.Sequential(*layers[:-1])


class MLPClassifier:
    def __init__(
        self,
        hidden_layer_sizes=(100,),
        alpha: float = 1e-8,
        batch_size="auto",
        learning_rate_init: float = 1e-3,
        max_iter: int = 200,
        random_state: Optional[int] = None,
        early_stopping: bool = False,
        validation_fraction: float = 0.1,
        n_iter_no_change: int = 10,
        scaling: bool = True,
        debug: bool = False,
        device=None,
    ):
        """The JAX classifier's arguments plus `device` ("cuda" unless the
        caller asks for another; without a card it raises unless "cpu")."""
        self.hidden_layer_sizes = tuple(hidden_layer_sizes)
        self.alpha = alpha
        self.batch_size = batch_size
        self.lr = learning_rate_init
        self.max_iter = max_iter
        self.random_state = random_state or 0
        self.early_stopping = early_stopping
        self.validation_fraction = validation_fraction
        self.patience = n_iter_no_change
        self.scaling = scaling
        self.debug = debug
        self.device = resolve_device(device)
        self.net: Optional[nn.Sequential] = None
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.multi_label = False

    def _regime(self, y: np.ndarray):
        if y.ndim == 2:
            return "mAP", y.shape[1], True
        if y.ndim == 1:
            return "acc", len(set(y.tolist())), False
        raise ValueError(f"Unsupported shape of y: {y.shape}")

    def _logits(self, X: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self.net(torch.from_numpy(np.asarray(X, np.float32)).to(self.device)) \
                .cpu().numpy()

    def fit(self, X, y, X_val=None, y_val=None,
            init_params: Optional[Dict[str, torch.Tensor]] = None):
        """init_params: a state dict of the probe's nn.Sequential (Linear
        layers at even indices) to start from, e.g. a JAX probe's initial
        parameters through utils.weights.mlp_clf_params_from_jax."""
        X, y = np.asarray(X, np.float32), np.asarray(y)
        metric, n_class, multi = self._regime(y)
        self.multi_label = multi
        self.n_class = n_class

        if self.scaling:
            self.scaler = _ScalerState(X)
            X = self.scaler(X)
        if X_val is not None:
            X_val = self.scaler(np.asarray(X_val, np.float32)) if self.scaling else X_val
            y_val = np.asarray(y_val)
        else:
            rng = np.random.default_rng(self.random_state)
            n_val = max(1, int(len(X) * self.validation_fraction))
            idx = rng.permutation(len(X))
            X, X_val = X[idx[n_val:]], X[idx[:n_val]]
            y, y_val = y[idx[n_val:]], y[idx[:n_val]]

        bs = min(200, len(X)) if self.batch_size == "auto" else self.batch_size
        sizes = [X.shape[-1], *self.hidden_layer_sizes, n_class]
        self.net = _init_mlp(sizes, torch.Generator().manual_seed(self.random_state))
        if init_params is not None:
            self.net.load_state_dict(init_params, strict=True)
        self.net.to(self.device)
        opt = torch.optim.Adam(self.net.parameters(), lr=self.lr, eps=1e-8,
                               weight_decay=self.alpha)
        loss_fn = nn.BCEWithLogitsLoss() if multi else nn.CrossEntropyLoss()
        X_dev = torch.from_numpy(X).to(self.device)
        y_dev = torch.from_numpy(y.astype(np.float32) if multi else y.astype(np.int64)) \
            .to(self.device)

        rng = np.random.default_rng(self.random_state)
        best_val, best_params, wait = -np.inf, copy.deepcopy(self.net.state_dict()), 0
        for epoch in range(self.max_iter):
            order = rng.permutation(len(X))
            for b0 in range(0, len(X), bs):
                sel = torch.from_numpy(order[b0 : b0 + bs]).to(self.device)
                opt.zero_grad(set_to_none=True)
                loss_fn(self.net(X_dev[sel]), y_dev[sel]).backward()
                opt.step()
            val = self._metric_value(X_val, y_val, multi)
            if self.debug:
                print(f"epoch {epoch+1}/{self.max_iter} val_{metric}={val:.5f}")
            if val >= best_val:
                best_val, best_params, wait = val, copy.deepcopy(self.net.state_dict()), 1
            else:
                if wait >= self.patience and self.early_stopping:
                    break
                wait += 1
        self.net.load_state_dict(best_params)
        self.params = {k: v.detach().cpu() for k, v in best_params.items()}
        self.best_val = best_val
        return self

    def _metric_value(self, X, y, multi) -> float:
        logits = self._logits(X)
        if multi:
            return average_precision(y, _sigmoid(logits))
        return float((logits.argmax(-1) == y).mean())

    def predict_proba(self, X) -> np.ndarray:
        X = self.scaler(np.asarray(X, np.float32)) if self.scaling else np.asarray(X)
        logits = self._logits(X)
        if self.multi_label:
            return _sigmoid(logits)
        e = np.exp(logits - logits.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    def score(self, X, y) -> float:
        y = np.asarray(y)
        proba = self.predict_proba(X)
        if y.ndim == 2:
            return average_precision(y, proba)
        return float((proba.argmax(-1) == y).mean())
