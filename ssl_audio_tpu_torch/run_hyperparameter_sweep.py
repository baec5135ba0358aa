"""Hyperparameter sweep of the port (the root run_hyperparameter_sweep.py
of the JAX package; reference run_hyperparameter_sweep.py).

    python -m ssl_audio_tpu_torch.run_hyperparameter_sweep --dataset fsd50k \\
        --tune lr wd --n_trials 8 --train_epochs 3

Protocol per trial (reference sweep.py:54-146): a short pretraining run
through the port's Trainer on the chosen dataset; after every epoch, the
encoder's embeddings of the eval splits (train / val / test) and a linear
probe (the MLP probe with no hidden layer, 100 epochs) or the
weighted-cosine kNN scored on the test split (tools/sweep.py probe_score);
the score goes to the pruner.  Datasets: `nsynth` (NSynth-50h HEAR, 88
pitch classes), `fsd50k` (200 classes) under --data_dir, and `synthetic`
(no data on disk).

With optuna installed: TPE sampling, Hyperband pruning and a wandb
callback where wandb is there, as the reference; without it (neither the
CPU test environment nor the card's machine has it) a built-in random
search over the same space with a median-rule pruner.  sample_space draws
with numpy, so the built-in search draws the JAX sweep's trial parameters
from the same seed.  Writes logs/hparams/{dataset}/{model_type}/
intermediate_values.csv (and a .png where matplotlib is there), the best
trial to --sweep_out as JSON, and prints `BEST: {...}`.  Every trial trains
and probes on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import csv
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from ssl_audio_tpu_torch.tools.sweep import CLASSES, get_eval_loaders, probe_score

HYPERPARAMETERS = [
    "lr", "wd", "projector_n_hidden_layers", "projector_out_dim",
    "mixup_ratio", "virtual_crop_scale", "mask_beta",
]


def sample_space(rng: np.random.Generator, tune: List[str]) -> Dict:
    """One trial's parameters from the reference's search space
    (sweep.py:66-106, define_model:148-152, get_*_50h:369-380), drawn from
    `rng` in the JAX sweep's order."""
    params: Dict = {}
    if "lr" in tune:
        params["lr"] = float(10 ** rng.uniform(-6, -2))
    if "wd" in tune:
        params["wd"] = float(10 ** rng.uniform(-3, 0))
    if "projector_n_hidden_layers" in tune:
        params["projector_n_hidden_layers"] = int(rng.choice([1, 2, 3]))
    if "projector_out_dim" in tune:
        params["projector_out_dim"] = int(rng.choice([64, 128, 256, 1024, 4096, 8192, 16384]))
    if "mixup_ratio" in tune:
        params["mixup_ratio"] = float(rng.choice([0, 0.2, 0.4, 0.6, 0.8]))
    if "virtual_crop_scale" in tune:
        params["virtual_crop_scale"] = [float(rng.choice([1, 1.2, 1.4, 1.6, 1.8])),
                                        float(rng.choice([1, 1.2, 1.4, 1.6, 1.8]))]
    if "mask_beta" in tune:
        params["mask_beta"] = float(rng.uniform(0.05, 0.5))
    return params


@dataclass
class Trial:
    number: int
    params: Dict
    scores: List[float] = field(default_factory=list)
    pruned: bool = False

    @property
    def best(self) -> float:
        return max(self.scores) if self.scores else float("-inf")


def run_trial(base_cfg, params: Dict, trial: Trial, report_cb, eval_mode: str = "linear",
              data_dir: str = "data") -> float:
    """Train base_cfg with `params` for its epochs through the port's
    Trainer, probing after each one (trial.scores); report_cb(trial, epoch)
    False prunes the trial."""
    from ssl_audio_tpu_torch.train.loop import Trainer

    cfg = base_cfg.replace(**params)
    trainer = Trainer(cfg, data_dir=data_dir)
    eval_loaders = get_eval_loaders(cfg, data_dir)
    for epoch in range(1, cfg.epochs + 1):
        trainer.train_one_epoch(epoch)
        score = probe_score(cfg, trainer.state.modules["encoder"], eval_loaders,
                            CLASSES[cfg.dataset], eval_mode)
        trial.scores.append(score)
        if report_cb and not report_cb(trial, epoch):
            trial.pruned = True
            break
    return trial.best


def median_pruner(trials: List[Trial], warmup_epochs: int = 1):
    """Prune a trial whose score at epoch e is below the median of the other
    trials' scores at e, once two of them have one (the median rule of the
    no-optuna fallback); never within the first warmup_epochs."""

    def cb(trial: Trial, epoch: int) -> bool:
        if epoch <= warmup_epochs:
            return True
        peers = [t.scores[epoch - 1] for t in trials
                 if t is not trial and len(t.scores) >= epoch]
        if len(peers) < 2:
            return True
        return trial.scores[-1] >= float(np.median(peers))

    return cb


def sweep_builtin(cfg, n_trials: int, tune: List[str], eval_mode: str, seed: int = 0,
                  data_dir: str = "data") -> List[Trial]:
    rng = np.random.default_rng(seed)
    trials: List[Trial] = []
    pruner = median_pruner(trials)
    for i in range(n_trials):
        trial = Trial(number=i, params=sample_space(rng, tune))
        trials.append(trial)
        score = run_trial(cfg, trial.params, trial, pruner, eval_mode, data_dir)
        status = "PRUNED" if trial.pruned else "done"
        print(f"[trial {i}] {status} best={score:.4f} params={trial.params}")
    return trials


def _optuna_params(trial, tune: List[str]) -> Dict:
    """The reference's suggest_* calls (sweep.py:66-106, 148-152, 369-380)."""
    params: Dict = {}
    if "lr" in tune:
        params["lr"] = trial.suggest_float("lr", 1e-6, 1e-2, log=True)
    if "wd" in tune:
        params["wd"] = trial.suggest_float("wd", 1e-3, 1e0, log=True)
    if "projector_n_hidden_layers" in tune:
        params["projector_n_hidden_layers"] = trial.suggest_categorical(
            "projector_n_hidden_layers", [1, 2, 3])
    if "projector_out_dim" in tune:
        params["projector_out_dim"] = trial.suggest_categorical(
            "projector_out_dim", [64, 128, 256, 1024, 4096, 8192, 16384])
    if "mixup_ratio" in tune:
        params["mixup_ratio"] = trial.suggest_categorical("mixup_ratio", [0, 0.2, 0.4, 0.6, 0.8])
    if "virtual_crop_scale" in tune:
        params["virtual_crop_scale"] = [
            trial.suggest_categorical("virtual_crop_scale_F", [1, 1.2, 1.4, 1.6, 1.8]),
            trial.suggest_categorical("virtual_crop_scale_T", [1, 1.2, 1.4, 1.6, 1.8]),
        ]
    if "mask_beta" in tune:
        params["mask_beta"] = trial.suggest_float("mask_beta", 0.05, 0.5)
    return params


def _wandb_callbacks(cfg, tune: List[str], n_trials: int):
    """optuna's wandb callback where wandb and optuna's integration are
    installed (reference sweep.py:481-491), else none."""
    try:
        import wandb  # noqa: F401
        from optuna.integration.wandb import WeightsAndBiasesCallback
    except ImportError:
        return []
    return [WeightsAndBiasesCallback(
        metric_name="score",
        wandb_kwargs=dict(project=f"Hyperparameter sweep {cfg.model_type} [{cfg.dataset}]",
                          name=f"{'_'.join(tune)} - {n_trials} trials"))]


def sweep_optuna(cfg, n_trials: int, tune: List[str], eval_mode: str, seed: int = 0,
                 data_dir: str = "data"):
    """The reference's study: TPE sampler, Hyperband pruner, the wandb
    callback where it is available.  ImportError naming optuna where it is
    not installed."""
    try:
        import optuna
    except ImportError as e:
        raise ImportError("sweep_optuna needs the optuna package; without it "
                          "main runs sweep_builtin") from e

    def objective(trial):
        params = _optuna_params(trial, tune)
        t = Trial(number=trial.number, params=params)

        def cb(t_, epoch):
            trial.report(t_.scores[-1], epoch)
            return not trial.should_prune()

        score = run_trial(cfg, params, t, cb, eval_mode, data_dir)
        if t.pruned:
            raise optuna.TrialPruned()
        return score

    study = optuna.create_study(direction="maximize",
                                sampler=optuna.samplers.TPESampler(seed=seed),
                                pruner=optuna.pruners.HyperbandPruner())
    study.optimize(objective, n_trials=n_trials, callbacks=_wandb_callbacks(cfg, tune, n_trials))
    return study


def save_intermediate_values(rows: List[List], save_path: str):
    """intermediate_values.csv, and a .png of the scores where matplotlib is
    installed (reference plot_and_save_intermediate_values, sweep.py:445-467).
    rows: [trial_number, k1, v1, k2, v2, ..., score_ep1, score_ep2, ...]"""
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, "intermediate_values.csv"), "w") as f:
        csv.writer(f).writerows(rows)
    try:
        import matplotlib
    except ImportError:
        return                                   # the CSV is the record
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for row in rows:
        n_kv = next((i for i, v in enumerate(row[1:], 1) if not isinstance(v, str)), len(row))
        scores = [v for v in row[n_kv:] if isinstance(v, (int, float))]
        label = ",".join(f"{row[i]}={row[i + 1]}" for i in range(1, n_kv - 1, 2))
        plt.plot(range(1, len(scores) + 1), scores, marker="o", label=label)
    plt.xlabel("Epoch")
    plt.ylabel("Score")
    plt.title("Intermediate scores")
    plt.legend(bbox_to_anchor=(1.05, 1.0), loc="upper left", fontsize=6)
    plt.tight_layout()
    plt.savefig(os.path.join(save_path, "intermediate_values.png"), bbox_inches="tight")
    plt.close()


def _trial_rows(trials: List[Trial]) -> List[List]:
    rows = []
    for t in trials:
        kv = [q for p in t.params.items() for q in p]
        rows.append([t.number] + kv + list(t.scores))
    return rows


def main(argv=None):
    from ssl_audio_tpu_torch.config import (
        Config,
        build_argparser,
        parse_config,
        require_supported,
        setup_model_defaults,
    )

    parser = build_argparser()
    parser.add_argument("--eval", type=str, default="linear", choices=["linear", "knn"])
    parser.add_argument("--tune", nargs="+", type=str, default=["lr", "wd"],
                        choices=HYPERPARAMETERS)
    parser.add_argument("--n_trials", type=int, default=8)
    parser.add_argument("--train_epochs", type=int, default=3)
    parser.add_argument("--sweep_out", type=str, default="sweep_results.json")
    parser.add_argument("--data_dir", type=str, default="data")
    args, fields = parse_config(parser, argv)
    cfg = setup_model_defaults(Config(**fields))
    cfg = cfg.replace(epochs=args.train_epochs, no_eval=True)
    require_supported(cfg)

    log_dir = os.path.join("logs", "hparams", cfg.dataset, cfg.model_type)
    try:
        import optuna  # noqa: F401
    except ImportError:
        optuna = None
    if optuna is not None:
        study = sweep_optuna(cfg, args.n_trials, args.tune, args.eval, data_dir=args.data_dir)
        best = {"params": study.best_params, "value": study.best_value}
        rows = []
        for t in study.trials:
            if t.intermediate_values:
                kv = [q for p in t.params.items() for q in p]
                ys = [y for _, y in sorted(t.intermediate_values.items())]
                rows.append([t.number] + kv + ys)
        save_intermediate_values(rows, log_dir)
    else:
        trials = sweep_builtin(cfg, args.n_trials, args.tune, args.eval,
                               data_dir=args.data_dir)
        done = [t for t in trials if t.scores]
        best_t = max(done, key=lambda t: t.best)
        best = {"params": best_t.params, "value": best_t.best}
        save_intermediate_values(_trial_rows(trials), log_dir)

    with open(args.sweep_out, "w") as f:
        json.dump(best, f, indent=2)
    print("BEST:", json.dumps(best))
    return best


if __name__ == "__main__":
    main()
