"""Learning proof: a short pretraining run whose per-epoch linear probe rises
above the random-init probe (port of the JAX package's
tools/prove_learning.py; the reference validates with the same per-epoch
probe hooks, main.py:479-519).  --method barlow (the default) trains
through the Trainer, dino and byola through main_pretrain's LegacyTrainer
with their recipes.

    python -m ssl_audio_tpu_torch.tools.prove_learning \\
        --dataset synthetic_multicue --model_type audiontt --epochs 24 \\
        --batch_size 128 --synthetic_steps_per_epoch 100 --optimizer Adam \\
        --lr 1e-3 --out learning_proof_torch_h100.json

Runs on the card (add --device cpu for the plain path at small sizes); no
data is needed.  The probe runs once at init and then through Trainer.fit's
eval_fn hook every --eval_every epochs and at the last one.  The table goes
to stdout, the record to --out as JSON: the JAX tool's keys (config,
config_hash, resolved_config, epochs[] with epoch / loss / score,
init_score, best_score, learned) plus the card's name and power limit, the
seconds of each epoch's training and probe and, on the card, the kernel
launches of each.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time

from ssl_audio_tpu_torch.config import (
    Config,
    build_argparser,
    config_fingerprint,
    setup_model_defaults,
)
from ssl_audio_tpu_torch.data import datasets as D
from ssl_audio_tpu_torch.data.pipeline import DataLoader
from ssl_audio_tpu_torch.main_pretrain import LegacyTrainer
from ssl_audio_tpu_torch.ops import launch_counts
from ssl_audio_tpu_torch.tools.sweep import CLASSES, get_eval_loaders, probe_score
from ssl_audio_tpu_torch.train.loop import Trainer
from ssl_audio_tpu_torch.utils import resolve_device


def build_parser():
    parser = build_argparser()
    parser.add_argument("--eval", type=str, default="linear", choices=["linear", "knn"])
    # the objective family: barlow through the Trainer, the legacy dino and
    # byola through main_pretrain's LegacyTrainer
    parser.add_argument("--method", type=str, default="barlow",
                        choices=["barlow", "dino", "byola"])
    parser.add_argument("--out", type=str, default="learning_proof.json")
    # the hard synthetic task: a random-init AudioNTT probe scores ~0.21 over
    # 20 classes (chance 0.05), leaving room for pretraining
    parser.add_argument("--n_classes", type=int, default=20)
    # difficulty knobs; None -> the task's defaults (synthetic: the hard
    # settings; synthetic_multicue: the dataset's own)
    parser.add_argument("--env_gain", type=float, default=None)
    parser.add_argument("--env_width", type=float, default=None)
    parser.add_argument("--noise", type=float, default=None)
    # probe every N epochs (the reference's epoch_eval_f protocol); 1 = every epoch
    parser.add_argument("--eval_every", type=int, default=1)
    # dino / byola: start from these weights ({"encoder", "head"[,
    # "predictor"]} state dicts, e.g. tools/jax_legacy_init.py's), online
    # and target alike, instead of the port's own initialisation
    parser.add_argument("--init_from", type=str, default=None)
    return parser


def load_initial_weights_(state, path: str) -> None:
    """The online modules and their target copies from `path`."""
    import torch

    sds = torch.load(path, map_location="cpu", weights_only=True)
    for name, module in state.modules.items():
        if name != "target":
            module.load_state_dict(sds[name], strict=True)
            state.modules["target"][name].load_state_dict(sds[name], strict=True)


def build_task(cfg, args):
    """-> (train dataset or None for the configured one, (train, val, test)
    probe loaders, probe classes), the JAX tool's splits per task."""
    mk = functools.partial(DataLoader, batch_size=cfg.batch_size, shuffle=False,
                           drop_last=False, num_workers=cfg.num_workers)
    n_train = cfg.synthetic_steps_per_epoch * cfg.batch_size

    def pick(value, default):
        return default if value is None else value

    if cfg.dataset == "synthetic":
        task = functools.partial(
            D.SyntheticLMS, cfg, n_classes=args.n_classes,
            env_gain=pick(args.env_gain, 0.5), env_width=pick(args.env_width, 0.25),
            noise=pick(args.noise, 1.0))
        splits = ((320, 990), (160, 991), (160, 992))
    elif cfg.dataset == "synthetic_multicue":
        # class = (envelope band, AM rate) jointly: it survives the
        # augmentations, so the probe should stay above init as the loss saturates
        task = functools.partial(
            D.SyntheticMultiCue, cfg, gain=pick(args.env_gain, 1.2),
            env_width=pick(args.env_width, 0.09), noise=pick(args.noise, 1.0))
        splits = ((400, 990), (200, 991), (200, 992))
    else:
        return None, get_eval_loaders(cfg), CLASSES[cfg.dataset]
    train_ds = task(length=n_train, seed=cfg.seed)
    return (train_ds, tuple(mk(task(length=n, seed=s)) for n, s in splits),
            train_ds.label_num)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    known = {f.name for f in dataclasses.fields(Config)}
    cfg = setup_model_defaults(
        Config(**{k: v for k, v in vars(args).items() if k in known}),
        method=None if args.method == "barlow" else args.method,
    ).replace(no_eval=False, epoch_eval_f=args.eval_every)
    device = resolve_device(cfg.device)
    card = None
    if device.type == "cuda":
        from ssl_audio_tpu_torch.tools.serving import smi_line

        card = smi_line()
    print(f"device={device} card={card}")

    train_ds, eval_loaders, n_classes = build_task(cfg, args)
    if args.init_from and args.method == "barlow":
        raise ValueError("--init_from takes the weights of a legacy family (dino, byola)")
    trainer = (Trainer(cfg, dataset=train_ds) if args.method == "barlow"
               else LegacyTrainer(cfg, args.method, dataset=train_ds))
    if args.init_from:
        load_initial_weights_(trainer.state, args.init_from)
    resolved, cfg_hash = config_fingerprint(cfg)
    # a record made under another configuration is about to be replaced: say so
    if os.path.exists(args.out):
        try:
            with open(args.out) as f:
                prev = json.load(f)
            if prev.get("config_hash") not in (None, cfg_hash):
                print(f"WARNING: overwriting {args.out} recorded under config "
                      f"{prev['config_hash']} (current: {cfg_hash})")
        except (json.JSONDecodeError, OSError):
            pass
    record = {"config": {"dataset": cfg.dataset, "model_type": cfg.model_type,
                         "batch_size": cfg.batch_size, "epochs": cfg.epochs,
                         "eval": args.eval, "method": args.method,
                         "init_from": args.init_from and os.path.basename(args.init_from)},
              "config_hash": cfg_hash, "resolved_config": resolved,
              "device": str(device), "card": card,
              "steps_per_epoch": trainer.niter_per_ep, "epochs": []}
    t0 = time.perf_counter()
    mark = {"t": t0, "launches": launch_counts()}

    def probe(state, epoch: int) -> float:
        """The probe of the state's encoder, recorded with the seconds and
        launches of the training before it and of the probe itself."""
        t_start, at_start = time.perf_counter(), launch_counts()
        score = probe_score(cfg, state.modules["encoder"], eval_loaders,
                            n_classes, args.eval)
        t_end, at_end = time.perf_counter(), launch_counts()
        entry = {"epoch": epoch, "loss": trainer.epoch_losses.get(epoch), "score": score,
                 "train_s": t_start - mark["t"], "probe_s": t_end - t_start,
                 "train_launches": _delta(at_start, mark["launches"]),
                 "probe_launches": _delta(at_end, at_start)}
        record["epochs"].append(entry)
        mark.update(t=t_end, launches=at_end)
        loss = "" if entry["loss"] is None else f"loss={entry['loss']:.4f}  "
        print(f"epoch {epoch:2d}  {loss}probe={score:.4f}  train {entry['train_s']:.1f}s  "
              f"probe {entry['probe_s']:.1f}s  [{t_end - t0:.0f}s]")
        return score

    probe(trainer.state, 0)
    trainer.fit(eval_fn=probe)

    scores = [e["score"] for e in record["epochs"]]
    init, best = scores[0], max(scores[1:])
    record["init_score"] = init
    record["best_score"] = best
    record["learned"] = bool(best > init)
    record["wall_s"] = time.perf_counter() - t0
    steps = cfg.epochs * trainer.niter_per_ep
    record["ms_per_step"] = 1e3 * sum(e["train_s"] for e in record["epochs"][1:]) / steps
    record["probe_s"] = sum(e["probe_s"] for e in record["epochs"])
    print(f"probe@init={init:.4f}  probe@best={best:.4f}  "
          f"{'LEARNED' if record['learned'] else 'NO IMPROVEMENT'}  "
          f"({record['wall_s']:.1f} s, {record['ms_per_step']:.1f} ms per step "
          f"with the loader, probes {record['probe_s']:.1f} s)")
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
    return record


if __name__ == "__main__":
    main()
