"""Write the JAX package's initial legacy state (DINO or BYOL-A, as
tools/prove_learning.py makes it: init_legacy_state with key cfg.seed) as
the PyTorch port's state dicts, so that the port's learning proof can start
from the same weights as the JAX record it is compared with.

    python tools/jax_legacy_init.py --record learning_proof_dino.json \\
        --out build/jax_init_dino.pt

The record's resolved_config gives the model (its method, widths and
seed).  The output holds {"encoder", "head"[, "predictor"]} state dicts in
the port's names (ssl_audio_tpu_torch/utils/weights.py
legacy_state_dicts_from_jax); the port's prove_learning takes it with
--init_from.  Runs on the CPU; only the initialisation is computed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--record", required=True, help="a learning_proof_*.json of the JAX tool")
    p.add_argument("--out", required=True, help=".pt output path")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from ssl_audio_tpu.config import Config
    from ssl_audio_tpu.train.legacy_steps import init_legacy_state
    from ssl_audio_tpu_torch.utils.weights import legacy_state_dicts_from_jax

    with open(args.record) as f:
        record = json.load(f)
    method = record["config"]["method"]
    known = {f.name for f in dataclasses.fields(Config)}
    resolved = {k: v for k, v in record["resolved_config"].items() if k in known}
    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v for k, v in resolved.items()})
    _, state = init_legacy_state(cfg, jax.random.key(cfg.seed), method,
                                 niter_per_ep=cfg.synthetic_steps_per_epoch)
    sds = legacy_state_dicts_from_jax(jax.tree.map(np.asarray, state.params),
                                      jax.tree.map(np.asarray, state.batch_stats), method)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save({"method": method, "record": os.path.basename(args.record), **sds}, args.out)
    n = sum(v.numel() for sd in sds.values() for v in sd.values())
    print(f"{method}: {n} values of JAX's initial state -> {args.out}")


if __name__ == "__main__":
    main()
