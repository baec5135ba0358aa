"""Checkpoints between the JAX package and the port (the port's counterpart
of the root tools/export_torch_ckpt.py and ssl_audio_tpu/utils/torch_export.py).

    python -m ssl_audio_tpu_torch.tools.convert_checkpoint --to pt \\
        --ckpt results/fsd50k/<run>/model_10 --out model_10.pt [the run's flags]
    python -m ssl_audio_tpu_torch.tools.convert_checkpoint --to pth \\
        --ckpt results/fsd50k/<run>/model_10[.pt] --out model_10.pth --model_type audiontt

--to pt: a JAX training checkpoint (the Orbax directory model_{k} that
main, main_bt_byol or main_pretrain writes; --method byol for main_bt_byol,
dino / byola for main_pretrain's families) becomes the port's model_{k}.pt
with all of the train state: every stack's parameters and running
statistics (the BYOL and legacy targets too), the optimizer's moments and
step count (LARS momentum; Adam / AdamW mu, nu, count), the LR schedule's
position, the mixup ring, the running norm, the step, the DINO centre and
the epoch to resume at.  Pass the run's own flags (model, widths,
optimizer, batch size, mixup bank...): they build the port's state that the
checkpoint fills, and a checkpoint of another configuration raises.  The
port's Trainer.fit (main / main_bt_byol --resume_path) and LegacyTrainer
(main_pretrain --resume_path) resume from the file with the same flags.

Randomness after a resume is not JAX's: JAX's keys and torch's generators
never draw the same numbers, so the file holds a device generator seeded
from --seed and the epoch, and the epochs after the resume draw other
augmentations, masks and dropout than the JAX run would have.  The host
generator (the mask-ratio draws) is the JAX run's own where its
`<ckpt>.rng.npz` lies beside the directory, else seeded from --seed and the
epoch as well.

--to pth: from a JAX Orbax directory (any layout the JAX loaders read) or a
port `.pt`, the encoder alone as a reference-layout state dict.  From an
Orbax directory it equals what JAX's tools/export_torch_ckpt.py writes from
it, key for key and value for value.  So a port `.pt` goes back to the JAX
package through a `.pth` and JAX's own tools/import_torch_ckpt.py.

Reading an Orbax directory needs tensorstore (it comes with
orbax-checkpoint): run this where the JAX checkpoint was written, and take
the `.pt` to the card.  The conversion runs on the CPU.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ssl_audio_tpu_torch.config import Config, build_argparser, parse_config, setup_model_defaults
from ssl_audio_tpu_torch.utils import checkpoint as ckpt_lib
from ssl_audio_tpu_torch.utils import weights
from ssl_audio_tpu_torch.utils.orbax import is_orbax_dir, read_orbax_tree

METHODS = ("barlow", "byol", "dino", "byola")


def generators(ckpt: str, seed: int, epoch: int) -> dict:
    """The generators a converted checkpoint resumes with: {"device_seed":
    drawn from (seed + 1, epoch), "host_pcg64": the words of the JAX run's
    `<ckpt>.rng.npz` where it exists, else of a generator seeded from
    (seed + 17, epoch)} (utils/checkpoint.py decode_rng reads either)."""
    device_seed = int(np.random.SeedSequence([seed + 1, epoch]).generate_state(1, np.uint64)[0])
    npz = os.path.abspath(ckpt) + ".rng.npz"
    if os.path.isfile(npz):
        with np.load(npz) as z:
            words = [int(w) for w in z["host_pcg64"]]
    else:
        words = ckpt_lib.host_words(np.random.default_rng(np.random.SeedSequence(
            [seed + 17, epoch])))
    return {"device_seed": device_seed, "host_pcg64": words}


def port_state(cfg, method: str):
    """The port's train state of cfg on the CPU, to be filled.  The
    schedules' length does not travel in a checkpoint, only their position
    (the count): the run that resumes builds its own from its loader."""
    gen = torch.Generator().manual_seed(cfg.seed)
    if method in ("dino", "byola"):
        from ssl_audio_tpu_torch.train.legacy_steps import init_legacy_state

        return init_legacy_state(cfg, gen, method, niter_per_ep=1, device="cpu")
    from ssl_audio_tpu_torch.train.state import init_train_state

    return init_train_state(cfg, gen, niter_per_ep=1, byol=method == "byol", device="cpu")


def to_pt(ckpt: str, out: str, cfg, method: str = "barlow"):
    """A JAX training checkpoint -> the port's checkpoint at `out`; returns
    the filled train state and the epoch to resume at."""
    state = port_state(cfg, method)
    sd, epoch = weights.train_state_dict_from_jax(
        read_orbax_tree(ckpt), state, method if method in ("dino", "byola") else None)
    state.load_state_dict(sd)
    ckpt_lib.save_checkpoint(out, state, epoch, generators(ckpt, cfg.seed, epoch))
    return state, epoch


def to_pth(ckpt: str, out: str, cfg) -> dict:
    """The encoder of a JAX Orbax directory or a port `.pt` -> a
    reference-layout state dict at `out` (returned)."""
    if is_orbax_dir(ckpt):
        params, stats = weights.encoder_trees_from_jax(read_orbax_tree(ckpt), ckpt)
        spec = None
        if "vit" in cfg.model_type:
            from ssl_audio_tpu_torch.train.state import build_encoder

            spec = build_encoder(cfg)[0].spec
        sd = weights.reference_state_dict_from_jax(
            params, stats, cfg.model_type, spec, bool(cfg.squeeze_excitation))
    else:
        ck = torch.load(ckpt, map_location="cpu", weights_only=True)
        model = ck.get("model", ck) if isinstance(ck, dict) else None
        sd = {k[len("encoder."):]: v for k, v in (model or {}).items()
              if k.startswith("encoder.")}
        if not sd:
            raise ValueError(f"{ckpt}: neither an Orbax directory nor a port checkpoint "
                             "with encoder.* tensors")
    torch.save(sd, out)
    return sd


def main(argv=None):
    parser = build_argparser()
    parser.add_argument("--ckpt", required=True,
                        help="a JAX Orbax directory, or (--to pth) a port .pt")
    parser.add_argument("--to", required=True, choices=["pt", "pth"])
    parser.add_argument("--out", required=True)
    parser.add_argument("--method", default="barlow", choices=METHODS,
                        help="the family that wrote the checkpoint: barlow (main), byol "
                             "(main_bt_byol), dino or byola (main_pretrain)")
    args, fields = parse_config(parser, argv)
    legacy = args.method in ("dino", "byola")
    cfg = setup_model_defaults(Config(**fields), method=args.method if legacy else None)
    cfg = cfg.replace(device="cpu")
    if args.to == "pt":
        state, epoch = to_pt(args.ckpt, args.out, cfg, args.method)
        print(f"Converted {args.ckpt} -> {args.out} ({args.method}, {cfg.model_type}, step "
              f"{state.step}, resumes at epoch {epoch})")
        return state
    sd = to_pth(args.ckpt, args.out, cfg)
    n = sum(v.numel() for v in sd.values())
    print(f"Exported {args.ckpt} -> {args.out} ({cfg.model_type}, {len(sd)} tensors, "
          f"{n / 1e6:.2f}M params)")
    return sd


if __name__ == "__main__":
    main()
