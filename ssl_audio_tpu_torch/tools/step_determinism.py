"""Whether the Barlow Twins training step gives the same bits twice on the
card, and if not, where the two runs part.

    python3 -m ssl_audio_tpu_torch.tools.step_determinism [--steps 3]
        [--model_type vit_base --fused_attention]

Two train states with the same seeded weights (tools/train_profile.py's
setup: the default configuration at full width, batch 128 of seeded 10-s
clips resident on the card) take --steps steps side by side on the same
clips with the same random draws (drawn once per step on a host generator).
Before the first step the views (frontend, crop and augmentations) are made
twice from copies of the augmentation state and compared; after each step
the loss, every gradient and every parameter and running statistic.  Three
settings in turn, each from fresh states: the package's default, cuDNN's
deterministic algorithms (torch.backends.cudnn.deterministic), and
torch.use_deterministic_algorithms(True, warn_only=True), whose warnings
name the operations that have no deterministic implementation.  One JSON
line per setting: the first step at which the runs differ, the gradient
tensors that differ at that step with their largest absolute difference,
and the warnings.  The package itself never turns these settings on.
"""
from __future__ import annotations

import argparse
import copy
import json
import warnings

import torch

from ssl_audio_tpu_torch.tools.serving import seeded_clips, smi_line
from ssl_audio_tpu_torch.tools.train_profile import CLIP_SECONDS, seeded_training


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def tensor_gaps(a: dict, b: dict) -> dict:
    """{name: largest absolute difference} of the tensors that differ."""
    return {k: max_abs(v, b[k]) for k, v in a.items() if not torch.equal(v, b[k])}


def view_gaps(cfg, state, wavs, draws) -> list:
    """The step's views, made twice from copies of the augmentation state:
    the largest absolute difference per view."""
    from ssl_audio_tpu_torch.augment.transforms import apply_pair_views
    from ssl_audio_tpu_torch.train.steps import make_device_frontend

    frontend = make_device_frontend(cfg, (0.0, 1.0))
    runs = []
    with torch.no_grad():
        for _ in range(2):
            runs.append(apply_pair_views(frontend(wavs, draws.starts), copy.deepcopy(state.aug),
                                         cfg, draws.views))
    return [max_abs(a, b) for a, b in zip(*runs)]


def run_setting(name: str, seed: int, steps: int, dev, wavs, overrides: dict) -> dict:
    from ssl_audio_tpu_torch.train.steps import draw_step

    states, step = [], None
    for _ in range(2):
        cfg, state, step, _ = seeded_training(seed, dev, **overrides)
        states.append(state)
    host = torch.Generator().manual_seed(seed + 9)
    out = {"setting": name, "steps": steps, "first_difference": None, "views": None,
           "losses": []}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(steps):
            draws = draw_step(host, cfg, tuple(wavs.shape), states[0].modules["encoder"],
                              wav=True).to(dev)
            if i == 0:
                out["views"] = view_gaps(cfg, states[0], wavs, draws)
            losses = [float(step(s, wavs, draws=draws)["loss"]) for s in states]
            out["losses"].append(losses)
            grads = [{k: p.grad for k, p in s.modules.named_parameters() if p.grad is not None}
                     for s in states]
            grad_gaps = tensor_gaps(*grads)
            state_gaps = tensor_gaps(*[s.modules.state_dict() for s in states])
            if (grad_gaps or state_gaps or losses[0] != losses[1]) \
                    and out["first_difference"] is None:
                worst = sorted(grad_gaps.items(), key=lambda kv: -kv[1])
                out["first_difference"] = {
                    "step": i + 1, "loss_equal": losses[0] == losses[1],
                    "grads_differing": len(grad_gaps), "grads_total": len(grads[0]),
                    "grad_gaps_largest_first": worst[:12],
                    "state_tensors_differing": len(state_gaps)}
        out["final_state_gap"] = max(
            tensor_gaps(*[s.modules.state_dict() for s in states]).values(), default=0.0)
    out["warnings"] = sorted({str(w.message).split("\n")[0][:200] for w in caught})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--model_type", default="audiontt")
    ap.add_argument("--fused_attention", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this is a measurement of the card")
    dev = torch.device("cuda")
    overrides = {}
    if args.model_type != "audiontt":
        overrides = dict(model_type=args.model_type, fused_attention=args.fused_attention)
    wavs = seeded_clips(torch.Generator().manual_seed(args.seed), 128,
                        CLIP_SECONDS * 16000).to(dev)
    print(smi_line())
    settings = (("default", lambda: None),
                ("cudnn_deterministic",
                 lambda: setattr(torch.backends.cudnn, "deterministic", True)),
                ("deterministic_algorithms",
                 lambda: torch.use_deterministic_algorithms(True, warn_only=True)))
    for name, turn_on in settings:
        turn_on()
        print(json.dumps({"model_type": args.model_type, **overrides,
                          **run_setting(name, args.seed, args.steps, dev, wavs, overrides)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
