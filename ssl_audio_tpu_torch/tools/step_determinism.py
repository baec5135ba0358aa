"""Whether the Barlow Twins training step gives the same bits twice on the
card, and if not, where the two runs part.

    python3 -m ssl_audio_tpu_torch.tools.step_determinism [--steps 3]
        [--model_type vit_base --fused_attention] [--small]
        [--steps_per_dispatch 4]

Two train states with the same seeded weights (tools/train_profile.py's
setup: the default configuration at full width, batch 128 of seeded 10-s
clips resident on the card; with --small the card tests' shapes, SMALL:
batch 8 of 1-s clips, 32 frames, projector 256, a ring of 16) take --steps
steps side by side on the same
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

With --steps_per_dispatch N it holds the CUDA graph of a window against N
eager steps instead: states from the same seed, each with a device
generator seeded alike, one taking N eager steps at a time, a twin taking
the same eager steps (the spread of two eager runs), the other
windows of N steps through train/steps.py make_multi_train_step (a warm-up
window, the capture, then replays; --steps rounded up to whole windows, at
least 3), compared after every window: the
losses, every tensor of the train state (parameters, running statistics,
optimizer state, LR counter, mixup ring) and the generators' states.  One
JSON line: the first window at which they differ and the tensors that
differ there, largest gap first (the earliest part of the step among them
names where the two part); at the end, the graph's and the twin's largest
loss and state gaps against the eager state.
"""
from __future__ import annotations

import argparse
import copy
import json
import warnings

import torch

from ssl_audio_tpu_torch.tools.serving import seeded_clips, smi_line
from ssl_audio_tpu_torch.tools.train_profile import CLIP_SECONDS, seeded_training

# --small: the shapes of the card tests' graph-against-eager comparisons
SMALL = dict(batch_size=8, crop_frames=32, projector_hidden_dim=256, mixup_n_memory=16)
SMALL_CLIP_SAMPLES = 16000


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


def flat_tensors(tree, prefix: str = "") -> dict:
    """{dotted path: tensor} of every tensor in nested dicts and lists."""
    if torch.is_tensor(tree):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (list, tuple)) else ()
    out = {}
    for k, v in items:
        out.update(flat_tensors(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def train_state_tensors(state) -> dict:
    """Every tensor a step updates, by name, with the LR counter and the
    mixup ring's device counters."""
    out = flat_tensors(state.state_dict())
    out["lr_counter"] = state.lr_schedule.counter
    if state.aug.mixup is not None:
        out["mixup.count"], out["mixup.pos"] = state.aug.mixup.count, state.aug.mixup.pos
    return out


def _max_loss_gap(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def run_graphed(seed: int, n: int, windows: int, dev, wavs, overrides: dict,
                byol: bool = False) -> dict:
    """A state taking windows through the graph against one taking the same
    steps eagerly, and a second eager state beside them (the twin): where
    the card's algorithms part two eager runs, the twin's gaps are the yard
    for the graph's.  byol: the BYOL-style state and step."""
    from ssl_audio_tpu_torch.tools.train_profile import window_runner

    cfg, eager, step, gen_eager = seeded_training(seed, dev, byol=byol, **overrides)
    _, twin, _, gen_twin = seeded_training(seed, dev, byol=byol, **overrides)
    _, graphed, _, gen_graphed = seeded_training(seed, dev, byol=byol, **overrides)
    run_window, multi = window_runner(cfg, graphed, gen_graphed, wavs, n, byol=byol)
    out = {"setting": f"graphed windows of {n} against eager steps", "windows": windows,
           "first_difference": None, "losses": []}
    for w in range(windows):
        losses = [float(step(eager, wavs, gen=gen_eager)["loss"]) for _ in range(n)]
        twin_losses = [float(step(twin, wavs, gen=gen_twin)["loss"]) for _ in range(n)]
        graphed_losses = [float(v) for v in run_window()["loss"]]
        out["losses"].append({"eager": losses, "graphed": graphed_losses, "twin": twin_losses,
                              "mode": "eager warm-up" if w == 0 else "graph"})
        gaps = tensor_gaps(train_state_tensors(graphed), train_state_tensors(eager))
        same_gen = torch.equal(gen_graphed.get_state(), gen_eager.get_state())
        if (gaps or not same_gen or losses != graphed_losses) \
                and out["first_difference"] is None:
            out["first_difference"] = {
                "window": w + 1, "losses_equal": losses == graphed_losses,
                "generators_equal": same_gen, "tensors_differing": len(gaps),
                "gaps_largest_first": sorted(gaps.items(), key=lambda kv: -kv[1])[:16]}
    out["graphs"] = {str(k): {"capture_s": v.capture_s, "launches_per_replay":
                              {c: n for c, n in v.launches.items() if n}}
                     for k, v in multi.graphs.items()}
    final = {}
    for name, other, gen in (("graphed", graphed, gen_graphed), ("twin", twin, gen_twin)):
        gaps = tensor_gaps(train_state_tensors(other), train_state_tensors(eager))
        final[name] = {
            "max_loss_rel_gap": max(_max_loss_gap(w[name], w["eager"]) for w in out["losses"]),
            "generators_equal": torch.equal(gen.get_state(), gen_eager.get_state()),
            "max_state_gap": max(gaps.values(), default=0.0),
            "gaps_largest_first": sorted(gaps.items(), key=lambda kv: -kv[1])}
    out["final"] = final
    return out


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
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps_per_dispatch", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this is a measurement of the card")
    dev = torch.device("cuda")
    overrides = dict(SMALL) if args.small else {}
    if args.model_type != "audiontt":
        overrides.update(model_type=args.model_type, fused_attention=args.fused_attention)
    batch, samples = (SMALL["batch_size"], SMALL_CLIP_SAMPLES) if args.small else \
        (128, CLIP_SECONDS * 16000)
    wavs = seeded_clips(torch.Generator().manual_seed(args.seed), batch, samples).to(dev)
    print(smi_line())
    if args.steps_per_dispatch > 1:
        n = args.steps_per_dispatch
        print(json.dumps({"model_type": args.model_type, **overrides,
                          **run_graphed(args.seed, n, max(-(-args.steps // n), 3),
                                        dev, wavs, overrides)}))
        return 0
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
