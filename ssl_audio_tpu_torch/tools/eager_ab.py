"""The eager training step of two checkouts of the port, timed in turns on
the card.

    python3 -m ssl_audio_tpu_torch.tools.eager_ab A_DIR B_DIR [--steps 20]

For each configuration, four turns in the order A B B A, each a process of
its own that imports ssl_audio_tpu_torch from its checkout and builds
tools/train_profile.py's seeded setup there (full width, batch 128 of
seeded 10-s clips resident on the card): two warm-up steps, then --steps
steps timed with the host clock, each ending in a synchronise.  The
configurations: AudioNTT2022 with LARS, fp32 and --use_fp16; ViT-B
--fused_attention with AdamW, fp32 and --use_fp16.  One JSON line per
configuration: every turn's median ms per step, and A's and B's median
over their two turns, beside the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CONFIGS = {
    "audiontt_fp32_lars": {},
    "audiontt_bf16_lars": {"use_fp16": True},
    "vitb_fp32_adamw": {"model_type": "vit_base", "fused_attention": True},
    "vitb_bf16_adamw": {"model_type": "vit_base", "fused_attention": True, "use_fp16": True},
}

# one turn: what both checkouts' tools/train_profile.py and tools/serving.py
# offer (seeded_training, step_wall_ms, seeded_clips)
TURN = """
import json, statistics, sys, torch
from ssl_audio_tpu_torch.tools.serving import seeded_clips
from ssl_audio_tpu_torch.tools.train_profile import CLIP_SECONDS, seeded_training, step_wall_ms
overrides, steps = json.loads(sys.argv[1]), int(sys.argv[2])
cfg, state, step, gen = seeded_training(0, torch.device("cuda"), **overrides)
wavs = seeded_clips(torch.Generator().manual_seed(0), cfg.batch_size,
                    CLIP_SECONDS * 16000).cuda()
for _ in range(2):
    step(state, wavs, gen=gen)
times = step_wall_ms(lambda: step(state, wavs, gen=gen), steps)
print(json.dumps({"ms_per_step_median": statistics.median(times), "ms_per_step_min": min(times)}))
"""


def turn(tree: str, overrides: dict, steps: int) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
    out = subprocess.run([sys.executable, "-c", TURN, json.dumps(overrides), str(steps)],
                         cwd=tree, env=env, capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"a turn in {tree} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a_dir")
    ap.add_argument("b_dir")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    from ssl_audio_tpu_torch.tools.serving import smi_line

    smi = smi_line()
    print(smi)
    for name, overrides in CONFIGS.items():
        turns = [(side, turn(tree, overrides, args.steps)) for side, tree in
                 (("A", args.a_dir), ("B", args.b_dir), ("B", args.b_dir), ("A", args.a_dir))]
        med = {side: statistics.median(t["ms_per_step_median"] for s, t in turns if s == side)
               for side in ("A", "B")}
        print(json.dumps({"config": name, **overrides, "steps_per_turn": args.steps,
                          "order": "A B B A", "a": args.a_dir, "b": args.b_dir,
                          "turns": [{"side": s, **t} for s, t in turns],
                          "ms_per_step_median": med, "b_over_a": med["B"] / med["A"],
                          "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
