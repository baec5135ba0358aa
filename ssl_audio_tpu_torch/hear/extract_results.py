"""Aggregate heareval output directories into a results.json, with the
18-task HEAR 2021 grouping: the port's own copy of the JAX package's
hear/extract_results.py (reference hear/extract_results.py:12-90), numpy
only, so the port's runtime reads nothing outside its package.

Usage:
    python -m ssl_audio_tpu_torch.hear.extract_results --base_dir <scores_dir> \
        --out results.json

Layout read: <base_dir>/<model>/<run>/<task>/test.predicted-scores.json,
from the external heareval harness or tools/reproduce.py's hear stage; per
task its "test" score (or the mean of "aggregated_scores"), per group the
average of the tasks found.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os

import numpy as np

TASKS = dict(
    environmental=[
        "esc50-v2.0.0-full",
        "fsd50k-v1.0-full",
        "gunshot_triangulation-v1.0-full",
    ],
    speech=[
        "speech_commands-v0.0.2-5h",
        "speech_commands-v0.0.2-full",
        "tfds_crema_d-1.0.0-full",
        "vocal_imitation-v1.1.3-full",
        "vox_lingua_top10-hear2021-full",
        "libricount-v1.0.0-hear2021-full",
    ],
    music=[
        "beijing_opera-v1.0-hear2021-full",
        "mridangam_stroke-v1.5-full",
        "mridangam_tonic-v1.5-full",
        "nsynth_pitch-v2.2.3-50h",
        "nsynth_pitch-v2.2.3-5h",
        "tfds_gtzan-1.0.0-full",
        "tfds_gtzan_music_speech-1.0.0-full",
    ],
    other=[
        "dcase2016_task2-hear2021-full",
        "maestro-v3.0.0-5h",
    ],
)


def extract_task_score(model_dir: str, task: str):
    subdirs = os.listdir(model_dir)
    if not subdirs:
        return None
    results_json = os.path.join(model_dir, subdirs[0], task, "test.predicted-scores.json")
    try:
        with open(results_json) as f:
            results = json.load(f)
    except FileNotFoundError:
        return None
    if "test" in results:
        return results["test"]["test_score"]
    if "aggregated_scores" in results:
        return results["aggregated_scores"]["test_score_mean"]
    return None


def extract_model_scores(model_dir: str) -> dict:
    scores = {}
    for task_type, tasks in TASKS.items():
        scores.setdefault(task_type, {})
        for task in tasks:
            score = extract_task_score(model_dir, task)
            if score is not None:
                scores[task_type][task] = score
        vals = list(scores[task_type].values())
        if vals:
            avg = float(np.mean(vals))
            if math.isfinite(avg):
                scores[task_type]["AVERAGE"] = avg
    return scores


def extract_all(base_dir: str, out_path: str):
    all_scores = {}
    for model_dir in glob.glob(os.path.join(base_dir, "*/")):
        model_name = model_dir.strip("/").split("/")[-1]
        all_scores[model_name] = extract_model_scores(model_dir)
    with open(out_path, "w") as f:
        json.dump(all_scores, f, indent=4)
    return all_scores


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--base_dir", required=True)
    # the JAX script's default, hear/results.json, is the recorded reference
    # results: the port writes beside the working directory instead
    p.add_argument("--out", default="results.json")
    args = p.parse_args()
    extract_all(args.base_dir, args.out)
