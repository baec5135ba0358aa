"""HEAR 2021 helpers (port of ssl_audio_tpu/hear/utils.py).

The HEAR frontend values of hear/config.yaml are carried here as defaults,
and a config override is read by a small parser for flat `key: value`
files: the port does not depend on PyYAML.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Tuple

import numpy as np

# hear/config.yaml (the reference's HEAR inference frontend)
DEFAULT_CONFIG = {
    "unit_sec": 0.95,
    "sample_rate": 16000,
    "n_fft": 1024,
    "win_length": 400,
    "hop_length": 160,
    "n_mels": 64,
    "f_min": 60,
    "f_max": 7800,
    "use_cls": True,
    "patch_size": [16, 16],
}


class AttrDict(dict):
    """Attribute access for config dicts."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


def _parse_value(text: str):
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~", ""):
        return None
    try:
        return ast.literal_eval(text)      # numbers, [lists], quoted strings
    except (ValueError, SyntaxError):
        return text


def load_config(path_to_config: str | None = None) -> AttrDict:
    """DEFAULT_CONFIG, updated from a flat `key: value` file when a path to
    an existing file is given (comments after '#' and blank lines ignored).
    A missing file means the defaults, as the JAX loader falls back to its
    packaged config."""
    cfg = AttrDict(DEFAULT_CONFIG)
    if not path_to_config or not Path(path_to_config).is_file():
        return cfg
    with open(path_to_config) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            key, sep, value = line.partition(":")
            if not sep or not key.strip():
                raise ValueError(f"{path_to_config}:{lineno}: want 'key: value', "
                                 f"got {line!r}")
            cfg[key.strip()] = _parse_value(value.strip())
    return cfg


def frame_audio(audio: np.ndarray, frame_size: int, hop_size: float,
                sample_rate: int) -> Tuple[np.ndarray, np.ndarray]:
    """Centred frames every hop_size ms: (n_sounds, n_samples) -> frames
    (n_sounds, n_frames, frame_size), timestamps (n_sounds, n_frames) in ms."""
    audio = np.asarray(audio)
    starts, timestamps = frame_starts(audio.shape[1], frame_size, hop_size,
                                      sample_rate)
    padded = np.pad(audio, ((0, 0), (frame_size // 2, frame_size - frame_size // 2)))
    idx = np.asarray(starts)[:, None] + np.arange(frame_size)[None, :]
    ts = np.broadcast_to(np.asarray(timestamps, np.float32)[None],
                         (audio.shape[0], len(starts))).copy()
    return padded[:, idx].astype(np.float32), ts


def frame_starts(n_samples: int, frame_size: int, hop_size: float,
                 sample_rate: int):
    """Start samples (in the centred, zero-padded signal) and timestamps in
    ms of the frames frame_audio cuts."""
    num_padded = n_samples + frame_size
    frame_step = hop_size / 1000.0 * sample_rate
    starts, timestamps = [], []
    i = 0
    while True:
        start = int(round(i * frame_step))
        if start + frame_size > num_padded:
            return starts, timestamps
        starts.append(start)
        timestamps.append(i * frame_step / sample_rate * 1000.0)
        i += 1


def compute_scene_stats(lms_list) -> Tuple[float, float]:
    """Mean of the per-clip (mean, std) over already-computed log-mels (the
    reference's population std)."""
    means = [float(np.mean(l)) for l in lms_list]
    stds = [float(np.std(l)) for l in lms_list]
    return float(np.mean(means)), float(np.mean(stds))


def compute_timestamp_stats(melspec: np.ndarray) -> Tuple[float, float]:
    """The reference's timestamp statistics: it divides the global mean and
    std by len(melspec) a second time, which rescales inputs by about N.
    Kept as it is because the published HEAR scores were made with it."""
    n = len(melspec)
    return float(melspec.mean() / n), float(melspec.std() / n)
