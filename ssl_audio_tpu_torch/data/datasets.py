"""Datasets of the port (the synthetic ones of ssl_audio_tpu/data/datasets.py,
calculate_norm_stats and the normalisation statistics).  The on-disk
datasets (FSD50K, AudioSet, LibriSpeech, NSynth) are not ported yet."""
from __future__ import annotations

from typing import Optional

import numpy as np

# (mean, std) of the log-mels per dataset, the reference's constants
NORM_STATS = {
    "fsd50k": (-4.950, 5.855),
    "librispeech": (-3.332, 4.205),
    "audioset": (-0.8294, 4.6230),
    "nsynth": (-8.82, 7.03),
}


class SyntheticLMS:
    """Random log-mel clips with a class-dependent spectral envelope, for
    smoke tests and benches (--dataset synthetic)."""

    def __init__(self, cfg, length: Optional[int] = None, n_classes=10, seed=0,
                 env_gain=2.0, env_width=0.08, noise=0.5):
        self.cfg = cfg
        self.length = length if length is not None else cfg.synthetic_len
        self.n_classes = n_classes
        self.seed = seed
        self.label_num = n_classes
        self.env_gain = env_gain
        self.env_width = env_width
        self.noise = noise

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        cls = idx % self.n_classes
        mel_axis = np.linspace(0, 1, self.cfg.n_mels)[:, None]
        env = np.exp(
            -0.5 * ((mel_axis - (cls + 0.5) / self.n_classes) / self.env_width) ** 2)
        lms = rng.standard_normal((1, self.cfg.n_mels, self.cfg.crop_frames)).astype(np.float32)
        lms = lms * self.noise + self.env_gain * env[None].astype(np.float32)
        y = np.zeros(self.n_classes, np.float32)
        y[cls] = 1.0
        return lms, y


class SyntheticMultiCue:
    """Random log-mel clips whose class survives the augmentations
    (--dataset synthetic_multicue, the learning proof's task).

    A class is a pair of cues: a spectral envelope position (n_env bands)
    and a temporal amplitude-modulation rate (n_rate geometric rates).  The
    random resize crop warps each axis by U(0.6, 1.5) per view, which
    jitters the band position and the rate but cannot erase both at once
    (band spacing 1 / n_env and the rate ratio are wider than the warp);
    mixup and the linear fader leave the dominant envelope and modulation
    in place.  Item idx draws from np.random.default_rng(seed * 1_000_003 +
    idx), as the JAX dataset does, so both give the same bits."""

    def __init__(self, cfg, length: Optional[int] = None, n_env=4, n_rate=5,
                 seed=0, gain=1.2, env_width=0.09, noise=1.0,
                 rate_min=2.0, rate_ratio=2.2, am_depth=0.9):
        self.cfg = cfg
        self.length = length if length is not None else cfg.synthetic_len
        self.n_env = n_env
        self.n_rate = n_rate
        self.n_classes = n_env * n_rate
        self.label_num = self.n_classes
        self.seed = seed
        self.gain = gain
        self.env_width = env_width
        self.noise = noise
        self.rate_min = rate_min
        self.rate_ratio = rate_ratio
        self.am_depth = am_depth

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        cls = idx % self.n_classes
        e, r = cls % self.n_env, cls // self.n_env
        F, T = self.cfg.n_mels, self.cfg.crop_frames
        mel = np.linspace(0, 1, F)[:, None]
        env = np.exp(-0.5 * ((mel - (e + 0.5) / self.n_env) / self.env_width) ** 2)
        rate = self.rate_min * self.rate_ratio ** r          # cycles per clip
        t = np.linspace(0, 1, T)[None, :]
        am = 1.0 + self.am_depth * np.sin(2 * np.pi * rate * t + rng.uniform(0, 2 * np.pi))
        lms = rng.standard_normal((1, F, T)).astype(np.float32) * self.noise
        lms += (self.gain * env * am)[None].astype(np.float32)
        y = np.zeros(self.n_classes, np.float32)
        y[cls] = 1.0
        return lms, y


def calculate_norm_stats(dataset, n_norm_calc=10000, seed=0):
    """(mean, std) of a random sample of the dataset's items."""
    rng = np.random.default_rng(seed)
    idxs = rng.integers(0, len(dataset), size=min(n_norm_calc, len(dataset)))
    vecs = np.stack([dataset[int(i)][0] for i in idxs])
    return float(vecs.mean()), float(vecs.std() + np.finfo(np.float32).eps)


class SyntheticWav:
    """Fixed-length waveforms (a class-dependent tone plus noise) for the
    on-device-frontend training mode: wav -> log-mel -> crop -> augment
    inside the step (--dataset synthetic_wav)."""

    returns_wav = True

    def __init__(self, cfg, length: Optional[int] = None, clip_seconds: float = 10.0,
                 n_classes: int = 10, seed: int = 0):
        self.cfg = cfg
        self.length = length if length is not None else cfg.synthetic_len
        self.n_samples = int(clip_seconds * cfg.sample_rate)
        self.n_classes = n_classes
        self.label_num = n_classes
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.default_rng(self.seed * 999_983 + idx)
        cls = idx % self.n_classes
        t = np.arange(self.n_samples) / self.cfg.sample_rate
        f0 = 200.0 * (1.3 ** cls)
        wav = 0.2 * np.sin(2 * np.pi * f0 * t) + 0.05 * rng.standard_normal(self.n_samples)
        y = np.zeros(self.n_classes, np.float32)
        y[cls] = 1.0
        return wav.astype(np.float32), y
