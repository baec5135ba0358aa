"""Datasets of the port (port of ssl_audio_tpu/data/datasets.py): the
on-disk sets in the reference's formats (FSD50K ground-truth CSVs, the
LibriSpeech json index, NSynth HEAR json, AudioSet segment CSVs of `.npy`
log-mels or of wavs, a directory of wavs), the synthetic sets,
calculate_norm_stats and the normalisation statistics.

An item is what the JAX dataset gives for the same tree and seed: a float32
(1, n_mels, crop_frames) log-mel (or a raw waveform) and its label, drawn
from the same np.random.default_rng(seed), so both packages give the same
bits.  With --load_wav (cfg.load_lms False) the log-mel of an item is made
from its wav by ops.mel.log_mel_spectrogram on cfg.device (None = the card,
as for the Trainer): the wav crop is drawn on the host, then the log-mel,
the frame crop or pad, and the normalisation.  `load_batch` does
the same for a whole batch with one log-mel launch; the loader calls it
where `mel_per_batch` is true.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ssl_audio_tpu_torch.utils import resolve_device

# (mean, std) of the log-mels per dataset, the reference's constants
NORM_STATS = {
    "fsd50k": (-4.950, 5.855),
    "librispeech": (-3.332, 4.205),
    "audioset": (-0.8294, 4.6230),
    "nsynth": (-8.82, 7.03),
}


def make_index_dict(label_csv: str) -> dict:
    """mids -> class index (as a string), from a CSV with a header row."""
    index_lookup = {}
    with open(label_csv, "r") as f:
        for row in csv.DictReader(f):
            index_lookup[row["mids"]] = row["index"]
    return index_lookup


def pcm_to_float(data: np.ndarray) -> np.ndarray:
    """int16 / int32 PCM scaled to [-1, 1), anything else cast, as float32."""
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    return data.astype(np.float32)


def load_wav(path: str, sample_rate: int) -> np.ndarray:
    """Mono float32 waveform at `sample_rate`: channels averaged; an integer
    factor by striding, any other ratio by scipy's resample_poly."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    data = pcm_to_float(data)
    if data.ndim > 1:
        data = data.mean(axis=1)
    if sr != sample_rate:
        if sr % sample_rate == 0:
            data = data[:: sr // sample_rate]
        else:
            from scipy.signal import resample_poly

            g = np.gcd(sr, sample_rate)
            data = resample_poly(data, sample_rate // g, sr // g).astype(np.float32)
    return data


def unit_crop(wav: np.ndarray, unit_length: int, rng: np.random.Generator) -> np.ndarray:
    """Zero-pad both ends to unit_length, or crop a random unit_length
    window (one draw from rng when the wav is longer)."""
    adj = unit_length - len(wav)
    if adj > 0:
        half = adj // 2
        wav = np.pad(wav, (half, adj - half))
    adj = len(wav) - unit_length
    start = int(rng.integers(0, adj + 1)) if adj > 0 else 0
    return wav[start: start + unit_length]


def draw_crop_start(length: int, crop_frames: int, rng: np.random.Generator) -> int:
    """crop_or_pad's draw: a start in [0, length - crop_frames) when the item
    is longer than crop_frames (the reference's exclusive bound), else 0 and
    no draw."""
    return int(rng.integers(0, length - crop_frames)) if length > crop_frames else 0


def crop_at(lms: np.ndarray, crop_frames: int, start: int) -> np.ndarray:
    """The last axis cropped to crop_frames from `start`, or zero-padded at
    the end to crop_frames, as float32."""
    length = lms.shape[-1]
    if length > crop_frames:
        lms = lms[..., start: start + crop_frames]
    elif length < crop_frames:
        lms = np.pad(lms, [(0, 0)] * (lms.ndim - 1) + [(0, crop_frames - length)])
    return lms.astype(np.float32)


def crop_or_pad(lms: np.ndarray, crop_frames: int, rng: np.random.Generator) -> np.ndarray:
    """Random time crop, or zero pad, to crop_frames."""
    return crop_at(lms, crop_frames, draw_crop_start(lms.shape[-1], crop_frames, rng))


class _LMSDatasetBase:
    """What the log-mel-or-wav datasets share.  A subclass gives
    `_paths(idx)` -> (npy path, wav path) and `_label(idx)`.  `rng` is
    shared by every item, as in the JAX package: on the loader's Python path
    with several threads the crops depend on the threads' order."""

    def __init__(self, cfg, transform=None, norm_stats=None, crop_frames=None, seed=0):
        self.cfg = cfg
        self.transform = transform         # host-side transform hook (rare)
        self.norm_stats = norm_stats
        self.crop_frames = cfg.crop_frames if crop_frames is None else crop_frames
        self.rng = np.random.default_rng(seed)
        self._mel = None
        self._stream = None

    @property
    def supports_native(self) -> bool:
        """Whether the C++ batch reader can serve this dataset: `.npy` reads
        with no host-side transform."""
        return bool(self.cfg.load_lms) and self.transform is None and hasattr(
            self, "batch_paths")

    @property
    def mel_per_batch(self) -> bool:
        """Whether the loader hands this dataset whole batches (load_batch):
        --load_wav with no transform."""
        return not self.cfg.load_lms and self.transform is None

    @property
    def unit_length(self) -> int:
        return int(self.cfg.unit_sec * self.cfg.sample_rate)

    @property
    def mel_spec(self):
        if self._mel is None:
            from ssl_audio_tpu_torch.ops.mel import MelSpec

            self._mel = MelSpec.from_config(self.cfg)
        return self._mel

    def _log_mel(self, wavs: np.ndarray) -> np.ndarray:
        """(B, L) host waveforms -> (B, n_mels, T) host log-mels, computed on
        cfg.device (on the card in a stream of the dataset's own, so a
        loader thread does not queue behind the training step)."""
        from ssl_audio_tpu_torch.ops.mel import log_mel_spectrogram

        dev = resolve_device(self.cfg.device)
        x = torch.from_numpy(np.ascontiguousarray(wavs, dtype=np.float32))
        if dev.type != "cuda":
            return log_mel_spectrogram(x.to(dev), self.mel_spec).cpu().numpy()
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(self._stream):
            return log_mel_spectrogram(x.to(dev), self.mel_spec).cpu().numpy()

    def _to_lms_from_wav(self, path: str) -> np.ndarray:
        wav = unit_crop(load_wav(path, self.cfg.sample_rate), self.unit_length, self.rng)
        return self._log_mel(wav[None])[0]

    def _normalise(self, lms: np.ndarray) -> np.ndarray:
        if self.norm_stats is not None:
            lms = (lms - self.norm_stats[0]) / self.norm_stats[1]
        if self.transform is not None:
            lms = self.transform(lms)
        return lms.astype(np.float32)

    def _finalize(self, lms: np.ndarray) -> np.ndarray:
        return self._normalise(crop_or_pad(lms, self.crop_frames, self.rng))

    def _load_item(self, npy_path: str, wav_path: str) -> np.ndarray:
        if self.cfg.load_lms:
            lms = np.load(npy_path)[None]                  # (1, n_mels, T)
        else:
            lms = self._to_lms_from_wav(wav_path)[None]
        return self._finalize(lms)

    def __getitem__(self, idx):
        return self._load_item(*self._paths(idx)), self._label(idx)

    def load_batch(self, indices, pool=None) -> Tuple[np.ndarray, np.ndarray]:
        """--load_wav items `indices` as one batch: the wavs read (on `pool`'s
        threads, if given), then each item's draws in turn (its wav crop,
        then its frame crop), one log-mel launch for the batch, and each
        item's crop or pad and normalisation.  The same draws and the same
        operations per item as __getitem__ over the indices in order."""
        sr = self.cfg.sample_rate
        wav_paths = [self._paths(int(i))[1] for i in indices]
        wavs = list((pool.map if pool is not None else map)(
            lambda p: load_wav(p, sr), wav_paths))
        frames = self.mel_spec.num_frames(self.unit_length)
        crops, starts = [], []
        for wav in wavs:
            crops.append(unit_crop(wav, self.unit_length, self.rng))
            starts.append(draw_crop_start(frames, self.crop_frames, self.rng))
        lms = self._log_mel(np.stack(crops))[:, None]     # (B, 1, n_mels, T)
        xs = np.stack([self._normalise(crop_at(x, self.crop_frames, s))
                       for x, s in zip(lms, starts)])
        return xs, np.stack([np.asarray(self._label(int(i))) for i in indices])


class FSD50K(_LMSDatasetBase):
    """FSD50K (reference datasets.py:26-124): split "train" or "val" (the
    rows of dev.csv with that split), "test" (eval.csv) or anything else,
    "train_val" in the loop, for every row of dev.csv.  A header row is not
    skipped, as in the JAX package."""

    def __init__(self, cfg, split="train", transform=None, norm_stats=None,
                 crop_frames=None, data_dir="data", seed=0):
        super().__init__(cfg, transform, norm_stats, crop_frames, seed)
        self.split = split
        self.data_dir = data_dir
        gt = os.path.join(data_dir, "FSD50K/FSD50K.ground_truth")
        with open(os.path.join(gt, "eval.csv" if split == "test" else "dev.csv")) as f:
            rows = list(csv.reader(f))
        if split in ("train", "val"):
            rows = [r for r in rows if len(r) > 3 and r[3] == split]
        self.files = [r[0] for r in rows]
        self.labels = [r[2] if len(r) > 2 else "" for r in rows]
        self.index_dict = make_index_dict(os.path.join(gt, "vocabulary.csv"))
        self.label_num = len(self.index_dict)

    def __len__(self):
        return len(self.files)

    def _label(self, idx) -> np.ndarray:
        y = np.zeros(self.label_num, np.float32)
        for s in self.labels[idx].split(","):
            if s:
                y[int(self.index_dict[s])] = 1.0
        return y

    def _paths(self, idx) -> Tuple[str, str]:
        sub = "FSD50K.eval_audio" if self.split == "test" else "FSD50K.dev_audio"
        name = self.files[idx]
        return (os.path.join(self.data_dir, f"FSD50K_lms/{sub}/{name}.npy"),
                os.path.join(self.data_dir, f"FSD50K/{sub}/{name}.wav"))

    def batch_paths(self, indices):
        return ([self._paths(int(i))[0] for i in indices],
                [self._label(int(i)) for i in indices])


class LibriSpeech(_LMSDatasetBase):
    """LibriSpeech (reference datasets.py:127-209) from its json index;
    labels are zeros."""

    def __init__(self, cfg, train=True, transform=None, norm_stats=None,
                 n_dummy=200, data_dir="data", seed=0):
        super().__init__(cfg, transform, norm_stats, None, seed)
        self.n_dummy = n_dummy
        base = "LibriSpeech_lms" if cfg.load_lms else "LibriSpeech"
        self.base_path = os.path.join(data_dir, base)
        with open(os.path.join(self.base_path, "librispeech_tr960_cut.json")) as fp:
            self.data = json.load(fp)["data"]

    def __len__(self):
        return len(self.data)

    def _label(self, idx) -> np.ndarray:
        return np.zeros(self.n_dummy, np.float32)

    def _paths(self, idx) -> Tuple[str, str]:
        fname = self.data[idx]["wav"]
        return (os.path.join(self.base_path, fname[: -len(".flac")] + ".npy"),
                os.path.join(self.base_path, fname))


class NSynthHEAR(_LMSDatasetBase):
    """NSynth pitch, HEAR layout (reference datasets.py:212-290): the class
    is the MIDI pitch - 21."""

    def __init__(self, cfg, split="train", transform=None, norm_stats=None,
                 data_dir="data", hear_dir="hear", seed=0):
        super().__init__(cfg, transform, norm_stats, None, seed)
        self.split = split
        self.data_dir = data_dir
        base = os.path.join(hear_dir, "tasks/nsynth_pitch-v2.2.3-50h")
        self.wav_dir = os.path.join(base, f"16000/{split}")
        with open(os.path.join(base, f"{split}.json")) as fp:
            data = json.load(fp)
        self.data = [(name, label[0]) for name, label in data.items()]
        self.label_num = 88  # MIDI pitches 21-108

    def __len__(self):
        return len(self.data)

    def _label(self, idx):
        return np.int32(int(self.data[idx][1]) - 21)

    def _paths(self, idx) -> Tuple[str, str]:
        fname = self.data[idx][0]
        return (os.path.join(self.data_dir, f"nsynth_lms/nsynth-{self.split}/audio/"
                                            f"{fname[:-len('.wav')]}.npy"),
                os.path.join(self.wav_dir, fname))


class AudioSet(_LMSDatasetBase):
    """AudioSet `.npy` log-mels (reference datasets.py:293-359): '#'-joined
    labels; an unreadable file is replaced by a random FSD50K dev clip
    (where FSD50K is there).  test=True takes the eval segments.  Always
    `.npy`, whatever cfg.load_lms says, as in the JAX package."""

    def __init__(self, cfg, transform=None, norm_stats=None, data_dir="data",
                 seed=0, test=False):
        super().__init__(cfg, transform, norm_stats, None, seed)
        self.base_dir = os.path.join(data_dir, "audioset_lms")
        self.data_dir = data_dir
        self.segments_dir = "eval_segments" if test else "unbalanced_train_segments"
        csv_name = ("eval_segments-downloaded.csv" if test
                    else "unbalanced_train_segments-downloaded.csv")
        with open(os.path.join(self.base_dir, csv_name)) as f:
            rows = list(csv.reader(f))
        self.audio_fnames = [r[0] for r in rows]
        self.labels = [r[1] for r in rows]
        self.index_dict = make_index_dict(os.path.join(self.base_dir, "class_labels_indices.csv"))
        self.label_num = len(self.index_dict)
        try:
            with open(os.path.join(data_dir, "FSD50K/FSD50K.ground_truth/dev.csv")) as f:
                self.files_fsd50k = [row[0] for row in csv.reader(f)]
        except FileNotFoundError:
            self.files_fsd50k = []

    def __len__(self):
        return len(self.audio_fnames)

    def _label(self, idx) -> np.ndarray:
        y = np.zeros(self.label_num, np.float32)
        for s in self.labels[idx].split("#"):
            if s:
                y[int(self.index_dict[s])] = 1.0
        return y

    def _npy_path(self, idx) -> str:
        return os.path.join(self.base_dir, self.segments_dir, f"{self.audio_fnames[idx]}.npy")

    def batch_paths(self, indices):
        return ([self._npy_path(int(i)) for i in indices],
                [self._label(int(i)) for i in indices])

    @property
    def mel_per_batch(self) -> bool:
        return False

    def __getitem__(self, idx):
        y = self._label(idx)
        try:
            lms = np.load(self._npy_path(idx))[None]
        except (ValueError, FileNotFoundError):
            if not self.files_fsd50k:
                raise
            alt = self.rng.choice(self.files_fsd50k)
            lms = np.load(
                os.path.join(self.data_dir, f"FSD50K_lms/FSD50K.dev_audio/{alt}.npy"))[None]
        return self._finalize(lms), y


class AudioSetWav:
    """Wav-domain AudioSet (reference old/data_manager/audioset.py:41-212):
    the balanced / unbalanced / eval segment CSVs (unbalanced then balanced
    for training, capped at `cap` rows with twohundredk_only), channels
    averaged, zero-padded at both ends or randomly cropped to unit_sec.
    Items are raw (unit_length,) float32 waveforms and multi-hot labels: the
    log-mel, crop and normalisation run in the training step
    (train/steps.py make_device_frontend).  The wavs must be at
    cfg.sample_rate (ValueError otherwise; the JAX package asserts)."""

    returns_wav = True
    supports_native = True   # C++ batch decode (native/wav_batch_loader.cc)

    def __init__(self, cfg, base_dir="data/audioset", balanced_only=False,
                 test=False, twohundredk_only=False, cap=int(2e5), seed=0):
        self.cfg = cfg
        self.base_dir = base_dir
        self.unit_length = int(cfg.unit_sec * cfg.sample_rate)
        self.rng = np.random.default_rng(seed)

        def read(name):
            with open(os.path.join(base_dir, name)) as f:
                return [row for row in csv.reader(f) if row]

        if test:
            rows = read("eval_segments-downloaded.csv")
        elif balanced_only:
            rows = read("balanced_train_segments-downloaded.csv")
        else:
            rows = (read("unbalanced_train_segments-downloaded.csv")
                    + read("balanced_train_segments-downloaded.csv"))
            if twohundredk_only:
                rows = rows[:cap]
        self.audio_fnames = [r[0] for r in rows]
        self.labels = [r[1] for r in rows]
        self.ident = [r[2] for r in rows]
        # the reference's old make_index_dict reads column 'mid'; the newer
        # CSVs name it 'mids'
        self.index_dict = {}
        with open(os.path.join(base_dir, "class_labels_indices.csv")) as f:
            for row in csv.DictReader(f):
                self.index_dict[row.get("mid", row.get("mids"))] = row["index"]
        self.label_num = len(self.index_dict)

    def __len__(self):
        return len(self.audio_fnames)

    def _label(self, idx) -> np.ndarray:
        y = np.zeros(self.label_num, np.float32)
        for s in self.labels[idx].split("#"):
            if s:
                y[int(self.index_dict[s])] = 1.0
        return y

    def _wav_path(self, idx) -> str:
        return os.path.join(self.base_dir, self.ident[idx], f"{self.audio_fnames[idx]}.wav")

    def batch_paths(self, batch_idx):
        """(paths, labels) for the loader's C++ wav reader."""
        return ([self._wav_path(int(i)) for i in batch_idx],
                [self._label(int(i)) for i in batch_idx])

    def __getitem__(self, idx):
        from scipy.io import wavfile

        y = self._label(idx)
        sr, wav = wavfile.read(self._wav_path(idx))
        if sr != self.cfg.sample_rate:
            raise ValueError(f"Convert .wav files to {self.cfg.sample_rate} Hz. "
                             f"{self.audio_fnames[idx]}.wav has {sr} Hz.")
        wav = pcm_to_float(wav)
        if wav.ndim == 2:                        # stereo -> mono
            wav = wav.mean(axis=1)
        return unit_crop(wav, self.unit_length, self.rng).astype(np.float32), y


class WavClips:
    """Every `.wav` under a directory as fixed-length raw waveforms (cropped
    at a random start, or zero-padded at the end) with a dummy label, for
    the on-device-frontend mode."""

    returns_wav = True

    def __init__(self, cfg, wav_dir: str, clip_seconds: float = 10.0, seed: int = 0):
        self.cfg = cfg
        self.n_samples = int(clip_seconds * cfg.sample_rate)
        self.rng = np.random.default_rng(seed)
        self.paths = []
        for root, _d, files in os.walk(wav_dir):
            for f in sorted(files):
                if f.lower().endswith(".wav"):
                    self.paths.append(os.path.join(root, f))
        if not self.paths:
            raise FileNotFoundError(f"no .wav files under {wav_dir}")
        self.label_num = 1

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx):
        wav = load_wav(self.paths[idx], self.cfg.sample_rate)
        if len(wav) >= self.n_samples:
            start = int(self.rng.integers(0, len(wav) - self.n_samples + 1))
            wav = wav[start: start + self.n_samples]
        else:
            wav = np.pad(wav, (0, self.n_samples - len(wav)))
        return wav.astype(np.float32), np.zeros(1, np.float32)


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
