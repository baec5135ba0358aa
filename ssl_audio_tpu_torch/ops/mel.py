"""Log-mel spectrogram frontend (port of ssl_audio_tpu/ops/mel.py).

Same pipeline and tables as the JAX module: reflect-pad like
torch.stft(center=True), windowed real DFT as fp32 matrix products (folded
into half-size e/o products when the window is midpoint-symmetric),
power, the HTK mel filterbank (norm=None), then log(mel + float32 eps).

`log_mel_spectrogram` takes the plain PyTorch version for a CPU tensor and
the hand-written CUDA kernel (ops/mel_kernel.py) for a CUDA tensor.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

# torch.finfo(torch.float32).eps — the log epsilon the reference adds
TORCH_FLOAT32_EPS = float(np.finfo(np.float32).eps)


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int) -> np.ndarray:
    """Triangular HTK mel filterbank, (n_freqs, n_mels) float32
    (torchaudio.functional.melscale_fbanks, mel_scale='htk')."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs, dtype=np.float64)
    m_pts = np.linspace(hz_to_mel_htk(f_min), hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window(periodic=True))."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


@dataclass(frozen=True)
class MelSpec:
    """Static frontend spec and its constant tables (numpy, float32)."""

    sample_rate: int = 16000
    n_fft: int = 1024
    win_length: int = 1024
    hop_length: int = 160
    n_mels: int = 64
    f_min: float = 60.0
    f_max: float = 7800.0

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    @functools.cached_property
    def window(self) -> np.ndarray:
        """Window zero-padded to n_fft and centred, as torch.stft does."""
        w = hann_window(self.win_length)
        if self.win_length < self.n_fft:
            left = (self.n_fft - self.win_length) // 2
            w = np.pad(w, (left, self.n_fft - self.win_length - left))
        return w

    @functools.cached_property
    def dft_matrices(self) -> tuple[np.ndarray, np.ndarray]:
        """(C, S): (n_fft, n_freqs) windowed real-DFT bases (S carries +sin;
        the sign is irrelevant for |.|^2)."""
        n = np.arange(self.n_fft, dtype=np.float64)[:, None]
        k = np.arange(self.n_freqs, dtype=np.float64)[None, :]
        ang = 2.0 * np.pi * n * k / self.n_fft
        w = self.window.astype(np.float64)[:, None]
        return ((w * np.cos(ang)).astype(np.float32),
                (w * np.sin(ang)).astype(np.float32))

    @functools.cached_property
    def dft_matrices_folded(self) -> tuple[np.ndarray, np.ndarray] | None:
        """(C_half, S_half): (n_fft//2+1, n_freqs) bases for the folded
        frames e[n] = f[n] + f[(N-n) % N], o[n] = f[n] - f[(N-n) % N]
        (rows 0 and N/2 of C halved, exact in fp).  None when the window is
        not midpoint-symmetric."""
        if self.n_fft % 2:
            return None
        w = self.window.astype(np.float64)
        idx = (self.n_fft - np.arange(self.n_fft)) % self.n_fft
        if not np.allclose(w, w[idx], rtol=0, atol=0):
            return None
        C, S = self.dft_matrices
        h = self.n_fft // 2 + 1
        C_half = C[:h].copy()
        C_half[0] *= 0.5
        C_half[self.n_fft // 2] *= 0.5
        return C_half, S[:h].copy()

    @functools.cached_property
    def dft_matrices_mel_folded(self) -> tuple[np.ndarray, np.ndarray] | None:
        folded = self.dft_matrices_folded
        if folded is None:
            return None
        k = self.n_freqs_used
        return folded[0][:, :k], folded[1][:, :k]

    @functools.cached_property
    def filterbank(self) -> np.ndarray:
        return mel_filterbank(self.n_freqs, self.f_min, self.f_max,
                              self.n_mels, self.sample_rate)

    @functools.cached_property
    def n_freqs_used(self) -> int:
        """Frequency bins that reach any mel band, rounded up to a multiple
        of 128 (bins above f_max have all-zero filterbank rows, so the
        truncation is exact)."""
        nz = np.nonzero(self.filterbank.sum(axis=1))[0]
        last = int(nz.max()) + 1 if len(nz) else self.n_freqs
        return min(self.n_freqs, ((last + 127) // 128) * 128)

    @functools.cached_property
    def dft_matrices_mel(self) -> tuple[np.ndarray, np.ndarray]:
        C, S = self.dft_matrices
        k = self.n_freqs_used
        return C[:, :k], S[:, :k]

    @functools.cached_property
    def filterbank_mel(self) -> np.ndarray:
        return self.filterbank[: self.n_freqs_used]

    def num_frames(self, num_samples: int) -> int:
        return 1 + num_samples // self.hop_length       # torch.stft(center=True)

    @classmethod
    def from_config(cls, cfg) -> "MelSpec":
        return cls(sample_rate=int(cfg.sample_rate), n_fft=int(cfg.n_fft),
                   win_length=int(cfg.win_length),
                   hop_length=int(cfg.hop_length), n_mels=int(cfg.n_mels),
                   f_min=float(cfg.f_min), f_max=float(cfg.f_max))


def _reflect_pad(wav: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, L) -> (B, L + 2*pad), torch.stft's centring pad."""
    if pad >= wav.shape[-1]:
        raise ValueError(f"reflect pad {pad} needs more than {pad} samples, "
                         f"got {wav.shape[-1]}")
    return torch.nn.functional.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A float32 table on `like`'s device in `like`'s dtype (float64 for the
    exact-arithmetic witness of the same function)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device, like.dtype)


def _log_mel_of_frames(x: torch.Tensor, first: torch.Tensor, spec: MelSpec,
                       fold: bool | None) -> torch.Tensor:
    """x (B, L + n_fft) reflect-padded clips, first (T,) or (B, T) first
    padded sample of every frame -> (B, n_mels, T) log-mel."""
    folded = _folded_bases(spec, fold)
    rows = torch.arange(x.shape[0], device=x.device)[:, None, None]
    first = first.expand(x.shape[0], -1)[:, :, None]             # (B, T, 1)
    if folded is not None:
        n = torch.arange(spec.n_fft // 2 + 1, device=x.device)
        a = x[rows, first + n]                                    # (B, T, h)
        b = x[rows, first + (spec.n_fft - n) % spec.n_fft]
        re = (a + b) @ _table(folded[0], x)
        im = (a - b) @ _table(folded[1], x)
    else:
        frames = x[rows, first + torch.arange(spec.n_fft, device=x.device)]
        C, S = spec.dft_matrices_mel
        re = frames @ _table(C, x)
        im = frames @ _table(S, x)
    mel = (re * re + im * im) @ _table(spec.filterbank_mel, x)
    return torch.log(mel + TORCH_FLOAT32_EPS).transpose(1, 2)


def log_mel_spectrogram_plain(wav: torch.Tensor, spec: MelSpec,
                              fold: bool | None = None) -> torch.Tensor:
    """(B, L) float32 -> (B, n_mels, T) log-mel in plain PyTorch: the CPU
    path and the oracle of the CUDA kernel.  fold as in
    log_mel_spectrogram."""
    x = _reflect_pad(wav, spec.n_fft // 2)
    T = spec.num_frames(wav.shape[-1])
    first = torch.arange(T, device=wav.device) * spec.hop_length
    return _log_mel_of_frames(x, first[None], spec, fold)


def log_mel_spectrogram_cropped_plain(wav: torch.Tensor, spec: MelSpec,
                                      fold: bool | None, starts: torch.Tensor,
                                      out_frames: int) -> torch.Tensor:
    """(B, L) float32 and per-clip first frames starts (B,) -> (B, n_mels,
    out_frames): output frame t of clip b is frame starts[b] + t of
    log_mel_spectrogram_plain(wav).  Plain PyTorch, log_mel_cuda's signature
    with crop starts: the CPU path and that kernel's oracle.  A frame index
    outside the clip is clamped to it, as in the kernel."""
    x = _reflect_pad(wav, spec.n_fft // 2)
    T_full = spec.num_frames(wav.shape[-1])
    frame = starts.long()[:, None] + torch.arange(out_frames, device=wav.device)
    first = frame.clamp(0, T_full - 1) * spec.hop_length
    return _log_mel_of_frames(x, first, spec, fold)


def _folded_bases(spec: MelSpec, fold: bool | None):
    """fold=None: folded bases whenever the window admits them; True:
    require them; False: never."""
    folded = spec.dft_matrices_mel_folded if fold is not False else None
    if fold and folded is None:
        raise ValueError("fold=True but the window is not midpoint-symmetric")
    return folded


def log_mel_spectrogram(wav: torch.Tensor, spec: MelSpec, fast: bool = False,
                        fold: bool | None = None) -> torch.Tensor:
    """(..., L) -> (..., n_mels, T) log-mel, the reference's
    (melspec(wav) + torch.finfo().eps).log().

    A CUDA tensor goes through the hand-written kernel (ops/mel_kernel.py),
    a CPU tensor through log_mel_spectrogram_plain.  `fast` is accepted for
    the JAX signature: there it selects a 3-pass bf16 split because the TPU's
    matrix unit is bf16, with a 1.5e-4 log-mel contract.  The port
    accumulates every product in fp32 either way, so fast=True returns the
    exact result, which lies inside that contract.  `fold` (None = auto)
    selects the folded or unfolded DFT, as in log_mel_spectrogram_pallas."""
    del fast
    lead = wav.shape[:-1]
    flat = wav.reshape(-1, wav.shape[-1]).float().contiguous()
    if flat.is_cuda:
        from ssl_audio_tpu_torch.ops.mel_kernel import log_mel_cuda

        out = log_mel_cuda(flat, spec, fold=fold)
    else:
        out = log_mel_spectrogram_plain(flat, spec, fold=fold)
    return out.reshape(*lead, *out.shape[1:])


def log_mel_spectrogram_cropped(wav: torch.Tensor, spec: MelSpec,
                                starts: torch.Tensor, out_frames: int,
                                fast: bool = False) -> torch.Tensor:
    """(B, L) and per-clip frame starts -> (B, n_mels, out_frames) log-mel of
    the cropped window only (the JAX function of the same name): frame t of
    the output equals frame starts[b] + t of log_mel_spectrogram(wav).  A
    CUDA tensor goes through the kernel, which reads starts on the device; a
    CPU tensor through the plain version.  `fast` as in
    log_mel_spectrogram."""
    del fast
    wav = wav.float().contiguous()
    if wav.is_cuda:
        from ssl_audio_tpu_torch.ops.mel_kernel import log_mel_cuda

        return log_mel_cuda(wav, spec, None, starts.to(torch.int32).contiguous(),
                            out_frames)
    return log_mel_spectrogram_cropped_plain(wav, spec, None, starts, out_frames)
