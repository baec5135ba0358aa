"""HEAR helpers shared by the serving wrappers (port of the shared part of
ssl_audio_tpu/hear/vit.py: its constants, _as_numpy,
_frame_audio_on_device, _timestamp_pipeline and _fetch_embeddings), used by
hear/conv.py and hear/vit.py.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ssl_audio_tpu_torch.hear.utils import frame_starts

# default frame duration / hop in ms, and the inference batch size
TIMESTAMP_FRAME_DUR = 950
TIMESTAMP_HOP_SIZE = 50
BATCH_SIZE = 512


def _as_numpy(audio) -> np.ndarray:
    """Tensor, array or list of equal-length clips -> ndarray (a ragged list
    raises ValueError from np.stack)."""
    if isinstance(audio, torch.Tensor):
        return audio.detach().cpu().numpy()
    if isinstance(audio, (list, tuple)):
        return np.stack([_as_numpy(a) for a in audio])
    return np.asarray(audio)


def frame_audio_on_device(audio: np.ndarray, frame_size: int, hop_size: float,
                          sample_rate: int, device: torch.device):
    """Device-side framing with the windows and timestamps of
    hear/utils.frame_audio: the audio is copied to the device once and the
    overlapping windows are gathered there.

    Returns (flat windows (M, frame_size) on device, M padded with zero
    rows to a BATCH_SIZE multiple; timestamps (n_sounds, n_frames) in ms,
    float32 on the CPU; N real rows)."""
    n_sounds, n_samples = audio.shape
    starts, ts = frame_starts(n_samples, frame_size, hop_size, sample_rate)
    pad_l = frame_size // 2
    x = torch.nn.functional.pad(
        torch.as_tensor(audio, dtype=torch.float32).to(device),
        (pad_l, frame_size - pad_l))
    idx = (torch.as_tensor(starts, device=device)[:, None]
           + torch.arange(frame_size, device=device)[None, :])
    flat = x[:, idx].reshape(n_sounds * len(starts), frame_size)
    N = flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, 0, 0, (-N) % BATCH_SIZE))
    timestamps = torch.as_tensor(ts, dtype=torch.float32)[None].repeat(n_sounds, 1)
    return flat, timestamps, N


def timestamp_pipeline(to_feature: Callable, encode: Callable,
                       flat: torch.Tensor, N: int,
                       fetch_dtype: str = "float32") -> torch.Tensor:
    """(M, frame_size) device windows, M a BATCH_SIZE multiple with N real
    rows -> (N, D) float32 embeddings on the CPU.

    Chunk by chunk of BATCH_SIZE real rows (zero padding rows are neither
    transformed nor encoded): to_feature -> log-mel (C, 1, F, T); the
    reference's statistics over the real rows, with its 1/N quirk
    (mean = mu / N, std = sqrt(unbiased var) / N, hear/utils.py); then
    normalise and encode.  fetch_dtype="bfloat16" casts on the device
    before the copy to the host (half the bytes; embeddings rounded to
    bf16)."""
    mels = [to_feature(flat[i : min(i + BATCH_SIZE, N)])
            for i in range(0, N, BATCH_SIZE)]
    total = N * int(np.prod(mels[0].shape[1:]))
    s1 = sum(m.sum(dtype=torch.float64) for m in mels)
    s2 = sum((m.double() ** 2).sum() for m in mels)
    mu = s1 / total
    var = (s2 - total * mu * mu) / (total - 1)         # torch .std() (unbiased)
    mean = (mu / N).float()
    std = (torch.sqrt(var) / N).float()
    embs = [encode((m - mean) / std) for m in mels]
    out = torch.cat(embs)
    if fetch_dtype == "bfloat16":
        out = out.to(torch.bfloat16)
    return fetch(out).float()


def fetch(t: torch.Tensor) -> torch.Tensor:
    """Copy a device tensor to the host through page-locked memory: a copy
    into pageable memory runs at a fraction of the link's rate (the
    timestamp embeddings of 16 10-s clips are 40 MB)."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host
