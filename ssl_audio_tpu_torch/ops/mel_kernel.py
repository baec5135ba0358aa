"""CUDA log-mel kernel (csrc/log_mel.cu), port of the Pallas kernel
ssl_audio_tpu/ops/mel_pallas.py log_mel_spectrogram_pallas: both its bodies,
_make_kernel_folded (fold) and _make_kernel (no fold), as two instantiations
of one templated kernel.

The kernel is bound by fp32 floating-point operations on the H100 (see the
source's header); its design keeps the overlapped frames out of device
memory and skips the basis rows outside the window's support, which are
exactly zero.  Plain version: ops/mel.py log_mel_spectrogram_plain.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ssl_audio_tpu_torch.ops import _build
from ssl_audio_tpu_torch.ops.mel import TORCH_FLOAT32_EPS, MelSpec, _folded_bases

# must match csrc/log_mel.cu
TILE_T = 32
FCH = 256
THREADS = 256
MAX_MELS = 128
SMEM_LIMIT = 232448            # bytes of shared memory one block may use
MAX_GRID_Y = 65535             # clips per launch (the grid's y extent)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"log_mel_launch": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, ctypes.c_float, _I, _P]}


@dataclass(frozen=True)
class KernelOperands:
    """What the kernel reads besides the wav: the DFT basis rows inside the
    window's support [n_lo, n_lo + K), columns zero-padded to a multiple of
    FCH, the filterbank with matching zero rows, and each mel band's nonzero
    filterbank rows [lo, hi)."""

    fold: bool
    n_lo: int
    basis_c: np.ndarray        # (K, n_pad)
    basis_s: np.ndarray        # (K, n_pad)
    fb: np.ndarray             # (n_pad, n_mels)
    band: np.ndarray           # (2, n_mels) int32

    def smem_bytes(self) -> int:
        k = self.basis_c.shape[0]
        return 4 * ((2 if self.fold else 1) * k * TILE_T
                    + TILE_T * (FCH + 1) + 16 * THREADS)

    def flops_per_frame(self) -> int:
        """Floating-point operations the kernel does per frame: the DFT
        products over the support (2 per FMA, re and im), the power, and the
        mel product over the bands' filterbank rows."""
        k, n_pad = self.basis_c.shape
        return (2 * 2 * k * n_pad + 3 * n_pad
                + 2 * int((self.band[1] - self.band[0]).sum()))


@functools.lru_cache(maxsize=None)
def kernel_operands(spec: MelSpec, fold: bool | None = None) -> KernelOperands:
    folded = _folded_bases(spec, fold)
    C, S = folded if folded is not None else spec.dft_matrices_mel
    rows = np.nonzero(np.abs(C).sum(axis=1) + np.abs(S).sum(axis=1))[0]
    lo, hi = int(rows.min()), int(rows.max()) + 1
    n_used = C.shape[1]
    n_pad = -(-n_used // FCH) * FCH
    cols = ((0, 0), (0, n_pad - n_used))
    fb = spec.filterbank_mel
    band = np.zeros((2, fb.shape[1]), np.int32)
    for m in range(fb.shape[1]):
        nz = np.nonzero(fb[:, m])[0]
        if len(nz):
            band[:, m] = nz.min(), nz.max() + 1
    return KernelOperands(
        fold=folded is not None, n_lo=lo,
        basis_c=np.ascontiguousarray(np.pad(C[lo:hi], cols)),
        basis_s=np.ascontiguousarray(np.pad(S[lo:hi], cols)),
        fb=np.ascontiguousarray(np.pad(fb, (cols[1], (0, 0)))), band=band)


@functools.lru_cache(maxsize=16)
def _device_tables(spec: MelSpec, fold: bool | None, device: torch.device):
    ops = kernel_operands(spec, fold)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (ops.basis_c, ops.basis_s, ops.fb, ops.band))


def log_mel_cuda(wav: torch.Tensor, spec: MelSpec,
                 fold: bool | None = None) -> torch.Tensor:
    """(B, L) float32 CUDA tensor -> (B, n_mels, T) log-mel through the CUDA
    kernel.  fold: None = the folded instantiation whenever the window
    admits it, False = the unfolded one, True = require the fold."""
    ops = kernel_operands(spec, fold)
    dev = wav.device
    if dev.type != "cuda":
        raise ValueError(f"log_mel_cuda needs a CUDA tensor, got {dev}")
    B, L = wav.shape
    _build.require(wav, "wav", (B, L), dev)
    if B > MAX_GRID_Y:
        raise ValueError(f"at most {MAX_GRID_Y} clips per launch, got {B}")
    if L <= spec.n_fft // 2:
        raise ValueError(f"reflect centring needs more than {spec.n_fft // 2} "
                         f"samples, got {L}")
    if spec.n_mels > MAX_MELS or ops.smem_bytes() > SMEM_LIMIT:
        raise ValueError(f"{spec} is outside the kernel's limits (n_mels <= "
                         f"{MAX_MELS}, {ops.smem_bytes()} > {SMEM_LIMIT} B "
                         f"of shared memory)")
    T = spec.num_frames(L)
    out = torch.empty(B, spec.n_mels, T, device=dev)
    if B == 0:
        return out
    basis_c, basis_s, fb, band = _device_tables(spec, fold, dev)
    lib = _build.load("log_mel.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        code = lib.log_mel_launch(
            wav.data_ptr(), B, L, T, basis_c.data_ptr(), basis_s.data_ptr(),
            fb.data_ptr(), band.data_ptr(), out.data_ptr(), spec.n_fft,
            spec.hop_length, ops.n_lo, basis_c.shape[0], basis_c.shape[1], spec.n_mels,
            TORCH_FLOAT32_EPS, int(ops.fold), _build.stream_ptr(dev))
    _build.check(code, "log_mel_launch")
    log_mel_cuda.launches["folded" if ops.fold else "unfolded"] += 1
    return out


# launches of each instantiation of the kernel
log_mel_cuda.launches = {"folded": 0, "unfolded": 0}
