"""CUDA log-mel kernel (csrc/log_mel.cu), port of the Pallas kernel
ssl_audio_tpu/ops/mel_pallas.py log_mel_spectrogram_pallas: both its bodies,
_make_kernel_folded (fold) and _make_kernel (no fold), as two instantiations
of one templated kernel.

The kernel runs the DFT product on the tensor cores (mma.sync TF32) at fp32
accuracy: every operand is split into two TF32 parts, hi = rna(x) and
lo = rna(x - hi), and three part-products are summed in fp32 (see the
source's header).  This module makes the kernel's host operands: the DFT
basis rows inside the window's support, split and packed in the mma's
fragment order, the filterbank and its bands, and the geometry of the wav
segment a block stages.  Plain version: ops/mel.py log_mel_spectrogram_plain.
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
FCH = 128                      # frequency columns per chunk (n_pad is a multiple)
K_STEP = 8                     # basis rows per mma k-step and per slab (K_pad is a multiple)
STAGES = 3                     # basis slabs in flight
SLAB_FLOATS = (FCH // 8) * 2 * 32 * 4
P_STRIDE = FCH + 1
TILES = {96: 1, 64: 2}         # frames per block -> most blocks per SM it is built for
MEL_GROUPS = 4                 # threads per frame (a block has 4 * tile)
MAX_MELS = 128
SMEM_LIMIT = 232448            # bytes of shared memory one block may use
SM_SMEM = 233472               # bytes of shared memory per SM (1024 reserved per block)
MAX_GRID_Y = 65535             # clips per launch (the grid's y extent)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "log_mel_launch": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, ctypes.c_float, _I, _I, _P],
    "log_mel_occupancy": [_I, _I, _I, _I, _I, _I, _I, _P, _P]}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits), ties
    away from zero: what cvt.rna.tf32.f32 returns, the low 13 bits zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (hi, lo), both TF32 values: hi = rna(x), lo = rna(x - hi) (the
    difference is exact in float32), so x - hi - lo is within 2^-22 |x|."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def pack_fragments(parts: np.ndarray) -> np.ndarray:
    """(2 cos|sin, 2 hi|lo, K_pad, n_pad) -> (K_pad/8, n_pad/8, 2, 32, 4): per
    k-step, n-tile, cos|sin and lane (g = lane // 4, q = lane % 4) the
    mma.m16n8k8 B fragment (rows q and q + 4, column g) of the hi part, then
    of the lo part, so that one 16-byte load gives a lane both."""
    cs, hl, k_pad, n_pad = parts.shape
    p = parts.reshape(cs, hl, k_pad // 8, 2, 4, n_pad // 8, 8)  # (cs, hl, ks, kh, q, nt, g)
    p = p.transpose(2, 5, 0, 6, 4, 1, 3)                         # (ks, nt, cs, g, q, hl, kh)
    return np.ascontiguousarray(p.reshape(k_pad // 8, n_pad // 8, cs, 32, 4))


@dataclass(frozen=True)
class KernelOperands:
    """What the kernel reads besides the wav: the DFT basis rows inside the
    window's support [n_lo, n_lo + K), columns zero-padded to a multiple of
    FCH (basis_c, basis_s, fp32), the same rows zero-padded to K_pad, split
    into TF32 hi and lo parts and packed in fragment order (frag), the
    filterbank with matching zero rows, and each mel band's nonzero
    filterbank rows [lo, hi) (the kernel reads their weights packed,
    band_weights)."""

    fold: bool
    n_lo: int
    n_fft: int
    hop: int
    basis_c: np.ndarray        # (K, n_pad)
    basis_s: np.ndarray        # (K, n_pad)
    frag: np.ndarray           # (K_pad/8, n_pad/8, 2, 32, 4), see pack_fragments
    fb: np.ndarray             # (n_pad, n_mels)
    band: np.ndarray           # (2, n_mels) int32

    @functools.cached_property
    def band_weights(self) -> tuple[np.ndarray, np.ndarray]:
        """(weights, table): each band's nonzero filterbank rows packed band
        after band (float32), and a (3, n_mels) int32 table of rows lo, hi
        and each band's offset in the weights."""
        lo, hi = self.band
        offset = np.concatenate([[0], np.cumsum(hi - lo)[:-1]]).astype(np.int32)
        weights = np.concatenate([self.fb[a:b, m] for m, (a, b) in enumerate(self.band.T)])
        return (np.ascontiguousarray(weights, np.float32),
                np.ascontiguousarray(np.stack([lo, hi, offset]), np.int32))

    @property
    def k_pad(self) -> int:
        return self.frag.shape[0] * K_STEP

    @functools.cached_property
    def sample_span(self) -> tuple[int, int]:
        """(n_min, n_max): the first and last sample of a frame that the
        padded rows read, f[n] and, folded, f[(N - n) % N]."""
        n = self.n_lo + np.arange(self.k_pad)
        if self.fold:
            n = np.concatenate([n, (self.n_fft - n) % self.n_fft])
        return int(n.min()), int(n.max())

    @property
    def row_stride(self) -> int:
        """Words between rows of `hop` staged samples: 4 mod 32, so the 8
        frames x 4 columns of an A fragment fall in 32 distinct banks."""
        return self.hop + (4 - self.hop) % 32

    def seg_rows(self, tile: int) -> int:
        """Rows of the wav segment a block of `tile` frames stages."""
        n_min, n_max = self.sample_span
        return -(-((tile - 1) * self.hop + n_max - n_min + 1) // self.hop)

    def smem_bytes(self, tile: int) -> int:
        """Shared memory of one block: the basis slabs (the chunk's power
        reuses them), mel sums, the wav segment, the column tables and the
        packed filterbank bands."""
        n_mels = self.fb.shape[1]
        mpt = -(-n_mels // MEL_GROUPS)
        return 4 * (max(STAGES * SLAB_FLOATS, tile * P_STRIDE) + mpt * MEL_GROUPS * tile
                    + self.seg_rows(tile) * self.row_stride
                    + (2 if self.fold else 1) * self.k_pad
                    + 3 * n_mels + len(self.band_weights[0]))

    def blocks_per_sm(self, tile: int) -> int:
        """Blocks of `tile` frames that fit on an SM: its shared memory, capped
        by the launch bounds the tile is built for."""
        return min(TILES[tile], SM_SMEM // (self.smem_bytes(tile) + 1024))

    def tile_for(self, clips: int, frames: int, sms: int) -> int:
        """The tile whose launch takes the least SM time: waves of blocks over
        `sms` SMs, each wave as long as one SM's frames (the blocks on an SM
        share its tensor cores); the larger tile on a tie."""
        def cost(tile):
            per_sm = self.blocks_per_sm(tile)
            blocks = clips * -(-frames // tile)
            return -(-blocks // (sms * per_sm)) * tile * per_sm, -tile
        return min((t for t in TILES if self.smem_bytes(t) <= SMEM_LIMIT), key=cost)

    def dft_flops_per_frame(self) -> int:
        """The DFT product's floating-point operations per frame: re and im,
        2 per multiply-add over the support rows and the padded columns."""
        k, n_pad = self.basis_c.shape
        return 2 * 2 * k * n_pad

    def flops_per_frame(self) -> int:
        """All floating-point operations per frame: the DFT, the power and the
        mel product over the bands' filterbank rows."""
        n_pad = self.basis_c.shape[1]
        return (self.dft_flops_per_frame() + 3 * n_pad
                + 2 * int((self.band[1] - self.band[0]).sum()))


@functools.lru_cache(maxsize=None)
def kernel_operands(spec: MelSpec, fold: bool | None = None) -> KernelOperands:
    folded = _folded_bases(spec, fold)
    C, S = folded if folded is not None else spec.dft_matrices_mel
    rows = np.nonzero(np.abs(C).sum(axis=1) + np.abs(S).sum(axis=1))[0]
    lo, hi = int(rows.min()), int(rows.max()) + 1
    n_used = C.shape[1]
    n_pad = -(-n_used // FCH) * FCH
    k_pad = -(-(hi - lo) // K_STEP) * K_STEP
    basis = [np.pad(B[lo:hi], ((0, 0), (0, n_pad - n_used))) for B in (C, S)]
    parts = np.stack([np.stack([t.numpy() for t in tf32_split(torch.from_numpy(
        np.pad(B, ((0, k_pad - (hi - lo)), (0, 0)))))]) for B in basis])
    fb = spec.filterbank_mel
    band = np.zeros((2, fb.shape[1]), np.int32)
    for m in range(fb.shape[1]):
        nz = np.nonzero(fb[:, m])[0]
        if len(nz):
            band[:, m] = nz.min(), nz.max() + 1
    return KernelOperands(
        fold=folded is not None, n_lo=lo, n_fft=spec.n_fft, hop=spec.hop_length,
        basis_c=np.ascontiguousarray(basis[0]), basis_s=np.ascontiguousarray(basis[1]),
        frag=pack_fragments(parts),
        fb=np.ascontiguousarray(np.pad(fb, ((0, n_pad - n_used), (0, 0)))), band=band)


@functools.lru_cache(maxsize=16)
def _device_tables(spec: MelSpec, fold: bool | None, device: torch.device):
    ops = kernel_operands(spec, fold)
    return tuple(torch.from_numpy(a).to(device) for a in (ops.frag, *ops.band_weights))


def occupancy(spec: MelSpec, fold: bool | None, tile: int) -> dict:
    """The shared memory a block of the instantiation takes with `tile`
    frames, as the source computes it, and the blocks that fit on one SM of
    the current card."""
    ops = kernel_operands(spec, fold)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    lib = _build.load("log_mel.cu", _SIGNATURES)
    _build.check(lib.log_mel_occupancy(int(ops.fold), tile, ops.seg_rows(tile),
                                       ops.row_stride, ops.k_pad, ops.fb.shape[1],
                                       len(ops.band_weights[0]), ctypes.byref(smem),
                                       ctypes.byref(blocks)), "log_mel_occupancy")
    return {"tile": tile, "smem_bytes": smem.value, "blocks_per_sm": blocks.value}


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def log_mel_cuda(wav: torch.Tensor, spec: MelSpec, fold: bool | None = None,
                 starts: torch.Tensor | None = None,
                 out_frames: int | None = None, *, tile: int | None = None) -> torch.Tensor:
    """(B, L) float32 CUDA tensor -> (B, n_mels, T) log-mel through the CUDA
    kernel.  fold: None = the folded instantiation whenever the window
    admits it, False = the unfolded one, True = require the fold.

    starts (B,) int32 on the device with out_frames: the cropped log-mel,
    output frame t of clip b = frame starts[b] + t of the whole clip's
    log-mel (a frame index outside the clip is clamped to it).  The kernel
    reads the starts itself; nothing is fetched to the host.  tile (frames
    per block, a key of TILES) is chosen for the launch unless given."""
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
    T_full = spec.num_frames(L)
    if (starts is None) != (out_frames is None):
        raise ValueError("starts and out_frames come together")
    if starts is None:
        T = T_full
    else:
        T = int(out_frames)
        if starts.device != dev or starts.dtype != torch.int32 \
                or tuple(starts.shape) != (B,) or not starts.is_contiguous():
            raise ValueError(f"starts: want contiguous int32 ({B},) on {dev}, got "
                             f"{starts.dtype} {tuple(starts.shape)} on {starts.device}")
        if not 0 < T <= T_full:
            raise ValueError(f"out_frames {T} outside 1..{T_full}")
    if tile is None:
        tile = ops.tile_for(B, T, _sm_count(dev))
    if spec.n_mels > MAX_MELS or spec.hop_length < K_STEP or tile not in TILES \
            or ops.smem_bytes(tile) > SMEM_LIMIT:
        raise ValueError(f"{spec} is outside the kernel's limits (n_mels <= {MAX_MELS}, "
                         f"hop >= {K_STEP}, tile in {tuple(TILES)}, "
                         f"{ops.smem_bytes(tile)} B of shared memory <= {SMEM_LIMIT})")
    out = torch.empty(B, spec.n_mels, T, device=dev)
    if B == 0:
        return out
    frag, fbw, band = _device_tables(spec, fold, dev)
    lib = _build.load("log_mel.cu", _SIGNATURES)
    with torch.cuda.device(dev):
        code = lib.log_mel_launch(
            wav.data_ptr(), B, L, T, T_full,
            None if starts is None else starts.data_ptr(),
            frag.data_ptr(), fbw.data_ptr(), band.data_ptr(), out.data_ptr(), spec.n_fft,
            spec.hop_length, ops.n_lo, ops.sample_span[0], ops.k_pad, ops.fb.shape[0],
            spec.n_mels, fbw.shape[0], ops.seg_rows(tile), ops.row_stride,
            TORCH_FLOAT32_EPS, int(ops.fold), tile, _build.stream_ptr(dev))
    _build.check(code, "log_mel_launch")
    log_mel_cuda.launches["folded" if ops.fold else "unfolded"] += 1
    return out


# launches of each instantiation of the kernel
log_mel_cuda.launches = {"folded": 0, "unfolded": 0}
