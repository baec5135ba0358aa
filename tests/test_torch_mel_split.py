"""The log-mel kernel's TF32 split (ssl_audio_tpu_torch/ops/mel_kernel.py,
csrc/log_mel.cu) on the CPU: the host's hi/lo basis tables and their packing
in mma fragment order, and the kernel's three-pass product emulated from
exactly those tables against the JAX package's plain log-mel
(ssl_audio_tpu/ops/mel.py) and a float64 witness.

The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.ops import mel as jmel
from ssl_audio_tpu_torch.ops import mel as tmel
from ssl_audio_tpu_torch.ops.mel_kernel import (
    FCH,
    K_STEP,
    SM_SMEM,
    TILES,
    kernel_operands,
    pack_fragments,
    tf32_round,
    tf32_split,
)
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

SPECS = [pytest.param(dict(win_length=400), id="hear"),
         pytest.param(dict(win_length=1024), id="train")]
FOLDS = [pytest.param(None, id="folded"), pytest.param(False, id="unfolded")]

# log-mel against the JAX fp32 plain path where the input is well conditioned:
# the port's fp32 contract
LOG_MEL_ATOL = 1e-4
# the split's error against the exact product, per element, relative: rna to
# 11 significant bits twice leaves at most 2^-22; 2^-21 is the stated limit
SPLIT_RTOL = 2.0 ** -21


def unpack_fragments(frag: np.ndarray) -> np.ndarray:
    """pack_fragments' inverse: (K_pad/8, n_pad/8, 2, 32, 4) -> (2 cos|sin,
    2 hi|lo, K_pad, n_pad)."""
    n_ks, n_nt, cs = frag.shape[:3]
    p = frag.reshape(n_ks, n_nt, cs, 8, 4, 2, 2).transpose(2, 5, 0, 6, 4, 1, 3)
    return np.ascontiguousarray(p.reshape(cs, 2, n_ks * 8, n_nt * 8))


def _low_bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32) & 0x1FFF


def test_tf32_round_is_rna():
    """Round to nearest on the 10-bit mantissa, ties away from zero, both
    signs; the low 13 bits come out zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23,
                      1 + 1.5 * ulp, 3.0 * 2.0 ** -100, 0.0], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0 * 2.0 ** -100, 0.0])
    got = tf32_round(x)
    assert torch.equal(got, want)
    assert not _low_bits(got).any()
    hi, lo = tf32_split(x)
    assert torch.equal(hi, got) and not _low_bits(lo).any()
    keep = [0, 1, 3, 4, 5]                    # at most 22 significant bits: hi + lo is exact
    assert torch.equal((hi + lo)[keep], x[keep])


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("fold", FOLDS)
def test_basis_split_tables(kw, fold):
    """hi and lo are TF32 values, hi + lo is within 2^-21 of the fp32 basis
    (relative), the K padding rows are zero, and the packed fragments unpack
    to the same tables."""
    ops = kernel_operands(tmel.MelSpec(**kw), fold)
    K, n_pad = ops.basis_c.shape
    assert ops.k_pad % K_STEP == 0 and 0 <= ops.k_pad - K < K_STEP and n_pad % FCH == 0
    parts = unpack_fragments(ops.frag)
    assert parts.shape == (2, 2, ops.k_pad, n_pad)
    assert np.array_equal(pack_fragments(parts), ops.frag)
    t = torch.from_numpy(parts)
    assert not _low_bits(t).any()
    assert not parts[:, :, K:].any()
    for cs, basis in enumerate((ops.basis_c, ops.basis_s)):
        hi, lo = parts[cs, 0, :K].astype(np.float64), parts[cs, 1, :K].astype(np.float64)
        err = np.abs(hi + lo - basis.astype(np.float64))
        assert (err <= SPLIT_RTOL * np.abs(basis)).all()
        assert np.array_equal(hi, tf32_round(torch.from_numpy(basis)).numpy())
    # fragment order: lane (g, q) of (k-step, n-tile) holds rows q, q + 4 of column g
    ks, nt, lane = ops.k_pad // 8 - 1, n_pad // 8 - 3, 13
    g, q = lane // 4, lane % 4
    np.testing.assert_array_equal(ops.frag[ks, nt, 1, lane], [
        parts[1, 0, ks * 8 + q, nt * 8 + g], parts[1, 0, ks * 8 + q + 4, nt * 8 + g],
        parts[1, 1, ks * 8 + q, nt * 8 + g], parts[1, 1, ks * 8 + q + 4, nt * 8 + g]])


def emulate_three_pass(wav: np.ndarray, spec, fold) -> np.ndarray:
    """The kernel's arithmetic from the operands the wrapper hands it: frames
    from the reflect index over the padded support rows, e and o summed in
    float32, both operands split into TF32 hi and lo, and hi*hi + hi*lo +
    lo*hi.  Each part-product is exact in float64; the sums are taken in
    float64 (the tensor cores sum in fp32, an error of the fp32 plain
    version's size that this leaves out)."""
    ops = kernel_operands(spec, fold)
    B, L = wav.shape
    T, N, pad = spec.num_frames(L), spec.n_fft, spec.n_fft // 2

    def sample(p):
        i = np.abs(p - pad)
        return wav[:, np.clip(np.where(i >= L, 2 * (L - 1) - i, i), 0, L - 1)]

    s = np.arange(T)[:, None] * spec.hop_length
    n = ops.n_lo + np.arange(ops.k_pad)[None, :]
    f = sample(s + n)
    if ops.fold:
        r = sample(s + (N - n) % N)
        a, b = f + r, f - r                     # float32, as in the kernel
    else:
        a = b = f
    parts = unpack_fragments(ops.frag).astype(np.float64)

    def product(x, cs):
        xh, xl = (p.numpy().astype(np.float64) for p in tf32_split(torch.from_numpy(x)))
        wh, wl = parts[cs]
        return xh @ wl + xl @ wh + xh @ wh

    re, im = product(a, 0), product(b, 1)
    power = re * re + im * im
    mel = np.stack([power[..., lo:hi] @ ops.fb[lo:hi, m].astype(np.float64)
                    for m, (lo, hi) in enumerate(ops.band.T)], axis=-1)
    return np.log(mel + tmel.TORCH_FLOAT32_EPS).transpose(0, 2, 1)


def _tone_then_quiet(rng, B, L):
    """0.3 tones over the first half, then a stretch of noise at 1e-4."""
    t = np.arange(L) / 16000
    wav = 0.3 * np.sin(2 * np.pi * (200 + 3000 * rng.random((B, 1))) * t)
    wav[:, L // 2:] = 1e-4 * rng.standard_normal((B, L - L // 2))
    return wav.astype(np.float32)


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("fold", FOLDS)
def test_three_pass_product_matches_jax(rng, kw, fold):
    """The emulated three-pass log-mel against the JAX plain path: within
    1e-4 on ordinary clips and on every frame of the quiet stretch.  The tone
    frames' bins near the eps floor are ill-conditioned for any fp32 product
    (the fp32 plain version itself is ~1e-3 from float64 there), so on all
    frames the three passes are held to the acceptance rule of the card,
    max(1e-4, 4 x the fp32 plain version's error) against float64."""
    spec, jspec = tmel.MelSpec(**kw), jmel.MelSpec(**kw)
    L = 8000
    noisy = (0.3 * rng.standard_normal((2, L))).astype(np.float32)
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(noisy), jspec))
    np.testing.assert_allclose(emulate_three_pass(noisy, spec, fold), ref,
                               atol=LOG_MEL_ATOL, rtol=0)

    wav = _tone_then_quiet(rng, 3, L)
    got = emulate_three_pass(wav, spec, fold)
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wav), jspec))
    quiet = -(-(L // 2 + spec.n_fft // 2) // spec.hop_length)   # first all-quiet frame
    np.testing.assert_allclose(got[..., quiet:], ref[..., quiet:], atol=LOG_MEL_ATOL, rtol=0)
    exact = tmel.log_mel_spectrogram_plain(torch.from_numpy(wav).double(), spec,
                                           fold=fold).numpy()
    fp32 = tmel.log_mel_spectrogram_plain(torch.from_numpy(wav), spec, fold=fold).numpy()
    plain_err = np.abs(fp32 - exact).max()
    assert np.abs(got - exact).max() <= max(LOG_MEL_ATOL, 4 * plain_err)


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("fold", FOLDS)
def test_staged_segment_geometry(kw, fold):
    """The segment a block stages holds every sample its frames read: frame
    R of the tile reads segment sample R*hop + n - n_min, stored at row
    R + (n - n_min) // hop, column (n - n_min) % hop, inside seg_rows rows;
    rows are 4 words apart mod 32 (8 frames x 4 columns of an A fragment in
    32 banks); the packed band weights the mel product reads are the
    filterbank's nonzero rows; a launch takes the tile with the least SM
    time (96 frames for the paths' T = 96, 64 for a scene request's 16
    clips of 1001 frames, two blocks of 64 on an SM at the HEAR spec)."""
    spec = tmel.MelSpec(**kw)
    ops = kernel_operands(spec, fold)
    n = ops.n_lo + np.arange(ops.k_pad)
    cols = [n] + ([np.where(n == 0, 0, spec.n_fft - n)] if ops.fold else [])
    n_min, n_max = ops.sample_span
    assert ops.row_stride % 32 == 4 and ops.row_stride >= spec.hop_length
    for tile in TILES:
        R = np.arange(tile)[:, None]
        for c in cols:
            x = c[None, :] - n_min
            assert (x >= 0).all() and (c <= n_max).all()
            row, col = R + x // spec.hop_length, x % spec.hop_length
            assert (row < ops.seg_rows(tile)).all()
            assert np.array_equal(row * spec.hop_length + col, R * spec.hop_length + x)
        assert ops.blocks_per_sm(tile) >= 1
    if spec.win_length == 400:
        assert 2 * (ops.smem_bytes(64) + 1024) <= SM_SMEM and ops.blocks_per_sm(64) == 2
    assert ops.tile_for(512, 96, 132) == 96 and ops.tile_for(128, 96, 132) == 96
    assert ops.tile_for(16, 1001, 132) == 64
    weights, table = ops.band_weights
    for m, (lo, hi, offset) in enumerate(table.T):
        np.testing.assert_array_equal(weights[offset:offset + hi - lo], ops.fb[lo:hi, m])
