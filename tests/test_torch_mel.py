"""The port's log-mel frontend (ssl_audio_tpu_torch/ops/mel.py) against the
JAX package's (ssl_audio_tpu/ops/mel.py and the Pallas kernel of
ops/mel_pallas.py, in interpret mode here), on the same numpy inputs.

The CUDA kernel runs only on the card: here its host-side operands are
checked by emulating the kernel's arithmetic from them on the CPU; the
kernel itself is compared with the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.ops import mel as jmel
from ssl_audio_tpu.ops.mel_pallas import log_mel_spectrogram_pallas
from ssl_audio_tpu_torch.ops import mel as tmel
from ssl_audio_tpu_torch.ops.mel_kernel import FCH, kernel_operands
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

HEAR = dict(win_length=400)        # hear/config.yaml frontend
TRAIN = dict(win_length=1024)      # the training frontend (MelSpec defaults)
SPECS = [pytest.param(HEAR, id="hear"), pytest.param(TRAIN, id="train")]

# plain log-mel vs JAX: both fp32 matrix products over the same tables, the
# sums taken in different orders; 1e-4 is the port's fp32 contract
LOG_MEL_ATOL = 1e-4


def _wav(rng, shape, scale=0.3):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("kw", SPECS)
def test_tables_equal_jax(kw):
    j, t = jmel.MelSpec(**kw), tmel.MelSpec(**kw)
    np.testing.assert_array_equal(t.window, j.window)
    for a, b in zip(t.dft_matrices, j.dft_matrices):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.dft_matrices_folded, j.dft_matrices_folded):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.dft_matrices_mel_folded, j.dft_matrices_mel_folded):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.filterbank, j.filterbank)
    np.testing.assert_array_equal(t.filterbank_mel, j.filterbank_mel)
    assert t.n_freqs_used == j.n_freqs_used == 512
    assert t.num_frames(15200) == j.num_frames(15200) == 96


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("fold", [None, False])
@pytest.mark.parametrize("length", [15200, 4801])
def test_plain_log_mel_matches_jax(rng, kw, fold, length):
    wav = _wav(rng, (3, length))
    ref = np.asarray(jmel.log_mel_spectrogram(jnp.asarray(wav), jmel.MelSpec(**kw)))
    out = tmel.log_mel_spectrogram(torch.from_numpy(wav), tmel.MelSpec(**kw),
                                   fold=fold).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=LOG_MEL_ATOL, rtol=0)


def test_plain_log_mel_matches_pallas_kernel(rng):
    """Against the Pallas kernel, both bodies, in interpret mode as
    tests/test_mel.py runs it."""
    wav = _wav(rng, (2, 4800))
    spec = tmel.MelSpec(**HEAR)
    out = tmel.log_mel_spectrogram_plain(torch.from_numpy(wav), spec).numpy()
    for fold in (True, False):
        ref = np.asarray(log_mel_spectrogram_pallas(
            jnp.asarray(wav), jmel.MelSpec(**HEAR), fold=fold))
        np.testing.assert_allclose(out, ref, atol=LOG_MEL_ATOL, rtol=0)


def test_leading_dims_fast_and_silence(rng):
    """(..., L) inputs, fast=True is the same exact result, and silence is
    exactly log(float32 eps)."""
    spec = tmel.MelSpec(**HEAR)
    wav = torch.from_numpy(_wav(rng, (2, 3, 4000)))
    out = tmel.log_mel_spectrogram(wav, spec)
    assert out.shape == (2, 3, 64, spec.num_frames(4000))
    torch.testing.assert_close(out[1, 2], tmel.log_mel_spectrogram(wav[1, 2:3], spec)[0],
                               rtol=0, atol=0)
    assert torch.equal(tmel.log_mel_spectrogram(wav, spec, fast=True), out)
    silent = tmel.log_mel_spectrogram(torch.zeros(1, 4000), spec)
    assert torch.all(silent == np.float32(np.log(np.float32(tmel.TORCH_FLOAT32_EPS))))


def test_fold_validation():
    spec = tmel.MelSpec(n_fft=1023, win_length=400)      # odd n_fft: no fold
    assert spec.dft_matrices_folded is None
    with pytest.raises(ValueError):
        tmel.log_mel_spectrogram(torch.zeros(1, 4000), spec, fold=True)
    with pytest.raises(ValueError):
        kernel_operands(spec, True)
    assert not kernel_operands(spec).fold


def _emulate_kernel(wav: np.ndarray, spec, fold):
    """The CUDA kernel's arithmetic in float64 numpy, from exactly the
    operands the wrapper hands it: the support rows [n_lo, n_lo + K), the
    per-sample reflect index, the zero-padded columns and filterbank."""
    ops = kernel_operands(spec, fold)
    B, L = wav.shape
    T, N, pad = spec.num_frames(L), spec.n_fft, spec.n_fft // 2
    K = ops.basis_c.shape[0]

    def sample(p):
        i = np.abs(p - pad)
        return wav[:, np.where(i >= L, 2 * (L - 1) - i, i)]

    s = np.arange(T)[:, None] * spec.hop_length
    n = ops.n_lo + np.arange(K)[None, :]
    f = sample(s + n)
    if ops.fold:
        r = sample(s + (N - n) % N)
        a, b = f + r, f - r
    else:
        a = b = f
    re = a @ ops.basis_c.astype(np.float64)
    im = b @ ops.basis_s.astype(np.float64)
    power = re * re + im * im
    mel = np.stack([power[..., lo:hi] @ ops.fb[lo:hi, m].astype(np.float64)
                    for m, (lo, hi) in enumerate(ops.band.T)], axis=-1)
    return np.log(mel + tmel.TORCH_FLOAT32_EPS).transpose(0, 2, 1)


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("fold", [None, False])
def test_kernel_operands(rng, kw, fold):
    spec = tmel.MelSpec(**kw)
    ops = kernel_operands(spec, fold)
    # HEAR: the 400-sample window sits at rows 312..711 of 1024 and its first
    # sample is 0, so rows 313..711 are nonzero; folded, rows 313..512
    expect = {("hear", True): (313, 200), ("hear", False): (313, 399),
              ("train", True): (1, 512), ("train", False): (1, 1023)}
    key = ("hear" if kw == HEAR else "train", fold is None)
    assert (ops.n_lo, ops.basis_c.shape[0]) == expect[key]
    assert ops.basis_c.shape[1] % FCH == 0 and ops.fb.shape[0] == ops.basis_c.shape[1]
    # every nonzero filterbank entry lies inside its mel's band
    rows = np.arange(ops.fb.shape[0])[:, None]
    inside = (rows >= ops.band[0]) & (rows < ops.band[1])
    assert not ops.fb[~inside].any() and (ops.band[1] > ops.band[0]).all()
    wav = _wav(rng, (2, 4001))
    ref = tmel.log_mel_spectrogram_plain(torch.from_numpy(wav), spec).numpy()
    np.testing.assert_allclose(_emulate_kernel(wav, spec, fold), ref,
                               atol=LOG_MEL_ATOL, rtol=0)


def test_kernel_operands_pad_columns(rng):
    """A spec whose used columns are not a multiple of the kernel's 128-column
    chunk (f_max at Nyquist: 513 columns) is padded with zero columns and
    zero filterbank rows."""
    spec = tmel.MelSpec(win_length=400, f_max=8000.0)
    ops = kernel_operands(spec)
    assert FCH == 128
    assert spec.n_freqs_used == 513 and ops.basis_c.shape[1] == 640
    assert not ops.basis_c[:, 513:].any() and not ops.fb[513:].any()
    wav = _wav(rng, (1, 3000))
    ref = tmel.log_mel_spectrogram_plain(torch.from_numpy(wav), spec).numpy()
    np.testing.assert_allclose(_emulate_kernel(wav, spec, None), ref,
                               atol=LOG_MEL_ATOL, rtol=0)


def test_cpu_tensor_takes_plain_path(rng):
    from ssl_audio_tpu_torch.ops.mel_kernel import log_mel_cuda

    before = dict(log_mel_cuda.launches)
    wav = torch.from_numpy(_wav(rng, (1, 4000)))
    spec = tmel.MelSpec(**HEAR)
    torch.testing.assert_close(tmel.log_mel_spectrogram(wav, spec),
                               tmel.log_mel_spectrogram_plain(wav, spec),
                               rtol=0, atol=0)
    assert log_mel_cuda.launches == before
    with pytest.raises(ValueError):
        log_mel_cuda(wav, spec)              # the kernel wrapper never runs on the CPU


# --- the cropped log-mel and the training frontend ---------------------------------

@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("which", ["first", "last", "mixed"])
def test_cropped_plain_matches_jax_cropped(rng, kw, which):
    """Crop starts at frame 0, at the last valid frame, and mixed; every
    output frame also equals the same frame of the whole clip's log-mel."""
    B, L, frames = 4, 16000, 32
    wav = _wav(rng, (B, L))
    spec = tmel.MelSpec(**kw)
    last = spec.num_frames(L) - frames
    starts = {"first": np.zeros(B), "last": np.full(B, last),
              "mixed": np.array([0, last, 17, last // 2])}[which].astype(np.int32)
    ref = np.asarray(jmel.log_mel_spectrogram_cropped(
        jnp.asarray(wav), jmel.MelSpec(**kw), jnp.asarray(starts), frames))
    out = tmel.log_mel_spectrogram_cropped(torch.from_numpy(wav), spec,
                                           torch.from_numpy(starts), frames)
    assert out.shape == ref.shape == (B, 64, frames)
    np.testing.assert_allclose(out.numpy(), ref, atol=LOG_MEL_ATOL, rtol=0)
    full = tmel.log_mel_spectrogram_plain(torch.from_numpy(wav), spec)
    for b in range(B):
        np.testing.assert_allclose(out[b].numpy(),
                                   full[b, :, starts[b]:starts[b] + frames].numpy(),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("fold", [None, False])
def test_cropped_plain_both_instantiations_and_clamped_starts(rng, fold):
    wav = torch.from_numpy(_wav(rng, (2, 8000)))
    spec = tmel.MelSpec()
    full = tmel.log_mel_spectrogram_plain(wav, spec, fold=fold)
    out = tmel.log_mel_spectrogram_cropped_plain(wav, spec, fold,
                                                 torch.tensor([5, 49]), 8)
    np.testing.assert_allclose(out[0].numpy(), full[0, :, 5:13].numpy(), atol=1e-5)
    # 51 frames: start 49 runs past the clip; frames past the end repeat the last
    np.testing.assert_allclose(out[1, :, :2].numpy(), full[1, :, 49:51].numpy(), atol=1e-5)
    np.testing.assert_allclose(out[1, :, 2:].numpy(),
                               full[1, :, 50:51].expand(-1, 6).numpy(), atol=1e-5)


@pytest.mark.parametrize("length,crop", [(16000, 32), (4000, 32)])
def test_device_frontend_matches_jax_with_injected_starts(rng, length, crop):
    """make_device_frontend with the starts JAX drew from its key: a 1-s clip
    (101 frames) cropped to 32, and a clip of 26 frames, shorter than
    crop_frames: zero-padded in the log domain, then normalised."""
    import jax

    from ssl_audio_tpu.config import default_config as jax_config
    from ssl_audio_tpu.train.steps import make_device_frontend as jax_frontend
    from ssl_audio_tpu_torch.config import default_config
    from ssl_audio_tpu_torch.train.steps import crop_start_bound, make_device_frontend

    kw = dict(dataset="synthetic_wav", crop_frames=crop)
    stats = (-4.95, 5.855)
    wav = _wav(rng, (3, length))
    key = jax.random.key(11)
    ref = np.asarray(jax_frontend(jax_config(**kw), stats)(key, jnp.asarray(wav)))
    hi = crop_start_bound(default_config(**kw), length)
    n_frames = 1 + length // 160
    assert hi == max(n_frames - crop + 1, 1)          # inclusive upper start
    starts = torch.from_numpy(np.array(jax.random.randint(key, (3,), 0, hi)))
    out = make_device_frontend(default_config(**kw), stats)(torch.from_numpy(wav), starts)
    assert out.shape == ref.shape == (3, 1, 64, crop)
    np.testing.assert_allclose(out.numpy(), ref, atol=LOG_MEL_ATOL, rtol=0)
    if n_frames < crop:
        torch.testing.assert_close(out[..., n_frames:],
                                   torch.full((3, 1, 64, crop - n_frames), -stats[0] / stats[1]))


def test_cuda_wrapper_rejects_cpu_tensors_and_bad_starts():
    from ssl_audio_tpu_torch.ops.mel_kernel import log_mel_cuda

    with pytest.raises(ValueError):
        log_mel_cuda(torch.zeros(2, 8000), tmel.MelSpec(), None,
                     torch.zeros(2, dtype=torch.int32), 8)
