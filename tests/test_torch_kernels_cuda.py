"""The port's CUDA kernels against their plain PyTorch versions on the card,
and the card path of the model and the HEAR API against the CPU path.

Every test here needs a CUDA device and nvcc and skips without them.  The
file imports nothing of JAX, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from ssl_audio_tpu_torch.ops.fused_conv import (
    fused_conv1_bn_relu_pool_eval,
    fused_conv1_fwd_cuda,
    fused_conv1_fwd_plain,
)
from ssl_audio_tpu_torch.ops.mel import MelSpec, log_mel_spectrogram_plain
from ssl_audio_tpu_torch.ops.mel_kernel import kernel_operands, log_mel_cuda

pytestmark = pytest.mark.cuda

# the tolerances of chip_smoke.py, with their reasons
MEL_ATOL = 1e-4      # fp32 DFT sums in another order than cuBLAS
CONV_ATOL = 1e-4     # cuDNN's fp32 conv algorithm rounds otherwise
STATS_RTOL = 1e-4    # fp32 sums over the batch in another order
EMB_RTOL = 1e-3      # embeddings / max|embedding|, card vs CPU


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) for the port's kernels")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _wav(rng, shape):
    return torch.from_numpy((0.3 * rng.standard_normal(shape)).astype(np.float32))


@pytest.mark.parametrize("win", [400, 1024])
@pytest.mark.parametrize("fold", [None, False])
@pytest.mark.parametrize("length", [15200, 4801])
def test_log_mel_kernel_matches_plain(dev, rng, win, fold, length):
    spec = MelSpec(win_length=win)
    wav = _wav(rng, (64, length)).to(dev)
    before = dict(log_mel_cuda.launches)
    out = log_mel_cuda(wav, spec, fold=fold)
    ref = log_mel_spectrogram_plain(wav, spec, fold=fold)
    torch.cuda.synchronize()
    took = "folded" if kernel_operands(spec, fold).fold else "unfolded"
    assert log_mel_cuda.launches == {**before, took: before[took] + 1}
    torch.testing.assert_close(out, ref, atol=MEL_ATOL, rtol=0)


def _conv_inputs(rng, B, H, W, C=64):
    x = np.round(rng.standard_normal((B, H, W)) * 2) / 2        # window ties
    wk = 0.3 * rng.standard_normal((9, C))
    bias = 0.1 * rng.standard_normal(C)
    gamma = 1.0 + 0.3 * rng.standard_normal(C)
    gamma[: C // 4] *= -1.0
    gamma[C // 2] = 0.0
    beta = 0.2 * rng.standard_normal(C)
    mean = 0.5 * rng.standard_normal(C)
    var = 0.5 + rng.random(C)
    return [torch.from_numpy(a.astype(np.float32)) for a in
            (x, wk, bias, gamma, beta, mean, var)]


@pytest.mark.parametrize("shape", [(64, 64, 96), (3, 18, 38)])
def test_fused_conv_kernel_matches_plain(dev, rng, shape):
    """sel, s1, s2 and the eval output; (3, 18, 38) leaves partial tiles."""
    x, wk, b, g, be, mean, var = (t.to(dev) for t in _conv_inputs(rng, *shape))
    sel, s1, s2 = fused_conv1_fwd_cuda(x, wk, b, g)
    sel_p, s1_p, s2_p = fused_conv1_fwd_plain(x, wk, b, g)
    out = fused_conv1_bn_relu_pool_eval(x[..., None], wk.reshape(3, 3, 1, -1),
                                        b, g, be, mean, var)
    torch.cuda.synchronize()
    torch.testing.assert_close(sel, sel_p, atol=CONV_ATOL, rtol=0)
    for a, p in ((s1, s1_p), (s2, s2_p)):
        assert float((a - p).abs().max()) <= STATS_RTOL * float(p.abs().max())
    ref = torch.relu(g * (sel_p - mean) * torch.rsqrt(var + 1e-5) + be)
    torch.testing.assert_close(out, ref, atol=CONV_ATOL, rtol=0)


def test_hear_api_card_matches_cpu(dev, rng):
    """Timestamp (fused block 1 and both kernels) and scene (T odd: plain
    block 1) embeddings on the card against the same model on the CPU."""
    from ssl_audio_tpu_torch.hear import conv

    card = conv.load_model("", "audiontt", fused_conv=True)
    cpu = conv.load_model("", "audiontt", fused_conv=True, device="cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    audio = _wav(rng, (2, 24000))
    launches = (log_mel_cuda.launches["folded"], fused_conv1_fwd_cuda.launches)
    for fn in (lambda m: conv.get_timestamp_embeddings(audio, m)[0],
               lambda m: conv.get_scene_embeddings(audio, m)):
        a, b = fn(card), fn(cpu)
        assert a.shape == b.shape and a.device.type == "cpu"
        assert float((a - b).abs().max()) <= EMB_RTOL * float(b.abs().max())
    assert log_mel_cuda.launches["folded"] > launches[0]
    assert fused_conv1_fwd_cuda.launches > launches[1]
