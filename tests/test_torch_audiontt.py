"""The port's AudioNTT2022 (ssl_audio_tpu_torch/models/audiontt.py) in eval
mode against the JAX module at full width (64 mels, d = 3072), with the
JAX-initialised weights carried over by audiontt_state_dict_from_jax and
loaded strict.  BatchNorm statistics and scales are perturbed (negative and
zero scales included) so the sign-aware fused block is exercised."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.models.audiontt import AudioNTT2022 as JaxAudioNTT2022
from ssl_audio_tpu.utils.torch_export import export_audiontt_state_dict
from ssl_audio_tpu_torch.models.audiontt import AudioNTT2022
from ssl_audio_tpu_torch.utils.weights import audiontt_state_dict_from_jax

# embeddings / max|embedding|: fp32 convolutions and 1024-2048-wide matrix
# products summed in different orders by XLA and PyTorch's CPU kernels
EMB_RTOL = 1e-5


def perturbed_variables(seed=1):
    """JAX init variables (key 0) with non-trivial BatchNorm parameters and
    running statistics, as numpy arrays."""
    x = jnp.zeros((1, 1, 64, 96))
    v = jax.tree.map(np.array, JaxAudioNTT2022().init(
        {"params": jax.random.key(0)}, x, train=False))
    rng = np.random.default_rng(seed)
    for i in range(2):
        bn = v["params"]["encoder"][f"BatchNorm_{i}"]
        st = v["batch_stats"]["encoder"][f"BatchNorm_{i}"]
        bn["scale"] = (1.0 + 0.3 * rng.standard_normal(64)).astype(np.float32)
        bn["scale"][:16] *= -1.0
        bn["scale"][32] = 0.0
        bn["bias"] = (0.2 * rng.standard_normal(64)).astype(np.float32)
        st["mean"] = (0.5 * rng.standard_normal(64)).astype(np.float32)
        st["var"] = (0.5 + rng.random(64)).astype(np.float32)
    return v


@pytest.fixture(scope="module")
def variables():
    return perturbed_variables()


def port_model(variables, fused_conv):
    m = AudioNTT2022(fused_conv=fused_conv)
    m.load_state_dict(audiontt_state_dict_from_jax(variables), strict=True)
    return m.eval()


def test_state_dict_matches_reference_export(variables):
    """The conversion equals torch_export's reference-layout state dict,
    which loads strict into the port module."""
    ours = audiontt_state_dict_from_jax(variables)
    ref = export_audiontt_state_dict(variables)
    assert ours.keys() == ref.keys() == AudioNTT2022().state_dict().keys()
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    AudioNTT2022().load_state_dict(ref, strict=True)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("T", [96, 95])
def test_eval_forward_matches_jax(variables, rng, fused, T):
    """fused_conv routes block 1 through the fused block when H and W are
    even; odd T (95) takes the plain block in both packages."""
    x = rng.standard_normal((2, 1, 64, T)).astype(np.float32)
    ref = np.asarray(JaxAudioNTT2022(fused_conv_eval=fused).apply(
        variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        out = port_model(variables, fused)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 3072)
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=EMB_RTOL * float(np.abs(ref).max()))


def test_fused_block_is_taken_only_for_even_shapes(variables, monkeypatch):
    import ssl_audio_tpu_torch.models.audiontt as audiontt

    calls = []
    real = audiontt.fused_conv1_bn_relu_pool_eval
    monkeypatch.setattr(audiontt, "fused_conv1_bn_relu_pool_eval",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    m = port_model(variables, True)
    with torch.no_grad():
        m(torch.zeros(1, 1, 64, 96))
        assert len(calls) == 1
        m(torch.zeros(1, 1, 64, 1001))           # a 10-s scene clip
        assert len(calls) == 1


def test_train_mode_not_ported():
    with pytest.raises(NotImplementedError):
        AudioNTT2022().train()(torch.zeros(1, 1, 64, 96))
