"""The port's AudioNTT2022 (ssl_audio_tpu_torch/models/audiontt.py) against
the JAX module at full width (64 mels, d = 3072), with the JAX-initialised
weights carried over by audiontt_state_dict_from_jax and loaded strict:
eval mode, and train mode (forward, parameter gradients, running statistics
after one call).  BatchNorm statistics and scales are perturbed (negative
and zero scales included) so the sign-aware fused block is exercised."""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.models.audiontt import AudioNTT2022 as JaxAudioNTT2022
from ssl_audio_tpu.utils.torch_export import export_audiontt_state_dict
from ssl_audio_tpu_torch.models.audiontt import AudioNTT2022
from ssl_audio_tpu_torch.utils.weights import audiontt_state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for the module's tests and fixtures
    (tests/test_torch_checkpoint.py says why: under the suite's six workers a
    pool of threads per worker made this file's tests tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """Train mode itself is ported (it raised NotImplementedError before), SE
    blocks too; what still raises in build_encoder is an encoder option that
    is not: the ViT's --layout_barrier, an XLA layout option."""
    from ssl_audio_tpu_torch.config import default_config
    from ssl_audio_tpu_torch.train.state import build_encoder

    out = AudioNTT2022().train()(torch.zeros(2, 1, 64, 96))
    assert out.shape == (2, 3072) and out.requires_grad
    enc, _ = build_encoder(default_config(dataset="synthetic", squeeze_excitation=True))
    assert enc.squeeze_excitation
    with pytest.raises(NotImplementedError):
        build_encoder(default_config(dataset="synthetic", model_type="vit_base",
                                     layout_barrier=True))


@pytest.mark.parametrize("fused_and_reorder", [True, False])
def test_train_forward_grads_and_running_stats_match_jax(variables, rng, monkeypatch,
                                                         fused_and_reorder):
    """One train-mode call: output, every parameter gradient, and the
    running statistics (biased batch variance, momentum 0.9).  Dropout is
    taken out on both sides: flax.linen.Dropout is patched to the identity
    for this test, and the port gets an all-ones keep mask scaled back by
    (1 - rate), so both compute the same function.  The zero BN scale is
    made nonzero when the plain composition runs: there the pool ties on z
    and routes to the first element in both packages, while the fused and
    reordered blocks route to the min of y in both."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)
    x = np.round(rng.standard_normal((3, 1, 64, 32)) * 2).astype(np.float32) / 2
    dout = rng.standard_normal((3, 3072)).astype(np.float32)
    jmodel = JaxAudioNTT2022(fused_conv=fused_and_reorder, pool_reorder=fused_and_reorder)

    def loss(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x), train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.key(0)})
        return jnp.sum(out * dout), (out, mut["batch_stats"])

    (_, (ref, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    m = AudioNTT2022(fused_conv=fused_and_reorder, pool_reorder=fused_and_reorder)
    m.load_state_dict(audiontt_state_dict_from_jax(variables), strict=True)
    m.train()
    keep = torch.full((3, 8, 2048), 0.7)                  # mask / (1 - 0.3) == 1
    out = m(torch.from_numpy(x), keep)
    (out * torch.from_numpy(dout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-4 * float(np.abs(ref).max()))
    want = audiontt_state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, grads),
         "batch_stats": jax.tree.map(np.asarray, new_stats)})
    for k, p in m.named_parameters():
        # fp32 sums over 3 x 64 x 32 positions and 1024-2048-wide products
        # in other orders: 1e-4 of the gradient's largest value
        if k in ("features.0.bias", "features.4.bias"):
            # a conv bias before a batch norm: the gradient is mathematically
            # 0, float noise of a cancellation on both sides
            assert float(p.grad.abs().max()) < 1e-3 and float(want[k].abs().max()) < 1e-3
            continue
        scale = float(want[k].abs().max())
        assert float((p.grad - want[k]).abs().max()) <= 1e-4 * max(scale, 1.0), k
    for k, v in m.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v, want[k], atol=1e-5, rtol=1e-5, msg=k)
    assert int(m.features[1].num_batches_tracked) == 1


def test_dropout_mask_is_applied_and_scaled(variables):
    m = AudioNTT2022(fused_conv=True, pool_reorder=True)
    m.load_state_dict(audiontt_state_dict_from_jax(variables), strict=True)
    m.train()
    x = torch.randn(2, 1, 64, 32, generator=torch.Generator().manual_seed(0))
    none = m.frames(x, torch.zeros(2, 8, 2048))[..., 1024:]
    bias_only = torch.relu(m.fc[3].bias).expand_as(none)
    torch.testing.assert_close(none, bias_only)
    m.eval()
    assert torch.equal(m.frames(x, torch.zeros(2, 8, 2048)), m.frames(x))   # eval ignores it


def test_max_pool2d_backward_routes_a_tie_to_the_first_window_element():
    """Block 2's reordered pool relies on it (JAX's select-and-scatter
    does the same); the card is checked in test_torch_kernels_cuda.py."""
    x = torch.zeros(1, 1, 4, 4, requires_grad=True)
    torch.nn.functional.max_pool2d(x, 2).sum().backward()
    want = torch.zeros(4, 4)
    want[::2, ::2] = 1.0
    assert torch.equal(x.grad[0, 0], want)
