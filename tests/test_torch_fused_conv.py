"""The port's fused Conv-BN-ReLU-Pool forward (ssl_audio_tpu_torch/ops/
fused_conv.py) against the JAX package's Pallas block (ssl_audio_tpu/ops/
fused_conv.py, interpret mode here), on the inputs of tests/test_fused_conv.py:
tie-heavy windows, negative gammas and a gamma of exactly 0.

The CUDA kernel runs only on the card; its comparison with the plain version
is in tests/test_torch_kernels_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.ops.fused_conv import (
    fused_conv1_bn_relu_pool,
    fused_conv1_bn_relu_pool_eval as jax_eval,
)
from ssl_audio_tpu_torch.ops.fused_conv import (
    fused_conv1_bn_relu_pool_eval,
    fused_conv1_fwd,
    fused_conv1_fwd_cuda,
    fused_conv1_fwd_plain,
)
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

# fp32 convolutions of 9 taps and pooled values of O(1): the two frameworks
# round the sums in different orders, the tolerance of tests/test_fused_conv.py
ATOL = RTOL = 1e-5
EPS = 1e-5


def make_inputs(rng, B=4, H=16, W=24, C=64, ties=False):
    """tests/test_fused_conv.py's inputs, plus one gamma of exactly 0."""
    x = rng.standard_normal((B, H, W, 1)).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2
    kernel = (rng.standard_normal((3, 3, 1, C)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32) * 0.1
    gamma = (1.0 + 0.3 * rng.standard_normal(C)).astype(np.float32)
    gamma[: C // 4] *= -1.0
    gamma[C // 2] = 0.0
    beta = (0.2 * rng.standard_normal(C)).astype(np.float32)
    return x, kernel, bias, gamma, beta


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("ties", [False, True])
def test_forward_matches_jax_training_block(rng, ties):
    """(sel, s1, s2) carry the training block's batch statistics and pooled
    output: mean = s1/n, var = s2/n - mean^2, pooled = relu(bn(sel))."""
    x, k, b, g, be = make_inputs(rng, ties=ties)
    p_j, m_j, v_j = (np.asarray(a) for a in fused_conv1_bn_relu_pool(
        *(jnp.asarray(a) for a in (x, k, b, g, be))))
    xt, kt, bt, gt, bet = _t(x, k, b, g, be)
    sel, s1, s2 = fused_conv1_fwd(xt[..., 0], kt.reshape(9, -1), bt, gt)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    mean = s1 / n
    var = s2 / n - mean * mean
    pooled = torch.relu(gt * (sel - mean) * torch.rsqrt(var + EPS) + bet)
    np.testing.assert_allclose(mean.numpy(), m_j, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(var.numpy(), v_j, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pooled.numpy(), p_j, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("ties", [False, True])
def test_eval_block_matches_jax(rng, ties):
    x, k, b, g, be = make_inputs(rng, ties=ties)
    mean = rng.standard_normal(64).astype(np.float32)
    var = (0.5 + rng.random(64)).astype(np.float32)
    ref = np.asarray(jax_eval(*(jnp.asarray(a) for a in (x, k, b, g, be, mean, var))))
    out = fused_conv1_bn_relu_pool_eval(*_t(x, k, b, g, be, mean, var))
    assert out.shape == ref.shape == (4, 8, 12, 64)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_sel_is_sign_aware_extreme(rng):
    """sel is the window max where gamma > 0 and the min otherwise, gamma
    == 0 included, checked directly on the conv output."""
    x, k, b, g, _ = make_inputs(rng, B=2, H=8, W=6, ties=True)
    xt, kt, bt, gt = _t(x[..., 0], k.reshape(9, -1), b, g)
    sel, _, _ = fused_conv1_fwd_plain(xt, kt, bt, gt)
    y = torch.nn.functional.conv2d(xt[:, None], kt.t().reshape(64, 1, 3, 3), bt,
                                   padding=1)                         # (B, C, H, W)
    win = y.reshape(2, 64, 4, 2, 3, 2).permute(0, 2, 4, 1, 3, 5).reshape(2, 4, 3, 64, 4)
    expect = torch.where(gt > 0, win.amax(-1), win.amin(-1))
    assert g[32] == 0.0
    torch.testing.assert_close(sel, expect, atol=ATOL, rtol=RTOL)


def test_cpu_tensor_takes_plain_path(rng):
    x, k, b, g, _ = make_inputs(rng, B=1, H=4, W=4)
    before = fused_conv1_fwd_cuda.launches
    fused_conv1_fwd(*_t(x[..., 0], k.reshape(9, -1), b, g))
    assert fused_conv1_fwd_cuda.launches == before
    with pytest.raises(ValueError):
        fused_conv1_fwd_cuda(*_t(x[..., 0], k.reshape(9, -1), b, g))
