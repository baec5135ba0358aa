"""The port's training block 1 (ops/fused_conv.py fused_conv1_bn_relu_pool,
a torch.autograd.Function) against the JAX custom_vjp of the same name, on
the CPU: the port takes its plain versions here, JAX runs its Pallas
kernels in interpret mode.  Inputs come from numpy with a seed.

Ties: inputs and weights are quantised (0.5 and 0.25), so conv outputs are
exact in fp32 whatever the summation order and 2x2 windows tie often; a
quarter of the gammas is negative and one is exactly 0 (the window's min is
routed there)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
from ssl_audio_tpu.ops.fused_conv import fused_conv1_bn_relu_pool as jax_block
from ssl_audio_tpu_torch.ops.fused_conv import (
    fused_conv1_bn_relu_pool,
    fused_conv1_bwd_plain,
    fused_conv1_dx_plain,
)
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

TOL = 1e-4            # fp32 (BASELINE.md); sums of a few thousand terms in other orders
DB_ATOL = 1e-4        # db is mathematically 0: float noise on both sides, absolute only


def make_inputs(seed, B=4, H=16, W=24, C=64, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, 1))
    kernel = rng.standard_normal((3, 3, 1, C)) * 0.3
    if ties:
        x = np.round(x * 2) / 2
        kernel = np.round(kernel * 4) / 4
    bias = rng.standard_normal(C) * 0.1
    gamma = 1.0 + 0.3 * rng.standard_normal(C)
    gamma[: C // 4] *= -1.0
    gamma[C // 2] = 0.0
    beta = 0.2 * rng.standard_normal(C)
    dp = rng.standard_normal((B, H // 2, W // 2, C))
    return [a.astype(np.float32) for a in (x, kernel, bias, gamma, beta, dp)]


def torch_grads(x, k, b, g, be, dp, need_dx):
    ts = [torch.tensor(a, requires_grad=True) for a in (x, k, b, g, be)]
    ts[0].requires_grad_(need_dx)
    pooled, mean, var = fused_conv1_bn_relu_pool(*ts)
    assert not mean.requires_grad and not var.requires_grad
    (pooled * torch.tensor(dp)).sum().backward()
    return pooled.detach(), mean, var, [t.grad for t in ts]


@pytest.mark.parametrize("ties", [False, True])
def test_block_matches_jax_custom_vjp(ties):
    x, k, b, g, be, dp = make_inputs(0, ties=ties)
    pooled, mean, var, grads = torch_grads(x, k, b, g, be, dp, need_dx=True)

    def loss(x, k, b, g, be):
        p, m, v = jax_block(x, k, b, g, be)
        return jnp.sum(p * dp), (p, m, v)

    (_, (p_j, m_j, v_j)), g_j = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4),
                                                   has_aux=True)(x, k, b, g, be)
    np.testing.assert_allclose(pooled.numpy(), p_j, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(mean.numpy(), m_j, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), v_j, atol=1e-5, rtol=1e-5)
    for name, a, j in zip(("dx", "dW", "db", "dgamma", "dbeta"), grads, g_j):
        j = np.asarray(j)
        if name == "db":
            np.testing.assert_allclose(a.numpy(), j, atol=DB_ATOL, rtol=0, err_msg=name)
        else:
            scale = max(1.0, float(np.abs(j).max()))
            np.testing.assert_allclose(a.numpy(), j, atol=TOL * scale, rtol=TOL,
                                       err_msg=name)


def test_no_dx_when_input_is_data():
    """Block 1's input is data: without requires_grad on x the Function
    returns no input gradient (and the dx function is not reached)."""
    x, k, b, g, be, dp = make_inputs(1)
    _, _, _, grads = torch_grads(x, k, b, g, be, dp, need_dx=False)
    assert grads[0] is None and all(t is not None for t in grads[1:])


def unfused_block(x, k, b, g, be, eps=1e-5):
    """conv -> train-mode BN (biased variance) -> relu -> max pool, by
    autograd; ties route to the first window element, as in JAX."""
    C = k.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), b, padding=1)
    mean = y.mean(dim=(0, 2, 3), keepdim=True)
    var = (y * y).mean(dim=(0, 2, 3), keepdim=True) - mean * mean
    z = g.view(1, C, 1, 1) * (y - mean) * torch.rsqrt(var + eps) + be.view(1, C, 1, 1)
    return F.max_pool2d(torch.relu(z), 2).permute(0, 2, 3, 1)


@pytest.mark.parametrize("ties", [False, True])
def test_plain_backward_agrees_with_autograd_through_unfused_block(ties):
    """The sums of fused_conv1_bwd_plain, assembled as the Function does,
    and fused_conv1_dx_plain's dy, against autograd through the unfused
    composition.  gamma == 0 is left out: the unfused block's pool then
    ties on z everywhere and routes to the first element, the fused block
    to the min of y (the JAX package's stated convention)."""
    x, k, b, g, be, dp = make_inputs(2, ties=ties)
    g[g == 0.0] = 0.7
    ts = [torch.tensor(a, requires_grad=True) for a in (x, k, b, g, be)]
    (unfused_block(*ts) * torch.tensor(dp)).sum().backward()
    ref = [t.grad for t in ts]
    _, _, _, got = torch_grads(x, k, b, g, be, dp, need_dx=True)
    for name, a, r in zip(("dx", "dW", "db", "dgamma", "dbeta"), got, ref):
        if name == "db":
            # autograd's db is the cancellation of ~1e2-sized sums: noise of 1e-4..1e-3
            assert float(a.abs().max()) < 1e-3 and float(r.abs().max()) < 1e-3
            continue
        scale = max(1.0, float(r.abs().max()))
        torch.testing.assert_close(a, r, atol=TOL * scale, rtol=TOL, msg=name)


def test_plain_sums_shapes_and_dy_layout():
    x, k, b, g, be, dp = (torch.tensor(a) for a in make_inputs(3, B=2, H=8, W=12))
    C = k.shape[-1]
    x2, wk = x[..., 0], k.reshape(9, C)
    pooled, mean, var = fused_conv1_bn_relu_pool(x, k, b, g, be)
    r = torch.rsqrt(var + 1e-5)
    t1, t2, sx, a1, a2, gram = fused_conv1_bwd_plain(x2, wk, b, g, mean, r, pooled, dp)
    assert [tuple(t.shape) for t in (t1, t2, sx, a1, a2, gram)] == \
        [(C,), (C,), (C,), (9, C), (9,), (9, 9)]
    torch.testing.assert_close(gram, gram.t())
    # the centre tap sees every input value once
    torch.testing.assert_close(a2[4], x2.sum(), atol=1e-3, rtol=1e-5)
    dy = fused_conv1_dx_plain(x2, wk, b, g, mean, r, pooled, dp, t1, t2, float(x2.numel()))
    assert dy.shape == (2, 8, 12, C)
    # BN's backward removes the mean and the xhat component of dy
    assert float(dy.sum(dim=(0, 1, 2)).abs().max()) < 1e-3


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_cotangent_layout_changes_nothing(layout):
    """The forward's output is a (B, H/2, W/2, C) view of channel-major
    memory, and the backward reads its cotangent in that layout: a
    cotangent handed over contiguous (channels-last memory) or as a view of
    NCHW memory gives the same values and gradients, bit for bit, and both
    the JAX custom_vjp's."""
    x, k, b, g, be, dp = make_inputs(4, ties=True)
    want = torch_grads(x, k, b, g, be, dp, need_dx=True)
    ts = [torch.tensor(a, requires_grad=True) for a in (x, k, b, g, be)]
    pooled, mean, var = fused_conv1_bn_relu_pool(*ts)
    assert pooled.permute(0, 3, 1, 2).is_contiguous()
    cot = torch.tensor(dp)
    if layout == "nchw":
        cot = cot.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        assert not cot.is_contiguous()
    pooled.backward(cot)
    assert torch.equal(pooled.detach(), want[0])
    for a, w in zip([t.grad for t in ts], want[3]):
        assert torch.equal(a, w)

    def loss(x, k, b, g, be):
        p, m, v = jax_block(x, k, b, g, be)
        return jnp.sum(p * dp), p

    (_, p_j), g_j = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        x, k, b, g, be)
    np.testing.assert_allclose(pooled.detach().numpy(), p_j, atol=TOL, rtol=TOL)
    for name, a, j in zip(("dx", "dW", "db", "dgamma", "dbeta"), [t.grad for t in ts], g_j):
        j = np.asarray(j)
        atol = DB_ATOL if name == "db" else TOL * max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(a.numpy(), j, atol=atol, rtol=0 if name == "db" else TOL,
                                   err_msg=name)
