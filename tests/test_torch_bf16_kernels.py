"""The bf16 versions of the port's kernel-bearing modules against the JAX
package's, on the CPU: the fused Conv-BN-ReLU-Pool block (training forward,
eval forward, backward; ssl_audio_tpu/ops/fused_conv.py) and the fused
attention (forward and backward; ssl_audio_tpu/ops/fused_attention.py),
the JAX Pallas kernels in interpret mode, the port through its plain
versions (what its wrappers run for a CPU tensor and the CUDA kernels'
oracle on the card, tests/test_torch_kernels_cuda.py).

Inputs come from a numpy seed; each side gets them in bf16 (the values are
bf16 values, so both read the same numbers).

Tolerances.  bf16 keeps 8 significant bits and the two frameworks round at
different places (sums in other orders cross a rounding boundary on one
side).  So each bf16 result is held against JAX's bf16 result by the gap
JAX itself shows between its bf16 and fp32 results on the same inputs:
the port's relative L2 gap may be at most GAP_FACTOR times JAX's, and at
most a fixed ceiling (EMB_CEIL for forward outputs, GRAD_CEIL per
gradient).  Where JAX's two types agree (dk and dv, bf16 values in both)
the fp32 attention tests' bound for a few flipped roundings, REL_FLOOR,
takes the place of the doubled gap.  The fp32 statistics and sums (mean, var, the bias cotangent)
are fp32 values of exact products and are held to STATS_RTOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.models.vit import NEG_INF
from ssl_audio_tpu.ops import fused_attention as jfa
from ssl_audio_tpu.ops import fused_conv as jfc
from ssl_audio_tpu_torch import ops
from ssl_audio_tpu_torch.ops import fused_attention as fa
from ssl_audio_tpu_torch.ops import fused_conv as fc
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

GAP_FACTOR = 2.0      # the port's gap to JAX bf16 <= 2 x JAX's own bf16-to-fp32 gap
EMB_CEIL = 2e-2       # ... and <= this relative L2 for forward outputs
GRAD_CEIL = 1e-1      # ... and for each gradient tensor
STATS_RTOL = 1e-4     # fp32 sums of exact bf16 products, in other orders
REL_FLOOR = 1e-4      # tests/test_torch_fused_attention.py's REL_L2
EPS = 1e-5
BF16 = torch.bfloat16


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def hold(port16, jax16, jax32, what, ceil):
    """port16 against jax16, within GAP_FACTOR x |jax16 - jax32| and ceil
    (relative L2); prints the three numbers (pytest -s)."""
    port16, jax16, jax32 = (np.asarray(a.detach().float() if torch.is_tensor(a) else a,
                                       np.float64) for a in (port16, jax16, jax32))
    gap = rel_l2(port16, jax16)
    jgap = rel_l2(jax16, jax32)
    print(f"{what}: port vs JAX bf16 {gap:.2e}; JAX bf16 vs fp32 {jgap:.2e}")
    assert gap <= max(GAP_FACTOR * jgap, REL_FLOOR), \
        f"{what}: {gap:.2e} > {GAP_FACTOR} x {jgap:.2e}"
    assert gap <= ceil, f"{what}: {gap:.2e} > {ceil}"


def conv_inputs(seed=0, B=2, H=16, W=24, C=64):
    """tests/test_torch_fused_conv.py's inputs (negative gammas, one 0), as
    bf16 values in fp32 arrays."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, 1))
    kernel = rng.standard_normal((3, 3, 1, C)) * 0.3
    bias = rng.standard_normal(C) * 0.1
    gamma = 1.0 + 0.3 * rng.standard_normal(C)
    gamma[: C // 4] *= -1.0
    gamma[C // 2] = 0.0
    beta = 0.2 * rng.standard_normal(C)
    return [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in (x, kernel, bias, gamma, beta)]


def jax_in(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def port_in(arrays, dtype=BF16):
    return [torch.from_numpy(np.array(a)).to(dtype) for a in arrays]


# ------------------------------------------------------------------ fused conv

def test_fused_conv_training_forward_matches_jax_bf16():
    arrs = conv_inputs()
    j16 = jfc.fused_conv1_bn_relu_pool(*jax_in(arrs, jnp.bfloat16))
    j32 = jfc.fused_conv1_bn_relu_pool(*jax_in(arrs, jnp.float32))
    pooled, mean, var = fc.fused_conv1_bn_relu_pool(*port_in(arrs))
    assert pooled.dtype == BF16 and mean.dtype == var.dtype == torch.float32
    assert j16[0].dtype == jnp.bfloat16 and fc.nchw_memory(pooled)
    hold(pooled, j16[0].astype(jnp.float32), j32[0], "pooled", EMB_CEIL)
    for got, want, name in ((mean, j16[1], "mean"), (var, j16[2], "var")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=STATS_RTOL,
                                   atol=STATS_RTOL, err_msg=name)


def test_fused_conv_sel_is_the_rounded_fp32_extreme():
    """The plain statistics forward in bf16: s1 / s2 are the fp32 sums of
    the fp32 conv of the (exactly widened) bf16 inputs, and sel is the fp32
    run's sel rounded once to bf16."""
    x, k, b, g, _ = conv_inputs(seed=1)
    args16 = port_in([x[..., 0], k.reshape(9, -1), b, g])
    args32 = port_in([x[..., 0], k.reshape(9, -1), b, g], torch.float32)
    sel16, s1_16, s2_16 = fc.fused_conv1_fwd_plain(*args16)
    sel32, s1_32, s2_32 = fc.fused_conv1_fwd_plain(*args32)
    assert sel16.dtype == BF16 and s1_16.dtype == torch.float32
    assert torch.equal(sel16, sel32.to(BF16))
    assert torch.equal(s1_16, s1_32) and torch.equal(s2_16, s2_32)


def test_fused_conv_eval_forward_matches_jax_bf16():
    arrs = conv_inputs(seed=2)
    rng = np.random.default_rng(3)
    stats = [rng.standard_normal(64).astype(np.float32),
             (0.5 + rng.random(64)).astype(np.float32)]      # running stats: fp32
    j16 = jfc.fused_conv1_bn_relu_pool_eval(*jax_in(arrs, jnp.bfloat16),
                                            *(jnp.asarray(s) for s in stats))
    j32 = jfc.fused_conv1_bn_relu_pool_eval(*jax_in(arrs, jnp.float32),
                                            *(jnp.asarray(s) for s in stats))
    out = fc.fused_conv1_bn_relu_pool_eval(*port_in(arrs), *port_in(stats, torch.float32))
    assert out.dtype == BF16 and out.shape == (2, 8, 12, 64) and fc.nchw_memory(out)
    hold(out, j16.astype(jnp.float32), j32, "eval pooled", EMB_CEIL)


def test_fused_conv_backward_matches_jax_bf16():
    """The autograd Function's backward (the plain backward on the CPU)
    against the JAX custom VJP: dW and db in x's type, dgamma and dbeta in
    gamma's (JAX fused_conv.py:534-536), each gradient held as above."""
    arrs = conv_inputs(seed=4)
    rng = np.random.default_rng(5)
    dp = np.asarray(jnp.asarray(rng.standard_normal((2, 8, 12, 64)), jnp.bfloat16)
                    .astype(jnp.float32))

    def jax_grads(dtype):
        (_, vjp) = jax.vjp(lambda *a: jfc.fused_conv1_bn_relu_pool(*a)[0],
                           *jax_in(arrs, dtype))
        return vjp(jnp.asarray(dp).astype(dtype))

    j16, j32 = jax_grads(jnp.bfloat16), jax_grads(jnp.float32)
    xs = port_in(arrs)
    params = [t.requires_grad_() for t in xs[1:]]
    pooled, _, _ = fc.fused_conv1_bn_relu_pool(xs[0], *params)
    pooled.backward(torch.from_numpy(dp).to(BF16))
    for i, (p, name) in enumerate(zip(params, ("dW", "db", "dgamma", "dbeta")), start=1):
        assert p.grad.dtype == BF16 and j16[i].dtype == jnp.bfloat16, name
        if name == "db":          # mathematically 0 (-(r g Sx T2)/n): float noise on both sides
            assert float(p.grad.float().abs().max()) <= 1e-2 * float(
                params[0].grad.float().abs().max())
            continue
        hold(p.grad, j16[i].astype(jnp.float32), j32[i], name, GRAD_CEIL)


def test_fused_conv_dtypes_are_float32_or_bf16():
    """The wrappers take exactly float32 and bfloat16; the dx kernel (B5)
    and its plain version are fp32 only; a CPU tensor takes the plain path
    and counts no launch, of either type."""
    x, k, b, g, be = port_in(conv_inputs(seed=6, B=1, H=4, W=4))
    with pytest.raises(ValueError):
        fc.fused_conv1_bn_relu_pool(x.half(), k, b, g, be)
    with pytest.raises(ValueError):           # a CPU tensor never reaches a kernel
        fc.fused_conv1_fwd_cuda(x[..., 0], k.reshape(9, -1), b, g)
    before = ops.launch_counts()
    pooled, mean, var = fc.fused_conv1_bn_relu_pool(x, k, b, g, be)
    assert ops.launch_counts() == before
    assert {"fused_conv1_fwd_bf16", "fused_conv1_bwd_bf16", "fused_attention_fwd_bf16",
            "fused_attention_bwd_bf16"} <= set(before)
    r = torch.rsqrt(var + EPS)
    args = (x[..., 0], k.reshape(9, -1), b, g, mean, r, pooled, torch.ones_like(pooled))
    with pytest.raises(ValueError, match="fp32 only"):
        fc.fused_conv1_dx(*args, mean, var, 16.0)
    x.requires_grad_()
    out, _, _ = fc.fused_conv1_bn_relu_pool(x, k, b, g, be)
    with pytest.raises(ValueError, match="fp32 only"):
        out.float().sum().backward()


# ------------------------------------------------------------------- attention

B, C, HEADS = 2, 32, 2
ATTN_CASES = [(25, True), (7, True)]


def attn_inputs(N, masked, seed=0):
    rng = np.random.default_rng(seed + N)
    qkv = np.asarray(jnp.asarray(rng.standard_normal((B, N, 3 * C)), jnp.bfloat16)
                     .astype(jnp.float32))
    bias = np.zeros((B, N), np.float32)
    if masked:
        drop = rng.random((B, N)) < 0.5
        drop[:, 0] = False
        bias[drop] = NEG_INF
    dout = np.asarray(jnp.asarray(rng.standard_normal((B, N, C)), jnp.bfloat16)
                      .astype(jnp.float32))
    return qkv, bias, dout


@pytest.mark.parametrize("N,masked", ATTN_CASES)
def test_attention_forward_matches_jax_bf16(N, masked):
    qkv, bias, _ = attn_inputs(N, masked)
    j16 = jfa.fused_attention(jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(bias), HEADS)
    j32 = jfa.fused_attention(jnp.asarray(qkv), jnp.asarray(bias), HEADS)
    got = fa.fused_attention(torch.from_numpy(qkv).to(BF16), torch.from_numpy(bias), HEADS)
    assert got.dtype == BF16 and j16.dtype == jnp.bfloat16 and got.shape == (B, N, C)
    hold(got, j16.astype(jnp.float32), j32, f"out N={N} masked={masked}", EMB_CEIL)


@pytest.mark.parametrize("N,masked", ATTN_CASES)
def test_attention_backward_matches_jax_bf16(N, masked):
    """dq / dk / dv in qkv's type, the bias cotangent fp32 (JAX
    fused_attention.py:230-233)."""
    qkv, bias, dout = attn_inputs(N, masked)

    def jax_vjp(dtype):
        _, vjp = jax.vjp(lambda x, b: jfa.fused_attention(x, b, HEADS),
                         jnp.asarray(qkv, dtype), jnp.asarray(bias))
        return vjp(jnp.asarray(dout, dtype))

    (jdq16, jdb16), (jdq32, jdb32) = jax_vjp(jnp.bfloat16), jax_vjp(jnp.float32)
    x = torch.from_numpy(qkv).to(BF16).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    fa.fused_attention(x, b, HEADS).backward(torch.from_numpy(dout).to(BF16))
    assert x.grad.dtype == BF16 and b.grad.dtype == torch.float32
    assert jdq16.dtype == jnp.bfloat16 and jdb16.dtype == jnp.float32
    for i, name in enumerate(("dq", "dk", "dv")):
        sl = slice(i * C, (i + 1) * C)
        hold(x.grad[..., sl], np.asarray(jdq16.astype(jnp.float32))[..., sl],
             np.asarray(jdq32)[..., sl], f"{name} N={N} masked={masked}", GRAD_CEIL)
    # fp32 sums of the same bf16-operand products in both types: JAX's bf16
    # and fp32 cotangents are equal, the port's differ from them by sum order
    np.testing.assert_array_equal(np.asarray(jdb16), np.asarray(jdb32))
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(jdb16), rtol=0,
                               atol=STATS_RTOL * float(np.abs(np.asarray(jdb16)).max()))
    if masked:          # a key under -1e9 takes no probability and passes no gradient
        dead = torch.from_numpy(bias == NEG_INF)
        assert float(b.grad[dead].abs().max()) == 0.0
        assert float(x.grad[..., C:].float()[dead].abs().max()) == 0.0


def test_attention_bf16_rounding_points():
    """In bf16 the output and dq are the fp32 run's values rounded once to
    bf16, and dk / dv the fp32 run's (already bf16) values; the bias
    cotangent is the fp32 run's.  The fp32 results are fp32, as before."""
    qkv, bias, dout = (torch.from_numpy(a) for a in attn_inputs(25, True, seed=3))
    out32 = fa.fused_attention_fwd_plain(qkv, bias, HEADS)
    out16 = fa.fused_attention_fwd_plain(qkv.to(BF16), bias, HEADS)
    assert out32.dtype == torch.float32 and torch.equal(out16, out32.to(BF16))
    d32, db32 = fa.fused_attention_bwd_plain(qkv, bias, dout, HEADS)
    d16, db16 = fa.fused_attention_bwd_plain(qkv.to(BF16), bias, dout.to(BF16), HEADS)
    assert d32.dtype == torch.float32 and d16.dtype == BF16
    assert torch.equal(d16, d32.to(BF16)) and torch.equal(db16, db32)
    assert torch.equal(d32[..., C:], d32[..., C:].to(BF16).float())   # dk, dv bf16 values


def test_attention_wrappers_take_float32_or_bf16():
    qkv, bias, _ = (torch.from_numpy(a) for a in attn_inputs(7, False))
    with pytest.raises(ValueError):            # a CPU tensor never reaches a kernel
        fa.fused_attention_fwd_cuda(qkv.to(BF16), bias, HEADS)
    before = ops.launch_counts()
    out = fa.fused_attention(qkv.to(BF16), bias, HEADS)
    assert out.dtype == BF16 and ops.launch_counts() == before
    assert fa.fused_attention(qkv.double(), bias, HEADS).dtype == torch.float32
