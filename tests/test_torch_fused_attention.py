"""The port's fused attention (ssl_audio_tpu_torch/ops/fused_attention.py)
against the JAX package's fused_attention and its custom VJP, which run the
Pallas kernels in interpret mode on the CPU.  The port's plain versions are
what the CPU runs and the CUDA kernels' oracle, so they carry the kernels'
rounding points: bf16 dot operands, bf16 P and dS, dk and dv rounded to
bf16, dq and the key-bias cotangent left in fp32.

Shapes are tiny (B = 2, C = 32, 2 heads of 16), N = 25 (the ViT's 24 patches
+ CLS) and N = 7 (a token-drop teacher at mask ratio 0.75: odd, and not a
multiple of the kernels' 32-row query tile), with zero key biases and with
the token mask's -1e9 on some keys (CLS always visible).

Tolerance: the two sides take fp32 sums in other orders and other exp
implementations, so a value at a bf16 rounding boundary can round the other
way on one side: a P or dS operand then moves by one bf16 spacing (at most
2^-7 of itself), and a rounded output (dk, dv) by one spacing of itself.
Each comparison allows one bf16 spacing of the output's largest value
(BF16_SPACING * max|ref|) and a relative L2 error of REL_L2 (a few flipped
elements stay far under it; a rounding point left out, ~2^-9 on every
element, does not); the errors measured here are fp32-order noise, below
1e-6 of the scale and 2e-7 in relative L2 (printed with -s)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl_audio_tpu.models.vit import NEG_INF
from ssl_audio_tpu.ops import fused_attention as jfa
from ssl_audio_tpu_torch.ops import fused_attention as fa
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

B, C, HEADS = 2, 32, 2
BF16_SPACING = 2.0 ** -7     # bf16 keeps 8 significant bits: spacing <= 2^-7 of a value
REL_L2 = 1e-4


def inputs(N: int, masked: bool, seed: int = 0):
    rng = np.random.default_rng(seed + N)
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    bias = np.zeros((B, N), np.float32)
    if masked:
        # the ViT's key-bias mask: -1e9 on about half the patch keys, CLS visible
        drop = rng.random((B, N)) < 0.5
        drop[:, 0] = False
        bias[drop] = NEG_INF
    dout = rng.standard_normal((B, N, C)).astype(np.float32)
    return qkv, bias, dout


def check(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    rel_l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"{what}: max abs err {err:.2e} of max|ref| {scale:.2e}, rel L2 {rel_l2:.2e}")
    assert err <= BF16_SPACING * scale, what
    assert rel_l2 <= REL_L2, what


CASES = [(25, False), (25, True), (7, False), (7, True)]


@pytest.mark.parametrize("N,masked", CASES)
def test_forward_matches_jax(N, masked):
    qkv, bias, _ = inputs(N, masked)
    want = jfa.fused_attention(jnp.asarray(qkv), jnp.asarray(bias), HEADS)
    got = fa.fused_attention_fwd_plain(torch.from_numpy(qkv), torch.from_numpy(bias), HEADS)
    assert got.shape == (B, N, C) and got.dtype == torch.float32
    check(got, want, f"out N={N} masked={masked}")


@pytest.mark.parametrize("N,masked", CASES)
def test_backward_matches_jax_vjp(N, masked):
    qkv, bias, dout = inputs(N, masked)
    _, vjp = jax.vjp(lambda x, b: jfa.fused_attention(x, b, HEADS),
                     jnp.asarray(qkv), jnp.asarray(bias))
    jdqkv, jdbias = vjp(jnp.asarray(dout))
    dqkv, dbias = fa.fused_attention_bwd_plain(
        torch.from_numpy(qkv), torch.from_numpy(bias), torch.from_numpy(dout), HEADS)
    assert dqkv.shape == (B, N, 3 * C) and dbias.shape == (B, N)
    for i, name in enumerate(("dq", "dk", "dv")):
        check(dqkv[..., i * C:(i + 1) * C], np.asarray(jdqkv)[..., i * C:(i + 1) * C],
              f"{name} N={N} masked={masked}")
    check(dbias, jdbias, f"dbias N={N} masked={masked}")
    if masked:
        # a key under -1e9 takes no probability and passes no gradient
        dead = bias == NEG_INF
        assert float(dbias[torch.from_numpy(dead)].abs().max()) == 0.0
        assert float(dqkv[..., C:][torch.from_numpy(dead)].abs().max()) == 0.0


def test_rounding_points():
    """dk and dv come out of the backward as bf16 values (the Pallas fold
    matmul rounds them), dq and the output do not; with every rounding point
    taken out the function is fp32 attention, within the bf16 operands'
    error of it."""
    qkv, bias, dout = (torch.from_numpy(a) for a in inputs(25, True))
    dqkv, dbias = fa.fused_attention_bwd_plain(qkv, bias, dout, HEADS)
    dq, dk, dv = dqkv[..., :C], dqkv[..., C:2 * C], dqkv[..., 2 * C:]
    for name, g in (("dk", dk), ("dv", dv)):
        assert torch.equal(g, g.bfloat16().float()), name
    out = fa.fused_attention_fwd_plain(qkv, bias, HEADS)
    for name, g in (("dq", dq), ("out", out), ("dbias", dbias)):
        assert not torch.equal(g, g.bfloat16().float()), name
    # against fp64 attention with no rounding anywhere: bf16 operands carry
    # 2^-9 relative error each, so the results sit ~1e-2 of their scale off
    x = qkv.double().requires_grad_()
    b = bias.double().requires_grad_()
    q, k, v = (t.reshape(B, 25, HEADS, C // HEADS).transpose(1, 2) for t in x.split(C, -1))
    p = torch.softmax(q @ k.transpose(-1, -2) * (C // HEADS) ** -0.5 + b[:, None, None], -1)
    ref = (p @ v).transpose(1, 2).reshape(B, 25, C)
    ref.backward(dout.double())
    for got, want in ((out, ref.detach()), (dqkv, x.grad), (dbias, b.grad)):
        rel = float((got.double() - want).norm() / want.norm())
        assert 1e-4 < rel < 2e-2


def test_supports_matches_jax():
    for batch in (1, 4):
        for seq in (0, 1, 7, 25, 49, 256, 257):
            for dim, heads in ((768, 12), (384, 6), (192, 3), (32, 2), (60, 4), (1024, 4),
                               (2048, 8), (256, 2), (100, 3)):
                assert fa.supports(batch, seq, dim, heads) == jfa.supports(batch, seq, dim, heads)


@pytest.mark.parametrize("needs_bias_grad", [False, True])
def test_function_backward_is_the_plain_backward(needs_bias_grad):
    """The autograd Function: forward = the plain forward, gradients = the
    plain backward, on the CPU."""
    qkv, bias, dout = (torch.from_numpy(a) for a in inputs(7, True))
    x = qkv.clone().requires_grad_()
    b = bias.clone().requires_grad_(needs_bias_grad)
    out = fa.fused_attention(x, b, HEADS)
    assert torch.equal(out, fa.fused_attention_fwd_plain(qkv, bias, HEADS))
    out.backward(dout)
    dqkv, dbias = fa.fused_attention_bwd_plain(qkv, bias, dout, HEADS)
    assert torch.equal(x.grad, dqkv)
    assert (b.grad is None) != needs_bias_grad
    if needs_bias_grad:
        assert torch.equal(b.grad, dbias)


def test_cuda_wrappers_take_only_cuda_tensors():
    """On the CPU a wrapper runs the plain version only because the tensor
    lies on the CPU; the kernels' wrappers refuse it and count nothing."""
    from ssl_audio_tpu_torch.ops import launch_counts, zero_launch_counts

    qkv, bias, dout = (torch.from_numpy(a) for a in inputs(7, False))
    zero_launch_counts()
    with pytest.raises(ValueError):
        fa.fused_attention_fwd_cuda(qkv, bias, HEADS)
    with pytest.raises(ValueError):
        fa.fused_attention_bwd_cuda(qkv, bias, dout, HEADS)
    assert torch.equal(fa.fused_attention_fwd(qkv, bias, HEADS),
                       fa.fused_attention_fwd_plain(qkv, bias, HEADS))
    counts = launch_counts()
    assert counts["fused_attention_fwd"] == counts["fused_attention_bwd"] == 0
