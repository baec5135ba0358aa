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

from ssl_audio_tpu_torch.ops import fused_attention as fa
from ssl_audio_tpu_torch.ops.fused_conv import (
    fused_conv1_bn_relu_pool,
    fused_conv1_bn_relu_pool_eval,
    fused_conv1_bwd_cuda,
    fused_conv1_bwd_plain,
    fused_conv1_dx_cuda,
    fused_conv1_dx_plain,
    fused_conv1_fwd_cuda,
    fused_conv1_fwd_plain,
    nchw_memory,
)
from ssl_audio_tpu_torch.ops.mel import (
    MelSpec,
    log_mel_spectrogram_cropped_plain,
    log_mel_spectrogram_plain,
)
from ssl_audio_tpu_torch.ops.mel_kernel import kernel_operands, log_mel_cuda

pytestmark = pytest.mark.cuda

# the tolerances of chip_smoke.py, with their reasons
MEL_ATOL = 1e-4      # three TF32 passes (~2^-22 per product) against cuBLAS fp32
CONV_ATOL = 1e-4     # cuDNN's fp32 conv algorithm rounds otherwise
STATS_RTOL = 1e-4    # fp32 sums over the batch in another order
EMB_RTOL = 1e-3      # embeddings / max|embedding|, card vs CPU
SUMS_RTOL = 1e-4     # backward sums / their largest value: fp32 sums in another order
DY_ATOL = 1e-4       # dy values O(1): the T1/n, T2/n terms come from those sums
BF16_SPACING = 2.0 ** -7   # attention: a bf16 operand or output rounded the other way
ATTN_REL_L2 = 1e-4         # moves one element by one bf16 spacing; relative L2 stays tiny
ATTN_REL_L2_BF16 = 2e-4    # bf16 dq / dk / dv: one more bf16 rounding (chip_smoke.py)


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


@pytest.mark.parametrize("fold", [None, False])
@pytest.mark.parametrize("frames", [96, 33])
def test_log_mel_kernel_with_crop_starts_matches_plain(dev, rng, fold, frames):
    """Per-clip crop starts at the training spec: first, last valid and
    mixed starts; 33 frames leave a partial frame tile."""
    spec = MelSpec(win_length=1024)
    B, L = 16, 48000
    wav = _wav(rng, (B, L)).to(dev)
    last = spec.num_frames(L) - frames
    starts = torch.from_numpy(rng.integers(0, last + 1, B).astype(np.int32))
    starts[0], starts[1] = 0, last
    starts = starts.to(dev)
    before = dict(log_mel_cuda.launches)
    out = log_mel_cuda(wav, spec, fold, starts, frames)
    ref = log_mel_spectrogram_cropped_plain(wav, spec, fold, starts, frames)
    full = log_mel_spectrogram_plain(wav, spec, fold=fold)
    torch.cuda.synchronize()
    took = "folded" if kernel_operands(spec, fold).fold else "unfolded"
    assert log_mel_cuda.launches == {**before, took: before[took] + 1}
    assert out.shape == (B, spec.n_mels, frames)
    torch.testing.assert_close(out, ref, atol=MEL_ATOL, rtol=0)
    for b in (0, 1, 5):
        s0 = int(starts[b])
        torch.testing.assert_close(out[b], full[b, :, s0:s0 + frames],
                                   atol=MEL_ATOL, rtol=0)


@pytest.mark.parametrize("fold", [None, False])
@pytest.mark.parametrize("case", ["partial_tiles", "k_not_a_slab", "last_and_past_starts",
                                  "short_clip", "one_clip"])
def test_log_mel_kernel_edges(dev, rng, fold, case):
    """Edges of the tensor-core kernel, each instantiation and both tiles:
    T not a multiple of the tile (T = 101, 33 cropped), a support K that is
    not a multiple of the 8-row slab (win 300: K = 150 folded, 299
    unfolded), crop starts at the last valid frame and clamped past the
    clip's end, L just above n_fft / 2 (reflect centring at its limit, a
    partial single tile), B = 1; one launch of the right instantiation each."""
    win, B, L, frames = {"partial_tiles": (1024, 3, 16000, None),
                         "k_not_a_slab": (300, 4, 15200, None),
                         "last_and_past_starts": (1024, 4, 16000, 33),
                         "short_clip": (1024, 2, 513, None),
                         "one_clip": (400, 1, 15200, 96)}[case]
    spec = MelSpec(win_length=win)
    ops = kernel_operands(spec, fold)
    if case == "k_not_a_slab":
        assert ops.basis_c.shape[0] % 8 != 0 and ops.k_pad % 8 == 0
    wav = _wav(rng, (B, L)).to(dev)
    T_full = spec.num_frames(L)
    starts = None
    if frames is not None:
        last = T_full - frames
        starts = torch.tensor(([last, last + 5, last + frames + 10, 0] * B)[:B],
                              dtype=torch.int32, device=dev)
    for tile in (64, 96):
        before = dict(log_mel_cuda.launches)
        if starts is None:
            out = log_mel_cuda(wav, spec, fold, tile=tile)
            ref = log_mel_spectrogram_plain(wav, spec, fold=fold)
        else:
            out = log_mel_cuda(wav, spec, fold, starts, frames, tile=tile)
            ref = log_mel_spectrogram_cropped_plain(wav, spec, fold, starts, frames)
        torch.cuda.synchronize()
        took = "folded" if ops.fold else "unfolded"
        assert log_mel_cuda.launches == {**before, took: before[took] + 1}
        assert out.shape == ref.shape and torch.isfinite(out).all()
        torch.testing.assert_close(out, ref, atol=MEL_ATOL, rtol=0, msg=f"tile {tile}")


@pytest.mark.parametrize("fold", [None, False])
def test_log_mel_dynamic_range_against_float64(dev, rng, fold):
    """0.3 tones over a 1e-4 noise floor: the kernel's error against the
    plain version in float64 is at most max(1e-4, 4 x the fp32 plain
    version's)."""
    spec = MelSpec(win_length=1024)
    t = np.arange(32000) / 16000
    tone = 0.3 * np.sin(2 * np.pi * (200 + 3000 * rng.random((8, 1))) * t)
    wav = torch.from_numpy((tone + 1e-4 * rng.standard_normal((8, 32000))).astype(np.float32))
    wav = wav.to(dev)
    exact = log_mel_spectrogram_plain(wav.double(), spec, fold=fold)
    plain = log_mel_spectrogram_plain(wav, spec, fold=fold)
    out = log_mel_cuda(wav, spec, fold)
    plain_err = float((plain.double() - exact).abs().max())
    assert float((out.double() - exact).abs().max()) <= max(MEL_ATOL, 4 * plain_err)


def test_log_mel_occupancy_matches_the_host_layout(dev):
    """The source's shared-memory size equals the wrapper's, and the blocks
    per SM the card reports are the wrapper's (two of 64 frames at the HEAR
    spec)."""
    from ssl_audio_tpu_torch.ops.mel_kernel import occupancy

    for win in (400, 1024):
        for fold in (None, False):
            spec = MelSpec(win_length=win)
            ops = kernel_operands(spec, fold)
            for tile in (64, 96):
                occ = occupancy(spec, fold, tile)
                assert occ["smem_bytes"] == ops.smem_bytes(tile), occ
                assert occ["blocks_per_sm"] == ops.blocks_per_sm(tile), occ


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


CONV_SHAPES = [(64, 64, 96), (3, 18, 38), (1, 64, 96), (2, 20, 100), (5, 14, 26)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_fused_conv_kernel_matches_plain(dev, rng, shape):
    """sel, s1, s2 and the eval output, all views of (B, C, H/2, W/2)
    memory; W/2 = 19, 50 and 13 leave ragged groups of cells and no 16-byte
    path, B = 1 a partial last block.  Two launches give the same bits."""
    x, wk, b, g, be, mean, var = (t.to(dev) for t in _conv_inputs(rng, *shape))
    sel, s1, s2 = fused_conv1_fwd_cuda(x, wk, b, g)
    again = fused_conv1_fwd_cuda(x, wk, b, g)
    sel_p, s1_p, s2_p = fused_conv1_fwd_plain(x, wk, b, g)
    out = fused_conv1_bn_relu_pool_eval(x[..., None], wk.reshape(3, 3, 1, -1),
                                        b, g, be, mean, var)
    torch.cuda.synchronize()
    assert all(torch.equal(a, a2) for a, a2 in zip((sel, s1, s2), again))
    for t in (sel, sel_p, out):
        assert nchw_memory(t)
    torch.testing.assert_close(sel, sel_p, atol=CONV_ATOL, rtol=0)
    for a, p in ((s1, s1_p), (s2, s2_p)):
        assert float((a - p).abs().max()) <= STATS_RTOL * float(p.abs().max())
    ref = torch.relu(g * (sel_p - mean) * torch.rsqrt(var + 1e-5) + be)
    torch.testing.assert_close(out, ref, atol=CONV_ATOL, rtol=0)


def _bwd_inputs(rng, dev, shape):
    x, wk, b, g, be, _, _ = (t.to(dev) for t in _conv_inputs(rng, *shape))
    pooled, mean, var = fused_conv1_bn_relu_pool(x[..., None], wk.reshape(3, 3, 1, -1),
                                                 b, g, be)
    dp = torch.from_numpy(rng.standard_normal(tuple(pooled.shape)).astype(np.float32))
    dp = dp.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)   # the forward's layout
    return (x, wk, b, g, mean, torch.rsqrt(var + 1e-5), pooled, dp.to(dev)), be


@pytest.mark.parametrize("shape", [(32, 64, 96), (3, 18, 38), (2, 20, 260), (1, 64, 96),
                                   (5, 14, 26)])
def test_fused_conv_bwd_and_dx_kernels_match_plain(dev, rng, shape):
    """Window ties, negative and zero gammas; (3, 18, 38) and (5, 14, 26)
    leave ragged groups of cells, (2, 20, 260) long rows, B = 1 a partial
    last block.  Two launches of the reduction give the same bits."""
    args, _ = _bwd_inputs(rng, dev, shape)
    before = (fused_conv1_bwd_cuda.launches, fused_conv1_dx_cuda.launches)
    got = fused_conv1_bwd_cuda(*args)
    again = fused_conv1_bwd_cuda(*args)
    ref = fused_conv1_bwd_plain(*args)
    n = float(args[0].numel())
    dy = fused_conv1_dx_cuda(*args, got[0], got[1], n)
    dy_ref = fused_conv1_dx_plain(*args, got[0], got[1], n)
    torch.cuda.synchronize()
    assert (fused_conv1_bwd_cuda.launches, fused_conv1_dx_cuda.launches) == \
        (before[0] + 2, before[1] + 1)
    for name, a, a2, p in zip(("t1", "t2", "sx", "a1", "a2", "gram"), got, again, ref):
        assert torch.equal(a, a2), name
        if name == "sx":         # mathematically 0: float noise against n = B*H*W terms
            assert float(a.abs().max()) <= 1e-5 * n and float(p.abs().max()) <= 1e-5 * n
            continue
        assert float((a - p).abs().max()) <= SUMS_RTOL * float(p.abs().max()), name
    torch.testing.assert_close(dy, dy_ref, atol=DY_ATOL, rtol=0)


def test_fused_conv_kernels_refuse_another_layout(dev, rng):
    """The backward kernels read pooled and its cotangent as the forward
    writes them: a (B, H/2, W/2, C) tensor over channels-last memory is
    refused (the Function converts it first)."""
    args, _ = _bwd_inputs(rng, dev, (2, 8, 12))
    nhwc = args[7].contiguous()
    with pytest.raises(ValueError, match="dpooled"):
        fused_conv1_bwd_cuda(*args[:7], nhwc)
    with pytest.raises(ValueError, match="pooled"):
        fused_conv1_dx_cuda(*args[:6], args[6].contiguous(), args[7], args[4], args[5], 1.0)


@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_fused_block_function_takes_either_cotangent_layout(dev, rng, layout):
    """The Function on the card with its cotangent in either memory layout:
    the same gradients, bit for bit, one forward and one backward launch."""
    x, wk, b, g, be, _, _ = _conv_inputs(rng, 8, 32, 48)
    dp = torch.from_numpy(rng.standard_normal((8, 16, 24, 64)).astype(np.float32)).to(dev)
    grads = {}
    for lay in ("nchw", layout):
        cot = dp.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1) if lay == "nchw" else dp
        ts = [t.clone().to(dev).requires_grad_() for t in
              (x[..., None], wk.reshape(3, 3, 1, -1), b, g, be)]
        before = (fused_conv1_fwd_cuda.launches, fused_conv1_bwd_cuda.launches)
        pooled, _, _ = fused_conv1_bn_relu_pool(*ts)
        pooled.backward(cot)
        torch.cuda.synchronize()
        assert (fused_conv1_fwd_cuda.launches, fused_conv1_bwd_cuda.launches) == \
            (before[0] + 1, before[1] + 1)
        grads[lay] = [t.grad for t in ts]
    for a, w in zip(grads[layout], grads["nchw"]):
        assert torch.equal(a, w)


def test_fused_conv_grid_matches_the_plan(dev):
    """The kernels' block counts are launch_plan()'s, and the registers of
    the backward (128 a thread, the most of the three) leave it 4 blocks of
    128 threads an SM."""
    from ssl_audio_tpu_torch.ops import _build
    from ssl_audio_tpu_torch.ops import fused_conv as fc

    fwd = _build.load("fused_conv_fwd.cu", fc._SIGNATURES)
    bwd = _build.load("fused_conv_bwd.cu", fc._BWD_SIGNATURES)
    for shape in CONV_SHAPES + [(128, 64, 96), (512, 64, 96), (1, 2, 2)]:
        blocks = fc.launch_plan(*shape).blocks
        assert fwd.fused_conv1_fwd_blocks(*shape) == blocks == bwd.fused_conv1_bwd_blocks(*shape)
    for dt in (0, 1):              # the fp32 and the bf16 instantiations
        assert bwd.fused_conv1_bwd_blocks_per_sm(dt) >= 4
        assert fwd.fused_conv1_fwd_blocks_per_sm(0, dt) >= 4
        assert fwd.fused_conv1_fwd_blocks_per_sm(1, dt) >= 4


def test_fused_block_function_card_matches_cpu(dev, rng):
    """The autograd Function on the card (three kernels) against the CPU
    (plain versions): outputs and all five gradients, dx included."""
    x, wk, b, g, be, _, _ = _conv_inputs(rng, 8, 32, 48)
    dp = torch.from_numpy(rng.standard_normal((8, 16, 24, 64)).astype(np.float32))
    results = {}
    for where in ("cpu", dev):
        ts = [t.clone().to(where).requires_grad_() for t in
              (x[..., None], wk.reshape(3, 3, 1, -1), b, g, be)]
        pooled, mean, var = fused_conv1_bn_relu_pool(*ts)
        (pooled * dp.to(where)).sum().backward()
        results[str(where)] = [t.detach().cpu() for t in (pooled, mean, var)] + \
            [t.grad.cpu() for t in ts]
    names = ("pooled", "mean", "var", "dx", "dW", "db", "dgamma", "dbeta")
    for name, a, p in zip(names, results[str(dev)], results["cpu"]):
        if name == "db":         # mathematically 0 on both sides
            assert float(a.abs().max()) < 1e-3 and float(p.abs().max()) < 1e-3
            continue
        scale = max(1.0, float(p.abs().max()))
        torch.testing.assert_close(a, p, atol=1e-4 * scale, rtol=1e-4, msg=name)


def test_fused_block_function_under_no_grad_launches_the_forward_alone(dev, rng):
    """The legacy teacher's block 1: under torch.no_grad() the Function
    launches the statistics-mode forward once, no backward kernel, keeps no
    graph, and gives the bits it gives with a graph."""
    x, wk, b, g, be, _, _ = _conv_inputs(rng, 8, 32, 48)
    ts = [t.to(dev) for t in (x[..., None], wk.reshape(3, 3, 1, -1), b, g, be)]
    before = (fused_conv1_fwd_cuda.launches, fused_conv1_bwd_cuda.launches)
    with torch.no_grad():
        out = fused_conv1_bn_relu_pool(*ts)
    torch.cuda.synchronize()
    assert (fused_conv1_fwd_cuda.launches, fused_conv1_bwd_cuda.launches) == \
        (before[0] + 1, before[1])
    assert all(t.grad_fn is None for t in out)
    graphed = fused_conv1_bn_relu_pool(ts[0], ts[1].clone().requires_grad_(), *ts[2:])
    assert all(torch.equal(a, c) for a, c in zip(out, graphed))


def test_max_pool2d_backward_routes_ties_to_the_first_element_on_the_card(dev):
    """Block 2's reordered pool relies on it, as on the CPU."""
    x = torch.zeros(2, 3, 4, 6, device=dev, requires_grad=True)
    torch.nn.functional.max_pool2d(x, 2).sum().backward()
    want = torch.zeros(4, 6, device=dev)
    want[::2, ::2] = 1.0
    assert torch.equal(x.grad, want.expand_as(x.grad))


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


def _attention_inputs(rng, B, N, C, masked):
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    bias = np.zeros((B, N), np.float32)
    if masked:                    # the ViT's token mask: -1e9 keys, CLS visible
        drop = rng.random((B, N)) < 0.75
        drop[:, 0] = False
        bias[drop] = -1e9
    dout = rng.standard_normal((B, N, C)).astype(np.float32)
    return [torch.from_numpy(a) for a in (qkv, bias, dout)]


def _attention_close(got, want, what, rel_l2=ATTN_REL_L2):
    scale = float(want.abs().max())
    if scale == 0.0:               # N = 1: P = 1, so dS and what follows from it vanish
        assert torch.equal(got, want), what
        return
    assert float((got - want).abs().max()) <= BF16_SPACING * scale, what
    assert float((got - want).double().norm() / want.double().norm()) <= rel_l2, what


@pytest.mark.parametrize("B,N,C,H,masked", [
    (128, 25, 768, 12, False), (128, 25, 768, 12, True),   # ViT-B step, both maskings
    (128, 7, 768, 12, False),                               # token-drop teacher
    (128, 2, 768, 12, False), (128, 3, 768, 12, False),    # DINO local crops: ViT-B, vitc
    (6, 49, 384, 6, True), (3, 33, 64, 2, True),           # two query tiles, hd 64 / 32
    (2, 256, 512, 4, True)])                                # the envelope: N 256, hd 128
def test_fused_attention_kernels_match_plain(dev, rng, B, N, C, H, masked):
    """Forward and backward kernels against their plain versions; dk and dv
    come out as bf16 values; two backward launches give the same bits."""
    qkv, bias, dout = (t.to(dev) for t in _attention_inputs(rng, B, N, C, masked))
    before = (fa.fused_attention_fwd_cuda.launches, fa.fused_attention_bwd_cuda.launches)
    out = fa.fused_attention_fwd_cuda(qkv, bias, H)
    dqkv, dbias = fa.fused_attention_bwd_cuda(qkv, bias, dout, H)
    again = fa.fused_attention_bwd_cuda(qkv, bias, dout, H)
    out_p = fa.fused_attention_fwd_plain(qkv, bias, H)
    dqkv_p, dbias_p = fa.fused_attention_bwd_plain(qkv, bias, dout, H)
    torch.cuda.synchronize()
    assert (fa.fused_attention_fwd_cuda.launches, fa.fused_attention_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 2)
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])
    _attention_close(out, out_p, "out")
    for i, name in enumerate(("dq", "dk", "dv")):
        _attention_close(dqkv[..., i * C:(i + 1) * C], dqkv_p[..., i * C:(i + 1) * C], name)
    _attention_close(dbias, dbias_p, "dbias")
    dkv = dqkv[..., C:]
    assert torch.equal(dkv, dkv.bfloat16().float())


def test_fused_attention_function_launches_both_kernels(dev, rng):
    """The autograd Function on the card: one forward and one backward
    launch, gradients equal to the backward kernel's."""
    qkv, bias, dout = (t.to(dev) for t in _attention_inputs(rng, 4, 25, 192, True))
    x = qkv.clone().requires_grad_()
    b = bias.clone().requires_grad_()
    before = (fa.fused_attention_fwd_cuda.launches, fa.fused_attention_bwd_cuda.launches)
    fa.fused_attention(x, b, 3).backward(dout)
    torch.cuda.synchronize()
    assert (fa.fused_attention_fwd_cuda.launches, fa.fused_attention_bwd_cuda.launches) == \
        (before[0] + 1, before[1] + 1)
    dqkv, dbias = fa.fused_attention_bwd_cuda(qkv, bias, dout, 3)
    assert torch.equal(x.grad, dqkv) and torch.equal(b.grad, dbias)


def _edge_inputs(rng, B, N, C):
    """The ViT's key-bias mask on most samples, and at the end one sample
    with every key but CLS at -1e9 (rows with one live key) and one with
    every key at -1e9 (fully masked rows: uniform over the N real keys)."""
    qkv, bias, dout = _attention_inputs(rng, B, N, C, True)
    bias[-1] = -1e9
    if B > 1:
        bias[-2, 1:] = -1e9
    return qkv, bias, dout


def _check_attention(dev, qkv, bias, dout, H, plan_fwd=None, plan_bwd=None):
    """Both kernels (with the given launch plans, or plan()'s) against the
    plain versions; two backward launches give the same bits; dk and dv are
    bf16 values."""
    C = qkv.shape[-1] // 3
    qkv, bias, dout = (t.to(dev) for t in (qkv, bias, dout))
    if plan_fwd is None:
        out = fa.fused_attention_fwd_cuda(qkv, bias, H)
        dqkv, dbias = fa.fused_attention_bwd_cuda(qkv, bias, dout, H)
        again = fa.fused_attention_bwd_cuda(qkv, bias, dout, H)
    else:
        out = fa._launch_fwd(qkv, bias, H, plan_fwd)
        dqkv, dbias = fa._launch_bwd(qkv, bias, dout, H, plan_bwd)
        again = fa._launch_bwd(qkv, bias, dout, H, plan_bwd)
    out_p = fa.fused_attention_fwd_plain(qkv, bias, H)
    dqkv_p, dbias_p = fa.fused_attention_bwd_plain(qkv, bias, dout, H)
    torch.cuda.synchronize()
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])
    _attention_close(out, out_p, "out")
    for i, name in enumerate(("dq", "dk", "dv")):
        _attention_close(dqkv[..., i * C:(i + 1) * C], dqkv_p[..., i * C:(i + 1) * C], name)
    _attention_close(dbias, dbias_p, "dbias")
    dkv = dqkv[..., C:]
    assert torch.equal(dkv, dkv.bfloat16().float())


@pytest.mark.parametrize("B", [2, 4])
@pytest.mark.parametrize("hd", [8, 32, 64, 128])
@pytest.mark.parametrize("N", [1, 7, 8, 9, 16, 17, 32, 33, 64, 65, 256])
def test_fused_attention_kernel_edges(dev, rng, N, hd, B):
    """Query and key tiles cut at every place (N around 16 and 32, one key,
    the envelope's 256), each padded head width, rows with one live key and
    fully masked rows.  B = 2 at N = 256, hd = 128 is where dK summed over
    queries in another order than the plain version's rounded an element to
    the other bf16 neighbour (1.1e-4 of dk's norm)."""
    H = 2
    _check_attention(dev, *_edge_inputs(rng, B, N, H * hd), H)


@pytest.mark.parametrize("B", [2, 4])
@pytest.mark.parametrize("N,H,hd", [(256, 4, 128), (256, 4, 8), (64, 16, 64), (128, 8, 128),
                                    (32, 32, 32)])
def test_fused_attention_kernels_at_the_envelope_edge(dev, rng, N, H, hd, B):
    """H N = 1024: the most heads the envelope takes at each N; at N = 256,
    hd = 128 the backward takes its query tiles in rounds."""
    if (N, hd) == (256, 128):
        assert fa.plan(B, N, H, hd, True).rounds_tiles < N // 16
    _check_attention(dev, *_edge_inputs(rng, B, N, H * hd), H)


@pytest.mark.parametrize("G", [1, 2, 3, 4, 6, 12])
@pytest.mark.parametrize("N", [25, 7])
def test_fused_attention_every_head_grouping(dev, rng, N, G):
    """The ViT-B shapes with every choice of heads per block that fits a
    block's shared memory (the backward's bias cotangent summed over the
    H / G groups); a G that does not fit is refused by the plan."""
    B, H, hd = 16, 12, 64
    try:
        plans = [fa.plan_for(B, N, H, hd, bwd, G) for bwd in (False, True)]
    except ValueError:
        assert fa.smem_bytes(N, hd, G, 1, True) > fa.SMEM_PER_BLOCK
        return
    _check_attention(dev, *_edge_inputs(rng, B, N, H * hd), H, *plans)


@pytest.mark.parametrize("B", [2, 16])
def test_fused_attention_rounds_of_query_tiles(dev, rng, B):
    """Forced rounds of one and three query tiles at N = 65 (the running
    dK, dV sums kept in device memory between rounds and continued in
    order, rounded after the last round)."""
    N, H, hd = 65, 4, 64
    for R in (1, 3):
        plans = [fa.plan_for(B, N, H, hd, bwd, 2)._replace(rounds_tiles=R)
                 for bwd in (False, True)]
        _check_attention(dev, *_edge_inputs(rng, B, N, H * hd), H, *plans)


def test_fused_attention_layout_matches_the_plan(dev):
    """The kernels' shared-memory bytes and warps per block (C entry points
    of the source) are those of the host's plan() formula."""
    from ssl_audio_tpu_torch.ops import _build
    lib = _build.load("fused_attention.cu", fa._SIGNATURES)
    for N in (1, 7, 16, 25, 33, 65, 200, 256):
        for hd in (8, 40, 64, 96, 128):
            for G in (1, 2, 4):
                for R in range(1, -(-N // 16) + 1):
                    for bwd in (False, True):
                        assert lib.fused_attention_smem_bytes(N, hd, G, R, int(bwd)) == \
                            fa.smem_bytes(N, hd, G, R, bwd), (N, hd, G, R, bwd)
                        assert lib.fused_attention_warps(N, G, R, int(bwd)) == \
                            fa.launch_warps(N, G, R, bwd)


# ------------------------------------------------------------------ bf16
# The bf16 instantiations against the plain versions in bf16 (the tolerances
# of chip_smoke.py): sel and the eval output within one bf16 spacing of each
# element beside CONV_ATOL (near 0 the two sides' fp32 values, cuDNN's conv
# and the fmaf chain, round to bf16 neighbours of values far smaller than
# their difference); fp32 sums as in fp32; attention as in fp32.

BF16 = torch.bfloat16


def _bf16_spacing(t):
    """One bf16 spacing at each element's magnitude (2^(e - 8) for |t| in
    [2^(e-1), 2^e))."""
    _, e = torch.frexp(t.float().abs())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def _bf16_close(got, want, what):
    got, want = got.float(), want.float()
    tol = torch.maximum(_bf16_spacing(got), _bf16_spacing(want)) + CONV_ATOL
    assert bool(((got - want).abs() <= tol).all()), what


@pytest.mark.parametrize("shape", [(128, 64, 96), (3, 18, 38), (1, 64, 96), (5, 14, 26)])
def test_fused_conv_bf16_kernels_match_plain(dev, rng, shape):
    """The forward (statistics and eval) and the backward in bf16: x and
    the parameters bf16, sel, the eval output bf16, the sums fp32; two
    launches give the same bits; the bf16 counters count them, the fp32
    ones do not."""
    x, wk, b, g, be, mean, var = (t.to(dev) for t in _conv_inputs(rng, *shape))
    x, wk, b, g, be = (t.to(BF16) for t in (x, wk, b, g, be))
    before = (fused_conv1_fwd_cuda.launches, fused_conv1_fwd_cuda.launches_bf16,
              fused_conv1_bwd_cuda.launches, fused_conv1_bwd_cuda.launches_bf16)
    sel, s1, s2 = fused_conv1_fwd_cuda(x, wk, b, g)
    again = fused_conv1_fwd_cuda(x, wk, b, g)
    sel_p, s1_p, s2_p = fused_conv1_fwd_plain(x, wk, b, g)
    out = fused_conv1_bn_relu_pool_eval(x[..., None], wk.reshape(3, 3, 1, -1), b, g, be,
                                        mean, var)
    out_p = torch.relu(g.float() * (sel_p.float() - mean) * torch.rsqrt(var + 1e-5)
                       + be.float()).to(BF16)
    assert sel.dtype == out.dtype == BF16 and s1.dtype == torch.float32
    assert all(torch.equal(a, a2) for a, a2 in zip((sel, s1, s2), again))
    assert nchw_memory(sel) and nchw_memory(out)
    _bf16_close(sel, sel_p, "sel")
    _bf16_close(out, out_p, "eval out")
    for a, p in ((s1, s1_p), (s2, s2_p)):
        assert float((a - p).abs().max()) <= STATS_RTOL * float(p.abs().max())
    n = float(x.numel())
    mean_b, var_b = s1 / n, s2 / n - (s1 / n) ** 2
    r = torch.rsqrt(var_b + 1e-5)
    pooled = torch.relu(g.float() * (sel.float() - mean_b) * r + be.float()).to(BF16)
    dp = torch.from_numpy(rng.standard_normal(tuple(pooled.shape)).astype(np.float32))
    dp = dp.to(dev).to(BF16).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    args = (x, wk, b, g, mean_b, r, pooled, dp)
    got = fused_conv1_bwd_cuda(*args, be)
    again = fused_conv1_bwd_cuda(*args, be)
    ref = fused_conv1_bwd_plain(*args, be)
    torch.cuda.synchronize()
    for name, a, a2, p in zip(("t1", "t2", "sx", "a1", "a2", "gram"), got, again, ref):
        assert torch.equal(a, a2), name
        if name == "sx":
            assert float(a.abs().max()) <= 1e-5 * n and float(p.abs().max()) <= 1e-5 * n
            continue
        assert float((a - p).abs().max()) <= SUMS_RTOL * float(p.abs().max()), name
    assert (fused_conv1_fwd_cuda.launches, fused_conv1_fwd_cuda.launches_bf16,
            fused_conv1_bwd_cuda.launches, fused_conv1_bwd_cuda.launches_bf16) == \
        (before[0], before[1] + 3, before[2], before[3] + 2)
    with pytest.raises(ValueError):               # B5 is fp32 only
        fused_conv1_dx_cuda(*args, got[0], got[1], n)
    with pytest.raises(ValueError):               # no mixed types
        fused_conv1_fwd_cuda(x, wk.float(), b, g)


@pytest.mark.parametrize("B,N,C,H,masked", [
    (128, 25, 768, 12, True), (128, 7, 768, 12, False), (3, 33, 64, 2, True),
    (2, 256, 512, 4, True),                       # the envelope: rounds of query tiles
    (128, 2, 768, 12, False), (128, 3, 768, 12, False)])   # DINO local crops
def test_fused_attention_bf16_kernels_match_plain(dev, rng, B, N, C, H, masked):
    """The bf16 instantiations: qkv, dO, O and dqkv bf16, the bias and its
    cotangent fp32; against the plain versions in bf16; two backward
    launches give the same bits; counted as bf16 launches."""
    qkv, bias, dout = (t.to(dev) for t in _attention_inputs(rng, B, N, C, masked))
    qkv, dout = qkv.to(BF16), dout.to(BF16)
    before = (fa.fused_attention_fwd_cuda.launches_bf16,
              fa.fused_attention_bwd_cuda.launches_bf16, fa.fused_attention_fwd_cuda.launches)
    out = fa.fused_attention_fwd_cuda(qkv, bias, H)
    dqkv, dbias = fa.fused_attention_bwd_cuda(qkv, bias, dout, H)
    again = fa.fused_attention_bwd_cuda(qkv, bias, dout, H)
    out_p = fa.fused_attention_fwd_plain(qkv, bias, H)
    dqkv_p, dbias_p = fa.fused_attention_bwd_plain(qkv, bias, dout, H)
    torch.cuda.synchronize()
    assert out.dtype == dqkv.dtype == BF16 and dbias.dtype == torch.float32
    assert (fa.fused_attention_fwd_cuda.launches_bf16,
            fa.fused_attention_bwd_cuda.launches_bf16,
            fa.fused_attention_fwd_cuda.launches) == (before[0] + 1, before[1] + 2, before[2])
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])
    _attention_close(out.float(), out_p.float(), "out")
    for i, name in enumerate(("dq", "dk", "dv")):
        sl = slice(i * C, (i + 1) * C)
        _attention_close(dqkv[..., sl].float(), dqkv_p[..., sl].float(), name, ATTN_REL_L2_BF16)
    _attention_close(dbias, dbias_p, "dbias")


# --------------------------------------------------------------------------
# --steps_per_dispatch: a window of steps as one CUDA graph against the
# same steps taken eagerly, at small shapes

BYOL = dict(stop_gradient=True, predictor=True)
# (overrides, launches per step, the BYOL-style step): the BYOL step runs
# block 1 / every attention block forward four times (online and target on
# both views) and backward through the online net only
GRAPH_CASES = [
    (dict(), {"log_mel_folded": 1, "fused_conv1_fwd": 2, "fused_conv1_bwd": 2}, False),
    (dict(use_fp16=True), {"log_mel_folded": 1, "fused_conv1_fwd_bf16": 2,
                           "fused_conv1_bwd_bf16": 2}, False),
    (dict(model_type="vit_tiny", fused_attention=True),
     {"log_mel_folded": 1, "fused_attention_fwd": 24, "fused_attention_bwd": 24}, False),
    (BYOL, {"log_mel_folded": 1, "fused_conv1_fwd": 4, "fused_conv1_bwd": 2}, True),
    (dict(model_type="vit_tiny", fused_attention=True, **BYOL),
     {"log_mel_folded": 1, "fused_attention_fwd": 48, "fused_attention_bwd": 24}, True),
    # the rest of the encoder zoo: a ResNet launches the log-mel kernel only;
    # SE follows the fused block 1; under --remat every block that takes a
    # gradient runs its attention forward twice (forward and recompute)
    (dict(model_type="resnet18"), {"log_mel_folded": 1}, False),
    (dict(squeeze_excitation=True),
     {"log_mel_folded": 1, "fused_conv1_fwd": 2, "fused_conv1_bwd": 2}, False),
    (dict(model_type="vit_tiny", fused_attention=True, remat=True),
     {"log_mel_folded": 1, "fused_attention_fwd": 48, "fused_attention_bwd": 24}, False),
]
GRAPH_IDS = ["audiontt", "audiontt_bf16", "vit_tiny_fused", "byol_audiontt",
             "byol_vit_tiny_fused", "resnet18", "audiontt_se", "vit_tiny_fused_remat"]


# Two eager runs at these small shapes and cuDNN's default algorithms part
# at step 1 in block 1-2 weight gradients (measured on an H100 80GB HBM3 at
# 700 W: 1.5e-5, losses 3.7e-7 relative apart at step 2 by step_determinism
# --small --steps 3; an eager twin's losses 1.7e-6 apart over 9 steps and
# the graph's 3.6e-6 by --steps_per_dispatch 3); at full width (batch 128)
# they agree bit for bit.  The graph is held to the eager runs' own spread,
# with room: 10x the twin's gap.
EAGER_LOSS_GAP = 2e-5


@pytest.fixture
def deterministic_cudnn():
    """At these small shapes cuDNN's default algorithms part two eager runs
    of AudioNTT (EAGER_LOSS_GAP says by how much): the bit-for-bit
    comparisons take cuDNN's deterministic algorithms, graphed and eager
    alike.  test_graphed_window_at_default_cudnn holds the default choice,
    and chip_smoke.py phase 12 the full-width step at the default choice,
    bit for bit."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = before


def _graphed_against_eager(dev, rng, overrides, byol=False):
    from ssl_audio_tpu_torch.tools.step_determinism import SMALL, SMALL_CLIP_SAMPLES, run_graphed

    wavs = _wav(rng, (SMALL["batch_size"], SMALL_CLIP_SAMPLES)).to(dev)
    return run_graphed(0, 3, 3, dev, wavs, {**SMALL, **overrides}, byol)


@pytest.mark.parametrize("overrides,per_step,byol", GRAPH_CASES, ids=GRAPH_IDS)
def test_graphed_window_equals_eager_steps(dev, rng, deterministic_cudnn, overrides, per_step,
                                           byol):
    """Three windows of 3 steps (eager warm-up, capture and replay, replay)
    against 9 eager steps from the same seed and generator seed: losses,
    every tensor of the train state (a BYOL state's target included) and the
    generators, bit for bit; a replay counts 3 x the step's launches."""
    out = _graphed_against_eager(dev, rng, overrides, byol)
    assert out["first_difference"] is None, out["first_difference"]
    (graph,) = out["graphs"].values()
    assert graph["launches_per_replay"] == {k: 3 * v for k, v in per_step.items()}


# at cuDNN's default algorithms two eager resnet18 runs part by 19 % in a
# loss within 9 steps at these shapes (measured on an H100 80GB HBM3 at
# 700 W): there is no spread to hold its graph to, and its graph is held bit
# for bit under deterministic cuDNN above
DEFAULT_CUDNN_CASES = [c for c, i in zip(GRAPH_CASES, GRAPH_IDS) if i != "resnet18"]
DEFAULT_CUDNN_IDS = [i for i in GRAPH_IDS if i != "resnet18"]


@pytest.mark.parametrize("overrides,per_step,byol", DEFAULT_CUDNN_CASES, ids=DEFAULT_CUDNN_IDS)
def test_graphed_window_at_default_cudnn(dev, rng, overrides, per_step, byol):
    """The same windows at cuDNN's default algorithms, which the package
    runs.  Where two eager runs already part at these shapes, bit for bit is
    out of reach: every step's loss is held within the eager runs' own
    measured spread (EAGER_LOSS_GAP, which the eager twin beside the graph
    must keep too), and what no cuDNN algorithm computes bit for bit: the
    generators, the LR counter and the mixup ring's count and position."""
    out = _graphed_against_eager(dev, rng, overrides, byol)
    final = out["final"]["graphed"]
    assert out["final"]["twin"]["max_loss_rel_gap"] <= EAGER_LOSS_GAP, out["losses"]
    assert final["max_loss_rel_gap"] <= EAGER_LOSS_GAP, out["losses"]
    assert final["generators_equal"]
    differing = {name for name, _ in final["gaps_largest_first"]}
    assert not differing & {"lr_counter", "mixup.count", "mixup.pos"}, differing
    (graph,) = out["graphs"].values()
    assert graph["launches_per_replay"] == {k: 3 * v for k, v in per_step.items()}


def test_trainer_epoch_graphed_equals_one_step_a_dispatch(dev, deterministic_cudnn, tmp_path):
    """The Trainer's epoch of 7 steps at --steps_per_dispatch 3 (an eager
    window, a graphed one, a 1-step tail) against the same epoch one step at
    a time; then a checkpoint of the graphed run resumes into a new Trainer
    whose windows capture their own graphs."""
    from ssl_audio_tpu_torch.config import config_from_args
    from ssl_audio_tpu_torch.tools.step_determinism import tensor_gaps, train_state_tensors
    from ssl_audio_tpu_torch.train.loop import Trainer

    argv = ["--dataset", "synthetic_wav", "--batch_size", "8", "--crop_frames", "32",
            "--projector_hidden_dim", "256", "--mixup_n_memory", "12", "--epochs", "2",
            "--synthetic_steps_per_epoch", "7", "--num_workers", "2"]
    runs = []
    for n in ("1", "3"):
        tr = Trainer(config_from_args([*argv, "--steps_per_dispatch", n]), log=lambda l: None)
        tr.train_one_epoch(1)
        runs.append(tr)
    single, graphed = runs
    assert list(graphed.multi_step.graphs) == [None]
    assert tensor_gaps(train_state_tensors(graphed.state), train_state_tensors(single.state)) == {}
    assert graphed.epoch_losses == single.epoch_losses
    assert torch.equal(graphed.gen.get_state(), single.gen.get_state())
    assert graphed.state.step == 7 and int(graphed.state.lr_schedule.counter) == 7
    from ssl_audio_tpu_torch.utils import checkpoint as ckpt

    path = str(tmp_path / "model_1.pt")
    ckpt.save_checkpoint(path, graphed.state, 2, ckpt.encode_rng(graphed.gen, graphed.host_rng))
    resumed = Trainer(config_from_args([*argv, "--steps_per_dispatch", "3"]),
                      log=lambda l: None)
    resumed.fit(resume_path=path)
    graphed.train_one_epoch(2)
    assert tensor_gaps(train_state_tensors(resumed.state),
                       train_state_tensors(graphed.state)) == {}
    assert resumed.epoch_losses[2] == graphed.epoch_losses[2]


@pytest.mark.parametrize("overrides,zero_grad,grad_rtol", [
    (dict(), ("encoder.features.0.bias", "encoder.features.4.bias"), 3e-2),
    (dict(model_type="vit_tiny", fused_attention=True, mask=True), ("encoder.norm.bias",), 0.3),
], ids=["audiontt", "vit_tiny_fused"])
def test_byol_step_card_matches_cpu(dev, rng, overrides, zero_grad, grad_rtol):
    """One BYOL step (--stop_gradient --predictor, batch 8) on the card
    against the same step on the CPU from the same seeded weights, wavs and
    draws: the loss within 1e-3, the online gradients per tensor within
    chip_smoke.py's step limits (relative L2: pool / ReLU decisions, and for
    the fused attention bf16 roundings, flip on 1e-7 differences), no
    gradient on the target, and the target after the EMA (of the pre-step
    online parameters, equal on both sides) within 1e-6 of its largest
    value."""
    from ssl_audio_tpu_torch.tools.step_determinism import SMALL, SMALL_CLIP_SAMPLES
    from ssl_audio_tpu_torch.tools.train_profile import seeded_training
    from ssl_audio_tpu_torch.train.steps import draw_step

    wavs = _wav(rng, (SMALL["batch_size"], SMALL_CLIP_SAMPLES))
    runs = []
    for where in ("cpu", dev):
        cfg, state, step, _ = seeded_training(0, where, byol=True, **SMALL, **BYOL, **overrides)
        draws = draw_step(torch.Generator().manual_seed(9), cfg, tuple(wavs.shape),
                          state.modules["encoder"], wav=True, byol=True)
        loss = float(step(state, wavs.to(where), draws=draws.to(where), mask_ratio=0.5)["loss"])
        assert all(p.grad is None for p in state.modules["target"].parameters())
        grads = {k: p.grad.cpu() for k, p in state.modules.named_parameters()
                 if p.grad is not None}
        target = {k: p.detach().cpu() for k, p in state.modules["target"].named_parameters()}
        runs.append((loss, grads, target))
    (loss_c, grads_c, target_c), (loss_d, grads_d, target_d) = runs
    assert abs(loss_d - loss_c) <= 1e-3 * abs(loss_c)
    assert set(grads_c) == set(grads_d) and not any(k.startswith("target.") for k in grads_c)
    for k, g in grads_c.items():
        if k not in zero_grad:
            assert float((grads_d[k] - g).norm() / g.norm()) <= grad_rtol, k
    for k, t in target_c.items():
        assert float((target_d[k] - t).abs().max()) <= 1e-6 * float(t.abs().max()), k


@pytest.mark.parametrize("overrides,per_step,zero_grad,grad_rtol", [
    (dict(model_type="resnet18_ReGP_NRF"), {"log_mel_folded": 1}, (), 3e-2),
    (dict(squeeze_excitation=True),
     {"log_mel_folded": 1, "fused_conv1_fwd": 2, "fused_conv1_bwd": 2},
     ("encoder.features.0.bias", "encoder.features.5.bias"), 3e-2),
    (dict(model_type="vit_tiny", fused_attention=True, remat=True, mask=True),
     {"log_mel_folded": 1, "fused_attention_fwd": 48, "fused_attention_bwd": 24},
     ("encoder.norm.bias",), 0.3),
], ids=["resnet18_regp_nrf", "audiontt_se", "vit_tiny_fused_remat"])
def test_zoo_step_card_matches_cpu(dev, rng, overrides, per_step, zero_grad, grad_rtol):
    """One Barlow Twins step (batch 8) of each new encoder on the card against
    the same step on the CPU from the same seeded weights, wavs and draws:
    the card's launches, the loss within 1e-3 and the gradients per tensor
    within chip_smoke.py's step limits (relative L2)."""
    from ssl_audio_tpu_torch import ops
    from ssl_audio_tpu_torch.tools.step_determinism import SMALL, SMALL_CLIP_SAMPLES
    from ssl_audio_tpu_torch.tools.train_profile import seeded_training
    from ssl_audio_tpu_torch.train.steps import draw_step

    wavs = _wav(rng, (SMALL["batch_size"], SMALL_CLIP_SAMPLES))
    runs = []
    for where in ("cpu", dev):
        cfg, state, step, _ = seeded_training(0, where, **SMALL, **overrides)
        draws = draw_step(torch.Generator().manual_seed(9), cfg, tuple(wavs.shape),
                          state.modules["encoder"], wav=True)
        ops.zero_launch_counts()
        loss = float(step(state, wavs.to(where), draws=draws.to(where), mask_ratio=0.5)["loss"])
        if where == dev:
            assert {k: v for k, v in ops.launch_counts().items() if v} == per_step
        runs.append((loss, {k: p.grad.cpu() for k, p in state.modules.named_parameters()
                            if p.grad is not None}))
    (loss_c, grads_c), (loss_d, grads_d) = runs
    assert abs(loss_d - loss_c) <= 1e-3 * abs(loss_c)
    assert set(grads_c) == set(grads_d)
    for k, g in grads_c.items():
        if k not in zero_grad:
            assert float((grads_d[k] - g).norm() / g.norm()) <= grad_rtol, k


@pytest.mark.parametrize("overrides,batch,per_step,loss_rtol", [
    ({}, 16, {"log_mel_folded": 1, "fused_conv1_fwd": 2, "fused_conv1_bwd": 2}, 1e-4),
    (dict(model_type="vit_tiny", fused_attention=True, mask=True, mask_ratio=0.75,
          token_drop=False), 16,
     {"log_mel_folded": 1, "fused_attention_fwd": 24, "fused_attention_bwd": 24}, 1e-3),
], ids=["audiontt", "vit_tiny_fused"])
def test_two_gloo_ranks_on_one_card_are_one_process(dev, overrides, batch, per_step, loss_rtol):
    """One data-parallel step on two gloo ranks sharing the card (each 8 of
    the batch's 16 rows; the real kernels with the cross-rank sums between
    their launches) against one process on the whole batch with world_scale
    2: the ranks bit for bit, the loss within chip_smoke.py's DP_RTOL
    (DP_FUSED_LOSS_RTOL with the fused attention, whose bf16 operands turn
    the ranks' other fp32 GEMM roundings into 2.6e-4 of the loss at these
    shapes) and the parameters after the step as one vector within
    DP_RTOL, every launch counted on each rank."""
    from ssl_audio_tpu_torch.tools import data_parallel

    ref = data_parallel.one_process_step(0, overrides, batch)
    ranks, _ = data_parallel.two_ranks_on_one_card(0, {"run": (overrides, batch)})
    r0, r1 = ranks["run"]
    assert r0["loss"] == r1["loss"] and r0["params_sha256"] == r1["params_sha256"]
    assert data_parallel.digest(r0["params"]) == r0["params_sha256"]
    assert abs(r0["loss"] - ref["loss"]) <= loss_rtol * abs(ref["loss"])
    gap = (r0["params"].double() - ref["params"].double()).norm()
    assert float(gap / ref["params"].double().norm()) <= 1e-4
    for r in (r0, r1, ref):
        assert {k: v for k, v in r["launches"].items() if v} == per_step
