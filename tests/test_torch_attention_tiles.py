"""The fused attention kernels' order of work (csrc/fused_attention.cu),
emulated in PyTorch on the CPU and held against the plain versions
(ssl_audio_tpu_torch/ops/fused_attention.py), and the launch plan over the
whole supports() envelope.  No JAX: these add seconds to the suite.

The emulation follows the kernels tile by tile: queries and keys padded to
16-row tiles, padded keys at -inf, q / dO staged in rounds of R query tiles
(the plan's), the softmax in two passes over the key tiles (max, then the
sum of expf(s - max)) before the normalised P is rounded, c = rowsum(dP * P)
over every key tile, dQ summed over key tiles in order, dK and dV summed
over queries one at a time in order, the running sums carried from round to
round and rounded to bf16 after the last (the plain version's order, term
for term), the bias cotangent summed per head over queries, then over the
block's G heads, then over the H / G groups.  The tile products of P V, dP
and dQ are fp32 matmuls of bf16 values (exact products, as on the tensor
cores; the order of the sums inside a tile is the library's).

Tolerances: those of the kernels against their plain versions (chip_smoke.py,
tests/test_torch_kernels_cuda.py): one bf16 spacing (2^-7) of max|ref| and
1e-4 relative L2, for an operand or output that rounds the other way.  Every
case runs at B = 2 and B = 4."""
import numpy as np
import pytest
import torch

from ssl_audio_tpu_torch.ops import fused_attention as fa


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One torch thread for the module's tests and fixtures
    (tests/test_torch_checkpoint.py says why: under the suite's six workers a
    pool of threads per worker made this file's tests tens of times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


T = fa.TILE
BF16_SPACING = 2.0 ** -7
REL_L2 = 1e-4


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _padded(qkv, bias, dout, heads):
    """(B, H, np, hd) bf16-valued q, k, v (and dO), zero rows past N; the
    key bias (B, np) with -inf on the padded keys."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    np_ = -(-N // T) * T

    def heads_of(x):
        out = torch.zeros(B, heads, np_, C // heads)
        out[:, :, :N] = _bf16(x.reshape(B, N, heads, C // heads).transpose(1, 2))
        return out

    q, k, v = (heads_of(qkv[..., i * C:(i + 1) * C]) for i in range(3))
    b = torch.full((B, np_), -torch.inf)
    b[:, :N] = bias
    return q, k, v, (heads_of(dout) if dout is not None else None), b, np_


def _scores(qt, k, b, kt, scale):
    """(q . k^T) * scale + bias for a query tile against key tile kt."""
    ks = slice(kt * T, (kt + 1) * T)
    return torch.matmul(qt, k[:, :, ks].transpose(-1, -2)) * scale + b[:, None, None, ks]


def _row_stats(qt, k, b, scale, nkt):
    m = torch.full(qt.shape[:-1], -torch.inf)
    for kt in range(nkt):
        m = torch.maximum(m, _scores(qt, k, b, kt, scale).amax(-1))
    d = torch.zeros_like(m)
    for kt in range(nkt):
        d = d + torch.exp(_scores(qt, k, b, kt, scale) - m[..., None]).sum(-1)
    return m, d


def emulate_fwd(qkv, bias, heads, rounds_tiles):
    B, N, C3 = qkv.shape
    scale = fa._scale(C3 // 3, heads)
    q, k, v, _, b, np_ = _padded(qkv, bias, None, heads)
    nkt = np_ // T
    out = torch.zeros_like(q)
    for r0 in range(0, np_, rounds_tiles * T):
        for t0 in range(r0, min(r0 + rounds_tiles * T, np_), T):
            qt = q[:, :, t0:t0 + T]
            m, d = _row_stats(qt, k, b, scale, nkt)
            o = torch.zeros_like(qt)
            for kt in range(nkt):
                p = torch.exp(_scores(qt, k, b, kt, scale) - m[..., None]) / d[..., None]
                o = o + torch.matmul(_bf16(p), v[:, :, kt * T:(kt + 1) * T])
            out[:, :, t0:t0 + T] = o
    return out[:, :, :N].transpose(1, 2).reshape(B, N, C3 // 3)


def emulate_bwd(qkv, bias, dout, heads, heads_per_block, rounds_tiles):
    B, N, C3 = qkv.shape
    C = C3 // 3
    scale = fa._scale(C, heads)
    q, k, v, do, b, np_ = _padded(qkv, bias, dout, heads)
    nkt, rq = np_ // T, rounds_tiles * T
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    db = torch.zeros(B, heads, np_)
    rounds = list(range(0, np_, rq))
    for ri, r0 in enumerate(rounds):
        rows = min(rq, N - r0)
        m, d, c = (torch.zeros(B, heads, rq) for _ in range(3))
        # phase A: per query tile, row statistics, c, dQ
        for t0 in range(0, rq, T):
            if t0 >= rows:
                continue
            qt, dot = q[:, :, r0 + t0:r0 + t0 + T], do[:, :, r0 + t0:r0 + t0 + T]
            mt, dt = _row_stats(qt, k, b, scale, nkt)
            ct = torch.zeros_like(mt)
            for kt in range(nkt):
                p = torch.exp(_scores(qt, k, b, kt, scale) - mt[..., None]) / dt[..., None]
                dp = torch.matmul(dot, v[:, :, kt * T:(kt + 1) * T].transpose(-1, -2))
                ct = ct + (dp * p).sum(-1)
            acc = torch.zeros_like(qt)
            for kt in range(nkt):
                p = torch.exp(_scores(qt, k, b, kt, scale) - mt[..., None]) / dt[..., None]
                dp = torch.matmul(dot, v[:, :, kt * T:(kt + 1) * T].transpose(-1, -2))
                ds = dp * p - p * ct[..., None]
                acc = acc + torch.matmul(_bf16(ds), k[:, :, kt * T:(kt + 1) * T])
            dq[:, :, r0 + t0:r0 + t0 + T] = acc * scale
            m[..., t0:t0 + T], d[..., t0:t0 + T], c[..., t0:t0 + T] = mt, dt, ct
        # phase B: per key tile, the transposed tiles over the round's queries
        valid = torch.arange(rq) < rows
        for kt in range(nkt):
            ks = slice(kt * T, (kt + 1) * T)
            # the running sums over queries: from 0, or from the last round's
            ak, av = ((torch.zeros_like(q[:, :, ks]), torch.zeros_like(q[:, :, ks])) if ri == 0
                      else (dk[:, :, ks], dv[:, :, ks]))
            dbt = torch.zeros(B, heads, T)
            for t0 in range(0, rows, T):
                qs, cols = slice(r0 + t0, r0 + t0 + T), slice(t0, t0 + T)
                st = torch.matmul(k[:, :, ks], q[:, :, qs].transpose(-1, -2)) * scale \
                    + b[:, None, ks, None]
                p = torch.exp(st - m[..., None, cols]) / d[..., None, cols]
                p = torch.where(valid[cols], p, 0.0)
                dpt = torch.matmul(v[:, :, ks], do[:, :, qs].transpose(-1, -2))
                ds = torch.where(valid[cols], dpt * p - p * c[..., None, cols], 0.0)
                dbt = dbt + ds.sum(-1)
                p16, ds16 = _bf16(p), _bf16(ds)
                for i in range(min(T, rows - t0)):       # one query at a time, in order
                    qi = r0 + t0 + i
                    av = av + p16[..., i, None] * do[:, :, qi, None, :]
                    ak = ak + ds16[..., i, None] * q[:, :, qi, None, :]
            if ri == len(rounds) - 1:
                ak, av = _bf16(ak * scale), _bf16(av)
            dk[:, :, ks], dv[:, :, ks] = ak, av
            db[:, :, ks] = dbt if ri == 0 else db[:, :, ks] + dbt
    groups = db[..., :N].reshape(B, heads // heads_per_block, heads_per_block, N).sum(2)
    dqkv = torch.cat([g[:, :, :N].transpose(1, 2).reshape(B, N, C) for g in (dq, dk, dv)], -1)
    return dqkv, groups.sum(1)


def inputs(B, N, C, masked, seed=0):
    """Seeded qkv, key bias and dO; masked: -1e9 on ~3/4 of the keys but
    CLS, and on every key of the last sample but one (a row with one live
    key); full: on every key of the last sample."""
    rng = np.random.default_rng(seed + N + C)
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    bias = np.zeros((B, N), np.float32)
    if masked == "keys":
        drop = rng.random((B, N)) < 0.75
        drop[:, 0] = False
        bias[drop] = -1e9
        bias[-1, 1:] = -1e9
    elif masked == "full":
        bias[-1] = -1e9
    dout = rng.standard_normal((B, N, C)).astype(np.float32)
    return [torch.from_numpy(a) for a in (qkv, bias, dout)]


def close(got, want, what):
    """Within one bf16 spacing of max|want| and REL_L2; exact where want is
    0 (N = 1: P = 1, so dS, dq, dk and the bias cotangent vanish)."""
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if scale == 0.0:
        assert err == 0.0, f"{what}: {err} where the plain version gives 0"
        return
    rel = float((got - want).double().norm() / want.double().norm())
    assert err <= BF16_SPACING * scale, f"{what}: {err} of {scale}"
    assert rel <= REL_L2, f"{what}: relative L2 {rel}"


SEQS = [1, 7, 8, 9, 16, 25, 32, 33, 64, 65, 256]
BATCHES = [2, 4]
WIDTHS = [8, 64, 128]


def _heads(N):
    return 2 if N < 256 else 4           # H N <= 1024 at the envelope's edge


@pytest.mark.parametrize("hd", WIDTHS)
@pytest.mark.parametrize("N", SEQS)
def test_emulated_forward_matches_plain(N, hd):
    H = _heads(N)
    qkv, bias, _ = inputs(4, N, H * hd, "keys" if N > 1 else None)
    p = fa.plan(4, N, H, hd, False)
    close(emulate_fwd(qkv, bias, H, p.rounds_tiles),
          fa.fused_attention_fwd_plain(qkv, bias, H), f"out N={N} hd={hd}")


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("hd", WIDTHS)
@pytest.mark.parametrize("N", SEQS)
def test_emulated_backward_matches_plain(N, hd, B):
    """B = 2 at N = 256, hd = 128 with three quarters of the keys masked is
    the case where dK summed over queries in another order than the plain
    product rounded one element to the other bf16 neighbour (1.1e-4 of dk's
    norm)."""
    H = _heads(N)
    qkv, bias, dout = inputs(B, N, H * hd, "keys" if N > 1 else None)
    p = fa.plan(B, N, H, hd, True)
    dqkv, dbias = emulate_bwd(qkv, bias, dout, H, p.heads_per_block, p.rounds_tiles)
    dqkv_p, dbias_p = fa.fused_attention_bwd_plain(qkv, bias, dout, H)
    C = H * hd
    for i, name in enumerate(("dq", "dk", "dv")):
        close(dqkv[..., i * C:(i + 1) * C], dqkv_p[..., i * C:(i + 1) * C], f"{name} N={N}")
    close(dbias, dbias_p, f"dbias N={N} hd={hd}")
    assert torch.equal(dqkv[..., C:], _bf16(dqkv[..., C:]))


@pytest.mark.parametrize("G,R", [(1, 1), (2, 1), (2, 3), (4, 2)])
def test_emulated_rounds_and_head_groups_match_plain(G, R):
    """Rounds of R query tiles (partials of dK, dV added in order, rounded
    after the last) and G heads per block give the plain results at N = 65."""
    qkv, bias, dout = inputs(3, 65, 4 * 32, "keys")
    close(emulate_fwd(qkv, bias, 4, R), fa.fused_attention_fwd_plain(qkv, bias, 4), "out")
    dqkv, dbias = emulate_bwd(qkv, bias, dout, 4, G, R)
    dqkv_p, dbias_p = fa.fused_attention_bwd_plain(qkv, bias, dout, 4)
    close(dqkv, dqkv_p, "dqkv")
    close(dbias, dbias_p, "dbias")


@pytest.mark.parametrize("N", [7, 25, 33])
def test_fully_masked_row_is_uniform_over_real_keys(N):
    """Every key of a sample at -1e9: the padded keys at -inf weigh 0 and
    every row of that sample is the plain version's uniform row, bf16(1/N)
    times the sum of v."""
    H, hd = 2, 64
    qkv, bias, dout = inputs(2, N, H * hd, "full")
    out = emulate_fwd(qkv, bias, H, fa.plan(2, N, H, hd, False).rounds_tiles)
    want = fa.fused_attention_fwd_plain(qkv, bias, H)
    close(out, want, "out")
    v = _bf16(qkv[-1, :, 2 * H * hd:])
    uniform = (_bf16(torch.tensor(1.0 / N)) * v).sum(0).expand(N, -1)
    assert torch.allclose(want[-1], uniform, atol=1e-5)
    assert torch.allclose(out[-1], uniform, atol=1e-5)
    dqkv, dbias = emulate_bwd(qkv, bias, dout, H, 1, fa.plan(2, N, H, hd, True).rounds_tiles)
    dqkv_p, dbias_p = fa.fused_attention_bwd_plain(qkv, bias, dout, H)
    close(dqkv, dqkv_p, "dqkv")
    close(dbias, dbias_p, "dbias")


def test_plan_covers_the_envelope():
    """Over supports()'s envelope every launch fits a block's shared memory,
    takes at most MAX_WARPS warps, and its blocks and rounds cover every
    head and query."""
    for hd in (8, 16, 24, 32, 40, 64, 96, 120, 128):
        for H in (1, 2, 3, 4, 12):
            for N in range(1, fa.MAX_SEQ + 1):
                if not fa.supports(128, N, H * hd, H):
                    continue
                for backward in (False, True):
                    p = fa.plan(128, N, H, hd, backward)
                    assert H % p.heads_per_block == 0
                    assert p.blocks * p.heads_per_block == 128 * H
                    assert p.smem == fa.smem_bytes(N, hd, p.heads_per_block, p.rounds_tiles,
                                                   backward) <= fa.SMEM_PER_BLOCK
                    assert 1 <= p.warps <= fa.MAX_WARPS
                    ntiles = -(-N // T)
                    assert 1 <= p.rounds_tiles <= ntiles
                    if p.rounds_tiles < ntiles:
                        assert N > 64, (N, hd, H, p)


def test_plan_at_the_vit_b_step():
    """The ViT-B step's shapes keep every query tile resident (one round)."""
    for N in (25, 7):
        for backward in (False, True):
            p = fa.plan(128, N, 12, 64, backward)
            assert p.rounds_tiles == -(-N // T)
            assert p.smem < 100_000


def test_smem_bytes_formula():
    """The layout of csrc/fused_attention.cu, spelled out at N = 25, hd = 64,
    R = 2, backward.  G = 1: K, V, q, dO tiles of 32 rows x 72 bf16; the bias
    (32), the column sums (2 x 32) and the bias cotangent (32) in fp32; then
    the larger of the score rows (32 query rows: fp32 score and dP * P rows
    of 34, bf16 P and dS rows of 40) and the cp.async ring, where each of 64
    threads holds its 7 chunks of 25 rows x 16 chunks of each of k, v, q and
    dO.  G = 4: 256 threads, a 32 KB ring of 8 slots each."""
    assert fa.ring_slots(25, 64, 1, 2, True) == 28
    assert fa.smem_bytes(25, 64, 1, 2, True) == 4 * 32 * 72 * 2 + 4 * (32 + 64 + 32) \
        + max(32 * (2 * 4 * 34 + 2 * 2 * 40), 16 * 64 * 28)
    assert fa.ring_slots(25, 64, 4, 2, True) == 8
    assert fa.smem_bytes(25, 64, 4, 2, False) == 3 * 4 * 32 * 72 * 2 + 4 * 32 \
        + max(4 * 32 * (4 * 34 + 2 * 40), 16 * 256 * 8)
    assert fa.launch_warps(25, 4, 2, True) == 8
    assert fa.launch_warps(7, 1, 1, False) == 1
    assert fa.launch_warps(256, 1, 8, True) == 8
