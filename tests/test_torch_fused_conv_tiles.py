"""The fused conv kernels' host-side plan (ssl_audio_tpu_torch/ops/fused_conv.py
launch_plan, the grid of csrc/fused_conv_fwd.cu and fused_conv_bwd.cu) and
their order of work, emulated in PyTorch on the CPU and held against the
plain versions.  No JAX: these add seconds to the suite.

The emulation follows the kernels: a thread per group of CELLS window cells
of one window row (groups numbered row-major over (b, i, j / CELLS), the last
of a row ragged where W/2 is not a multiple of CELLS), its 4 x (2 CELLS + 2)
input patch with zeros outside the image, the conv as one fmaf chain per
output starting at the bias (taps row-major), a thread's sums over its
cells in order, a warp's (32 consecutive groups) by halving exchanges
(warp_reduce_scatter), a block's warps in order, and the blocks by
reduce_columns_kernel's fixed order.  The kernels' sign fold (the extreme
as a max of -y for gamma <= 0) gives y's values bit for bit and is not
emulated.  fmaf is emulated in float64 (the
product of two fp32 values is exact there) rounded once to fp32.

Tolerances: those of the kernels against their plain versions (chip_smoke.py):
sel 1e-4 absolute (conv sums in another order), s1 / s2 and the backward's
sums 1e-4 of their largest value (fp32 sums in another order)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssl_audio_tpu_torch.ops import fused_conv as fc
from tests.test_torch_checkpoint import one_intra_op_thread  # noqa: F401  (autouse fixture)

CONV_ATOL = 1e-4
SUMS_RTOL = 1e-4
C = fc.C_OUT
LANES = 32
PW = 2 * fc.CELLS + 2          # input patch columns of a thread

# (B, H, W): the main path's shapes (training view, serving chunk), B = 1, and
# ragged edges: W/2 = 19, 50, 13, 1 (not multiples of CELLS), a partial last block
SHAPES = [(128, 64, 96), (512, 64, 96), (1, 64, 96), (3, 18, 38), (2, 20, 100),
          (5, 14, 26), (1, 2, 2), (2, 6, 8)]
SMALL = [(3, 18, 38), (2, 20, 100), (1, 8, 96), (2, 6, 10)]


def groups(B, H, W):
    """group_of() for every thread of the grid -> (b, i, j0, n) arrays; n = 0
    for the threads past the last group."""
    plan = fc.launch_plan(B, H, W)
    h2, w2, g4 = H // 2, W // 2, plan.groups_per_row
    g = np.arange(plan.blocks * fc.THREADS)
    live = g < B * h2 * g4
    b = g // (h2 * g4)
    rem = g - b * h2 * g4
    i = rem // g4
    j0 = fc.CELLS * (rem - i * g4)
    n = np.where(live, np.minimum(fc.CELLS, w2 - j0), 0)
    return b, i, j0, n


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_window_cell_once(shape):
    B, H, W = shape
    plan = fc.launch_plan(B, H, W)
    h2, w2 = H // 2, W // 2
    assert plan.groups_per_row == -(-w2 // fc.CELLS)
    assert (plan.blocks - 1) * fc.THREADS < plan.groups <= plan.blocks * fc.THREADS
    b, i, j0, n = groups(B, H, W)
    count = np.zeros((B, h2, w2), np.int64)
    for k in range(fc.CELLS):
        m = k < n
        np.add.at(count, (b[m], i[m], j0[m] + k), 1)
    assert (count == 1).all()
    assert int(n.sum()) == B * h2 * w2


@pytest.mark.parametrize("shape", SHAPES)
def test_vector_accesses_are_aligned(shape):
    """Where a thread takes its 16-byte path (a full group and W/2 a multiple
    of 4) every channel plane offset of its cells, and the first inner
    column of its input patch, are multiples of 4 floats."""
    B, H, W = shape
    h2, w2 = H // 2, W // 2
    b, i, j0, n = groups(B, H, W)
    vec = (n == fc.CELLS) & (w2 % 4 == 0)
    for c in (0, 1, C - 1):
        assert ((((b * C + c) * h2 + i) * w2 + j0)[vec] % 4 == 0).all()
    if W % 4 == 0:
        assert ((2 * j0[n == fc.CELLS]) % 4 == 0).all()


def test_grid_at_the_main_path_shapes():
    """One view of the training step: 384 blocks, all resident at once at 3
    blocks per SM; the serving chunk 1,536 blocks; static shared memory
    under the 48 KB a block gets without opting in."""
    assert fc.launch_plan(128, 64, 96).blocks == 384
    assert fc.launch_plan(512, 64, 96).blocks == 1536
    assert fc.waves(384, 3) < 1.0
    assert fc.waves(1536, 7) == pytest.approx(1536 / (7 * 132))
    assert fc.SMEM_FWD == 6144 and fc.SMEM_BWD == 17408
    assert max(fc.SMEM_FWD, fc.SMEM_BWD) < 48 * 1024


# ---------------------------------------------------------------------------
# emulation
# ---------------------------------------------------------------------------

def f32(t):
    return t.to(torch.float32)


def fma(a, b, c):
    """fmaf: a * b + c rounded once to fp32 (the product is exact in float64)."""
    return f32(a.double() * b.double() + c.double())


def patches(x, B, H, W):
    """Every thread's 4 x (2 CELLS + 2) input patch: rows 2i-1 .. 2i+2,
    columns 2 j0 - 1 .. 2 j0 + 2 CELLS, zeros outside the image."""
    b, i, j0, n = groups(B, H, W)
    live = n > 0
    pad = F.pad(x, (1, 2 * fc.CELLS + 1, 1, 1))          # (B, H + 2, W + 2 CELLS + 2)
    rows = torch.from_numpy(2 * i[live])[:, None, None] + torch.arange(4)[None, :, None]
    cols = torch.from_numpy(2 * j0[live])[:, None, None] + torch.arange(PW)[None, None, :]
    p = pad[torch.from_numpy(b[live])[:, None, None], rows, cols]
    return p, (b[live], i[live], j0[live], n[live])


def conv_at(p, wk, bias, r, col):
    """y for every patch and channel at patch offset (r, col): the chain
    starts at the bias and takes the taps row-major, one fmaf each.
    p (T, 4, PW), wk (9, C) -> (T, C)."""
    acc = bias[None, :].expand(p.shape[0], -1)
    for dh in range(3):
        for dw in range(3):
            acc = fma(wk[dh * 3 + dw][None, :], p[:, r + dh, col + dw][:, None], acc)
    return acc


def corners(p, wk, bias, k):
    return [conv_at(p, wk, bias, q // 2, 2 * k + q % 2) for q in range(4)]


def extreme(v, pos):
    mx = torch.maximum(torch.maximum(v[0], v[1]), torch.maximum(v[2], v[3]))
    mn = torch.minimum(torch.minimum(v[0], v[1]), torch.minimum(v[2], v[3]))
    return torch.where(pos[None, :], mx, mn)


def warp_reduce_scatter(v):
    """The halving exchanges over 32 lanes: v (32, ..., N) -> (held (32, ...,
    N / 32 or 1), base (32,)), lane l holding the totals of values base[l] ..."""
    lanes = torch.arange(LANES)
    n = v.shape[-1]
    base = torch.zeros(LANES, dtype=torch.long)
    for m in (16, 8, 4, 2, 1):
        partner = lanes ^ m
        up = ((lanes & m) != 0).view(-1, *([1] * (v.dim() - 1)))
        if n > 1:
            h = n // 2
            send = torch.where(up, v[..., :h], v[..., h:n])
            keep = torch.where(up, v[..., h:n], v[..., :h])
            v = keep + send[partner]
            base = base + (lanes & m != 0).long() * h
            n = h
        else:
            v = v + v[partner]
    return v, base


def lanes_to_values(v):
    """The totals a warp holds after warp_reduce_scatter, as (..., N)."""
    held, base = warp_reduce_scatter(v)
    N = v.shape[-1]
    out = torch.full(v.shape[1:], float("nan"))
    for lane in range(LANES):
        for s in range(held.shape[-1]):
            idx = int(base[lane]) + s
            if torch.isnan(out[..., idx]).all():
                out[..., idx] = held[lane, ..., s]
            else:                        # lanes that hold the same total agree
                assert torch.equal(out[..., idx], held[lane, ..., s])
    assert not torch.isnan(out).any(), N
    return out


def per_block(per_group, blocks):
    """Sums per group (G, ..., N) -> per warp of 32 consecutive groups by the
    halving exchanges -> per block, its warps in order: (blocks, ..., N)."""
    full = torch.zeros(blocks * fc.THREADS, *per_group.shape[1:])
    full[:per_group.shape[0]] = per_group
    wps = fc.THREADS // LANES
    lanes = full.view(blocks, wps, LANES, *per_group.shape[1:])
    per_warp = lanes_to_values(lanes.movedim(2, 0))            # (blocks, wps, ..., N)
    out = torch.zeros(blocks, *per_group.shape[1:])
    for wp in range(wps):
        out = out + per_warp[:, wp]
    return out


def reduce_columns(partials):
    """reduce_columns_kernel: 16 lanes per column each add every 16th row
    in order, then the lanes in order.  partials (rows, K) -> (K,)."""
    rows = partials.shape[0]
    lanes = [torch.zeros(partials.shape[1:]) for _ in range(16)]
    for row in range(rows):
        lanes[row % 16] = lanes[row % 16] + partials[row]
    total = torch.zeros(partials.shape[1:])
    for lane in lanes:
        total = total + lane
    return total


def inputs(B, H, W, seed=0):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((B, H, W)) * 2) / 2          # window ties
    wk = 0.3 * rng.standard_normal((9, C))
    bias = 0.1 * rng.standard_normal(C)
    gamma = 1.0 + 0.3 * rng.standard_normal(C)
    gamma[: C // 4] *= -1.0
    gamma[C // 2] = 0.0
    beta = 0.2 * rng.standard_normal(C)
    dp = rng.standard_normal((B, H // 2, W // 2, C))
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, wk, bias, gamma, beta, dp)]


def emulate_fwd(x, wk, bias, gamma):
    """sel (B, H/2, W/2, C) and s1, s2 in the forward kernel's order of work."""
    B, H, W = x.shape
    p, (b, i, j0, n) = patches(x, B, H, W)
    pos = gamma > 0
    sel = torch.zeros(B, H // 2, W // 2, C)
    s = torch.zeros(len(n), C, 2)
    for k in range(fc.CELLS):
        v = corners(p, wk, bias, k)
        m = torch.from_numpy(k < n)
        sel[b[k < n], i[k < n], j0[k < n] + k] = extreme(v, pos)[m]
        s1 = (v[0] + v[1]) + (v[2] + v[3])
        s2 = fma(v[0], v[0], v[1] * v[1]) + fma(v[2], v[2], v[3] * v[3])
        s[m, :, 0] = s[m, :, 0] + s1[m]
        s[m, :, 1] = s[m, :, 1] + s2[m]
    plan = fc.launch_plan(B, H, W)
    blk = per_block(s, plan.blocks)                              # (blocks, C, 2)
    sums = reduce_columns(blk.transpose(1, 2).reshape(plan.blocks, 2 * C)).view(2, C)
    return sel, sums[0], sums[1]


def emulate_bwd(x, wk, bias, gamma, mean, r, pooled, dp):
    """(t1, t2, sx, a1, a2, gram) in the backward kernel's order of work."""
    B, H, W = x.shape
    p, (b, i, j0, n) = patches(x, B, H, W)
    pos = gamma > 0
    T = len(n)
    chan = torch.zeros(T, C, 16)
    sd = torch.zeros(T, C)
    taps = torch.zeros(T, 64)
    pairs = [(a, c2) for a in range(9) for c2 in range(a, 9)]
    for k in range(fc.CELLS):
        m = torch.from_numpy(k < n)
        kk = np.minimum(j0 + k, W // 2 - 1)
        v = corners(p, wk, bias, k)
        ext = extreme(v, pos)
        qsel = torch.where(v[0] == ext, 0, torch.where(v[1] == ext, 1,
                                                        torch.where(v[2] == ext, 2, 3)))
        pl, dl = pooled[b, i, kk], dp[b, i, kk]
        dz = torch.where(pl > 0, dl, torch.zeros(()))
        dz = torch.where(m[:, None], dz, torch.zeros(()))
        new = chan.clone()
        new[..., 0] = chan[..., 0] + dz
        new[..., 1] = fma(dz, (ext - mean) * r, chan[..., 1])
        for s in range(9):
            # the selected corner's neighbour of tap s: an fmaf at that corner
            # only, the all-corner chain's value (dz is 0 at the other three)
            nb = torch.stack([p[:, q // 2 + s // 3, 2 * k + q % 2 + s % 3] for q in range(4)], -1)
            pick = torch.gather(nb[:, None, :].expand(-1, C, -1), 2, qsel[..., None])[..., 0]
            new[..., 3 + s] = fma(dz, pick, chan[..., 3 + s])
        chan = torch.where(m[:, None, None], new, chan)
        sd = torch.where(m[:, None], sd + ((v[0] + v[1]) + (v[2] + v[3])), sd)
        for q in range(4):
            nb = [p[:, q // 2 + s // 3, 2 * k + q % 2 + s % 3] for s in range(9)]
            t2 = taps.clone()
            for idx, (a, c2) in enumerate(pairs):
                t2[:, idx] = fma(nb[a], nb[c2], taps[:, idx])
            for a in range(9):
                t2[:, 45 + a] = taps[:, 45 + a] + nb[a]
            taps = torch.where(m[:, None], t2, taps)
    # Sx: r (sum y - 4 n mean) per thread (the kernel sums s y and negates back: exact)
    chan[..., 2] = f32(sd.double() - 4.0 * torch.from_numpy(n)[:, None].double()
                       * mean.double()) * r
    plan = fc.launch_plan(B, H, W)
    chan_b = per_block(chan, plan.blocks)[..., :12]               # (blocks, C, 12)
    taps_b = per_block(taps, plan.blocks)                         # (blocks, 64)
    gram_b = torch.zeros(plan.blocks, 9, 9)
    for idx, (a, c2) in enumerate(pairs):
        gram_b[:, a, c2] = gram_b[:, c2, a] = taps_b[:, idx]
    part = torch.cat([chan_b.transpose(1, 2).reshape(plan.blocks, -1),
                      gram_b.reshape(plan.blocks, 81), taps_b[:, 45:54]], 1)
    sums = reduce_columns(part)
    ch = sums[:12 * C].view(12, C)
    return ch[0], ch[1], ch[2], ch[3:], sums[12 * C + 81:], sums[12 * C:12 * C + 81].view(9, 9)


@pytest.mark.parametrize("shape", SMALL)
def test_conv_chain_matches_plain_conv(shape):
    """The chain from the bias (the order every kernel shares) against the
    plain version's conv2d; the patch walk reads the zero-padded image."""
    B, H, W = shape
    x, wk, bias, *_ = inputs(B, H, W)
    p, (b, i, j0, n) = patches(x, B, H, W)
    with fc.no_tf32():
        y = F.conv2d(x[:, None], wk.t().reshape(C, 1, 3, 3), bias, padding=1)
    for k in range(fc.CELLS):
        m = k < n
        for q, v in enumerate(corners(p, wk, bias, k)):
            want = y[b[m], :, 2 * i[m] + q // 2, 2 * (j0[m] + k) + q % 2]
            assert float((v[torch.from_numpy(m)] - want).abs().max()) <= 1e-5


@pytest.mark.parametrize("shape", SMALL)
def test_emulated_forward_matches_plain(shape):
    B, H, W = shape
    x, wk, bias, gamma, *_ = inputs(B, H, W)
    sel, s1, s2 = emulate_fwd(x, wk, bias, gamma)
    sel_p, s1_p, s2_p = fc.fused_conv1_fwd_plain(x, wk, bias, gamma)
    assert float((sel - sel_p).abs().max()) <= CONV_ATOL
    for a, want in ((s1, s1_p), (s2, s2_p)):
        assert float((a - want).abs().max()) <= SUMS_RTOL * float(want.abs().max())


@pytest.mark.parametrize("shape", SMALL)
def test_emulated_backward_matches_plain(shape):
    """T1, T2, Sx, A1 (at the selected corner only), Gram and A2 from the
    group patches, halving exchanges, warps, blocks, against the plain
    version."""
    B, H, W = shape
    x, wk, bias, gamma, beta, dp = inputs(B, H, W)
    with torch.no_grad():
        pooled, mean, var = fc.fused_conv1_bn_relu_pool(x[..., None], wk.reshape(3, 3, 1, C),
                                                        bias, gamma, beta)
    r = torch.rsqrt(var + 1e-5)
    got = emulate_bwd(x, wk, bias, gamma, mean, r, pooled, dp)
    want = fc.fused_conv1_bwd_plain(x, wk, bias, gamma, mean, r, pooled, dp)
    n = float(x.numel())
    for name, a, w in zip(("t1", "t2", "sx", "a1", "a2", "gram"), got, want):
        if name == "sx":                # mathematically 0: float noise
            assert float(a.abs().max()) <= 1e-5 * n and float(w.abs().max()) <= 1e-5 * n
            continue
        assert float((a - w).abs().max()) <= SUMS_RTOL * float(w.abs().max()), name


def test_a1_at_the_selected_corner_is_the_all_corner_sum_bit_for_bit():
    """The running A1 chain with one fmaf at the selected corner equals the
    chain over all four corners with dz routed to the selected one (0 at
    the others): fmaf(0, p, a) is a."""
    gen = torch.Generator().manual_seed(3)
    a = torch.zeros(4096)
    a_all = torch.zeros(4096)
    for _ in range(8):
        nb = torch.round(torch.randn(4096, 4, generator=gen) * 4) / 4
        qsel = torch.randint(0, 4, (4096,), generator=gen)
        dz = torch.randn(4096, generator=gen) * (torch.rand(4096, generator=gen) > 0.3)
        a = fma(dz, nb.gather(1, qsel[:, None])[:, 0], a)
        for q in range(4):
            a_all = fma(torch.where(qsel == q, dz, torch.zeros(())), nb[:, q], a_all)
    assert torch.equal(a, a_all)


@pytest.mark.parametrize("N", [2, 16, 64, 96])
def test_halving_exchange_holds_every_total_once(N):
    """warp_reduce_scatter: every value's total is held, lanes holding the
    same total agree, and the totals are the sums of the 32 lanes."""
    gen = torch.Generator().manual_seed(N)
    v = torch.randn(LANES, N, generator=gen)
    held, base = warp_reduce_scatter(v.clone())
    per_lane = held.shape[-1]
    assert per_lane == max(1, N // LANES)
    idx = (base[:, None] + torch.arange(per_lane)[None, :]).flatten()
    assert sorted(set(idx.tolist())) == list(range(N))
    if N < LANES:                    # lanes that differ in the low bits share a total
        step = LANES // N
        assert all(torch.equal(base[0::step], base[j::step]) for j in range(step))
        assert sorted(base[0::step].tolist()) == list(range(N))
    out = lanes_to_values(v)
    assert torch.allclose(out, v.double().sum(0).float(), atol=1e-5)
    assert torch.equal(out, lanes_to_values(v))       # the same bits twice
