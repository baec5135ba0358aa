// Backward of the fused Conv3x3(Cin=1) + BatchNorm + ReLU + MaxPool2x2 block
// for Hopper: the reduction kernel in fp32 or bf16 (the element type T of
// the common header: x, the weights, bias, gamma, pooled and dpooled), the
// dx kernel in fp32 only.
//
// Replaces the two Pallas backward bodies of ssl_audio_tpu/ops/fused_conv.py:
// _bwd_kernel behind _bwd_call (fused_conv1_bwd_kernel) and _dx_kernel
// behind _dx_call (fused_conv1_dx_kernel), with their shared prologue
// _corners_dz.  The contract is kept, the TPU layout is not: X16, the
// flat-shift garbage lanes with their closed-form corrections and W16
// existed for Mosaic's dots.  Here the same quantities are reduced in tap
// space.
//
// Inputs: x (B, H, W), wk (9, C) tap-major, bias, gamma (C,), the batch
// mean and r = rsqrt(batch var + eps) (C,), the forward's output pooled and
// its cotangent dpooled, both (B, C, H/2, W/2) in memory (the forward's
// layout).  For every window cell and channel a kernel recomputes the four
// corners y (the shared conv_at, so y is bit for bit the forward's), finds
// the first corner in the order (0,0) (0,1) (1,0) (1,1) that equals the
// window's extreme (max where gamma > 0, min otherwise), and routes
//   dz = dpooled * [pooled > 0]
// to it.  relu' is read from the saved output rather than from a recomputed
// z = gamma * xhat + beta: the forward's epilogue runs outside these
// kernels, and a z recomputed here could differ from it in the last bit;
// pooled > 0 is the mask the forward applied.  With xhat = (y - mean) * r:
//   fused_conv1_bwd_kernel reduces, over all positions,
//     T1[c] = sum dz         T2[c] = sum dz * xhat        Sx[c] = sum xhat
//     A1[s, c] = sum dz[c] * xpad[pos + tap s]
//     A2[s] = sum xpad[pos + s],  Gram[s', s] = sum xpad[pos + s'] xpad[pos + s];
//   fused_conv1_dx_kernel writes the conv output's cotangent
//     dy = r * gamma * (dz - T1/n - xhat * T2/n), laid out (B, H, W, C).
// dW, db, dgamma, dbeta are (C, 9)-sized algebra on these sums and are
// assembled by the caller, as in the JAX package.
//
// fused_conv1_bwd_kernel (the training step's, two launches with the
// reduction).  Bound on the H100 at one view of the step, (128, 64, 96):
// bytes, 0.031 ms (x, pooled and dpooled read once); the FMA it needs is
// below that.  Design, against the four launches before it:
//   * the forward's thread map (common header): a thread holds the input
//     patch of 4 window cells and walks the channels (384 blocks of 128), so
//     pooled and dpooled come as 16-byte loads, 512 contiguous bytes a warp,
//     one channel ahead of the work on them, and y is recomputed from
//     registers;
//   * A1 only at the selected corner: 9 FMA a cell, not 36 (dz is 0 at the
//     other three, and fmaf(0, p, a) is a), its 3 x 3 neighbourhood picked
//     from the patch by two selects per value;
//   * T2 from the extreme itself (xhat of the selected corner); Sx as
//     r (sum y - 16 mean) per thread and channel;
//   * the extreme as a max of s y (the common header's sign fold);
//   * the 12 per-channel sums of a warp added by halving exchanges (16
//     values, 31 shuffles, warp_reduce_scatter), then over the block's
//     warps in order;
//   * the channel-free Gram (its 45 distinct products) and A2 from the
//     patch the thread already holds, once, before the channel loop: no
//     separate kernel walks the input again;
//   * every block writes its partials, and one reduce_columns_kernel adds
//     them in a fixed order.  No float atomics: two launches give the same
//     bits.
//
// fused_conv1_dx_kernel (B5, on no training path: block 1's input is data)
// keeps its own map: a thread per channel and row group over a staged input
// tile, so that dy (B, H, W, C) is written in contiguous 128-byte segments;
// it reads pooled and dpooled in the forward's layout.
//
// bf16 (the --use_fp16 step; JAX fused_conv.py:283, every sum fp32): the
// inputs widen exactly as they are loaded, so y, the routing and every sum
// are what the fp32 kernel computes from the same values, but for relu':
// pooled holds z of the rounded sel, which near 0 differs in sign from z of
// the fp32 y, so the bf16 kernel takes the JAX rule (_corners_dz: z =
// gamma * xhat + beta > 0 in fp32 at the selected corner, a multiply and an
// add, unfused) and reads no pooled: x and dpooled, half the fp32 bytes or
// less (bound 0.0083 ms at a view of the step).  In fp32 the two rules
// agree but for last-bit cases, and the fp32 kernel keeps pooled > 0.  The
// dx kernel (B5) stays fp32: no bf16 path needs the input's gradient.
#include "fused_conv_common.cuh"

namespace {

using namespace fused_conv;

constexpr int NSUM = 12;             // per-channel sums: T1, T2, Sx, A1[0..8]
constexpr int NPAIR = 45;            // distinct products of the symmetric 9 x 9 Gram
constexpr int NTAP = 90;             // Gram (81) + A2 (9), as the reduction writes them
constexpr int NPART = NSUM * C + NTAP;

// index of the Gram product (a, b) among the 45 distinct ones (a <= b, row-major)
__host__ __device__ constexpr int pair_index(int a, int b) {
  const int lo = a < b ? a : b, hi = a < b ? b : a;
  return lo * 9 - lo * (lo - 1) / 2 + (hi - lo);
}

// The channel-free sums over the positions of the thread's cells -- the 45
// distinct Gram products, then A2 (values 45 .. 53; 54 .. 63 stay 0) --
// added over the warp by halving exchanges into tap_red (64 values).
__device__ __forceinline__ void tap_sums(const float (&p)[4][PW], int n, int lane,
                                         float* tap_red) {
  float t[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) t[e] = 0.f;
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    if (k >= n) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float nb[9];
#pragma unroll
      for (int s = 0; s < 9; ++s) nb[s] = p[q / 2 + s / 3][2 * k + q % 2 + s % 3];
#pragma unroll
      for (int a = 0; a < 9; ++a) {
#pragma unroll
        for (int b = a; b < 9; ++b) t[pair_index(a, b)] = fmaf(nb[a], nb[b], t[pair_index(a, b)]);
        t[NPAIR + a] += nb[a];
      }
    }
  }
  const int base = warp_reduce_scatter<64>(t, lane);
  tap_red[base] = t[0];
  tap_red[base + 1] = t[1];
}

// pooled (fp32 only: the bf16 kernel's relu' does not read it) and dpooled
// of a thread's cells in one channel, widened: 16-byte (float) or 8-byte
// (bf16) loads where its group is whole and W/2 a multiple of 4; 0 past the
// valid cells.
template <typename T>
__device__ __forceinline__ void load_cells(const T* __restrict__ pooled,
                                           const T* __restrict__ dpooled, size_t at,
                                           bool vec, int n, float (&pl)[CELLS],
                                           float (&dl)[CELLS]) {
  constexpr bool with_pooled = sizeof(T) == sizeof(float);
  if (vec) {
    if (with_pooled) load4(pooled + at, pl);
    load4(dpooled + at, dl);
    return;
  }
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    if (with_pooled) pl[k] = k < n ? widen(pooled[at + k]) : 0.f;
    dl[k] = k < n ? widen(dpooled[at + k]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(TPB)
fused_conv1_bwd_kernel(const T* __restrict__ x, int B, int H, int W,
                       const T* __restrict__ wk,           // (9, C)
                       const T* __restrict__ bias,         // (C,)
                       const T* __restrict__ gamma,        // (C,)
                       const T* __restrict__ beta,         // (C,): bf16 only (relu')
                       const float* __restrict__ mean,     // (C,)
                       const float* __restrict__ rstd,     // (C,): rsqrt(var + eps)
                       const T* __restrict__ pooled,       // (B, C, H/2, W/2): fp32 only
                       const T* __restrict__ dpooled,      // (B, C, H/2, W/2)
                       float* __restrict__ partials) {     // (n_blocks, NPART)
  constexpr bool z_rule = sizeof(T) == sizeof(bf16);    // relu' from z, not from pooled
  // per channel, times its sign s (common header): s w0-3, s w4-7,
  // (s w8, s bias, s, 0), (mean, r, gamma, beta) (the last two bf16 only)
  __shared__ float4 cw[C][4];
  __shared__ float red[WARPS][NSUM][C];
  __shared__ float tap_red[WARPS][64];

  for (int c = threadIdx.x; c < C; c += TPB) {
    const float s = channel_sign(widen(gamma[c]));
    float wc[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wc[t] = s * widen(wk[t * C + c]);
    cw[c][0] = make_float4(wc[0], wc[1], wc[2], wc[3]);
    cw[c][1] = make_float4(wc[4], wc[5], wc[6], wc[7]);
    cw[c][2] = make_float4(wc[8], s * widen(bias[c]), s, 0.f);
    cw[c][3] = make_float4(mean[c], rstd[c], z_rule ? widen(gamma[c]) : 0.f,
                           z_rule ? widen(beta[c]) : 0.f);
  }
  const Group gr = group_of(B, H, W);
  float p[4][PW];
  load_patch(x, H, W, gr, p);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h2 = H / 2, w2 = W / 2;
  const size_t plane = static_cast<size_t>(h2) * w2;
  const size_t cell0 = (static_cast<size_t>(gr.b) * C * h2 + gr.i) * w2 + gr.j0;
  const bool vec = gr.n == CELLS && w2 % 4 == 0;
  // pooled and dpooled of the next channel, loaded one channel ahead so that
  // their latency passes under the work on this one (first under the taps)
  float pn[CELLS] = {}, dn[CELLS];
  load_cells(pooled, dpooled, cell0, vec, gr.n, pn, dn);

  tap_sums(p, gr.n, lane, tap_red[warp]);
  __syncthreads();

#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const float4 q0 = cw[c][0], q1 = cw[c][1], q2 = cw[c][2], q3 = cw[c][3];
    const float w[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
    const float bc = q2.y, sgn = q2.z, mc = q3.x, r = q3.y, gc = q3.z, bec = q3.w;
    float pl[CELLS], dl[CELLS];
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      pl[k] = pn[k];
      dl[k] = dn[k];
    }
    if (c + 1 < C) load_cells(pooled, dpooled, cell0 + (c + 1) * plane, vec, gr.n, pn, dn);
    // T1, T2, Sx, A1[0..8]; 12 .. 15 stay 0
    float v16[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) v16[e] = 0.f;
    float sv = 0.f;                  // the sum of s y over the cells' corners
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      if (k >= gr.n) continue;
      float v[4];
      cell_corners(p, w, bc, k, v);
      const float ext = corners_max(v);     // of s y: the extreme is s ext
      // first corner, in select-and-scatter order, that holds the extreme
      const int qsel = v[0] == ext ? 0 : v[1] == ext ? 1 : v[2] == ext ? 2 : 3;
      const float xh = (sgn * ext - mc) * r;   // xhat of the selected corner
      const bool on = z_rule ? __fadd_rn(__fmul_rn(gc, xh), bec) > 0.f : pl[k] > 0.f;
      const float dz = on ? dl[k] : 0.f;
      v16[0] += dz;
      v16[1] = fmaf(dz, xh, v16[1]);
      sv += (v[0] + v[1]) + (v[2] + v[3]);
      // the selected corner's 3 x 3 neighbourhood: rows pi .. pi + 2, then
      // columns 2k + pj .. 2k + pj + 2 of the patch
      const bool pi = qsel >= 2, pj = qsel & 1;
      float rows[3][4];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) rows[a][cc] = pi ? p[a + 1][2 * k + cc] : p[a][2 * k + cc];
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const float nb = pj ? rows[s / 3][s % 3 + 1] : rows[s / 3][s % 3];
        v16[3 + s] = fmaf(dz, nb, v16[3 + s]);
      }
    }
    v16[2] = fmaf(sgn, sv, -4.f * gr.n * mc) * r;   // r sum (y - mean)
    const int base = warp_reduce_scatter<16>(v16, lane);
    if (!(lane & 1) && base < NSUM) red[warp][base][c] = v16[0];
  }

  __syncthreads();
  for (int k = threadIdx.x; k < NPART; k += TPB) {
    float acc = 0.f;
    if (k < NSUM * C) {        // the block's warps in order
      const int s = k / C, c = k - s * C;
#pragma unroll
      for (int wp = 0; wp < WARPS; ++wp) acc += red[wp][s][c];
    } else {
      const int e = k - NSUM * C;
      const int ti = e < 81 ? pair_index(e / 9, e % 9) : NPAIR + e - 81;
#pragma unroll
      for (int wp = 0; wp < WARPS; ++wp) acc += tap_red[wp][ti];
    }
    partials[static_cast<size_t>(blockIdx.x) * NPART + k] = acc;
  }
}

// ---------------------------------------------------------------------------
// dx: a thread per (channel, row group) over a staged input tile
// ---------------------------------------------------------------------------

constexpr int DX_THREADS = 256;
constexpr int DX_GROUPS = DX_THREADS / C;  // row groups of a block
constexpr int DX_R = 8;                    // window rows per block
constexpr int DX_CW = 16;                  // window columns per block
constexpr int TROWS = 2 * DX_R + 2;        // staged input rows (with the zero pad)
constexpr int TCOLS = 2 * DX_CW + 2;       // staged input columns

// Zero-padded input tile of image xb for the window tile at (i0, j0):
// rows 2*i0-1 .. 2*i0+2R, columns 2*j0-1 .. 2*j0+2CW.  The caller
// synchronises before reading xs.
__device__ __forceinline__ void stage_tile(const float* __restrict__ xb, int H, int W, int i0,
                                           int j0, float* xs) {
  for (int idx = threadIdx.x; idx < TROWS * TCOLS; idx += DX_THREADS) {
    const int r = 2 * i0 - 1 + idx / TCOLS, col = 2 * j0 - 1 + idx % TCOLS;
    xs[idx] = (r >= 0 && r < H && col >= 0 && col < W)
        ? xb[static_cast<size_t>(r) * W + col] : 0.f;
  }
}

// The 4x4 input patch of a window slides by two columns along a window row:
// patch_begin loads the two columns left of the first cell into p[.][2..3],
// patch_slide(jl) shifts them to p[.][0..1] and loads cell jl's new ones.
__device__ __forceinline__ void patch_begin(const float* row, float (&p)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    p[a][2] = row[a * TCOLS + 0];
    p[a][3] = row[a * TCOLS + 1];
  }
}

__device__ __forceinline__ void patch_slide(const float* row, int jl, float (&p)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    p[a][0] = p[a][2];
    p[a][1] = p[a][3];
    p[a][2] = row[a * TCOLS + 2 * jl + 2];
    p[a][3] = row[a * TCOLS + 2 * jl + 3];
  }
}

__global__ void __launch_bounds__(DX_THREADS)
fused_conv1_dx_kernel(const float* __restrict__ x, int H, int W,
                      const float* __restrict__ wk,       // (9, C)
                      const float* __restrict__ bias,     // (C,)
                      const float* __restrict__ gamma,    // (C,)
                      const float* __restrict__ mean,     // (C,)
                      const float* __restrict__ rstd,     // (C,): rsqrt(var + eps)
                      const float* __restrict__ pooled,   // (B, C, H/2, W/2)
                      const float* __restrict__ dpooled,  // (B, C, H/2, W/2)
                      const float* __restrict__ t1,       // (C,): the reduced T1
                      const float* __restrict__ t2,       // (C,): the reduced T2
                      float n,                            // B*H*W (global count)
                      float* __restrict__ dy) {           // (B, H, W, C)
  __shared__ float xs[TROWS * TCOLS];

  const int h2 = H / 2, w2 = W / 2;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * DX_R, j0 = blockIdx.x * DX_CW;
  const int tid = threadIdx.x;
  const int c = tid % C, g = tid / C;

  stage_tile(x + static_cast<size_t>(b) * H * W, H, W, i0, j0, xs);
  float w[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) w[s] = wk[s * C + c];
  const float bc = bias[c];
  const float gc = gamma[c];
  const bool pos = gc > 0.f;
  const float mc = mean[c], r = rstd[c];
  const float rg = r * gc, t1n = t1[c] / n, t2n = t2[c] / n;
  __syncthreads();

  for (int il = g; il < DX_R && i0 + il < h2; il += DX_GROUPS) {
    const float* row = xs + 2 * il * TCOLS;
    float p[4][4];
    patch_begin(row, p);
    const size_t cell0 = ((static_cast<size_t>(b) * C + c) * h2 + i0 + il) * w2 + j0;
    // the cell's top-left corner in dy (B, H, W, C)
    float* dy0 = dy + ((static_cast<size_t>(b) * H + 2 * (i0 + il)) * W + 2 * j0) * C + c;
    for (int jl = 0; jl < DX_CW && j0 + jl < w2; ++jl) {
      patch_slide(row, jl, p);
      float v[4];
      cell_corners(p, w, bc, 0, v);
      const float ext = window_extreme(v, pos);
      const float dz = pooled[cell0 + jl] > 0.f ? dpooled[cell0 + jl] : 0.f;
      const int qsel = v[0] == ext ? 0 : v[1] == ext ? 1 : v[2] == ext ? 2 : 3;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pi = q / 2, pj = q % 2;
        const float xhat = (v[q] - mc) * r;
        const float dzq = q == qsel ? dz : 0.f;
        dy0[(pi * W + 2 * jl + pj) * C] = rg * (dzq - t1n - xhat * t2n);
      }
    }
  }
}

}  // namespace

extern "C" {

// Blocks of fused_conv1_bwd_kernel for (B, H, W); the wrapper sizes the
// partial-sum scratch (n_blocks, 12 C + 90) with it.
int fused_conv1_bwd_blocks(int B, int H, int W) { return n_blocks(B, H, W); }

// Resident blocks per SM of fused_conv1_bwd_kernel of element type dtype
// (0 float, 1 bf16).
int fused_conv1_bwd_blocks_per_sm(int dtype) {
  int n = 0;
  if (dtype)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_conv1_bwd_kernel<bf16>, TPB, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_conv1_bwd_kernel<float>, TPB, 0);
  return n;
}

// sums (12 C + 90): rows T1, T2, Sx, A1[0..8] of C values, then Gram (9 x 9)
// and A2 (9).  c_out must equal C.  x, wk, bias, gamma, beta, pooled and
// dpooled of element type dtype (0 float, 1 bf16); mean, rstd, partials and
// sums float.  fp32 reads pooled (relu' = pooled > 0) and not beta; bf16
// reads beta (relu' = gamma xhat + beta > 0) and not pooled.
int fused_conv1_bwd_launch(const void* x, int B, int H, int W, const void* wk,
                           const void* bias, const void* gamma, const void* beta,
                           const void* mean, const void* rstd, const void* pooled,
                           const void* dpooled, void* partials, void* sums, int c_out,
                           int dtype, void* stream) {
  if (H % 2 || W % 2 || c_out != C || B < 1 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = n_blocks(B, H, W);
  auto pp = static_cast<float*>(partials);
  auto mp = static_cast<const float*>(mean);
  auto rp = static_cast<const float*>(rstd);
  if (dtype)
    fused_conv1_bwd_kernel<bf16><<<blocks, TPB, 0, s>>>(
        static_cast<const bf16*>(x), B, H, W, static_cast<const bf16*>(wk),
        static_cast<const bf16*>(bias), static_cast<const bf16*>(gamma),
        static_cast<const bf16*>(beta), mp, rp, static_cast<const bf16*>(pooled),
        static_cast<const bf16*>(dpooled), pp);
  else
    fused_conv1_bwd_kernel<float><<<blocks, TPB, 0, s>>>(
        static_cast<const float*>(x), B, H, W, static_cast<const float*>(wk),
        static_cast<const float*>(bias), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), mp, rp, static_cast<const float*>(pooled),
        static_cast<const float*>(dpooled), pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_columns(pp, blocks, NPART, static_cast<float*>(sums), s);
}

// dy (B, H, W, C) from the same prologue and the reduced sums T1, T2 (C,);
// n = B*H*W.
int fused_conv1_dx_launch(const void* x, int B, int H, int W, const void* wk,
                          const void* bias, const void* gamma, const void* mean,
                          const void* rstd, const void* pooled, const void* dpooled,
                          const void* t1, const void* t2, float n, void* dy, int c_out,
                          void* stream) {
  if (H % 2 || W % 2 || c_out != C || B < 1 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((W / 2 + DX_CW - 1) / DX_CW, (H / 2 + DX_R - 1) / DX_R, B);
  fused_conv1_dx_kernel<<<grid, DX_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), H, W, static_cast<const float*>(wk),
      static_cast<const float*>(bias), static_cast<const float*>(gamma),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const float*>(pooled), static_cast<const float*>(dpooled),
      static_cast<const float*>(t1), static_cast<const float*>(t2), n,
      static_cast<float*>(dy));
  return cudaGetLastError();
}

}  // extern "C"
