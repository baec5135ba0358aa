// Backward of the fused Conv3x3(Cin=1) + BatchNorm + ReLU + MaxPool2x2 block
// for Hopper, fp32.
//
// Replaces the two Pallas backward bodies of ssl_audio_tpu/ops/fused_conv.py:
// _bwd_kernel behind _bwd_call (DX=false below) and _dx_kernel behind
// _dx_call (DX=true), with their shared prologue _corners_dz.  The contract
// is kept, the TPU layout is not: X16, the flat-shift garbage lanes with
// their closed-form corrections and W16 existed for Mosaic's dots.  Here the
// same quantities are reduced in tap space.
//
// Inputs: x (B, H, W), wk (9, C) tap-major, bias, gamma (C,), stats (2, C) =
// (batch mean, r = rsqrt(batch var + eps)), the forward's output pooled
// (B, H/2, W/2, C) and its cotangent dpooled.  For every window cell and
// channel the kernel recomputes the four corners y (the forward's own device
// code, so y is bit for bit the forward's), finds the first corner in the
// order (0,0) (0,1) (1,0) (1,1) that equals the window's extreme (max where
// gamma > 0, min otherwise), and routes
//   dz = dpooled * [pooled > 0]
// to it.  relu' is read from the saved output rather than from a recomputed
// z = gamma * xhat + beta: the forward's epilogue runs outside this kernel, and
// a z recomputed here could differ from it in the last bit; pooled > 0 is the
// mask the forward applied.  With xhat = (y - mean) * r:
//   DX=false reduces, over all positions,
//     T1[c] = sum dz         T2[c] = sum dz * xhat        Sx[c] = sum xhat
//     A1[s, c] = sum dz[c] * xpad[pos + tap s]
//     and, in tap_gram_kernel, the channel-free input sums
//     A2[s] = sum xpad[pos + s],  Gram[s', s] = sum xpad[pos + s'] xpad[pos + s];
//   DX=true writes the conv output's cotangent
//     dy = r * gamma * (dz - T1/n - xhat * T2/n), laid out (B, H, W, C).
// dW, db, dgamma, dbeta are (C, 9)-sized algebra on these sums and are
// assembled by the caller, as in the JAX package.
//
// Reductions across blocks: every block writes its partial sums, and
// reduce_columns_kernel adds them in a fixed order.  No float atomics, so two
// runs give the same bits.
//
// Thread map of the main kernel: the forward's (thread = channel x row group,
// a warp = 32 consecutive channels of one cell), so pooled and dpooled are
// read, and dy is written, in contiguous 128-byte segments.
//
// Bound on the H100: bytes for DX=true (dy is 16x the input); for DX=false
// the bytes of pooled and dpooled against ~100 FMA per window cell and
// channel put it near the fp32 ridge; see PERF.md for the measured times.
#include "fused_conv_common.cuh"

namespace {

using namespace fused_conv;

constexpr int NSUM = 12;             // per-channel sums: T1, T2, Sx, A1[0..8]
constexpr int NTAP = 90;             // Gram (81) + A2 (9)
constexpr int GRAM_THREADS = 96;
constexpr int GRAM_ROWS = 16;        // output rows per tap_gram block
constexpr int GRAM_COLS = 128;       // output columns per tap_gram block
constexpr int GRAM_TC = GRAM_COLS + 2;
constexpr int RED_COLS = 32;         // reduce_columns: columns per block
constexpr int RED_LANES = 16;        //   and row lanes per column

template <bool DX>
__global__ void __launch_bounds__(THREADS)
fused_conv1_bwd_kernel(const float* __restrict__ x, int H, int W,
                       const float* __restrict__ wk,       // (9, C)
                       const float* __restrict__ bias,     // (C,)
                       const float* __restrict__ gamma,    // (C,)
                       const float* __restrict__ stats,    // (2, C): mean, r
                       const float* __restrict__ pooled,   // (B, H/2, W/2, C)
                       const float* __restrict__ dpooled,  // (B, H/2, W/2, C)
                       const float* __restrict__ sums,     // DX: (2, C): the reduced T1, T2
                       float n,                            // DX: B*H*W (global count)
                       float* __restrict__ partials,       // !DX: (n_blocks, NSUM, C)
                       float* __restrict__ dy) {           // DX: (B, H, W, C)
  __shared__ float xs[TROWS * TCOLS];
  __shared__ float red[DX ? 1 : NSUM * THREADS];

  const int h2 = H / 2, w2 = W / 2;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * R, j0 = blockIdx.x * CW;
  const int tid = threadIdx.x;
  const int c = tid % C, g = tid / C;

  stage_tile(x + static_cast<size_t>(b) * H * W, H, W, i0, j0, xs);
  float w[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) w[s] = wk[s * C + c];
  const float bc = bias[c];
  const float gc = gamma[c];
  const bool pos = gc > 0.f;
  const float mean = stats[c], r = stats[C + c];
  float rg = 0.f, t1n = 0.f, t2n = 0.f;
  if (DX) {
    rg = r * gc;
    t1n = sums[c] / n;
    t2n = sums[C + c] / n;
  }
  __syncthreads();

  float t1 = 0.f, t2 = 0.f, sx = 0.f;
  float a1[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) a1[s] = 0.f;

  for (int il = g; il < R && i0 + il < h2; il += GROUPS) {
    const float* row = xs + 2 * il * TCOLS;
    float p[4][4];
    patch_begin(row, p);
    const size_t cell0 = ((static_cast<size_t>(b) * h2 + i0 + il) * w2 + j0) * C + c;
    // DX: the cell's top-left corner in dy (B, H, W, C)
    float* dy0 = DX ? dy + ((static_cast<size_t>(b) * H + 2 * (i0 + il)) * W + 2 * j0) * C + c
                    : nullptr;
    for (int jl = 0; jl < CW && j0 + jl < w2; ++jl) {
      patch_slide(row, jl, p);
      float v[4];
      conv_corners(p, w, bc, v);
      const float ext = window_extreme(v, pos);
      const size_t cell = cell0 + static_cast<size_t>(jl) * C;
      const float dz = pooled[cell] > 0.f ? dpooled[cell] : 0.f;
      // first corner, in select-and-scatter order, that holds the extreme
      const int qsel = v[0] == ext ? 0 : v[1] == ext ? 1 : v[2] == ext ? 2 : 3;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pi = q / 2, pj = q % 2;
        const float xhat = (v[q] - mean) * r;
        const float dzq = q == qsel ? dz : 0.f;
        if (DX) {
          dy0[(pi * W + 2 * jl + pj) * C] = rg * (dzq - t1n - xhat * t2n);
        } else {
          sx += xhat;
          t2 = fmaf(dzq, xhat, t2);
#pragma unroll
          for (int dh = 0; dh < 3; ++dh)
#pragma unroll
            for (int dw = 0; dw < 3; ++dw)
              a1[dh * 3 + dw] = fmaf(dzq, p[pi + dh][pj + dw], a1[dh * 3 + dw]);
        }
      }
      t1 += dz;
    }
  }

  if (!DX) {
    red[0 * THREADS + tid] = t1;
    red[1 * THREADS + tid] = t2;
    red[2 * THREADS + tid] = sx;
#pragma unroll
    for (int s = 0; s < 9; ++s) red[(3 + s) * THREADS + tid] = a1[s];
    __syncthreads();
    if (g == 0) {
      const size_t blk = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                         gridDim.x + blockIdx.x;
      for (int k = 0; k < NSUM; ++k) {
        float acc = 0.f;
#pragma unroll
        for (int gg = 0; gg < GROUPS; ++gg) acc += red[k * THREADS + gg * C + c];
        partials[(blk * NSUM + k) * C + c] = acc;
      }
    }
  }
}

// Channel-free sums of the zero-padded input over all output positions of a
// (GRAM_ROWS x GRAM_COLS) tile of one image: thread t < 81 holds
// Gram[t / 9][t % 9], threads 81..89 hold A2[t - 81].
__global__ void __launch_bounds__(GRAM_THREADS)
tap_gram_kernel(const float* __restrict__ x, int H, int W,
                float* __restrict__ partials) {            // (n_blocks, NTAP)
  __shared__ float xs[(GRAM_ROWS + 2) * GRAM_TC];
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * GRAM_ROWS, w0 = blockIdx.x * GRAM_COLS;
  const float* xb = x + static_cast<size_t>(b) * H * W;
  for (int idx = threadIdx.x; idx < (GRAM_ROWS + 2) * GRAM_TC; idx += GRAM_THREADS) {
    const int r = h0 - 1 + idx / GRAM_TC, col = w0 - 1 + idx % GRAM_TC;
    xs[idx] = (r >= 0 && r < H && col >= 0 && col < W)
        ? xb[static_cast<size_t>(r) * W + col] : 0.f;
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= NTAP) return;
  const bool pair = t < 81;
  const int sa = pair ? t / 9 : t - 81, sb = pair ? t % 9 : 0;
  const int off_a = (sa / 3) * GRAM_TC + sa % 3, off_b = (sb / 3) * GRAM_TC + sb % 3;
  const int rows = min(GRAM_ROWS, H - h0), cols = min(GRAM_COLS, W - w0);
  float acc = 0.f;
  for (int lh = 0; lh < rows; ++lh) {
    const float* base = xs + lh * GRAM_TC;
    float racc = 0.f;
    for (int lw = 0; lw < cols; ++lw) {
      const float a = base[off_a + lw];
      racc = pair ? fmaf(a, base[off_b + lw], racc) : racc + a;
    }
    acc += racc;
  }
  const size_t blk = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                     gridDim.x + blockIdx.x;
  partials[blk * NTAP + t] = acc;
}

// out[k] = sum over rows of partials (n_rows, K), in a fixed order: a block
// takes RED_COLS columns, each of its RED_LANES lanes per column adds every
// RED_LANES-th row, then the lanes are added in order.
__global__ void __launch_bounds__(RED_COLS * RED_LANES)
reduce_columns_kernel(const float* __restrict__ partials, int n_rows, int K,
                      float* __restrict__ out) {
  __shared__ float buf[RED_LANES][RED_COLS];
  const int col = threadIdx.x % RED_COLS, lane = threadIdx.x / RED_COLS;
  const int k = blockIdx.x * RED_COLS + col;
  float acc = 0.f;
  if (k < K)
    for (int row = lane; row < n_rows; row += RED_LANES)
      acc += partials[static_cast<size_t>(row) * K + k];
  buf[lane][col] = acc;
  __syncthreads();
  if (lane == 0 && k < K) {
    float total = 0.f;
#pragma unroll
    for (int l = 0; l < RED_LANES; ++l) total += buf[l][col];
    out[k] = total;
  }
}

dim3 main_grid(int B, int H, int W) {
  return dim3((W / 2 + CW - 1) / CW, (H / 2 + R - 1) / R, B);
}

dim3 gram_grid(int B, int H, int W) {
  return dim3((W + GRAM_COLS - 1) / GRAM_COLS, (H + GRAM_ROWS - 1) / GRAM_ROWS, B);
}

int blocks_of(dim3 g) { return static_cast<int>(g.x * g.y * g.z); }

}  // namespace

extern "C" {

// Blocks of the two reducing kernels for (B, H, W); the wrapper sizes the
// scratch (n, NSUM, C) and (n_gram, NTAP) with them.
int fused_conv1_bwd_blocks(int B, int H, int W) { return blocks_of(main_grid(B, H, W)); }
int fused_conv1_gram_blocks(int B, int H, int W) { return blocks_of(gram_grid(B, H, W)); }

// chan_sums (NSUM, C): rows T1, T2, Sx, A1[0..8]; tap_sums (10, 9): rows
// Gram[0..8], A2.  c_out must equal C.
int fused_conv1_bwd_launch(const void* x, int B, int H, int W, const void* wk,
                           const void* bias, const void* gamma, const void* stats,
                           const void* pooled, const void* dpooled,
                           void* partials, void* gram_partials, void* chan_sums,
                           void* tap_sums, int c_out, void* stream) {
  if (H % 2 || W % 2 || c_out != C) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const float*>(x);
  const dim3 grid = main_grid(B, H, W), ggrid = gram_grid(B, H, W);
  fused_conv1_bwd_kernel<false><<<grid, THREADS, 0, s>>>(
      xp, H, W, static_cast<const float*>(wk), static_cast<const float*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(stats),
      static_cast<const float*>(pooled), static_cast<const float*>(dpooled),
      nullptr, 0.f, static_cast<float*>(partials), nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tap_gram_kernel<<<ggrid, GRAM_THREADS, 0, s>>>(
      xp, H, W, static_cast<float*>(gram_partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_columns_kernel<<<(NSUM * C + RED_COLS - 1) / RED_COLS,
                          RED_COLS * RED_LANES, 0, s>>>(
      static_cast<const float*>(partials), blocks_of(grid), NSUM * C,
      static_cast<float*>(chan_sums));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_columns_kernel<<<(NTAP + RED_COLS - 1) / RED_COLS,
                          RED_COLS * RED_LANES, 0, s>>>(
      static_cast<const float*>(gram_partials), blocks_of(ggrid), NTAP,
      static_cast<float*>(tap_sums));
  return cudaGetLastError();
}

// dy (B, H, W, C) from the same prologue and the reduced sums (2, C) = T1,
// T2; n = B*H*W.
int fused_conv1_dx_launch(const void* x, int B, int H, int W, const void* wk,
                          const void* bias, const void* gamma, const void* stats,
                          const void* pooled, const void* dpooled,
                          const void* sums, float n, void* dy, int c_out,
                          void* stream) {
  if (H % 2 || W % 2 || c_out != C) return cudaErrorInvalidValue;
  fused_conv1_bwd_kernel<true><<<main_grid(B, H, W), THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), H, W, static_cast<const float*>(wk),
      static_cast<const float*>(bias), static_cast<const float*>(gamma),
      static_cast<const float*>(stats), static_cast<const float*>(pooled),
      static_cast<const float*>(dpooled), static_cast<const float*>(sums),
      n, nullptr, static_cast<float*>(dy));
  return cudaGetLastError();
}

}  // extern "C"
