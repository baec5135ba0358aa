// Fused Conv3x3(Cin=1) + per-2x2-window extreme (+ eval BN/ReLU epilogue)
// forward for Hopper, fp32.
//
// Replaces the Pallas forward of ssl_audio_tpu/ops/fused_conv.py: _fwd_kernel
// behind _fwd_call (sel, s1, s2) and, with the epilogue fused, the eval block
// fused_conv1_bn_relu_pool_eval.  The TPU kernel's X16 flat-shift layout,
// its zeroed garbage lanes and the closed-form bias correction are Mosaic
// layout workarounds and are not carried over: here a block stages a padded
// input tile in shared memory and reads the 4x4 input patch of each 2x2
// window straight from it.
//
// x (B, H, W), H and W even, 3x3 kernel wk (9, C) tap-major, bias (C,),
// gamma (C,).  For every window cell (i, j) and channel c the kernel
// computes the four conv outputs y of the window's corners, then
//   sel[b, i, j, c] = max of the four where gamma[c] > 0, min otherwise
//                     (gamma == 0 takes the min, as the TPU kernel does);
//   EVAL=false: writes sel, and per-block partial sums of y and y*y over all
//               four corners; a second small kernel reduces the partials in
//               a fixed order, so s1 = sum(y), s2 = sum(y^2) are deterministic;
//   EVAL=true:  writes relu(gamma * (sel - mean) * r + beta), r =
//               rsqrt(running var + eps) from the host, and no sums.
// The monotone BN affine and ReLU commute with the sign-aware extreme, so
// the (B, H, W, C) conv activation never exists, in memory or in registers.
//
// C = 64 channels (AudioNTT's base width), a compile-time constant.
// Thread map: thread = (channel c, row group g), 4 row groups.  A warp holds
// 32 consecutive channels of one window cell, so each store is one contiguous
// 128-byte segment of the channels-last output, every thread keeps its own
// channel's 9 weights and running sums in registers, and all lanes of a warp
// read the same input value from shared memory (a broadcast).  Along a row
// the 4x4 patch slides by two columns, so each cell loads 8 new values.
//
// Bound on the H100: bytes.  The pooled output (B, H/2, W/2, C) fp32 is 16x
// the input for C = 64; at 36 FMA per output value the work is ~9 FLOP per
// byte written, under the card's fp32 ridge of ~20 FLOP/byte.
#include "fused_conv_common.cuh"

namespace {

using namespace fused_conv;   // C, the tile constants, staging and the conv recompute

template <bool EVAL>
__global__ void __launch_bounds__(THREADS)
fused_conv1_fwd_kernel(const float* __restrict__ x, int H, int W,
                       const float* __restrict__ wk,      // (9, C)
                       const float* __restrict__ bias,    // (C,)
                       const float* __restrict__ gamma,   // (C,)
                       const float* __restrict__ stats,   // EVAL: (3, C) mean, rsqrt(var+eps), beta
                       float* __restrict__ out,           // (B, H/2, W/2, C)
                       float* __restrict__ partials) {    // !EVAL: (2, n_blocks, C)
  __shared__ float xs[TROWS * TCOLS];
  __shared__ float red[2 * THREADS];

  const int h2 = H / 2, w2 = W / 2;
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * R, j0 = blockIdx.x * CW;
  const int tid = threadIdx.x;
  const int c = tid % C, g = tid / C;

  const float* xb = x + static_cast<size_t>(b) * H * W;
  stage_tile(xb, H, W, i0, j0, xs);
  float w[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) w[s] = wk[s * C + c];
  const float bc = bias[c];
  const bool pos = gamma[c] > 0.f;
  float a_scale = 0.f, a_mean = 0.f, a_beta = 0.f;
  if (EVAL) {
    a_mean = stats[c];
    a_scale = stats[C + c];
    a_beta = stats[2 * C + c];
  }
  const float gc = gamma[c];
  __syncthreads();

  float s1 = 0.f, s2 = 0.f;
  for (int il = g; il < R && i0 + il < h2; il += GROUPS) {
    const float* row = xs + 2 * il * TCOLS;
    float p[4][4];
    patch_begin(row, p);
    float* o = out + ((static_cast<size_t>(b) * h2 + i0 + il) * w2 + j0) * C + c;
    for (int jl = 0; jl < CW && j0 + jl < w2; ++jl) {
      patch_slide(row, jl, p);
      float v[4];
      conv_corners(p, w, bc, v);
      const float sel = window_extreme(v, pos);
      if (EVAL) {
        o[static_cast<size_t>(jl) * C] =
            fmaxf(gc * (sel - a_mean) * a_scale + a_beta, 0.f);
      } else {
        o[static_cast<size_t>(jl) * C] = sel;
        s1 += (v[0] + v[1]) + (v[2] + v[3]);
        s2 += (v[0] * v[0] + v[1] * v[1]) + (v[2] * v[2] + v[3] * v[3]);
      }
    }
  }

  if (!EVAL) {
    red[tid] = s1;
    red[THREADS + tid] = s2;
    __syncthreads();
    if (g == 0) {
      float t1 = 0.f, t2 = 0.f;
#pragma unroll
      for (int k = 0; k < GROUPS; ++k) {
        t1 += red[k * C + c];
        t2 += red[THREADS + k * C + c];
      }
      const size_t n_blocks = static_cast<size_t>(gridDim.x) * gridDim.y * gridDim.z;
      const size_t blk = (static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y) *
                         gridDim.x + blockIdx.x;
      partials[blk * C + c] = t1;
      partials[(n_blocks + blk) * C + c] = t2;
    }
  }
}

// One block per (channel, statistic): strided sums then a fixed-order tree.
__global__ void __launch_bounds__(THREADS)
reduce_partials_kernel(const float* __restrict__ partials, int n_blocks,
                       float* __restrict__ sums) {   // (2, C): s1, s2
  __shared__ float buf[THREADS];
  const int c = blockIdx.x, which = blockIdx.y;
  const float* p = partials + static_cast<size_t>(which) * n_blocks * C + c;
  float acc = 0.f;
  for (int k = threadIdx.x; k < n_blocks; k += THREADS)
    acc += p[static_cast<size_t>(k) * C];
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[which * C + c] = buf[0];
}

}  // namespace

extern "C" {

// Blocks the forward launches for (B, H, W); the wrapper sizes the
// partial-sum scratch (2, n_blocks, C) with it.
int fused_conv1_fwd_blocks(int B, int H, int W) {
  return ((W / 2 + CW - 1) / CW) * ((H / 2 + R - 1) / R) * B;
}

// c_out must equal C.  eval != 0: stats = (3, C) running mean,
// rsqrt(running var + eps), beta; out = the eval block's pooled activation;
// partials and sums unused.
// eval == 0: stats unused; out = sel; partials (2, n_blocks, C) scratch;
// sums (2, C) = s1, s2.
int fused_conv1_fwd_launch(const void* x, int B, int H, int W, const void* wk,
                           const void* bias, const void* gamma,
                           const void* stats, void* out, void* partials,
                           void* sums, int c_out, int eval, void* stream) {
  if (H % 2 || W % 2 || c_out != C) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((W / 2 + CW - 1) / CW, (H / 2 + R - 1) / R, B);
  auto xp = static_cast<const float*>(x);
  auto wp = static_cast<const float*>(wk);
  auto bp = static_cast<const float*>(bias);
  auto gp = static_cast<const float*>(gamma);
  auto sp = static_cast<const float*>(stats);
  auto op = static_cast<float*>(out);
  auto pp = static_cast<float*>(partials);
  if (eval) {
    fused_conv1_fwd_kernel<true><<<grid, THREADS, 0, s>>>(
        xp, H, W, wp, bp, gp, sp, op, nullptr);
    return cudaGetLastError();
  }
  fused_conv1_fwd_kernel<false><<<grid, THREADS, 0, s>>>(
      xp, H, W, wp, bp, gp, nullptr, op, pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_blocks = static_cast<int>(grid.x * grid.y * grid.z);
  reduce_partials_kernel<<<dim3(C, 2), THREADS, 0, s>>>(
      pp, n_blocks, static_cast<float*>(sums));
  return cudaGetLastError();
}

}  // extern "C"
