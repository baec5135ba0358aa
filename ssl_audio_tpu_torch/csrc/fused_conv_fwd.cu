// Fused Conv3x3(Cin=1) + per-2x2-window extreme (+ eval BN/ReLU epilogue)
// forward for Hopper, fp32 or bf16 (the element type T of the common
// header: x, the weights, bias, gamma and the output; sums fp32).
//
// Replaces the Pallas forward of ssl_audio_tpu/ops/fused_conv.py: _fwd_kernel
// behind _fwd_call (sel, s1, s2) and, with the epilogue fused, the eval block
// fused_conv1_bn_relu_pool_eval.  The TPU kernel's X16 flat-shift layout,
// its zeroed garbage lanes and the closed-form bias correction are Mosaic
// layout workarounds and are not carried over.
//
// x (B, H, W), H and W even, 3x3 kernel wk (9, C) tap-major, bias (C,),
// gamma (C,).  For every window cell (i, j) and channel c the kernel
// computes the four conv outputs y of the window's corners, then
//   sel[b, c, i, j] = max of the four where gamma[c] > 0, min otherwise
//                     (gamma == 0 takes the min, as the TPU kernel does);
//   EVAL=false: writes sel, and per-block partial sums of y and y*y over all
//               four corners; reduce_columns_kernel adds the partials in a
//               fixed order, so s1 = sum(y), s2 = sum(y^2) are deterministic
//               (no float atomics);
//   EVAL=true:  writes relu(a * sel + b), a = gamma r, b = beta - a mean,
//               r = rsqrt(running var + eps) from the host, and no sums.
// The monotone BN affine and ReLU commute with the sign-aware extreme, so
// the (B, H, W, C) conv activation never exists, in memory or in registers.
//
// Output layout (B, C, H/2, W/2), channel-major like the TPU kernel's own
// sel: the NCHW tensor AudioNTT's block-2 cuDNN convolution reads, so no
// layout conversion runs between the two blocks.  The wrapper hands it out
// as a (B, H/2, W/2, C) view, the JAX function's shape.
//
// Bounds on the H100 (the output is 16x the input for C = 64): at one
// serving chunk, x (512, 64, 96), bytes 213.9 MB = 0.0639 ms at 3.35 TB/s
// against 4.18 GFLOP of fp32 FMA = 0.0624 ms at 67 TFLOP/s; at the training
// shape (128, 64, 96) in statistics mode, bytes 0.0160 ms and FMA 0.0143 ms.
// The two nearly tie, so the FP32 pipes and the store path must both be
// busy.  The tensor cores do not pay here: Cin = 1 gives a product depth of
// 9 taps, fp32 accuracy takes three TF32 passes over it padded to 12 or 16
// (4-5x the FMA work at 7.4x the rate, with mma.sync at about half its
// peak), and it would change y's bits, which the backward recomputes.
//
// Design (common header): a thread holds the 4 x 10 input patch of 4
// consecutive window cells in registers, loaded once, and walks the 64
// channels; a channel's 9 weights, bias and epilogue constants are four
// 16-byte shared-memory broadcasts, so ~43 instructions are issued per 36
// conv FMA (a thread per channel that re-reads the patch from shared memory
// per cell issued ~60-65).  Stores: the thread's 4 outputs of a channel are
// one 16-byte store, a warp's 512 contiguous bytes of one channel plane;
// the store queue drains while the thread computes the next channel, so no
// staging in shared memory is needed for the stores to overlap the FMAs.
// Blocks of 128 threads: 1,536 at the serving chunk, 384 at the training
// shape.  Four threads to a group, each with a quarter of the channels
// (four times the warps), measured no faster (PERF.md).  The statistics
// mode takes the extreme as a max of s y (common header).
//
// bf16 (T = __nv_bfloat16, the --use_fp16 step and HEAR compute_dtype
// "bfloat16"; JAX: bf16 operands, fp32 accumulation, sel stored in x's
// dtype, fused_conv.py:166-171, :221): x and the parameters widen exactly,
// y and s1 / s2 are the fp32 values the fp32 kernel computes from the same
// values; sel is rounded to bf16 as it is stored; the eval output is the
// epilogue on the rounded sel, rounded again.  x and the output are half
// the bytes: 0.0320 ms at the serving chunk, under the FMA's 0.0624 ms, so
// the bf16 kernels are bound by their operations.
#include "fused_conv_common.cuh"

namespace {

using namespace fused_conv;

// A thread's outputs of one channel, rounded to T: one 16-byte (float) or
// 8-byte (bf16) store where its group is whole and W/2 a multiple of 4, else
// one store per valid cell.
template <typename T>
__device__ __forceinline__ void store_cells(T* oc, const float (&sel)[CELLS], bool vec, int n) {
  if (vec) {
    store4(oc, sel);
    return;
  }
#pragma unroll
  for (int k = 0; k < CELLS; ++k)
    if (k < n) oc[k] = narrow<T>(sel[k]);
}

template <bool EVAL, typename T>
__global__ void __launch_bounds__(TPB)
fused_conv1_fwd_kernel(const T* __restrict__ x, int B, int H, int W,
                       const T* __restrict__ wk,          // (9, C)
                       const T* __restrict__ bias,        // (C,)
                       const T* __restrict__ gamma,       // (C,)
                       const float* __restrict__ stats,   // EVAL: (3, C) mean, rsqrt(var+eps), beta
                       T* __restrict__ out,               // (B, C, H/2, W/2)
                       float* __restrict__ partials) {    // !EVAL: (n_blocks, 2, C)
  // per channel: w0-3, w4-7, (w8, bias, gamma, 0), (a, b, 0, 0); in the
  // statistics mode times the channel's sign s (common header), with s in
  // place of gamma
  __shared__ float4 cw[C][4];
  __shared__ float red[2][WARPS][C];

  for (int c = threadIdx.x; c < C; c += TPB) {
    const float g = widen(gamma[c]), s = EVAL ? 1.f : channel_sign(g);
    float a = 0.f, b = 0.f;
    if (EVAL) {
      a = g * stats[C + c];
      b = fmaf(-a, stats[c], stats[2 * C + c]);
    }
    float wc[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) wc[t] = s * widen(wk[t * C + c]);
    cw[c][0] = make_float4(wc[0], wc[1], wc[2], wc[3]);
    cw[c][1] = make_float4(wc[4], wc[5], wc[6], wc[7]);
    cw[c][2] = make_float4(wc[8], s * widen(bias[c]), EVAL ? g : s, 0.f);
    cw[c][3] = make_float4(a, b, 0.f, 0.f);
  }
  const Group gr = group_of(B, H, W);
  float p[4][PW];
  load_patch(x, H, W, gr, p);
  __syncthreads();

  const int h2 = H / 2, w2 = W / 2, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t plane = static_cast<size_t>(h2) * w2;
  T* o = out + (static_cast<size_t>(gr.b) * C * h2 + gr.i) * w2 + gr.j0;
  const bool vec = gr.n == CELLS && w2 % 4 == 0;

#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const float4 q0 = cw[c][0], q1 = cw[c][1], q2 = cw[c][2];
    const float w[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
    const float bc = q2.y, sgn = q2.z;  // EVAL: gamma; else the sign s
    float sel[CELLS];                   // EVAL: the extreme; else max(s y)
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      float v[4];
      cell_corners(p, w, bc, k, v);
      sel[k] = EVAL ? window_extreme(v, sgn > 0.f) : corners_max(v);
      if (!EVAL && k < gr.n) {
        s1 += (v[0] + v[1]) + (v[2] + v[3]);
        s2 += fmaf(v[0], v[0], v[1] * v[1]) + fmaf(v[2], v[2], v[3] * v[3]);
      }
    }
    if (EVAL) {
      const float4 q3 = cw[c][3];
      // bf16: the epilogue reads sel as stored, rounded (the JAX kernel's
      // sel_ref in x's dtype); for float the rounding is the identity
#pragma unroll
      for (int k = 0; k < CELLS; ++k)
        sel[k] = fmaxf(fmaf(q3.x, widen(narrow<T>(sel[k])), q3.y), 0.f);
    } else {                            // s max(s y) and the sum of s y, negated back: exact
#pragma unroll
      for (int k = 0; k < CELLS; ++k) sel[k] *= sgn;
      s1 *= sgn;
    }
    store_cells(o + c * plane, sel, vec, gr.n);
    if (!EVAL) {
      // lanes 0 .. 15 end with the warp's s1, lanes 16 .. 31 with its s2
      float s12[2] = {s1, s2};
      const int which = warp_reduce_scatter(s12, lane);
      if ((lane & 15) == 0) red[which][warp][c] = s12[0];
    }
  }

  if (!EVAL) {
    __syncthreads();
    // the block's partials: its warps in order
    for (int k = threadIdx.x; k < 2 * C; k += TPB) {
      const int s = k / C, c = k - s * C;
      float acc = 0.f;
#pragma unroll
      for (int wp = 0; wp < WARPS; ++wp) acc += red[s][wp][c];
      partials[static_cast<size_t>(blockIdx.x) * 2 * C + k] = acc;
    }
  }
}

template <bool EVAL, typename T>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fused_conv1_fwd_kernel<EVAL, T>, TPB, 0);
  return n;
}

template <typename T>
int launch(const void* x, int B, int H, int W, const void* wk, const void* bias,
           const void* gamma, const void* stats, void* out, void* partials, void* sums,
           int eval, cudaStream_t s) {
  const int blocks = n_blocks(B, H, W);
  auto xp = static_cast<const T*>(x);
  auto wp = static_cast<const T*>(wk);
  auto bp = static_cast<const T*>(bias);
  auto gp = static_cast<const T*>(gamma);
  auto op = static_cast<T*>(out);
  if (eval) {
    fused_conv1_fwd_kernel<true, T><<<blocks, TPB, 0, s>>>(
        xp, B, H, W, wp, bp, gp, static_cast<const float*>(stats), op, nullptr);
    return cudaGetLastError();
  }
  auto pp = static_cast<float*>(partials);
  fused_conv1_fwd_kernel<false, T><<<blocks, TPB, 0, s>>>(xp, B, H, W, wp, bp, gp, nullptr, op,
                                                          pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_columns(pp, blocks, 2 * C, static_cast<float*>(sums), s);
}

}  // namespace

extern "C" {

// Blocks the forward launches for (B, H, W); the wrapper sizes the
// partial-sum scratch (n_blocks, 2, C) with it.
int fused_conv1_fwd_blocks(int B, int H, int W) { return n_blocks(B, H, W); }

// Resident blocks per SM of the eval (eval != 0) or statistics kernel of
// element type dtype (0 float, 1 bf16), from its registers and shared
// memory (what the card reports).
int fused_conv1_fwd_blocks_per_sm(int eval, int dtype) {
  if (dtype)
    return eval ? blocks_per_sm<true, bf16>() : blocks_per_sm<false, bf16>();
  return eval ? blocks_per_sm<true, float>() : blocks_per_sm<false, float>();
}

// c_out must equal C.  x, wk, bias, gamma and out of element type dtype
// (0 float, 1 bf16); stats, partials and sums float.
// eval != 0: stats = (3, C) running mean, rsqrt(running var + eps), beta;
// out = the eval block's pooled activation; partials and sums unused.
// eval == 0: stats unused; out = sel; partials (n_blocks, 2, C) scratch;
// sums (2, C) = s1, s2.  out is (B, C, H/2, W/2) either way.
int fused_conv1_fwd_launch(const void* x, int B, int H, int W, const void* wk,
                           const void* bias, const void* gamma,
                           const void* stats, void* out, void* partials,
                           void* sums, int c_out, int eval, int dtype, void* stream) {
  if (H % 2 || W % 2 || c_out != C || B < 1 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype)
    return launch<bf16>(x, B, H, W, wk, bias, gamma, stats, out, partials, sums, eval, s);
  return launch<float>(x, B, H, W, wk, bias, gamma, stats, out, partials, sums, eval, s);
}

}  // extern "C"
