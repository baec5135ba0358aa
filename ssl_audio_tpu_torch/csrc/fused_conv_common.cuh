// Shared device code of the fused Conv3x3(Cin=1) block's kernels
// (fused_conv_fwd.cu, fused_conv_bwd.cu).
//
// The backward and dx kernels recompute the conv output y of every window
// corner and test y == extreme(y) to find the element the forward selected,
// so every kernel must produce y bit for bit the same.  The one FMA order
// lives here, in conv_at: the chain starts at the bias and takes the nine
// taps row-major, one fmaf each.  Every kernel reads the same input values
// (zero outside the image), the same weights and the same bias, so y is the
// same wherever it is recomputed, whatever the thread map.
//
// The thread map of the forward and backward kernels: a thread owns a
// group of CELLS consecutive window cells of one window row and holds their
// 4 x PW input patch in registers, loaded once from device memory, while it
// walks the C channels.  Groups are numbered row-major over (b, i, j / CELLS),
// so a warp holds 32 consecutive groups: 128 consecutive cells of one
// channel plane of the (B, C, H/2, W/2) output, whose values it stores or
// loads as 16-byte vectors, 512 contiguous bytes a warp.
//
// Element types: every kernel but dx is a template over T, the type of the
// tensors it reads and writes (x, the weights, bias and gamma, sel / pooled
// and its cotangent): float, or __nv_bfloat16 for the bf16 compute mode.
// A bf16 value widens to fp32 exactly, and a product of two bf16 values is
// exact in fp32, so y, every sum and every comparison are fp32 in both; a
// bf16 kernel rounds only what it stores (sel, the eval output).  The
// batch statistics and the eval epilogue's constants stay fp32.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fused_conv {

constexpr int C = 64;                // output channels (AudioNTT's base width)
constexpr int CELLS = 4;             // window cells per thread, along a window row
constexpr int PW = 2 * CELLS + 2;    // input patch columns of a thread
constexpr int TPB = 128;             // threads per block of the forward and backward
constexpr int WARPS = TPB / 32;
constexpr unsigned FULL = 0xffffffffu;

typedef __nv_bfloat16 bf16;

// One element widened to fp32, and an fp32 value rounded to T (nearest even).
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) { return __float2bfloat16_rn(v); }

// The low and high bf16 of a packed pair, widened.
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// Four consecutive elements at p, widened: one 16-byte (float) or 8-byte
// (bf16) load; p aligned to it.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  v[0] = bf_lo(u.x); v[1] = bf_hi(u.x); v[2] = bf_lo(u.y); v[3] = bf_hi(u.y);
}

// ... and four values stored as T at p, rounded once each.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// y at the conv output position whose 3x3 neighbourhood starts at row r,
// column col of the patch p: bias + sum over taps, row-major, one fmaf each.
template <int NC>
__device__ __forceinline__ float conv_at(const float (&p)[4][NC], const float (&w)[9],
                                         float bias, int r, int col) {
  float acc = bias;
#pragma unroll
  for (int dh = 0; dh < 3; ++dh)
#pragma unroll
    for (int dw = 0; dw < 3; ++dw) acc = fmaf(w[dh * 3 + dw], p[r + dh][col + dw], acc);
  return acc;
}

// The four corners of window cell k of a patch, in the order (0,0) (0,1)
// (1,0) (1,1).
template <int NC>
__device__ __forceinline__ void cell_corners(const float (&p)[4][NC], const float (&w)[9],
                                             float bias, int k, float (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = conv_at(p, w, bias, q / 2, 2 * k + q % 2);
}

// The sign-aware extreme as a max.  For a channel with gamma <= 0 the
// statistics forward and the backward run the conv with the negated weights
// and bias (channel_sign = -1), which gives -y bit for bit: rounding to
// nearest is symmetric in sign, so every fmaf of the chain is the negation
// of the one with the weights as they are.  Then max(-y) = -min(y), and the
// window's extreme costs 3 max, not 3 max, 3 min and a select.
__device__ __forceinline__ float channel_sign(float gamma) { return gamma > 0.f ? 1.f : -1.f; }

__device__ __forceinline__ float corners_max(const float (&v)[4]) {
  return fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
}

// Max of the corners where gamma > 0, min otherwise (gamma == 0 included),
// on y itself: the eval forward's and the dx kernel's form.  (The eval
// forward with the sign fold measured slower, 0.121 against 0.101-0.104 ms
// at the serving chunk, though it issues fewer instructions: PERF.md.)
__device__ __forceinline__ float window_extreme(const float (&v)[4], bool pos) {
  return pos ? fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]))
             : fminf(fminf(v[0], v[1]), fminf(v[2], v[3]));
}

// A thread's group of window cells: image b, window row i, first cell j0,
// n valid cells (0 past the last group).
struct Group {
  int b, i, j0, n;
};

__host__ __device__ inline int groups_per_row(int w2) { return (w2 + CELLS - 1) / CELLS; }

__host__ __device__ inline long long n_groups(int B, int H, int W) {
  return static_cast<long long>(B) * (H / 2) * groups_per_row(W / 2);
}

__host__ __device__ inline int n_blocks(int B, int H, int W) {
  return static_cast<int>((n_groups(B, H, W) + TPB - 1) / TPB);
}

__device__ __forceinline__ Group group_of(int B, int H, int W) {
  const int h2 = H / 2, w2 = W / 2, g4 = groups_per_row(w2);
  const long long g = static_cast<long long>(blockIdx.x) * TPB + threadIdx.x;
  Group gr{0, 0, 0, 0};
  if (g < static_cast<long long>(B) * h2 * g4) {
    const int per_image = h2 * g4;
    gr.b = static_cast<int>(g / per_image);
    const int rem = static_cast<int>(g - static_cast<long long>(gr.b) * per_image);
    gr.i = rem / g4;
    gr.j0 = CELLS * (rem - gr.i * g4);
    gr.n = min(CELLS, w2 - gr.j0);
  }
  return gr;
}

// The group's zero-padded input patch: rows 2i-1 .. 2i+2, columns
// 2 j0 - 1 .. 2 j0 + 2 CELLS; zeros outside the image and for no group.
// Its 2 CELLS inner columns come as two 16-byte (float) or two 8-byte
// (bf16) loads where W is a multiple of 4 and they lie inside the row.
template <typename T>
__device__ __forceinline__ void load_patch(const T* __restrict__ x, int H, int W,
                                           const Group& gr, float (&p)[4][PW]) {
  const T* xb = x + static_cast<size_t>(gr.b) * H * W;
  const int c0 = 2 * gr.j0;
  const bool vec = gr.n == CELLS && W % 4 == 0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = 2 * gr.i - 1 + a;
    const bool row_in = gr.n > 0 && r >= 0 && r < H;
    const T* row = xb + static_cast<size_t>(row_in ? r : 0) * W;
    if (row_in && vec) {
      float u[4], t[4];
      load4(row + c0, u);
      load4(row + c0 + 4, t);
      p[a][1] = u[0]; p[a][2] = u[1]; p[a][3] = u[2]; p[a][4] = u[3];
      p[a][5] = t[0]; p[a][6] = t[1]; p[a][7] = t[2]; p[a][8] = t[3];
    } else {
#pragma unroll
      for (int k = 1; k < PW - 1; ++k) {
        const int col = c0 - 1 + k;
        p[a][k] = row_in && col < W ? widen(row[col]) : 0.f;
      }
    }
    p[a][0] = row_in && c0 > 0 ? widen(row[c0 - 1]) : 0.f;
    p[a][PW - 1] = row_in && c0 + PW - 2 < W ? widen(row[c0 + PW - 2]) : 0.f;
  }
}

// v[0 .. N) summed over the 32 lanes of a warp by halving exchanges
// (offsets 16, 8, 4, 2, 1): at each step a lane keeps one half of its values,
// adds its partner's copy of that half and sends the other.  Afterwards lane
// l holds the totals of values base .. base + N / 32 - 1 in v[0 ..) (for
// N < 32 the last steps add whole values, so lanes that differ only in the
// low bits hold the same total).  The order of the additions is fixed: two
// runs give the same bits.  -> base.
template <int N, int M>
__device__ __forceinline__ void halving_step(float* v, int lane, int& base) {
  if constexpr (M > 0) {
    if constexpr (N > 1) {
      constexpr int h = N / 2;
      const bool up = (lane & M) != 0;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = up ? v[i] : v[i + h];
        const float keep = up ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(FULL, send, M);
      }
      if (up) base += h;
      halving_step<h, M / 2>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(FULL, v[0], M);
      halving_step<1, M / 2>(v, lane, base);
    }
  }
}

template <int N>
__device__ __forceinline__ int warp_reduce_scatter(float (&v)[N], int lane) {
  int base = 0;
  halving_step<N, 16>(v, lane, base);
  return base;
}

// out[k] = sum over rows of partials (n_rows, K), in a fixed order: a block
// takes RED_COLS columns, each of its RED_LANES lanes per column adds every
// RED_LANES-th row, then the lanes are added in order.
constexpr int RED_COLS = 32;
constexpr int RED_LANES = 16;

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

inline cudaError_t reduce_columns(const float* partials, int n_rows, int K, float* out,
                                  cudaStream_t s) {
  reduce_columns_kernel<<<(K + RED_COLS - 1) / RED_COLS, RED_COLS * RED_LANES, 0, s>>>(
      partials, n_rows, K, out);
  return cudaGetLastError();
}

}  // namespace fused_conv
