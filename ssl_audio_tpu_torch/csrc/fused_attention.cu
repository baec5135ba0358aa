// Fused multi-head self-attention for short ViT sequences, forward and
// backward, for Hopper.
//
// Replaces the two Pallas bodies of ssl_audio_tpu/ops/fused_attention.py:
// _fwd_kernel behind _fwd_call and _bwd_kernel behind _bwd_call.  The
// contract is kept (ops/fused_attention.py states it with its rounding
// points); the TPU design is not: there every head of a sample was packed
// into block-diagonal (H*N, C) slabs by 0/1 matmuls so that one MXU-shaped
// dot served all heads.  Here one thread block owns one (sample, head) and
// reads that head's q, k and v columns straight from the raw (B, N, 3C) qkv
// with strides: no split, transpose or packing pass.
//
// Inputs and outputs are fp32.  q, k, v (and dO in the backward) are rounded
// to bf16 (nearest even) when they are staged in shared memory; a product of
// two bf16 values is exact in fp32, so every dot is an fp32 sum of exact
// products, as on the TPU's matrix unit.  The softmax runs in fp32 with the
// row max subtracted, expf (not __expf) and an IEEE division, in the order
// of the plain version; P, and dS in the backward, are rounded to bf16 where
// the Pallas kernel feeds them to a dot.
//
// Queries are taken in tiles of TQ rows, so the (TQ, N) fp32 score tile and
// the head's K and V fit shared memory up to the envelope of supports()
// (N <= 256, hd <= 128): at most ~216 KB in the backward.  K and V rows are
// padded to hd + 2 bf16 values, an odd number of 32-bit words, so the
// threads of a warp that walk different keys hit different banks.
//
// Backward: the block loops over the query tiles.  dQ of a tile is complete
// within the tile.  dK and dV sum over all queries: each (key, column)
// element has one owning thread, which adds each tile's partial sum into
// the output in device memory and rounds it (dK times scale, then bf16; dV
// bf16) after the last tile; the main path's N = 25 is one tile.  The
// key-bias cotangent (the column sums of dS) is written per (sample, head,
// key) by the thread that owns the key; the caller sums over heads.  No
// atomics: two launches give the same bits.
//
// Bound on the H100 at the ViT-B step's shape (B 128, N 25, C 768): bytes.
// The forward reads qkv and the bias and writes O, 4 (3 + 1) B N C bytes
// (39 MB, 12 us at 3.35 TB/s), against ~0.25 GFLOP.  This first version is
// simple fp32 FMA on the CUDA cores (no tensor cores), one block per
// (sample, head); PERF.md has its times against the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TQ = 32;                 // query rows per tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum_d a[d] * b[d] over hd (even) bf16 values, fp32 accumulation in order
__device__ __forceinline__ float dot_bf16(const bf16* a, const bf16* b, int hd) {
  const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(a);
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(b);
  float acc = 0.f;
  for (int d = 0; d < hd / 2; ++d) {
    const float2 x = __bfloat1622float2(a2[d]);
    const float2 y = __bfloat1622float2(b2[d]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// rows [n0, n0 + rows) of one third of qkv (or of dout when stride == C and
// col == 0), head h's hd columns, into shared memory as bf16 with row stride ks
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, int stride,
                                           int col, int n0, int rows, int hd,
                                           int ks, bf16* dst) {
  for (int i = threadIdx.x; i < rows * hd; i += THREADS) {
    const int r = i / hd, d = i - (i / hd) * hd;
    dst[r * ks + d] = __float2bfloat16_rn(src[(size_t)(n0 + r) * stride + col + d]);
  }
}

// S = bf16(q) bf16(k)^T * scale + bias for a tile of `rows` queries, then
// the fp32 row softmax in place: s (rows, N) holds P afterwards
__device__ void tile_probs(const bf16* sq, const bf16* sk, const float* sb, float* s,
                           int rows, int N, int hd, int ks, float scale) {
  for (int e = threadIdx.x; e < rows * N; e += THREADS) {
    const int r = e / N, j = e - (e / N) * N;
    s[e] = dot_bf16(sq + r * ks, sk + j * ks, hd) * scale + sb[j];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += WARPS) {
    float* row = s + r * N;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float d = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      d += e;
    }
    d = warp_sum(d);
    for (int j = lane; j < N; j += 32) row[j] = row[j] / d;
  }
  __syncthreads();
}

struct Layout {
  int ks;            // padded row stride of the bf16 tiles
  size_t bias, s, ds, k, v, q, dout, bytes;   // byte offsets, total
};

__host__ __device__ inline Layout layout(int N, int hd, bool backward) {
  Layout L;
  L.ks = hd + 2;
  size_t off = 0;
  L.bias = off; off += sizeof(float) * ((N + 3) / 4 * 4);
  L.s = off;    off += sizeof(float) * TQ * N;
  L.ds = off;   off += backward ? sizeof(float) * TQ * N : 0;
  L.k = off;    off += sizeof(bf16) * N * L.ks;
  L.v = off;    off += sizeof(bf16) * N * L.ks;
  L.q = off;    off += sizeof(bf16) * TQ * L.ks;
  L.dout = off; off += backward ? sizeof(bf16) * TQ * L.ks : 0;
  L.bytes = off;
  return L;
}

__global__ void __launch_bounds__(THREADS)
fused_attention_fwd_kernel(const float* __restrict__ qkv,   // (B, N, 3C)
                           const float* __restrict__ bias,  // (B, N)
                           float* __restrict__ out,         // (B, N, C)
                           int N, int H, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(N, hd, false);
  float* sb = reinterpret_cast<float*>(smem + L.bias);
  float* s = reinterpret_cast<float*>(smem + L.s);
  bf16* sk = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sv = reinterpret_cast<bf16*>(smem + L.v);
  bf16* sq = reinterpret_cast<bf16*>(smem + L.q);
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int C = H * hd, C3 = 3 * C, ks = L.ks;
  const float* x = qkv + (size_t)b * N * C3;

  stage_rows(x, C3, C + h * hd, 0, N, hd, ks, sk);
  stage_rows(x, C3, 2 * C + h * hd, 0, N, hd, ks, sv);
  for (int j = threadIdx.x; j < N; j += THREADS) sb[j] = bias[(size_t)b * N + j];

  for (int q0 = 0; q0 < N; q0 += TQ) {
    const int rows = min(TQ, N - q0);
    stage_rows(x, C3, h * hd, q0, rows, hd, ks, sq);
    __syncthreads();
    tile_probs(sq, sk, sb, s, rows, N, hd, ks, scale);
    // O = bf16(P) bf16(V); a thread per (row, column): 128-byte stores
    for (int e = threadIdx.x; e < rows * hd; e += THREADS) {
      const int r = e / hd, d = e - (e / hd) * hd;
      const float* p = s + r * N;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(round_bf16(p[j]), __bfloat162float(sv[j * ks + d]), acc);
      out[((size_t)b * N + q0 + r) * C + h * hd + d] = acc;
    }
    __syncthreads();      // the next tile overwrites sq and s
  }
}

__global__ void __launch_bounds__(THREADS)
fused_attention_bwd_kernel(const float* __restrict__ qkv,    // (B, N, 3C)
                           const float* __restrict__ bias,   // (B, N)
                           const float* __restrict__ dout,   // (B, N, C)
                           float* __restrict__ dqkv,         // (B, N, 3C)
                           float* __restrict__ dbias,        // (B, H, N)
                           int N, int H, int hd, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(N, hd, true);
  float* sb = reinterpret_cast<float*>(smem + L.bias);
  float* p = reinterpret_cast<float*>(smem + L.s);
  float* ds = reinterpret_cast<float*>(smem + L.ds);
  bf16* sk = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sv = reinterpret_cast<bf16*>(smem + L.v);
  bf16* sq = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sdo = reinterpret_cast<bf16*>(smem + L.dout);
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int C = H * hd, C3 = 3 * C, ks = L.ks;
  const float* x = qkv + (size_t)b * N * C3;
  const float* dy = dout + (size_t)b * N * C;
  float* dx = dqkv + (size_t)b * N * C3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  stage_rows(x, C3, C + h * hd, 0, N, hd, ks, sk);
  stage_rows(x, C3, 2 * C + h * hd, 0, N, hd, ks, sv);
  for (int j = threadIdx.x; j < N; j += THREADS) sb[j] = bias[(size_t)b * N + j];
  float db = 0.f;                       // column sum of dS for key threadIdx.x (N <= THREADS)

  for (int q0 = 0; q0 < N; q0 += TQ) {
    const int rows = min(TQ, N - q0);
    const bool last = q0 + TQ >= N;
    stage_rows(x, C3, h * hd, q0, rows, hd, ks, sq);
    stage_rows(dy, C, h * hd, q0, rows, hd, ks, sdo);
    __syncthreads();
    tile_probs(sq, sk, sb, p, rows, N, hd, ks, scale);
    // T = dP * P with dP = bf16(dO) bf16(V)^T
    for (int e = threadIdx.x; e < rows * N; e += THREADS) {
      const int r = e / N, j = e - (e / N) * N;
      ds[e] = dot_bf16(sdo + r * ks, sv + j * ks, hd) * p[e];
    }
    __syncthreads();
    // dS = T - P * rowsum(T)
    for (int r = warp; r < rows; r += WARPS) {
      float c = 0.f;
      for (int j = lane; j < N; j += 32) c += ds[r * N + j];
      c = warp_sum(c);
      for (int j = lane; j < N; j += 32) ds[r * N + j] = ds[r * N + j] - p[r * N + j] * c;
    }
    __syncthreads();
    if (threadIdx.x < N)
      for (int r = 0; r < rows; ++r) db += ds[r * N + threadIdx.x];
    __syncthreads();
    // the dots take bf16(P) and bf16(dS)
    for (int e = threadIdx.x; e < rows * N; e += THREADS) {
      p[e] = round_bf16(p[e]);
      ds[e] = round_bf16(ds[e]);
    }
    __syncthreads();
    // dQ = bf16(dS) bf16(K) * scale, complete within the tile
    for (int e = threadIdx.x; e < rows * hd; e += THREADS) {
      const int r = e / hd, d = e - (e / hd) * hd;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(ds[r * N + j], __bfloat162float(sk[j * ks + d]), acc);
      dx[(size_t)(q0 + r) * C3 + h * hd + d] = acc * scale;
    }
    // dK = bf16(dS)^T bf16(Q), dV = bf16(P)^T bf16(dO): this tile's part,
    // added by the element's owner to the sum of the earlier tiles
    for (int e = threadIdx.x; e < N * hd; e += THREADS) {
      const int j = e / hd, d = e - (e / hd) * hd;
      float gk = 0.f, gv = 0.f;
      for (int r = 0; r < rows; ++r) {
        gk = fmaf(ds[r * N + j], __bfloat162float(sq[r * ks + d]), gk);
        gv = fmaf(p[r * N + j], __bfloat162float(sdo[r * ks + d]), gv);
      }
      float* pk = dx + (size_t)j * C3 + C + h * hd + d;
      float* pv = pk + C;
      if (q0 > 0) {
        gk += *pk;
        gv += *pv;
      }
      if (last) {
        gk = round_bf16(gk * scale);
        gv = round_bf16(gv);
      }
      *pk = gk;
      *pv = gv;
    }
    __syncthreads();      // the next tile overwrites the staged tiles
  }
  if (threadIdx.x < N) dbias[((size_t)b * H + h) * N + threadIdx.x] = db;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int fused_attention_fwd_launch(const void* qkv, const void* bias, void* out,
                                          int B, int N, int H, int hd, float scale,
                                          void* stream) {
  if (N > THREADS || hd % 2) return (int)cudaErrorInvalidValue;
  const size_t bytes = layout(N, hd, false).bytes;
  cudaError_t err = prepare(fused_attention_fwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  fused_attention_fwd_kernel<<<B * H, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)qkv, (const float*)bias, (float*)out, N, H, hd, scale);
  return (int)cudaGetLastError();
}

extern "C" int fused_attention_bwd_launch(const void* qkv, const void* bias,
                                          const void* dout, void* dqkv, void* dbias,
                                          int B, int N, int H, int hd, float scale,
                                          void* stream) {
  if (N > THREADS || hd % 2) return (int)cudaErrorInvalidValue;
  const size_t bytes = layout(N, hd, true).bytes;
  cudaError_t err = prepare(fused_attention_bwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  fused_attention_bwd_kernel<<<B * H, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)qkv, (const float*)bias, (const float*)dout, (float*)dqkv,
      (float*)dbias, N, H, hd, scale);
  return (int)cudaGetLastError();
}
