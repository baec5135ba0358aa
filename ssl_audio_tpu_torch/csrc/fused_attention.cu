// Fused multi-head self-attention for short ViT sequences, forward and
// backward, for Hopper: several heads per block, the products that take P
// and dS on the tensor cores.
//
// Replaces the two Pallas bodies of ssl_audio_tpu/ops/fused_attention.py:
// _fwd_kernel (:152) behind _fwd_call and _bwd_kernel (:187) behind
// _bwd_call.  The contract is kept (ops/fused_attention.py states it with
// its rounding points); the TPU design is not: there every head of a sample
// was packed into block-diagonal (H*N, C) slabs by 0/1 matmuls so that one
// MXU-shaped dot served all heads.  Here a block reads G heads' q, k, v
// (and dO) columns straight from the raw (B, N, 3C) qkv: no split,
// transpose or packing pass.
//
// Bound on the H100 at the ViT-B step's shape (B 128, N 25, C 768): bytes.
// The forward reads qkv and the bias and writes O, 4 (3 + 1) B N C bytes
// (39 MB, 12 us at 3.35 TB/s), against ~0.25 GFLOP of products; the
// backward moves 7 B N C fp32 values (21 us).  So the design keeps the
// block's whole input in flight at once and little work between a block's
// copies and its stores.
//
// Design.
//   * A block holds G heads of one sample (G divides H; ops/fused_attention.py
//     plan() picks G per launch).  A row of the block's q, k or v columns is
//     G hd fp32 values contiguous in qkv.  Every thread issues its 16-byte
//     cp.async copies of q, k, v (and dO) at once into its own slots of a
//     staging ring (no barrier between copy and conversion; the ring
//     overlays the score tiles, which are not live yet), loads the bias row
//     meanwhile, and converts each chunk to bf16 into row-padded tiles once
//     it has landed.
//   * The scores S = q k^T and, in the backward, dP = dO v^T are fp32 FMA
//     sums over hd in order, on the CUDA cores: the plain version's product
//     (one fp32 FMA per term, d ascending), so P and dS are the plain
//     version's values bit for bit wherever the softmax sums agree.  On the
//     tensor cores the same sums come out in another order, and one P
//     rounded to bf16 the other way moves ~10 elements of dv by a bf16
//     spacing: the first version of this kernel, with S and dP by mma.sync,
//     missed the kernels' 1e-4 relative-L2 limit on small batches (PERF.md,
//     PR 5).  A thread owns 4 rows x 4 keys of a 16 x 32 block: 8 rows
//     loaded per 16 sums, where an mma C fragment's 2 x 4 loads 6 per 8.
//   * The products O = bf16(P) V and dQ = bf16(dS) K run on the tensor
//     cores: mma.sync.m16n8k16 bf16 -> fp32, not wgmma.  wgmma takes 64-row
//     tiles; a head has 25 query rows on the main path (7 for the token-drop
//     teacher) and its own K, so a 64-row tile would be at least 60 %
//     padding.  m16n8k16 pads 25 to 32 queries and keys (7 to 16).  The
//     operands are bf16, so every product is exact.  P and dS are written to
//     shared memory in bf16 and every operand comes by ldmatrix (.trans
//     where it is needed transposed), from rows padded by 16 bytes: eight
//     rows of an 8x8 matrix fall in 32 distinct banks.
//   * dV = bf16(P)^T dO and dK = bf16(dS)^T q, which the contract rounds to
//     bf16, are fp32 FMA sums over queries in order on the CUDA cores, the
//     plain version's order: the tensor cores' order let a dk element round
//     to the other bf16 neighbour, 1.1e-4 of dk's norm at B = 2.
//   * A warp owns (head, 16-query tile) for the softmax, P V and dQ.  The
//     contract rounds the normalised P to bf16 before P V, so FlashAttention's
//     online softmax (normalise O after P V) is out: the warp stores the
//     tile's scores (fp32) in shared memory and takes the row max, then the
//     row sum of expf(s - m), then P = expf(s - m) / d.  Padded keys
//     (j >= N) get -inf, so a row whose every real key is at -1e9 stays the
//     plain version's uniform row and the padding weighs 0.
//   * Backward.  Phase A per (head, query tile): the softmax, then
//     c = rowsum(dP * P) (the contract's centre: O holds bf16(P) bf16(V), so
//     the D = rowsum(dO * O) shortcut would centre otherwise),
//     dS = dP * P - P * c, bf16(P) and bf16(dS) to shared memory with the
//     tile's column sums of dS, dQ = bf16(dS) K.  Phase B per (head, 16-key
//     tile): dV += bf16(P)^T dO and dK += bf16(dS)^T q, the queries in
//     order inside the warp.  K and V stay resident; q and dO come in rounds
//     of R query tiles only where all of them do not fit (N above 64): each
//     dK, dV element's owning thread then keeps its running sum in the
//     output in device memory between rounds, continues it in the next, and
//     rounds after the last round.
//   * The bias cotangent is summed over queries tile by tile, then over the
//     block's G heads, in a fixed order, and written per (sample, head
//     group, key); with G = H that is (B, N).  No float atomics anywhere:
//     two launches give the same bits.
// Not used: TMA, clusters, warp specialisation: ~19 KB per head do not
// need them.
//
// Element types.  Both kernels are templates over T, the type of the tensors
// they read and write (qkv, dO, O, dqkv): float, or __nv_bfloat16 for the
// bf16 compute mode (JAX: O and dq / dk / dv in qkv's dtype,
// fused_attention.py:178, :230-232; the bias and its cotangent fp32, :233).
// A bf16 qkv is read as it is: its 16-byte chunks go by cp.async straight
// into the row-padded tiles, half the bytes and no conversion pass (the
// ring is the fp32 path's).  Every product and sum is as in fp32; what
// differs is the stores: O and dq are rounded to bf16 once (the fp32
// contract leaves them fp32), dK and dV round as they do in fp32.  With
// several rounds of query tiles (N above 64) the running dK / dV sums go to
// an fp32 scratch the size of dqkv, since the bf16 output cannot hold them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int MAX_WARPS = 8;
constexpr int QT = 16;                 // query / key rows per tile

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// shared-memory layout, the same formula as ops/fused_attention.py
// smem_bytes() and launch_warps()
// ---------------------------------------------------------------------------

__host__ __device__ inline int hdp_of(int hd) { return hd <= 32 ? 32 : hd <= 64 ? 64 : 128; }
__host__ __device__ inline int pad16(int n) { return (n + QT - 1) / QT * QT; }
__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline int warps_of(int N, int G, int R, bool backward) {
  const int tasks_a = G * R, tasks_b = G * (pad16(N) / QT);
  const int t = backward && tasks_b > tasks_a ? tasks_b : tasks_a;
  return t < MAX_WARPS ? t : MAX_WARPS;
}

// each thread's 16-byte chunks of the first round's parts (k, q, v; dO), at most
__host__ __device__ inline int staged_chunks(int N, int hd, int G, int R, bool backward, int T) {
  const int cpr = G * hd / 4, rq = R * QT < N ? R * QT : N;
  return 2 * ceil_div(N * cpr, T) + (backward ? 2 : 1) * ceil_div(rq * cpr, T);
}

struct Layout {
  int lds;                // row stride of the q, k, v, dO tiles: HDP + 8 bf16
  int lsf, lsb;           // row strides of the fp32 (np + 2) and bf16 (np + 8) score tiles
  int np, rq;             // padded keys; query rows per round
  int slots;              // ring slots per thread
  size_t k, v, q, dout, bias, colsum, dbias, s, t, p, ds, ring, bytes;
};

// The staging ring (all of a thread's chunks, at most 32 KB a block)
// overlays the score tiles: a round's copies have all landed before its
// first pass writes a score, and the next round's copies start after a
// barrier that follows its last read.
__host__ __device__ inline Layout layout(int N, int hd, int G, int R, bool backward) {
  Layout L;
  L.lds = hdp_of(hd) + 8;
  L.np = pad16(N);
  L.lsf = L.np + 2;
  L.lsb = L.np + 8;
  L.rq = R * QT;
  const int T = 32 * warps_of(N, G, R, backward);
  const int want = staged_chunks(N, hd, G, R, backward, T), most = 2048 / T;
  L.slots = want < most ? want : most;
  const size_t kv = sizeof(bf16) * (size_t)G * L.np * L.lds;
  const size_t qt = sizeof(bf16) * (size_t)G * L.rq * L.lds;
  const size_t rows = (size_t)G * L.rq;                  // score rows
  const int b = backward ? 1 : 0;
  size_t off = 0;
  L.k = off;      off += kv;
  L.v = off;      off += kv;
  L.q = off;      off += qt;
  L.dout = off;   off += b * qt;
  L.bias = off;   off += sizeof(float) * L.np;
  L.colsum = off; off += b * sizeof(float) * G * R * L.np;
  L.dbias = off;  off += b * sizeof(float) * G * L.np;
  L.s = L.ring = off;
  L.t = L.s + sizeof(float) * rows * L.lsf;
  L.p = L.t + b * sizeof(float) * rows * L.lsf;
  L.ds = L.p + sizeof(bf16) * rows * L.lsb;
  const size_t scores = L.ds + b * sizeof(bf16) * rows * L.lsb - off;
  const size_t ring = (size_t)16 * T * L.slots;
  L.bytes = off + (scores > ring ? scores : ring);
  return L;
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// four 8x8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p))
               : "memory");
}

// d += a b, m16n8k16, bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the low and high bf16 of a packed pair as fp32
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// lane's row address inside a 16 x 16 tile at `t` (row stride lds) for
// ldmatrix.x4: as an A operand (matrices: rows 0-7 / 8-15, then cols 8-15)
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int lds, int lane) {
  return t + ((lane & 7) + ((lane >> 3) & 1) * 8) * lds + (lane >> 4) * 8;
}

// ... as the B operand (with .trans) of two n8 tiles whose k runs along the
// tile's rows (V for P V): b0, b1 of columns 0-7, then of columns 8-15
__device__ __forceinline__ const bf16* bk_addr(const bf16* t, int lds, int lane) {
  return t + ((lane & 7) + ((lane >> 3) & 1) * 8) * lds + ((lane >> 4) & 1) * 8;
}

// ---------------------------------------------------------------------------
// staging: fp32 rows of the raw tensors -> bf16 tiles, through cp.async
// ---------------------------------------------------------------------------

// rows [row0, row0 + rows) of G heads' hd columns starting at column col0 of
// a (N, stride) matrix of T, to dst[g][r][d] (bf16, row stride lds, G blocks
// of rows_alloc rows)
template <typename T>
struct Part {
  const T* src;
  int stride, col0, row0, rows, rows_alloc;
  bf16* dst;
};

// elements of T in a 16-byte chunk
template <typename T>
__host__ __device__ constexpr int chunk_elems() { return 16 / (int)sizeof(T); }

// The thread's share of the 16-byte chunks of the staged parts: thread t
// takes chunks t, t + T, ... of a part (4 fp32 or 8 bf16 columns each;
// consecutive threads read consecutive bytes).  fp32: it copies them by
// cp.async into its own slots of the ring (slot i of thread t at
// ring[i T + t]), so it converts only what it copied itself and needs no
// barrier between copy and conversion; where every part's chunks fit the
// ring at once (the ViT shapes) they are all in flight together, otherwise
// each part goes in batches of `slots`.  bf16: straight into the tiles, all
// at once.
struct Stage {
  float4* ring;
  int T, tid, slots, cpr, hd4, lds;  // cpr, hd4: chunks per row of G heads, of one head
  float inv_cpr, inv_hd4;          // exact quotients of the small ints involved
};

__device__ __forceinline__ int quot(int a, float inv) { return (int)(((float)a + 0.5f) * inv); }

template <typename T>
__device__ __forceinline__ int chunks_of(const Stage& st, const Part<T>& P) {
  const int total = P.rows * st.cpr;
  return total > st.tid ? (total - st.tid + st.T - 1) / st.T : 0;
}

// the thread's chunks [from, from + n) of P into ring slots [slot0, slot0 + n)
// (fp32), or into P's tiles (bf16)
template <typename T>
__device__ __forceinline__ void copy_chunks(const Stage& st, const Part<T>& P, int from, int n,
                                            int slot0) {
  constexpr int E = chunk_elems<T>();
  for (int i = 0; i < n; ++i) {
    const int c = st.tid + (from + i) * st.T, r = quot(c, st.inv_cpr), col = c - r * st.cpr;
    const T* src = P.src + (size_t)(P.row0 + r) * P.stride + P.col0 + E * col;
    if constexpr (sizeof(T) == sizeof(bf16)) {
      const int g = quot(col, st.inv_hd4), d = E * (col - g * st.hd4);
      cp_async16(P.dst + ((size_t)g * P.rows_alloc + r) * st.lds + d, src);
    } else {
      cp_async16(st.ring + (slot0 + i) * st.T + st.tid, src);
    }
  }
}

// ... and from the ring, as bf16, into P's tiles (fp32; bf16 chunks landed there)
template <typename T>
__device__ __forceinline__ void convert_chunks(const Stage& st, const Part<T>& P, int from, int n,
                                               int slot0) {
  if constexpr (sizeof(T) == sizeof(float)) {
    for (int i = 0; i < n; ++i) {
      const int c = st.tid + (from + i) * st.T, r = quot(c, st.inv_cpr), col = c - r * st.cpr;
      const int g = quot(col, st.inv_hd4), d = 4 * (col - g * st.hd4);
      const float4 x = st.ring[(slot0 + i) * st.T + st.tid];
      uint2 packed;
      packed.x = pack_bf16(x.x, x.y);
      packed.y = pack_bf16(x.z, x.w);
      *reinterpret_cast<uint2*>(P.dst + ((size_t)g * P.rows_alloc + r) * st.lds + d) = packed;
    }
  }
}

// one part in batches of `slots`, each waited for
template <typename T>
__device__ __forceinline__ void stage_part(const Stage& st, const Part<T>& P) {
  const int n = chunks_of(st, P);
  for (int from = 0; from < n; from += st.slots) {
    const int m = min(st.slots, n - from);
    copy_chunks(st, P, from, m, 0);
    cp_async_commit();
    cp_async_wait_all();
    convert_chunks(st, P, from, m, 0);
  }
}

// parts a (, b, c, d): all in flight at once if the ring holds them
// (`all`; always for bf16), else one after another; `between` runs while
// the copies are in flight
template <typename T, typename F>
__device__ __forceinline__ void stage(const Stage& st, bool all, int nparts, const Part<T>& a,
                                      const Part<T>& b, const Part<T>& c, const Part<T>& d,
                                      F between) {
  if (all || sizeof(T) == sizeof(bf16)) {
    const int na = chunks_of(st, a), nb = nparts > 1 ? chunks_of(st, b) : 0;
    const int nc = nparts > 2 ? chunks_of(st, c) : 0, nd = nparts > 3 ? chunks_of(st, d) : 0;
    copy_chunks(st, a, 0, na, 0);
    if (nparts > 1) copy_chunks(st, b, 0, nb, na);
    if (nparts > 2) copy_chunks(st, c, 0, nc, na + nb);
    if (nparts > 3) copy_chunks(st, d, 0, nd, na + nb + nc);
    cp_async_commit();
    between();
    cp_async_wait_all();
    convert_chunks(st, a, 0, na, 0);
    if (nparts > 1) convert_chunks(st, b, 0, nb, na);
    if (nparts > 2) convert_chunks(st, c, 0, nc, na + nb);
    if (nparts > 3) convert_chunks(st, d, 0, nd, na + nb + nc);
  } else {
    between();
    stage_part(st, a);
    if (nparts > 1) stage_part(st, b);
    if (nparts > 2) stage_part(st, c);
    if (nparts > 3) stage_part(st, d);
  }
}

// zero rows [rows, alloc) of each of G tiles (what the products read past
// the staged rows must be finite)
__device__ __forceinline__ void zero_rows(bf16* t, int G, int rows, int alloc, int lds) {
  const int per_row = lds / 8, per_tile = (alloc - rows) * per_row;
  for (int i = threadIdx.x; i < G * per_tile; i += blockDim.x) {
    const int g = i / per_tile, k = i - g * per_tile;
    *reinterpret_cast<uint4*>(t + ((size_t)g * alloc + rows + k / per_row) * lds +
                              8 * (k % per_row)) = make_uint4(0, 0, 0, 0);
  }
}

// ---------------------------------------------------------------------------
// the work of one warp
// ---------------------------------------------------------------------------

// One head's tiles in shared memory, as a warp sees them.
struct Head {
  const bf16 *q, *k, *v, *dout;   // q, dout: the warp's query rows; k, v: all keys
  const float* bias;              // (np): the key bias, -inf on padded keys
  float *s, *t;                   // fp32 score and dP * P rows of the query tile (stride lsf)
  bf16 *p, *ds;                   // bf16 P and dS rows of the query tile (stride lsb)
  int lds, lsf, lsb, np, hd, n;   // n: real keys
  float scale;
};

__device__ __forceinline__ void unpack4(uint2 x, float (&v)[4]) {
  v[0] = bf_lo(x.x);
  v[1] = bf_hi(x.x);
  v[2] = bf_lo(x.y);
  v[3] = bf_hi(x.y);
}

// a b^T for the 16 rows of a and the 32 rows of b (bf16, row stride lds),
// fp32 FMA over hd in order (d = 0, 1, ...).  Thread (rg, kg) = (lane / 8,
// lane % 8) owns rows 4 rg + i and columns kg + 8 j (acc[i][j]); column
// groups j >= NJ hold no real key and are left at 0.
template <int NJ>
__device__ __forceinline__ void fma_block_t(const bf16* a, const bf16* b, int lds, int hd,
                                            int lane, float (&acc)[4][4]) {
  const bf16* ar = a + 4 * (lane >> 3) * lds;
  const bf16* br = b + (lane & 7) * lds;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < hd; d += 4) {
    float x[4][4], y[NJ][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) unpack4(*reinterpret_cast<const uint2*>(ar + i * lds + d), x[i]);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      unpack4(*reinterpret_cast<const uint2*>(br + 8 * j * lds + d), y[j]);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(x[i][dd], y[j][dd], acc[i][j]);
  }
}

// the block of columns kb .. kb + 31 (nj of its 8-column groups hold real keys)
__device__ __forceinline__ void fma_block(const bf16* a, const bf16* b, int lds, int hd, int lane,
                                          int nj, float (&acc)[4][4]) {
  switch (nj) {
    case 1: fma_block_t<1>(a, b, lds, hd, lane, acc); break;
    case 2: fma_block_t<2>(a, b, lds, hd, lane, acc); break;
    case 3: fma_block_t<3>(a, b, lds, hd, lane, acc); break;
    default: fma_block_t<4>(a, b, lds, hd, lane, acc); break;
  }
}

__device__ __forceinline__ int groups_of(int n, int kb) {
  const int g = ceil_div(n - kb, 8);
  return g < 4 ? g : 4;
}

__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// The softmax of a query tile with `rows` real rows: S = (q k^T) * scale +
// bias into the fp32 score rows and the row max m; expf(s - m) and the row
// sum d; then P = expf(s - m) / d, fp32 into the score rows and bf16 into
// the P rows (0 on padded query rows).  Each thread's elements as in
// fma_block; a row's 8 owners reduce by shuffles.
__device__ __forceinline__ void softmax_tile(const Head& hh, int lane, int rows) {
  const int rg = lane >> 3, kg = lane & 7;
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY}, d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kb = 0; kb < hh.np; kb += 32) {
    float acc[4][4];
    fma_block(hh.q, hh.k + kb * hh.lds, hh.lds, hh.hd, lane, groups_of(hh.n, kb), acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kb + 8 * j >= hh.np) continue;
      const int key = kb + kg + 8 * j;
      const float b = hh.bias[key];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = __fadd_rn(__fmul_rn(acc[i][j], hh.scale), b);
        hh.s[(4 * rg + i) * hh.lsf + key] = s;
        m[i] = fmaxf(m[i], s);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = group_max(m[i]);
  for (int key = kg; key < hh.np; key += 8)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* s = hh.s + (4 * rg + i) * hh.lsf + key;
      const float e = expf(*s - m[i]);
      *s = e;
      d[i] += e;
    }
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = group_sum(d[i]);
  for (int key = kg; key < hh.np; key += 8)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * rg + i;
      float* s = hh.s + row * hh.lsf + key;
      const float p = row < rows ? __fdiv_rn(*s, d[i]) : 0.f;
      *s = p;
      hh.p[row * hh.lsb + key] = __float2bfloat16_rn(p);
    }
}

template <int HDP>
__device__ __forceinline__ void mma_rows(float (&acc)[HDP / 8][4], const uint32_t (&a)[4],
                                         const bf16* tile, int lds, int hd, int lane);

// acc (16 x hd) = bf16 rows x (np x hd) tile: A fragments of the 16 rows
// (stride ls) by ldmatrix, one k16 step per 16 keys
template <int HDP>
__device__ __forceinline__ void rows_times(float (&acc)[HDP / 8][4], const bf16* rows, int ls,
                                           const bf16* tile, int lds, int np, int hd,
                                           int lane) {
#pragma unroll
  for (int nt = 0; nt < HDP / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int kt = 0; kt < np / QT; ++kt) {
    uint32_t a[4];
    ldsm_x4(a, a_addr(rows + kt * QT, ls, lane));
    mma_rows<HDP>(acc, a, tile + kt * QT * lds, lds, hd, lane);
  }
}

// Backward phase A after softmax_tile: T = dP * P (dP = dO v^T by FMA) into
// the dP * P rows and c = rowsum(T); then dS = T - P * c (0 on padded rows)
// as bf16 into the dS rows, and the tile's column sums of dS to colsum
__device__ __forceinline__ void ds_tile(const Head& hh, int lane, int rows, float* colsum) {
  const int rg = lane >> 3, kg = lane & 7;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int kb = 0; kb < hh.np; kb += 32) {
    float acc[4][4];
    fma_block(hh.dout, hh.v + kb * hh.lds, hh.lds, hh.hd, lane, groups_of(hh.n, kb), acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kb + 8 * j >= hh.np) continue;
      const int key = kb + kg + 8 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int at = (4 * rg + i) * hh.lsf + key;
        const float t = __fmul_rn(acc[i][j], hh.s[at]);
        hh.t[at] = t;
        c[i] += t;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = group_sum(c[i]);
  for (int key = kg; key < hh.np; key += 8) {
    float col = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 4 * rg + i, at = row * hh.lsf + key;
      const float ds = row < rows ? __fsub_rn(hh.t[at], __fmul_rn(hh.s[at], c[i])) : 0.f;
      hh.ds[row * hh.lsb + key] = __float2bfloat16_rn(ds);
      col += ds;
    }
    col += __shfl_xor_sync(0xffffffffu, col, 8);
    col += __shfl_xor_sync(0xffffffffu, col, 16);
    if (rg == 0) colsum[key] = col;
  }
}

template <int HDP>
__device__ __forceinline__ void mma_rows(float (&acc)[HDP / 8][4], const uint32_t (&a)[4],
                                         const bf16* tile, int lds, int hd, int lane) {
#pragma unroll
  for (int n2 = 0; n2 < HDP / 16; ++n2) {
    if (n2 * 16 < hd) {
      uint32_t b[4];
      ldsm_x4_t(b, bk_addr(tile + n2 * 16, lds, lane));
      mma16816(acc[2 * n2], a, b[0], b[1]);
      mma16816(acc[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = u;
}

// rows [0, rows) and columns [0, hd) of acc (n8 tiles over hd) times `mul`,
// rounded to bf16 if `bf`, to dst (row stride ld; a bf16 dst rounds anyway)
template <int HDP, typename T>
__device__ __forceinline__ void store_rows(T* dst, int ld, const float (&acc)[HDP / 8][4],
                                           int rows, int hd, int lane, float mul, bool bf) {
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < HDP / 8; ++nt) {
    const int col = nt * 8 + 2 * q4;
    if (col >= hd) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r >= rows) continue;
      float a = __fmul_rn(acc[nt][2 * h], mul), b = __fmul_rn(acc[nt][2 * h + 1], mul);
      if (bf) {
        a = round_bf16(a);
        b = round_bf16(b);
      }
      store2(dst + (size_t)r * ld + col, a, b);
    }
  }
}

// Backward phase B: dV = bf16(P)^T dO and dK = bf16(dS)^T q for key tile kt
// of one head, fp32 FMA over the round's queries in order (i = 0, 1, ...):
// the plain version's order (ops/fused_attention.py _sum_over_queries), so
// the sums are its sums bit for bit and round to the same bf16 values.  On
// the tensor cores the same sums come out in another order, and a dk element
// rounded to the other bf16 neighbour was 1.1e-4 of dk's norm at N = 256,
// B = 2 (PERF.md).  Lane (kq, cq) = (lane / 8, lane % 8) owns keys
// 4 kq .. 4 kq + 3 and columns c0 + 4 cq .. + 3 of each 32-column chunk c0.
// With several rounds the running sums go to `run` in device memory after
// each round, exactly, and the next round continues from them (fp32: run is
// the output; bf16: an fp32 scratch of the output's layout); after the last,
// dK is scaled and both are rounded to bf16 and stored to dst.
template <typename T>
__device__ __forceinline__ void bwd_keys(const bf16* q, const bf16* dout, int lds, int hd,
                                         int lane, int kt, const bf16* p_rows,
                                         const bf16* ds_rows, int ls, int q_valid, int keys,
                                         T* dst, float* run, int ld, int C, float scale,
                                         bool first, bool last) {
  const int kq = lane >> 3, cq = lane & 7;
  const bf16* pr = p_rows + kt * QT + 4 * kq;
  const bf16* sr = ds_rows + kt * QT + 4 * kq;
  for (int c0 = 0; c0 < hd; c0 += 32) {
    const int col = c0 + 4 * cq;
    if (col >= hd) continue;
    float dk[4][4], dv[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float4 k4 = make_float4(0.f, 0.f, 0.f, 0.f), v4 = k4;
      if (!first && 4 * kq + a < keys) {
        const float* o = run + (size_t)(4 * kq + a) * ld + col;
        k4 = *reinterpret_cast<const float4*>(o);
        v4 = *reinterpret_cast<const float4*>(o + C);
      }
      dk[a][0] = k4.x; dk[a][1] = k4.y; dk[a][2] = k4.z; dk[a][3] = k4.w;
      dv[a][0] = v4.x; dv[a][1] = v4.y; dv[a][2] = v4.z; dv[a][3] = v4.w;
    }
    for (int i = 0; i < q_valid; ++i) {
      float pv[4], sv[4], x[4], y[4];
      unpack4(*reinterpret_cast<const uint2*>(pr + i * ls), pv);
      unpack4(*reinterpret_cast<const uint2*>(sr + i * ls), sv);
      unpack4(*reinterpret_cast<const uint2*>(q + i * lds + col), x);
      unpack4(*reinterpret_cast<const uint2*>(dout + i * lds + col), y);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv[a][e] = fmaf(pv[a], y[e], dv[a][e]);
          dk[a][e] = fmaf(sv[a], x[e], dk[a][e]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (4 * kq + a >= keys) continue;
      if (last) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dk[a][e] = round_bf16(__fmul_rn(dk[a][e], scale));
          dv[a][e] = round_bf16(dv[a][e]);
        }
      }
      const size_t at = (size_t)(4 * kq + a) * ld + col;
      if (last) {
        store4(dst + at, dk[a]);
        store4(dst + at + C, dv[a]);
      } else {
        store4(run + at, dk[a]);
        store4(run + at + C, dv[a]);
      }
    }
  }
}

struct Block {
  int b, group, h0, C, rounds, warp, lane, W;
  Layout L;
  Stage st;
};

// E: elements of the staged type in a 16-byte chunk
__device__ __forceinline__ Block block_of(unsigned char* smem, int N, int H, int hd, int G,
                                          int R, bool backward, int E) {
  Block k;
  k.L = layout(N, hd, G, R, backward);
  k.W = blockDim.x / 32;
  k.warp = threadIdx.x >> 5;
  k.lane = threadIdx.x & 31;
  const int groups = H / G;
  k.b = blockIdx.x / groups;
  k.group = blockIdx.x - k.b * groups;
  k.h0 = k.group * G;
  k.C = H * hd;
  k.rounds = (k.L.np / QT + R - 1) / R;
  k.st.ring = reinterpret_cast<float4*>(smem + k.L.ring);
  k.st.T = blockDim.x;
  k.st.tid = threadIdx.x;
  k.st.slots = k.L.slots;
  k.st.cpr = G * hd / E;
  k.st.hd4 = hd / E;
  k.st.lds = k.L.lds;
  k.st.inv_cpr = 1.f / k.st.cpr;
  k.st.inv_hd4 = 1.f / k.st.hd4;
  return k;
}

// the key bias of sample b, -inf on the padded keys
__device__ __forceinline__ void bias_row(float* sb, const float* bias, int b, int N, int np) {
  for (int j = threadIdx.x; j < np; j += blockDim.x)
    sb[j] = j < N ? bias[(size_t)b * N + j] : -INFINITY;
}

template <int HDP, typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, HDP == 128 ? 1 : 2)
fused_attention_fwd_kernel(const T* __restrict__ qkv,       // (B, N, 3C)
                           const float* __restrict__ bias,  // (B, N)
                           T* __restrict__ out,             // (B, N, C)
                           int N, int H, int hd, int G, int R, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Block k = block_of(smem, N, H, hd, G, R, false, chunk_elems<T>());
  const Layout& L = k.L;
  bf16* sk = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sv = reinterpret_cast<bf16*>(smem + L.v);
  bf16* sq = reinterpret_cast<bf16*>(smem + L.q);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  bf16* sp = reinterpret_cast<bf16*>(smem + L.p);
  float* sb = reinterpret_cast<float*>(smem + L.bias);
  const int C = k.C, C3 = 3 * C;
  const T* x = qkv + (size_t)k.b * N * C3;

  for (int round = 0; round < k.rounds; ++round) {
    const int qrow0 = round * L.rq, q_valid = min(L.rq, N - qrow0);
    const Part<T> pq = {x, C3, k.h0 * hd, qrow0, q_valid, L.rq, sq};
    if (round == 0) {
      const Part<T> pk = {x, C3, C + k.h0 * hd, 0, N, L.np, sk};
      const Part<T> pv = {x, C3, 2 * C + k.h0 * hd, 0, N, L.np, sv};
      stage(k.st, staged_chunks(N, hd, G, R, false, k.st.T) <= L.slots, 3, pk, pq, pv, pv, [&] {
        bias_row(sb, bias, k.b, N, L.np);
        zero_rows(sk, G, N, L.np, L.lds);
        zero_rows(sv, G, N, L.np, L.lds);
        zero_rows(sq, G, q_valid, L.rq, L.lds);
      });
    } else {
      __syncthreads();                             // the last round read sq and the scores
      stage(k.st, ceil_div(q_valid * k.st.cpr, k.st.T) <= L.slots, 1, pq, pq, pq, pq, [] {});
    }
    __syncthreads();
    for (int t = k.warp; t < G * R; t += k.W) {
      const int gl = t / R, r = t - gl * R;
      if (r * QT >= q_valid) continue;
      const int o = gl * L.rq + r * QT, rows = min(QT, q_valid - r * QT);
      const Head hh = {sq + o * L.lds, sk + gl * L.np * L.lds, sv + gl * L.np * L.lds, nullptr,
                       sb, ss + o * L.lsf, nullptr, sp + o * L.lsb, nullptr, L.lds, L.lsf,
                       L.lsb, L.np, hd, N, scale};
      softmax_tile(hh, k.lane, rows);
      __syncwarp();
      float acc[HDP / 8][4];
      rows_times<HDP>(acc, hh.p, L.lsb, hh.v, L.lds, L.np, hd, k.lane);
      store_rows<HDP>(out + ((size_t)k.b * N + qrow0 + r * QT) * C + (k.h0 + gl) * hd, C, acc,
                      rows, hd, k.lane, 1.f, false);
    }
  }
}

template <int HDP, typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, HDP == 128 ? 1 : 2)
fused_attention_bwd_kernel(const T* __restrict__ qkv,        // (B, N, 3C)
                           const float* __restrict__ bias,   // (B, N)
                           const T* __restrict__ dout,       // (B, N, C)
                           T* __restrict__ dqkv,             // (B, N, 3C)
                           float* __restrict__ dbias,        // (B, H / G, N)
                           float* run,                       // bf16, rounds > 1: (B, N, 3C) scratch
                           int N, int H, int hd, int G, int R, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Block k = block_of(smem, N, H, hd, G, R, true, chunk_elems<T>());
  const Layout& L = k.L;
  bf16* sk = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sv = reinterpret_cast<bf16*>(smem + L.v);
  bf16* sq = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sd = reinterpret_cast<bf16*>(smem + L.dout);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  float* stt = reinterpret_cast<float*>(smem + L.t);
  bf16* sp = reinterpret_cast<bf16*>(smem + L.p);
  bf16* sds = reinterpret_cast<bf16*>(smem + L.ds);
  float* sb = reinterpret_cast<float*>(smem + L.bias);
  float* scs = reinterpret_cast<float*>(smem + L.colsum);
  float* sdb = reinterpret_cast<float*>(smem + L.dbias);
  const int C = k.C, C3 = 3 * C, nkt = L.np / QT;
  const T* x = qkv + (size_t)k.b * N * C3;
  const T* dy = dout + (size_t)k.b * N * C;
  T* dx = dqkv + (size_t)k.b * N * C3;
  // dK / dV running sums between rounds: the fp32 output itself, or the scratch
  float* dxr = nullptr;
  if constexpr (sizeof(T) == sizeof(float)) dxr = reinterpret_cast<float*>(dx);
  else if (run != nullptr) dxr = run + (size_t)k.b * N * C3;

  for (int round = 0; round < k.rounds; ++round) {
    const int qrow0 = round * L.rq, q_valid = min(L.rq, N - qrow0);
    const bool first = round == 0, last = round == k.rounds - 1;
    const Part<T> pq = {x, C3, k.h0 * hd, qrow0, q_valid, L.rq, sq};
    const Part<T> pd = {dy, C, k.h0 * hd, qrow0, q_valid, L.rq, sd};
    if (first) {
      const Part<T> pk = {x, C3, C + k.h0 * hd, 0, N, L.np, sk};
      const Part<T> pv = {x, C3, 2 * C + k.h0 * hd, 0, N, L.np, sv};
      stage(k.st, staged_chunks(N, hd, G, R, true, k.st.T) <= L.slots, 4, pk, pq, pv, pd, [&] {
        bias_row(sb, bias, k.b, N, L.np);
        zero_rows(sk, G, N, L.np, L.lds);
        zero_rows(sv, G, N, L.np, L.lds);
        zero_rows(sq, G, q_valid, L.rq, L.lds);
        zero_rows(sd, G, q_valid, L.rq, L.lds);
      });
    } else {
      __syncthreads();                             // the last round read the round's tiles
      stage(k.st, 2 * ceil_div(q_valid * k.st.cpr, k.st.T) <= L.slots, 2, pq, pd, pd, pd,
            [] {});
    }
    __syncthreads();
    // phase A: per (head, query tile)
    for (int t = k.warp; t < G * R; t += k.W) {
      const int gl = t / R, r = t - gl * R;
      if (r * QT >= q_valid) continue;
      const int o = gl * L.rq + r * QT, rows = min(QT, q_valid - r * QT);
      const Head hh = {sq + o * L.lds, sk + gl * L.np * L.lds, sv + gl * L.np * L.lds,
                       sd + o * L.lds, sb, ss + o * L.lsf, stt + o * L.lsf, sp + o * L.lsb,
                       sds + o * L.lsb, L.lds, L.lsf, L.lsb, L.np, hd, N, scale};
      softmax_tile(hh, k.lane, rows);
      ds_tile(hh, k.lane, rows, scs + (gl * R + r) * L.np);
      __syncwarp();
      float acc[HDP / 8][4];
      rows_times<HDP>(acc, hh.ds, L.lsb, hh.k, L.lds, L.np, hd, k.lane);
      store_rows<HDP>(dx + (size_t)(qrow0 + r * QT) * C3 + (k.h0 + gl) * hd, C3, acc, rows, hd,
                      k.lane, scale, false);
    }
    __syncthreads();
    // the bias cotangent: the round's tiles' column sums, in order
    for (int i = threadIdx.x; i < G * L.np; i += blockDim.x) {
      const int gl = i / L.np, j = i - gl * L.np;
      float acc = first ? 0.f : sdb[i];
      for (int r = 0; r * QT < q_valid; ++r) acc += scs[(gl * R + r) * L.np + j];
      sdb[i] = acc;
    }
    // phase B: dK, dV per (head, key tile)
    for (int t = k.warp; t < G * nkt; t += k.W) {
      const int gl = t / nkt, kt = t - gl * nkt;
      const size_t at = (size_t)(kt * QT) * C3 + C + (k.h0 + gl) * hd;
      bwd_keys(sq + gl * L.rq * L.lds, sd + gl * L.rq * L.lds, L.lds, hd, k.lane, kt,
               sp + gl * L.rq * L.lsb, sds + gl * L.rq * L.lsb, L.lsb, q_valid,
               min(QT, N - kt * QT), dx + at, dxr == nullptr ? nullptr : dxr + at, C3, C,
               scale, first, last);
    }
  }
  __syncthreads();
  // the bias cotangent summed over the block's heads, in order
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float acc = 0.f;
    for (int g = 0; g < G; ++g) acc += sdb[g * L.np + j];
    dbias[((size_t)k.b * (H / G) + k.group) * N + j] = acc;
  }
}

// allow the largest block the envelope needs and prefer shared memory over
// L1 (the caller keeps one flag per kernel: once per instantiation)
template <typename Kernel>
cudaError_t prepare(Kernel kernel, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         232448);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

bool valid(int B, int N, int H, int hd, int G, int R, bool backward) {
  return B >= 1 && N >= 1 && N <= 256 && hd >= 8 && hd <= 128 && hd % 8 == 0 && G >= 1 &&
         H % G == 0 && R >= 1 && R <= pad16(N) / QT &&
         layout(N, hd, G, R, backward).bytes <= 232448;
}

template <int HDP, typename T>
cudaError_t fwd(const void* qkv, const void* bias, void* out, int B, int N, int H, int hd,
                float scale, int G, int R, cudaStream_t stream) {
  static bool prepared = false;
  auto kernel = fused_attention_fwd_kernel<HDP, T>;
  cudaError_t err = prepare(kernel, prepared);
  if (err != cudaSuccess) return err;
  kernel<<<B * (H / G), 32 * warps_of(N, G, R, false), layout(N, hd, G, R, false).bytes,
           stream>>>((const T*)qkv, (const float*)bias, (T*)out, N, H, hd, G, R, scale);
  return cudaGetLastError();
}

template <int HDP, typename T>
cudaError_t bwd(const void* qkv, const void* bias, const void* dout, void* dqkv, void* dbias,
                void* run, int B, int N, int H, int hd, float scale, int G, int R,
                cudaStream_t stream) {
  static bool prepared = false;
  auto kernel = fused_attention_bwd_kernel<HDP, T>;
  cudaError_t err = prepare(kernel, prepared);
  if (err != cudaSuccess) return err;
  kernel<<<B * (H / G), 32 * warps_of(N, G, R, true), layout(N, hd, G, R, true).bytes,
           stream>>>((const T*)qkv, (const float*)bias, (const T*)dout, (T*)dqkv,
                     (float*)dbias, (float*)run, N, H, hd, G, R, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_t(const void* qkv, const void* bias, void* out, int B, int N, int H, int hd,
                  float scale, int G, int R, cudaStream_t s) {
  switch (hdp_of(hd)) {
    case 32: return fwd<32, T>(qkv, bias, out, B, N, H, hd, scale, G, R, s);
    case 64: return fwd<64, T>(qkv, bias, out, B, N, H, hd, scale, G, R, s);
    default: return fwd<128, T>(qkv, bias, out, B, N, H, hd, scale, G, R, s);
  }
}

template <typename T>
cudaError_t bwd_t(const void* qkv, const void* bias, const void* dout, void* dqkv, void* dbias,
                  void* run, int B, int N, int H, int hd, float scale, int G, int R,
                  cudaStream_t s) {
  switch (hdp_of(hd)) {
    case 32: return bwd<32, T>(qkv, bias, dout, dqkv, dbias, run, B, N, H, hd, scale, G, R, s);
    case 64: return bwd<64, T>(qkv, bias, dout, dqkv, dbias, run, B, N, H, hd, scale, G, R, s);
    default: return bwd<128, T>(qkv, bias, dout, dqkv, dbias, run, B, N, H, hd, scale, G, R, s);
  }
}

}  // namespace

// G heads per block, R query tiles of 16 per round: ops/fused_attention.py
// plan().  qkv and out of element type dtype (0 float, 1 bf16); bias float.
extern "C" int fused_attention_fwd_launch(const void* qkv, const void* bias, void* out,
                                          int B, int N, int H, int hd, float scale, int G,
                                          int R, int dtype, void* stream) {
  if (!valid(B, N, H, hd, G, R, false) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype ? fwd_t<bf16>(qkv, bias, out, B, N, H, hd, scale, G, R, s)
                     : fwd_t<float>(qkv, bias, out, B, N, H, hd, scale, G, R, s));
}

// qkv, dout and dqkv of element type dtype; bias and dbias float.  run: for
// bf16 with more than one round of query tiles, an fp32 (B, N, 3C) scratch
// for the running dK / dV sums; else unused (may be null).
extern "C" int fused_attention_bwd_launch(const void* qkv, const void* bias,
                                          const void* dout, void* dqkv, void* dbias,
                                          void* run, int B, int N, int H, int hd, float scale,
                                          int G, int R, int dtype, void* stream) {
  if (!valid(B, N, H, hd, G, R, true) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (dtype && R < pad16(N) / QT && run == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(dtype ? bwd_t<bf16>(qkv, bias, dout, dqkv, dbias, run, B, N, H, hd, scale, G, R, s)
                     : bwd_t<float>(qkv, bias, dout, dqkv, dbias, run, B, N, H, hd, scale, G, R,
                                    s));
}

// the launch geometry the kernels take for (N, hd, G, R): shared-memory
// bytes and warps per block (checked against the host's plan by the card
// tests)
extern "C" int fused_attention_smem_bytes(int N, int hd, int G, int R, int backward) {
  return (int)layout(N, hd, G, R, backward != 0).bytes;
}

extern "C" int fused_attention_warps(int N, int G, int R, int backward) {
  return warps_of(N, G, R, backward != 0);
}
