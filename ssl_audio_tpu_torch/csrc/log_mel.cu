// Fused framing -> windowed DFT -> power -> mel -> log for Hopper, the DFT
// on the tensor cores at fp32 accuracy.
//
// Replaces the Pallas kernel of ssl_audio_tpu/ops/mel_pallas.py
// (log_mel_spectrogram_pallas, the pallas_call at :326): the FOLD=true
// instantiation stands for _make_kernel_folded (:185; e = f + f_rev against
// the half cos basis, o = f - f_rev against the half sin basis), FOLD=false
// for _make_kernel (:139; full frames against the full bases).  The TPU
// kernel's hop-row layout, reversed-row tensor and sublane rotates were
// Mosaic constraints and are not carried over.
//
// (B, L) wav -> (B, n_mels, T) log-mel, torch.stft(center=True) reflect
// centring included.  With per-clip crop starts (the training frontend,
// log_mel_spectrogram_cropped there) output frame t of clip b is frame
// starts[b] + t of the clip's T_full frames, clamped to the clip: the block
// reads its clip's start itself and the reflect index is taken on the whole
// clip.  The host passes only the basis rows inside the window's support
// [n_lo, n_lo + K) (zero rows outside it are skipped exactly: the HEAR window
// is 400 of 1024 samples), K padded with zero rows to a multiple of 8.
//
// Accuracy.  As the Pallas kernel's "fast" mode splits fp32 operands into
// bf16 parts for the MXU (mel_pallas.py:23-38, MODE_PASSES :74-78), this
// kernel splits them into TF32 parts for mma.sync m16n8k8:
// hi = cvt.rna(x), lo = cvt.rna(x - hi), and sums hi*hi + hi*lo + lo*hi in
// fp32 accumulators.  The 11-bit parts leave ~2^-22 of relative error per
// product (fp32: 2^-24); the dropped lo*lo pass is of the same order as the
// rounding of lo itself, so a fourth pass would not buy a digit.  The basis
// is split once on the host (ops/mel_kernel.py kernel_operands, packed in
// fragment order), the frames as their fragments are built.  (Raw fp32 bits
// fed to a TF32 mma are truncated, so lo would not hold the remainder: the
// split rounds with cvt.rna.)
//
// Bound on the H100 (ops/mel_kernel.py flops_per_frame, chip_smoke.py): the
// DFT is 4 K n_pad flops per frame, three TF32 passes of it at 495 TFLOP/s,
// plus the power and the banded mel product at the fp32 rate of 67 TFLOP/s;
// the new wav and output are ~0.9 kB per frame, so operations bound it.  The
// fp32 bound of the CUDA-core version this replaces (all at 67 TFLOP/s) is
// reported beside it.
//
// Design, against what held the CUDA-core version back:
//   1. The DFT product runs on the tensor cores: M = frames, N = frequency
//      columns, K = support rows.  A warp owns a 32-frame x 32-column tile of
//      re AND im (2 x 4 m16n8 tiles each, 64 fp32 accumulators), so
//      re^2 + im^2 is formed in registers: no exchange between warps.  Three
//      passes run at ~0.085 ms each on a HEAR chunk (PERF.md section 6): half of
//      the kernel's time.
//   2. The block stages the raw wav segment its TILE_T frames read, once,
//      reflect-indexed, by asynchronous copies: (TILE_T - 1) hop + (support)
//      samples, stored as rows of `hop` samples with a row stride = 4 mod 32
//      words, so the 8 frames x 4 columns of an A fragment fall in 32
//      distinct banks.  A fragments
//      (f[n] + f[N-n] and f[n] - f[N-n] folded, f[n] unfolded) are built from
//      it per k-step; the frame matrix never exists.  46 kB at TILE_T = 64,
//      67 kB at 96, where the CUDA-core version held 130-180 kB of 32 frames.
//   3. The basis goes through shared memory: slabs of 8 rows x FCH columns of
//      cos and sin, hi and lo, already in mma fragment order (one 16-byte
//      LDS per lane per n-tile), copied with cp.async STAGES deep so the next
//      slabs are in flight while the tensor cores consume this one.  Every
//      warp of the block reads the same slab.
//   4. Per chunk of FCH columns the power goes to shared memory once (over
//      the drained slab buffers); each thread then adds the chunk's share of
//      the banded mel product for one frame and a quarter of the mels, fp32
//      FMA over each band's nonzero filterbank rows only (their weights packed
//      band after band in shared memory, ~4 kB), to sums kept in shared
//      memory.  log(mel + eps) is stored with consecutive threads on
//      consecutive frames (coalesced in the (n_mels, T) layout).
// Tiles: TILE_T = 96 (12 warps, one block per SM: no padded frames at the
// paths' T = 96, a third less basis traffic per frame) or 64 (8 warps, two
// blocks per SM at the HEAR spec), whichever keeps the SMs busy the shortest
// time for the launch (ops/mel_kernel.py tile_for: 96 for the timestamp
// chunks and the training crops, 64 for a scene request's 16 clips of 1001
// frames).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FCH = 128;                        // frequency columns per chunk
constexpr int NT_CHUNK = FCH / 8;               // mma n-tiles per chunk
constexpr int STAGES = 3;                       // basis slabs in flight
constexpr int SLAB_FLOATS = NT_CHUNK * 2 * 32 * 4;   // (n-tile, cos|sin, lane, 4)
constexpr int P_STRIDE = FCH + 1;               // power row: conflict-free column reads
constexpr int COL_WARPS = FCH / 32;             // warps across a chunk's columns
constexpr int MEL_GROUPS = 4;                   // threads per frame in the mel product
constexpr int MAX_MELS = 128;

template <int TILE_T>
struct Tile {
  static constexpr int THREADS = 32 * (TILE_T / 32) * COL_WARPS;
  static constexpr int REGION = STAGES * SLAB_FLOATS > TILE_T * P_STRIDE
                                    ? STAGES * SLAB_FLOATS : TILE_T * P_STRIDE;
  static_assert(TILE_T % 32 == 0 && THREADS == MEL_GROUPS * TILE_T, "tile map");
};

// index into the clip of padded sample p (torch.stft's reflect centring)
__device__ __forceinline__ int padded_index(int L, int pad, int p) {
  int i = p - pad;                   // reflect about the first and last sample
  i = i < 0 ? -i : i;
  i = i >= L ? 2 * (L - 1) - i : i;
  return min(max(i, 0), L - 1);      // clamped only past what any frame reads
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in three TF32 passes, the small ones first; b = (hi b0, hi b1,
// lo b0, lo b1) as packed on the host
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float4 b) {
  mma_tf32(d, al, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(d, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, ah, __float_as_uint(b.x), __float_as_uint(b.y));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// offset of segment sample x in the row layout (rows of hop samples, stride rs)
__device__ __forceinline__ int seg_offset(int x, int hop, int rs) {
  return (x / hop) * rs + x % hop;
}

template <bool FOLD, int TILE_T>
__global__ void __launch_bounds__(Tile<TILE_T>::THREADS, TILE_T == 64 ? 2 : 1)
log_mel_kernel(const float* __restrict__ wav, int L, int T, int T_full,
               const int* __restrict__ starts,   // (B,) first frame per clip, or null
               const float* __restrict__ frag,   // (K_pad/8, n_pad/8, 2, 32, 4) packed basis
               const float* __restrict__ fbw,    // (n_w,) each band's nonzero weights
               const int* __restrict__ band,     // (3, n_mels): rows [lo, hi), offset in fbw
               float* __restrict__ out,          // (B, n_mels, T)
               int n_fft, int hop, int n_lo, int n_min, int K_pad, int n_pad,
               int n_mels, int n_w, int seg_rows, int rs, float eps) {
  constexpr int THREADS = Tile<TILE_T>::THREADS;
  extern __shared__ float4 smem4[];
  float* slab_s = reinterpret_cast<float*>(smem4);   // STAGES slabs, then the power
  float* p_s = slab_s;                               // (TILE_T, P_STRIDE)
  float* mel_s = slab_s + Tile<TILE_T>::REGION;      // (mels per thread, THREADS)
  const int mpt = (n_mels + MEL_GROUPS - 1) / MEL_GROUPS;
  float* seg_s = mel_s + mpt * THREADS;              // (seg_rows, rs)
  int* colf_s = reinterpret_cast<int*>(seg_s + seg_rows * rs);   // (K_pad,) f[n]
  int* colr_s = colf_s + K_pad;                                  // (K_pad,) f[N - n]
  int* band_s = colr_s + (FOLD ? K_pad : 0);                     // (3, n_mels)
  float* fbw_s = reinterpret_cast<float*>(band_s + 3 * n_mels);  // (n_w,)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE_T;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;             // mma group and thread in group
  const int fw = warp / COL_WARPS, cw = warp % COL_WARPS;
  const float* w = wav + static_cast<size_t>(b) * L;
  const int pad = n_fft / 2;
  const int start = starts ? starts[b] : 0;
  // a start outside [0, T_full - T] is clamped frame by frame; the clamp is
  // monotone, so the tile's frames lie in [fr0, fr0 + TILE_T)
  const int fr0 = min(max(start + t0, 0), T_full - 1);
  const int n_ks = K_pad / 8;
  const int nt_all = n_pad / 8;

  auto load_slab = [&](int chunk, int ks, int stage) {
    const float* src = frag + (static_cast<size_t>(ks) * nt_all + chunk * NT_CHUNK) * 256;
    float* dst = slab_s + stage * SLAB_FLOATS;
    for (int i = tid; i < SLAB_FLOATS / 4; i += THREADS) cp_async16(dst + 4 * i, src + 4 * i);
  };

  // the wav segment, reflect-indexed, and the filterbank's bands go in by
  // asynchronous copies (one group), the first chunk's slabs behind them; the
  // first k-step's wait and barrier cover all of it
  const int base = fr0 * hop + n_min;                // padded position of segment sample 0
  for (int idx = tid; idx < seg_rows * hop; idx += THREADS) {
    const int r = idx / hop;
    cp_async4(seg_s + r * rs + idx - r * hop, w + padded_index(L, pad, base + idx));
  }
  for (int i = tid; i < 3 * n_mels; i += THREADS) cp_async4(band_s + i, band + i);
  for (int i = tid; i < n_w; i += THREADS) cp_async4(fbw_s + i, fbw + i);
  cp_async_commit();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_ks) load_slab(0, s, s);
    cp_async_commit();
  }
  for (int k = tid; k < K_pad; k += THREADS) {
    const int n = n_lo + k;
    colf_s[k] = seg_offset(n - n_min, hop, rs);
    if (FOLD) colr_s[k] = seg_offset((n == 0 ? 0 : n_fft - n) - n_min, hop, rs);
  }
  for (int j = 0; j < mpt; ++j) mel_s[j * THREADS + tid] = 0.f;

  // this thread's A-fragment rows: frames fw*32 + mt*16 + g (+8)
  int rowoff[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = fw * 32 + mt * 16 + h * 8 + g;
      rowoff[mt][h] = (min(max(start + t0 + t, 0), T_full - 1) - fr0) * rs;
    }
  const int mt_ = tid % TILE_T;                      // mel phase: one frame per thread
  const int mg = tid / TILE_T;                       //   and mels mg, mg + 4, ...

  for (int chunk = 0; chunk < n_pad / FCH; ++chunk) {
    if (chunk > 0) {
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_ks) load_slab(chunk, s, s);
        cp_async_commit();
      }
    }
    float re[2][4][4], im[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) re[mt][nt][i] = im[mt][nt][i] = 0.f;

    for (int ks = 0; ks < n_ks; ++ks) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();                 // slab ks landed; slab ks - 1 is consumed
      if (ks + STAGES - 1 < n_ks) load_slab(chunk, ks + STAGES - 1, (ks + STAGES - 1) % STAGES);
      cp_async_commit();

      // A fragments: a0 (row g, col q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
      const int cf[2] = {colf_s[ks * 8 + q], colf_s[ks * 8 + q + 4]};
      uint32_t eh[2][4], el[2][4], oh[2][4], ol[2][4];
      if (FOLD) {
        const int cr[2] = {colr_s[ks * 8 + q], colr_s[ks * 8 + q + 4]};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float f = seg_s[rowoff[mt][i & 1] + cf[i >> 1]];
            const float r = seg_s[rowoff[mt][i & 1] + cr[i >> 1]];
            split_tf32(f + r, eh[mt][i], el[mt][i]);
            split_tf32(f - r, oh[mt][i], ol[mt][i]);
          }
      } else {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            split_tf32(seg_s[rowoff[mt][i & 1] + cf[i >> 1]], eh[mt][i], el[mt][i]);
            oh[mt][i] = eh[mt][i];
            ol[mt][i] = el[mt][i];
          }
      }
      const float4* sl = reinterpret_cast<const float4*>(
          slab_s + (ks % STAGES) * SLAB_FLOATS) + (cw * 4 * 2) * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float4 bc = sl[(nt * 2) * 32];
        const float4 bs = sl[(nt * 2 + 1) * 32];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma3(re[mt][nt], eh[mt], el[mt], bc);
          mma3(im[mt][nt], oh[mt], ol[mt], bs);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();                   // every warp is done with the slabs

    // power = re^2 + im^2 from registers: c0, c1 (row g, cols 2q, 2q + 1),
    // c2, c3 (row g + 8)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = fw * 32 + mt * 16 + g + (i >> 1) * 8;
          const int col = cw * 32 + nt * 8 + 2 * q + (i & 1);
          p_s[row * P_STRIDE + col] =
              fmaf(re[mt][nt][i], re[mt][nt][i], im[mt][nt][i] * im[mt][nt][i]);
        }
    __syncthreads();

    // mel product over each band's nonzero filterbank rows only (a bin feeds
    // at most two triangles), in ascending row order, the weights from shared
    // memory; a warp holds 32 frames of one mel, so band bounds and weight
    // reads are uniform across it
    const int f0 = chunk * FCH;
    const float* prow = p_s + mt_ * P_STRIDE - f0;
    for (int j = 0; j < mpt; ++j) {
      const int m = mg + j * MEL_GROUPS;
      if (m >= n_mels) break;
      const int lo = max(band_s[m], f0), hi = min(band_s[n_mels + m], f0 + FCH);
      const float* wm = fbw_s + band_s[2 * n_mels + m] - band_s[m];
      float sum = mel_s[j * THREADS + tid];
#pragma unroll 4
      for (int f = lo; f < hi; ++f) sum = fmaf(prow[f], wm[f], sum);
      mel_s[j * THREADS + tid] = sum;
    }
    __syncthreads();                   // the next chunk's slabs overwrite the power
  }

  if (t0 + mt_ < T) {
    float* o = out + static_cast<size_t>(b) * n_mels * T + t0 + mt_;
    for (int j = 0; j < mpt; ++j) {
      const int m = mg + j * MEL_GROUPS;
      if (m >= n_mels) break;
      o[static_cast<size_t>(m) * T] = logf(mel_s[j * THREADS + tid] + eps);
    }
  }
}

// must match ops/mel_kernel.py KernelOperands.smem_bytes
template <int TILE_T>
size_t smem_bytes(bool fold, int seg_rows, int rs, int K_pad, int n_mels, int n_w) {
  const size_t mpt = (n_mels + MEL_GROUPS - 1) / MEL_GROUPS;
  return sizeof(float) * (Tile<TILE_T>::REGION + mpt * Tile<TILE_T>::THREADS +
                          static_cast<size_t>(seg_rows) * rs +
                          (fold ? 2 : 1) * static_cast<size_t>(K_pad) + 3 * n_mels + n_w);
}

template <bool FOLD, int TILE_T>
cudaError_t prepare(size_t smem) {
  auto kernel = log_mel_kernel<FOLD, TILE_T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <bool FOLD, int TILE_T>
int launch(const float* wav, int B, int L, int T, int T_full, const int* starts,
           const float* frag, const float* fbw, const int* band, float* out, int n_fft,
           int hop, int n_lo, int n_min, int K_pad, int n_pad, int n_mels, int n_w,
           int seg_rows, int rs, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes<TILE_T>(FOLD, seg_rows, rs, K_pad, n_mels, n_w);
  cudaError_t err = prepare<FOLD, TILE_T>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TILE_T - 1) / TILE_T, B);
  log_mel_kernel<FOLD, TILE_T><<<grid, Tile<TILE_T>::THREADS, smem, stream>>>(
      wav, L, T, T_full, starts, frag, fbw, band, out, n_fft, hop, n_lo, n_min, K_pad,
      n_pad, n_mels, n_w, seg_rows, rs, eps);
  return cudaGetLastError();
}

template <bool FOLD, int TILE_T>
int occupancy(int seg_rows, int rs, int K_pad, int n_mels, int n_w, int* smem_out,
              int* blocks) {
  const size_t smem = smem_bytes<TILE_T>(FOLD, seg_rows, rs, K_pad, n_mels, n_w);
  *smem_out = static_cast<int>(smem);
  cudaError_t err = prepare<FOLD, TILE_T>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, log_mel_kernel<FOLD, TILE_T>, Tile<TILE_T>::THREADS, smem);
}

}  // namespace

extern "C" {

// T: frames written per clip; T_full: frames of a whole clip; starts: (B,)
// int32 first frames on the device, or null for 0 (then T = T_full).  The
// segment geometry (n_min, seg_rows, rs) and K_pad come from
// ops/mel_kernel.py KernelOperands; tile is 64 or 96 frames per block.
int log_mel_launch(const void* wav, int B, int L, int T, int T_full,
                   const void* starts, const void* frag, const void* fbw,
                   const void* band, void* out, int n_fft, int hop, int n_lo,
                   int n_min, int K_pad, int n_pad, int n_mels, int n_w, int seg_rows,
                   int rs, float eps, int fold, int tile, void* stream) {
  if (n_pad % FCH != 0 || K_pad % 8 != 0 || n_mels > MAX_MELS || rs % 32 != 4 ||
      (tile != 64 && tile != 96))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const float*>(wav);
  auto fr = static_cast<const float*>(frag);
  auto f = static_cast<const float*>(fbw);
  auto bd = static_cast<const int*>(band);
  auto o = static_cast<float*>(out);
  auto st = static_cast<const int*>(starts);
#define LOG_MEL_LAUNCH(FOLD, TILE)                                                   \
  return launch<FOLD, TILE>(w, B, L, T, T_full, st, fr, f, bd, o, n_fft, hop, n_lo, \
                            n_min, K_pad, n_pad, n_mels, n_w, seg_rows, rs, eps, s)
  if (fold) {
    if (tile == 64) LOG_MEL_LAUNCH(true, 64);
    LOG_MEL_LAUNCH(true, 96);
  }
  if (tile == 64) LOG_MEL_LAUNCH(false, 64);
  LOG_MEL_LAUNCH(false, 96);
#undef LOG_MEL_LAUNCH
}

// the shared memory one block of the instantiation takes and how many such
// blocks fit on an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
int log_mel_occupancy(int fold, int tile, int seg_rows, int rs, int K_pad, int n_mels,
                      int n_w, int* smem, int* blocks) {
  if (tile != 64 && tile != 96) return cudaErrorInvalidValue;
  if (fold)
    return tile == 64 ? occupancy<true, 64>(seg_rows, rs, K_pad, n_mels, n_w, smem, blocks)
                      : occupancy<true, 96>(seg_rows, rs, K_pad, n_mels, n_w, smem, blocks);
  return tile == 64 ? occupancy<false, 64>(seg_rows, rs, K_pad, n_mels, n_w, smem, blocks)
                    : occupancy<false, 96>(seg_rows, rs, K_pad, n_mels, n_w, smem, blocks);
}

}  // extern "C"
