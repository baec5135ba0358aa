// Fused framing -> windowed DFT -> power -> mel -> log, fp32, for Hopper.
//
// Replaces the Pallas kernel of ssl_audio_tpu/ops/mel_pallas.py
// (log_mel_spectrogram_pallas): the FOLD=true instantiation stands for
// _make_kernel_folded (e = f + f_rev against the half cos basis, o = f - f_rev
// against the half sin basis), FOLD=false for _make_kernel (full frames
// against the full bases).  The TPU kernel's hop-row layout, reversed-row
// tensor and sublane rotates were Mosaic constraints and are not carried over.
//
// (B, L) wav -> (B, n_mels, T) log-mel, torch.stft(center=True) reflect
// centring included.  With per-clip crop starts (the training frontend,
// log_mel_spectrogram_cropped there) output frame t of clip b is frame
// starts[b] + t of the clip's T_full frames: the block reads its clip's start
// itself and the reflect index is still taken on the whole clip, so the pad,
// the hop-block gather and the static framing of the JAX path have no
// counterpart.  One block per (clip, tile of TILE_T frames):
//   1. it builds its frames' DFT operands in shared memory straight from the
//      raw wav (reflect index computed per sample); the (B, T, n_fft) frame
//      tensor never exists in device memory;
//   2. per chunk of FCH frequency columns half the threads accumulate
//      8-frame by 8-column tiles of re, the other half of im, in fp32 FMA,
//      reading the bases through L1;
//   3. the chunk's power goes to shared memory and a second loop adds its
//      share of the mel product, over each mel band's nonzero filterbank
//      rows only, to each thread's mel sums (kept in shared memory, so the
//      DFT tile has the registers);
//   4. log(mel + eps) is written with consecutive threads on consecutive
//      frames (coalesced stores into the (n_mels, T) layout).
// The host passes only the basis rows inside the window's support
// [n_lo, n_lo + K): rows outside it are exactly zero (the HEAR window is 400
// of 1024 samples), so skipping them is exact and cuts the DFT work 2.5x.
//
// Bound on the H100: floating-point operations.  At the HEAR shapes the DFT
// does ~0.41 MFLOP per frame against ~0.9 kB of new wav and output per
// frame, far above the card's ~20 FLOP/byte fp32 ridge.  No TF32 or bf16
// pass: the DFT needs full fp32 accumulation.
#include <cuda_runtime.h>

namespace {

constexpr int TILE_T = 32;           // frames per block
constexpr int FCH = 256;             // frequency columns per chunk
constexpr int THREADS = 256;
constexpr int FR = 8;                // frames per thread in the DFT tile
constexpr int FQ = 8;                // frequencies per thread in the DFT tile
constexpr int P_STRIDE = FCH + 1;    // padded power row: conflict-free column reads
constexpr int MEL_GROUPS = THREADS / TILE_T;   // 8 mel groups of 32 frames
constexpr int MAX_MPT = 16;          // mels per thread -> n_mels <= 128

static_assert(2 * (TILE_T / FR) * (FCH / FQ) == THREADS, "DFT tile map");

__device__ __forceinline__ float padded_sample(const float* __restrict__ w,
                                               int L, int pad, int p) {
  int i = p - pad;                   // reflect about the first and last sample
  i = i < 0 ? -i : i;
  i = i >= L ? 2 * (L - 1) - i : i;
  return w[i];
}

template <bool FOLD>
__global__ void __launch_bounds__(THREADS, 2)
log_mel_kernel(const float* __restrict__ wav, int L, int T, int T_full,
               const int* __restrict__ starts,      // (B,) first frame per clip, or null
               const float* __restrict__ basis_c,   // (K, n_pad)
               const float* __restrict__ basis_s,   // (K, n_pad)
               const float* __restrict__ fb,        // (n_pad, n_mels)
               const int* __restrict__ band,        // (2, n_mels): nonzero rows [lo, hi) of fb
               float* __restrict__ out,             // (B, n_mels, T)
               int n_fft, int hop, int n_lo, int K, int n_pad, int n_mels,
               float eps) {
  extern __shared__ float4 smem4[];
  float* a_s = reinterpret_cast<float*>(smem4);      // (K, TILE_T): e or frames
  float* b_s = a_s + K * TILE_T;                     // (K, TILE_T): o (FOLD)
  float* p_s = b_s + (FOLD ? K * TILE_T : 0);        // (TILE_T, P_STRIDE) power
  float* mel_s = p_s + TILE_T * P_STRIDE;            // (MAX_MPT, THREADS) mel sums

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE_T;
  const int tid = threadIdx.x;
  const float* w = wav + static_cast<size_t>(b) * L;
  const int pad = n_fft / 2;
  const int start = starts ? starts[b] : 0;

  for (int idx = tid; idx < K * TILE_T; idx += THREADS) {
    const int k = idx / TILE_T, t = idx % TILE_T;
    float av = 0.f, bv = 0.f;
    if (t0 + t < T) {
      // a start outside [0, T_full - T] is clamped frame by frame, so no
      // sample index leaves the clip's reflect range
      const int s = min(max(start + t0 + t, 0), T_full - 1) * hop;
      const int n = n_lo + k;
      const float f = padded_sample(w, L, pad, s + n);
      if (FOLD) {
        const float r = padded_sample(w, L, pad, s + (n_fft - n) % n_fft);
        av = f + r;
        bv = f - r;
      } else {
        av = f;
      }
    }
    a_s[idx] = av;
    if (FOLD) b_s[idx] = bv;
  }
  __syncthreads();

  // DFT tile map: warps 0-3 accumulate the cosine product (re), warps 4-7
  // the sine product (im), each thread an 8-frame x 8-column tile of it.  A
  // warp shares one frame group, so per basis row it reads 8 frame values
  // (a broadcast) and 8 basis values per lane: 2 kB delivered per 64 FMAs,
  // where computing re and im together for 8 x 4 columns took 3 kB.
  const bool is_im = tid >= THREADS / 2;
  const int half = tid % (THREADS / 2);
  const int ty = half / (FCH / FQ);  // frame group: frames ty*FR ..
  const int tx = half % (FCH / FQ);  // column group: columns tx*FQ ..
  const int mt = tid % TILE_T;       // mel phase: one frame per thread
  const int mg = tid / TILE_T;       //   and mels mg, mg + 8, ...
  const float4* x4 = reinterpret_cast<const float4*>(FOLD && is_im ? b_s : a_s) +
                     ty * (FR / 4);
  const float* basis = is_im ? basis_s : basis_c;
  const int row4 = n_pad / 4;
  for (int j = 0; j < MAX_MPT; ++j) mel_s[j * THREADS + tid] = 0.f;

  for (int f0 = 0; f0 < n_pad; f0 += FCH) {
    float acc[FR][FQ];
#pragma unroll
    for (int i = 0; i < FR; ++i)
#pragma unroll
      for (int j = 0; j < FQ; ++j) acc[i][j] = 0.f;

    const float4* w4 = reinterpret_cast<const float4*>(basis + f0) + tx * (FQ / 4);
    float4 w0 = __ldg(w4), w1 = __ldg(w4 + 1);
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      // next basis row in flight while this one's 64 FMAs issue
      const size_t kn = static_cast<size_t>(k + 1 < K ? k + 1 : k) * row4;
      const float4 n0 = __ldg(w4 + kn), n1 = __ldg(w4 + kn + 1);
      const float4 x0 = x4[k * (TILE_T / 4)], x1 = x4[k * (TILE_T / 4) + 1];
      const float xv[FR] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float wv[FQ] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < FR; ++i)
#pragma unroll
        for (int j = 0; j < FQ; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
      w0 = n0;
      w1 = n1;
    }
    // power = re^2 + im^2: the re warps store re^2, then the im warps add
    float* pw = p_s + ty * FR * P_STRIDE + tx * FQ;
    if (!is_im) {
#pragma unroll
      for (int i = 0; i < FR; ++i)
#pragma unroll
        for (int j = 0; j < FQ; ++j) pw[i * P_STRIDE + j] = acc[i][j] * acc[i][j];
    }
    __syncthreads();
    if (is_im) {
#pragma unroll
      for (int i = 0; i < FR; ++i)
#pragma unroll
        for (int j = 0; j < FQ; ++j)
          pw[i * P_STRIDE + j] = fmaf(acc[i][j], acc[i][j], pw[i * P_STRIDE + j]);
    }
    __syncthreads();

    // mel product over each band's nonzero filterbank rows only (a bin
    // feeds at most two triangles): the same sums in the same order as the
    // dense product, without its zero terms.  A warp holds 32 frames of one
    // mel, so the band bounds and filterbank reads are uniform across it.
    const float* prow = p_s + mt * P_STRIDE;
    for (int j = 0; j < MAX_MPT; ++j) {
      const int m = mg + j * MEL_GROUPS;
      if (m >= n_mels) break;
      const int lo = max(band[m], f0), hi = min(band[n_mels + m], f0 + FCH);
      float sum = mel_s[j * THREADS + tid];
      for (int f = lo; f < hi; ++f)
        sum = fmaf(prow[f - f0], __ldg(fb + static_cast<size_t>(f) * n_mels + m), sum);
      mel_s[j * THREADS + tid] = sum;
    }
    __syncthreads();                 // the next chunk rewrites p_s
  }

  if (t0 + mt < T) {
    float* o = out + static_cast<size_t>(b) * n_mels * T + t0 + mt;
    for (int j = 0; j < MAX_MPT; ++j) {
      const int m = mg + j * MEL_GROUPS;
      if (m >= n_mels) break;
      o[static_cast<size_t>(m) * T] = logf(mel_s[j * THREADS + tid] + eps);
    }
  }
}

size_t smem_bytes(bool fold, int K) {
  return sizeof(float) * ((fold ? 2 : 1) * static_cast<size_t>(K) * TILE_T +
                          TILE_T * P_STRIDE + MAX_MPT * THREADS);
}

template <bool FOLD>
int launch(const float* wav, int B, int L, int T, int T_full, const int* starts,
           const float* basis_c,
           const float* basis_s, const float* fb, const int* band, float* out,
           int n_fft,
           int hop, int n_lo, int K, int n_pad, int n_mels, float eps,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(FOLD, K);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_kernel<FOLD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + TILE_T - 1) / TILE_T, B);
  log_mel_kernel<FOLD><<<grid, THREADS, smem, stream>>>(
      wav, L, T, T_full, starts, basis_c, basis_s, fb, band, out, n_fft, hop,
      n_lo, K, n_pad, n_mels, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// T: frames written per clip; T_full: frames of a whole clip; starts: (B,)
// int32 first frames on the device, or null for 0 (then T = T_full).
int log_mel_launch(const void* wav, int B, int L, int T, int T_full,
                   const void* starts, const void* basis_c,
                   const void* basis_s, const void* fb, const void* band,
                   void* out, int n_fft,
                   int hop, int n_lo, int K, int n_pad, int n_mels, float eps,
                   int fold, void* stream) {
  if (n_pad % FCH != 0 || n_mels > MEL_GROUPS * MAX_MPT) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto w = static_cast<const float*>(wav);
  auto c = static_cast<const float*>(basis_c);
  auto sn = static_cast<const float*>(basis_s);
  auto f = static_cast<const float*>(fb);
  auto bd = static_cast<const int*>(band);
  auto o = static_cast<float*>(out);
  auto st = static_cast<const int*>(starts);
  return fold ? launch<true>(w, B, L, T, T_full, st, c, sn, f, bd, o, n_fft, hop,
                             n_lo, K, n_pad, n_mels, eps, s)
              : launch<false>(w, B, L, T, T_full, st, c, sn, f, bd, o, n_fft, hop,
                              n_lo, K, n_pad, n_mels, eps, s);
}

}  // extern "C"
