// Shared device code of the fused Conv3x3(Cin=1) block's kernels
// (fused_conv_fwd.cu, fused_conv_bwd.cu).
//
// The backward recomputes the conv output y of every window corner and
// tests y == extreme(y) to find the element the forward selected, so both
// sources must produce y bit for bit the same: the same tile staging, the
// same patch walk and the same FMA order, all of which live here.
#pragma once
#include <cuda_runtime.h>

namespace fused_conv {

constexpr int C = 64;                // output channels (AudioNTT's base width)
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / C;  // row groups of a block
constexpr int R = 8;                 // window rows per block
constexpr int CW = 16;               // window columns per block
constexpr int TROWS = 2 * R + 2;     // staged input rows (with the zero pad)
constexpr int TCOLS = 2 * CW + 2;    // staged input columns

// Zero-padded input tile of image xb for the window tile at (i0, j0):
// rows 2*i0-1 .. 2*i0+2R, columns 2*j0-1 .. 2*j0+2CW.  The caller
// synchronises before reading xs.
__device__ __forceinline__ void stage_tile(const float* __restrict__ xb, int H,
                                           int W, int i0, int j0, float* xs) {
  for (int idx = threadIdx.x; idx < TROWS * TCOLS; idx += THREADS) {
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

__device__ __forceinline__ void patch_slide(const float* row, int jl,
                                            float (&p)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    p[a][0] = p[a][2];
    p[a][1] = p[a][3];
    p[a][2] = row[a * TCOLS + 2 * jl + 2];
    p[a][3] = row[a * TCOLS + 2 * jl + 3];
  }
}

// Conv output of the window's four corners, in the order (0,0) (0,1) (1,0)
// (1,1): taps row-major, one fmaf chain per corner, the bias added last.
__device__ __forceinline__ void conv_corners(const float (&p)[4][4],
                                             const float (&w)[9], float bc,
                                             float (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int pi = q / 2, pj = q % 2;
    float acc = 0.f;
#pragma unroll
    for (int dh = 0; dh < 3; ++dh)
#pragma unroll
      for (int dw = 0; dw < 3; ++dw)
        acc = fmaf(w[dh * 3 + dw], p[pi + dh][pj + dw], acc);
    v[q] = acc + bc;
  }
}

// Max of the corners where gamma > 0, min otherwise (gamma == 0 included).
__device__ __forceinline__ float window_extreme(const float (&v)[4], bool pos) {
  return pos ? fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]))
             : fminf(fminf(v[0], v[1]), fminf(v[2], v[3]));
}

}  // namespace fused_conv
