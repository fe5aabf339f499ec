// Packed x packed MXSF matmul for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/mx_matmul.py::mxsf_matmul_pallas (body _matmul_kernel):
//
//   y[M,N] (f32) = decode(x codes[M,K], scales; xblk) @
//                  decode(w codes[K,N], scales; wblk)
//
// Both operands are block-padded code grids (M % xbm, K % xbk, K % wbm and
// N % wbn are 0; the wrapper checks).  The training path uses it for the
// 2D backward, dx = g @ w^T and dw = x^T @ g with (8, 8) tiles on both
// sides; any block shape whose edges divide the grid is taken.
//
// Bound on the H100: operations at training shapes (M = 2048 rows: far
// above the ~295 op/byte ridge).  Design: the fused matmul's structure
// without its quantize prologue.  One 256-thread block per 64 x 64 output
// tile loops over K in steps of 64; each step decodes both operand tiles
// into shared memory through a 256-entry table times 2^(scale - 127) (each
// element looks up its own block's scale, so any block shape works), and
// each thread accumulates a 4 x 4 register tile with f32 FMAs (8 shared
// loads per 16 FMAs).  A decoded MXSF value has at most 6 significant bits,
// so every product is exact in f32 and each output is the sum over
// k = 0, 1, ... in order: the kernel-order sum reproduces it bit for bit.
#include "mxsf_codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;   // output tile edge (rows and columns)
constexpr int kBK = 64;  // K step

__global__ void __launch_bounds__(kThreads)
mx_matmul_kernel(const uint8_t* __restrict__ xc, const uint8_t* __restrict__ xs,
                 const uint8_t* __restrict__ wc, const uint8_t* __restrict__ ws,
                 float* __restrict__ y, int M, int K, int N, int xbm, int xbk,
                 int wbm, int wbn) {
  __shared__ float lut[256];
  __shared__ float xt[kT][kBK];
  __shared__ float wt[kBK][kT];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kT, n0 = blockIdx.x * kT;
  const int xsk = K / xbk, wsn = N / wbn;
  lut[tid] = mxsf::decode_mxsf(static_cast<uint32_t>(tid));

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // decode both tiles: 16 elements of each per thread, coalesced along
    // the row of each operand
#pragma unroll 4
    for (int e = tid; e < kT * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int m = m0 + r, k = k0 + c;
      float v = 0.f;
      if (m < M && k < K) {
        const int s = xs[static_cast<size_t>(m / xbm) * xsk + k / xbk];
        v = lut[xc[static_cast<size_t>(m) * K + k]] *
            mxsf::exp2i(s - mxsf::kScaleBias);
      }
      xt[r][c] = v;
    }
#pragma unroll 4
    for (int e = tid; e < kBK * kT; e += kThreads) {
      const int r = e / kT, c = e % kT;
      const int k = k0 + r, n = n0 + c;
      float v = 0.f;
      if (k < K && n < N) {
        const int s = ws[static_cast<size_t>(k / wbm) * wsn + n / wbn];
        v = lut[wc[static_cast<size_t>(k) * N + n]] *
            mxsf::exp2i(s - mxsf::kScaleBias);
      }
      wt[r][c] = v;
    }
    __syncthreads();
    // thread owns rows ty + 16 i and columns tx + 16 j
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xt[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wt[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) y[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// xc: (M, K), xs: (M/xbm, K/xbk), wc: (K, N), ws: (K/wbm, N/wbn), all
// uint8 row-major; y: (M, N) f32.
extern "C" int mxsf_matmul(const void* xc, const void* xs, const void* wc,
                           const void* ws, void* y, int M, int K, int N,
                           int xbm, int xbk, int wbm, int wbn, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + kT - 1) / kT, (M + kT - 1) / kT);
  mx_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xc), static_cast<const uint8_t*>(xs),
      static_cast<const uint8_t*>(wc), static_cast<const uint8_t*>(ws),
      static_cast<float*>(y), M, K, N, xbm, xbk, wbm, wbn);
  return cudaGetLastError();
}
