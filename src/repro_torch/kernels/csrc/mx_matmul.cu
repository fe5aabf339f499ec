// Packed x packed MXSF matmul for Hopper (sm_90a), on the tensor cores.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/mx_matmul.py::mxsf_matmul_pallas (body _matmul_kernel):
//
//   y[M,N] (f32) = decode(x codes[M,K], scales; xblk) @
//                  decode(w codes[K,N], scales; wblk)
//
// Both operands are block-padded code grids (the wrapper checks).  The
// training path uses it for the 2D backward, dx = g @ w^T and dw = x^T @ g,
// with (8,8) tiles on both sides; (1,64)/(64,1) and (1,32)/(32,1) are
// instantiated too.  Block edges are template parameters.
//
// Bound on the H100: operations at training shapes (M = 2048 rows, far
// above the ~295 op/byte ridge): 2 M K N at the bf16 tensor rate, 989
// TFLOP/s -- 0.073 ms for the 2048 x 6912 x 2560 dx of h2o-danube's gate.
//
// Design (mxsf_mma.cuh): 128 x 128 output tiles, two warpgroups each
// issuing wgmma m64n128k16 (bf16 x bf16 -> f32, operands from shared
// memory) per 16 k, K in steps of 64 through a 3-stage cp.async ring of
// the B codes (1 byte an element) and E8M0 scales.  A is prepared: 16-step
// producer blocks at the front of the grid decode each A tile once per
// call into bf16 (table x 2^(scale - 127), exact), and an output block
// copies it by cp.async two steps ahead (or, if not yet published, decodes
// it itself); each block decodes its B tile of step i+1 into bf16 while
// step i's wgmma runs.  Each step's four wgmma sum into a fragment that is
// then added to the f32 accumulator with an f32 add.  f32 path: a step
// where a nonzero block of either tile has S_e outside [-52, 63] runs f32
// FMAs on the decoded values instead (the tensor cores' products would not
// all be exact and normal in f32).
#include "mxsf_mma.cuh"

namespace {

using namespace mxmma;

constexpr int kBM = 128, kBN = 128;

template <int ABM, int ABK, int WBM, int WBN>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return launch_gemm<kBM, kBN, 8, 1, kAPacked, ABM, ABK, WBM, WBN, true, true>(
      p, stream);
}

}  // namespace

// xc: (M, K), xs: (M/xbm, K/xbk), wc: (K, N), ws: (K/wbm, N/wbn), all
// uint8 row-major; y: (M, N) f32.  work: (splits, M, N) f32 when splits >
// 1; counters: (M tiles x N tiles) int32, zero; f32_steps: one int32.
// a_cp, b_cp: cp.async widths for the code rows.  bm, bn: the wrapper's
// tile, checked against this file's.  prep: the bf16 A tiles (M tiles x
// steps x 128 x 64); ready: one int32 per (M tile, step), epoch: this
// launch's (the words of earlier launches must differ); prep_steps: steps
// per producer block.
extern "C" int mxsf_matmul(const void* xc, const void* xs, const void* wc,
                           const void* ws, void* y, void* work,
                           void* counters, void* f32_steps, int M, int K,
                           int N, int xbm, int xbk, int wbm, int wbn,
                           int a_cp, int b_cp, int per, int splits, int bm,
                           int bn, void* prep, void* ready, int epoch,
                           int prep_steps, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (bm != kBM || bn != kBN) return cudaErrorInvalidValue;
  Params p{};
  p.a = xc;
  p.as = static_cast<const uint8_t*>(xs);
  p.bc = static_cast<const uint8_t*>(wc);
  p.bs = static_cast<const uint8_t*>(ws);
  p.y = static_cast<float*>(y);
  p.work = static_cast<float*>(work);
  p.counters = static_cast<int*>(counters);
  p.f32_steps = static_cast<int*>(f32_steps);
  p.M = M;
  p.K = K;
  p.Kp = K;
  p.N = N;
  p.a_cp = a_cp;
  p.b_cp = b_cp;
  p.per = per;
  p.splits = splits;
  p.prep = static_cast<uint8_t*>(prep);
  p.ready = static_cast<int*>(ready);
  p.epoch = epoch;
  p.prep_steps = prep_steps;
  p.acodes = static_cast<const uint8_t*>(xc);  // a consumer's f32 path
  p.ascales = p.as;
  p.arows = M;
  p.ald = K;
  auto st = static_cast<cudaStream_t>(stream);
  if (xbm == 8 && xbk == 8 && wbm == 8 && wbn == 8)
    return launch<8, 8, 8, 8>(p, st);
  if (xbm == 1 && xbk == 64 && wbm == 64 && wbn == 1)
    return launch<1, 64, 64, 1>(p, st);
  if (xbm == 1 && xbk == 32 && wbm == 32 && wbn == 1)
    return launch<1, 32, 32, 1>(p, st);
  return cudaErrorInvalidValue;  // the wrapper admits no other blocks
}
