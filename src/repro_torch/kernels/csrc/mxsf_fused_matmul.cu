// Fused MXSF quantize -> matmul for Hopper (sm_90a), on the tensor cores.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/mxsf_fused_matmul.py::mxsf_fused_matmul_pallas (body _fused_kernel):
//
//   y[M,N] (f32) = A @ decode(w codes[Kp,N], E8M0 scales; wblk)
//
// with A = qdq_MXSF(x[M,K]; xblk) (quantize_lhs) or the raw x, and the
// serving and training switches of the JAX kernel:
//   (1,64) x against (64,1) weights (serving; the 1D training layout);
//   (8,8) x against (8,8) weights (the 2D training layout);
//   raw x (quantize_lhs=False: the backward's unquantized g) against
//   either weight block;
//   emit_codes: x's codes (Mb, Kb) and scales, cropped to x's block-padded
//   shape, are written as well -- the packed residual of the backward.
// x columns K..Kp-1 and weight rows past Kp read as zero.
//
// Bound on the H100: the weight bytes at serving shapes (4 to 64 rows, far
// below the ~295 op/byte ridge; 0.043 ms for the 5120 x 27648 weight at
// 3.35 TB/s), operations at training shapes (2048 rows: 2 M K N at the
// bf16 tensor rate, 0.073 ms for 2048 x 2560 x 6912).
//
// Design (mxsf_mma.cuh).  A quantized x runs on the tensor cores, the
// weight codes of each 64-k step staged by a 3-stage cp.async ring and
// decoded to bf16 (table x 2^(scale - 127), exact) while the previous
// step's products run, each step's products summed into a fragment added
// to the f32 accumulator with an f32 add:
//   * more than 64 rows (training): 128 x 128 tiles, two warpgroups of
//     wgmma m64n128k16; x prepared -- 8-step producer blocks at the front
//     of the grid run the MXSF converter (lanes of a block share its amax
//     by shuffles; flog2, a branch-free bit-exact encoder, the table) once
//     per call, write the emitted codes and scales and the bf16 tiles, and
//     an output block copies a tile two steps ahead by cp.async (or, if not
//     yet published, quantizes it itself): each x element is quantized
//     once per call (108 times at N = 6912 with the 64-wide tiles before);
//   * 17 to 64 rows (prefill): 64 x 256 tiles, the same wgmma, each block
//     quantizing its x tile once per step: ceil(N / 256) times per call;
//   * 16 rows or fewer (decode): 16 x 256 tiles of mma.sync m16n8k16 on
//     ldmatrix fragments, the weight decode interleaved with them.
// Output tiles fewer than 264 (serving) split K in whole steps: each split
// writes a partial, and the last block of the tile sums them in order.
// f32 path: a step where a nonzero block of x or w has S_e outside
// [-52, 63] runs f32 FMAs on the decoded values instead.  A raw x keeps
// f32 FMAs (an f32 x times a decoded weight is not exact in bf16 x bf16 ->
// f32): 128 x 128 tiles, each thread an 8 x 8 register block, x (f32; the
// wrapper widens a bf16 x) from the swizzled stage, the weight decoded to
// f32 once per step.
#include "mxsf_mma.cuh"

using namespace mxmma;

// x: (M, K) f32 or bf16, row-major; wc: (Kp, N) uint8; ws: (Kp/64, N) for
// (64,1) weight blocks or (Kp/8, N/8) for (8,8); y: (M, N) f32.  K <= Kp.
// xmode: 0 raw x, 1 (1,64) blocks, 2 (8,8) tiles (with (8,8) weights).
// xcodes/xscales: nullptr, or the (mb, kb) codes and scales of x under its
// block, to be written (with x prepared, always given: the f32 path of an
// output block reads the producers' codes).  work, counters, f32_steps,
// a_cp, b_cp, per, splits, prep, ready, epoch, prep_steps: as for
// mx_matmul (used by the 128 x 128 quantized-x instances only).  bm, bn: the wrapper's tile, which
// must be one of this file's for the mode.
extern "C" int mxsf_fused_matmul(const void* x, int x_bf16, const void* wc,
                                 const void* ws, void* y, void* work,
                                 void* counters, void* f32_steps, int M,
                                 int K, int Kp, int N, int xmode, int wb8,
                                 void* xcodes, void* xscales, int mb, int kb,
                                 int a_cp, int b_cp, int per, int splits,
                                 int bm, int bn, void* prep, void* ready,
                                 int epoch, int prep_steps, void* stream) {
  Params p{};
  p.a = x;
  p.a_bf16 = x_bf16;
  p.bc = static_cast<const uint8_t*>(wc);
  p.bs = static_cast<const uint8_t*>(ws);
  p.y = static_cast<float*>(y);
  p.work = static_cast<float*>(work);
  p.counters = static_cast<int*>(counters);
  p.f32_steps = static_cast<int*>(f32_steps);
  p.emit_codes = static_cast<uint8_t*>(xcodes);
  p.emit_scales = static_cast<uint8_t*>(xscales);
  p.emit_mb = mb;
  p.emit_kb = kb;
  p.M = M;
  p.K = K;
  p.Kp = Kp;
  p.N = N;
  p.a_cp = a_cp;
  p.b_cp = b_cp;
  p.per = per;
  p.splits = splits;
  p.prep = static_cast<uint8_t*>(prep);
  p.ready = static_cast<int*>(ready);
  p.epoch = epoch;
  p.prep_steps = prep_steps;
  p.acodes = p.emit_codes;  // a consumer's f32 path reads the producers'
  p.ascales = p.emit_scales;
  p.arows = mb;
  p.ald = kb;
  auto st = static_cast<cudaStream_t>(stream);
  if (xmode == 1 && !wb8 && bm == 16 && bn == 256)
    return launch_gemm<16, 256, 1, 8, kARow64, 1, 64, 64, 1, false>(p, st);
  if (xmode == 1 && !wb8 && bm == 64 && bn == 256)
    return launch_gemm<64, 256, 4, 2, kARow64, 1, 64, 64, 1, true>(p, st);
  if (xmode == 2 && wb8 && bm == 64 && bn == 256)
    return launch_gemm<64, 256, 4, 2, kATile8, 8, 8, 8, 8, true>(p, st);
  // prepared x: producer blocks quantize each x tile once per call
  if (xmode == 1 && !wb8 && bm == 128 && bn == 128)
    return launch_gemm<128, 128, 8, 1, kARow64, 1, 64, 64, 1, true, true>(p, st);
  if (xmode == 2 && wb8 && bm == 128 && bn == 128)
    return launch_gemm<128, 128, 8, 1, kATile8, 8, 8, 8, 8, true, true>(p, st);
  if (xmode == 0 && wb8 && bm == 128 && bn == 128)
    return launch_gemm<128, 128, 2, 4, kARaw, 1, 64, 8, 8, false>(p, st);
  if (xmode == 0 && !wb8 && bm == 128 && bn == 128)
    return launch_gemm<128, 128, 2, 4, kARaw, 1, 64, 64, 1, false>(p, st);
  return cudaErrorInvalidValue;  // the wrapper admits no other pairing
}
