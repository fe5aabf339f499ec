// MXSF block quantizer and packed -> packed requantizer for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   kernels/mxsf_quant.py::mxsf_quantize_pallas   (body _quant_kernel)
//   kernels/mxsf_quant.py::mxsf_requantize_pallas (body _requant_kernel)
// which share the converter body _encode_tile: block amax -> shared
// exponent S_e = flog2(amax) (-127 for an all-zero block) -> encode every
// element of the block relative to 2^S_e -> one E8M0 byte clip(S_e + 127).
//
//   quantize:   x (M, K) f32 or bf16 -> codes (Mb, Kb) uint8 and scales
//               (Mb/bm, Kb/bk) uint8, with Mb, Kb the block-padded dims;
//               rows >= M and columns >= K read as zero.
//   requantize: codes (M, K) + scales under from-blocks (fbm, fbk) -> the
//               same values re-encoded under to-blocks (tbm, tbk), codes
//               (Mb, Kb) padded to the to-block.  The decode is the plain
//               dequantize (code value times 2^(byte - 127), the exponent
//               clipped to [-126, 127] as in the JAX package), so the result
//               is bit for bit quantize(dequantize(qt), to_block).
//
// Bound on the H100: bytes.  Per element the quantizer reads 2 or 4 bytes
// and writes 1 + 1/(bm*bk); the requantizer reads 1 + 1/(fbm*fbk) and
// writes 1 + 1/(tbm*tbk).  Design: one thread per MX block, which makes a
// pass over the block for its amax and a second pass (from L1/L2) to encode
// it.  It takes every (bm, bk) the JAX kernels take with no special case.
// Neighbouring threads hold neighbouring blocks along K, so a (64, 1)
// column block reads coalesced rows while a (1, 64) row block strides by
// 64 elements: simple before fast.
#include "mxsf_codec.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const void* __restrict__ x, int x_bf16, int M, int K, int bm,
                int bk, int nbk, long long nblocks,
                uint8_t* __restrict__ codes, uint8_t* __restrict__ scales) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b >= nblocks) return;
  const int bi = static_cast<int>(b / nbk), bj = static_cast<int>(b % nbk);
  const int r0 = bi * bm, c0 = bj * bk;
  const size_t kb = static_cast<size_t>(nbk) * bk;
  float amax = 0.f;
  for (int i = 0; i < bm; ++i) {
    const int r = r0 + i;
    if (r >= M) break;
    for (int j = 0; j < bk; ++j) {
      const int c = c0 + j;
      if (c >= K) break;
      amax = fmaxf(amax, fabsf(mxsf::load_act(
                             x, x_bf16, static_cast<size_t>(r) * K + c)));
    }
  }
  const int se = amax > 0.f ? mxsf::flog2(amax) : -127;
  for (int i = 0; i < bm; ++i) {
    const int r = r0 + i;
    for (int j = 0; j < bk; ++j) {
      const int c = c0 + j;
      const float v = (r < M && c < K)
                          ? mxsf::load_act(x, x_bf16,
                                           static_cast<size_t>(r) * K + c)
                          : 0.f;
      codes[static_cast<size_t>(r) * kb + c] =
          static_cast<uint8_t>(mxsf::encode_mxsf(mxsf::scale_by_exp2(v, -se)));
    }
  }
  scales[b] = static_cast<uint8_t>(min(max(se + mxsf::kScaleBias, 0), 255));
}

// value of element (r, c) of a packed (M, K) tensor under (fbm, fbk) blocks
__device__ __forceinline__ float dequant_at(const float* lut,
                                            const uint8_t* __restrict__ ci,
                                            const uint8_t* __restrict__ si,
                                            int M, int K, int fbm, int fbk,
                                            int r, int c) {
  if (r >= M || c >= K) return 0.f;
  const int s = si[static_cast<size_t>(r / fbm) * (K / fbk) + c / fbk];
  return lut[ci[static_cast<size_t>(r) * K + c]] *
         mxsf::exp2i(s - mxsf::kScaleBias);
}

__global__ void __launch_bounds__(kThreads)
requantize_kernel(const uint8_t* __restrict__ ci,
                  const uint8_t* __restrict__ si, int M, int K, int fbm,
                  int fbk, int tbm, int tbk, int nbk, long long nblocks,
                  uint8_t* __restrict__ codes, uint8_t* __restrict__ scales) {
  __shared__ float lut[256];
  lut[threadIdx.x] = mxsf::decode_mxsf(threadIdx.x);
  __syncthreads();
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b >= nblocks) return;
  const int bi = static_cast<int>(b / nbk), bj = static_cast<int>(b % nbk);
  const int r0 = bi * tbm, c0 = bj * tbk;
  const size_t kb = static_cast<size_t>(nbk) * tbk;
  float amax = 0.f;
  for (int i = 0; i < tbm; ++i)
    for (int j = 0; j < tbk; ++j)
      amax = fmaxf(amax, fabsf(dequant_at(lut, ci, si, M, K, fbm, fbk,
                                          r0 + i, c0 + j)));
  const int se = amax > 0.f ? mxsf::flog2(amax) : -127;
  for (int i = 0; i < tbm; ++i)
    for (int j = 0; j < tbk; ++j) {
      const float v = dequant_at(lut, ci, si, M, K, fbm, fbk, r0 + i, c0 + j);
      codes[static_cast<size_t>(r0 + i) * kb + c0 + j] =
          static_cast<uint8_t>(mxsf::encode_mxsf(mxsf::scale_by_exp2(v, -se)));
    }
  scales[b] = static_cast<uint8_t>(min(max(se + mxsf::kScaleBias, 0), 255));
}

unsigned grid_for(long long nblocks) {
  return static_cast<unsigned>((nblocks + kThreads - 1) / kThreads);
}

}  // namespace

// x: (M, K) f32 or bf16, row-major.  codes: (Mb, Kb) and scales:
// (Mb/bm, Kb/bk), Mb = ceil(M/bm)*bm, Kb = ceil(K/bk)*bk (the wrapper
// allocates both and checks the shapes).
extern "C" int mxsf_quantize(const void* x, int x_bf16, int M, int K, int bm,
                             int bk, void* codes, void* scales,
                             void* stream) {
  const int nbm = (M + bm - 1) / bm, nbk = (K + bk - 1) / bk;
  const long long nblocks = static_cast<long long>(nbm) * nbk;
  if (nblocks == 0) return 0;
  quantize_kernel<<<grid_for(nblocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      x, x_bf16, M, K, bm, bk, nbk, nblocks, static_cast<uint8_t*>(codes),
      static_cast<uint8_t*>(scales));
  return cudaGetLastError();
}

// ci: (M, K) uint8 with M % fbm == 0 and K % fbk == 0; si: (M/fbm, K/fbk).
// codes: (Mb, Kb) and scales: (Mb/tbm, Kb/tbk), padded to the to-block.
extern "C" int mxsf_requantize(const void* ci, const void* si, int M, int K,
                               int fbm, int fbk, int tbm, int tbk,
                               void* codes, void* scales, void* stream) {
  const int nbm = (M + tbm - 1) / tbm, nbk = (K + tbk - 1) / tbk;
  const long long nblocks = static_cast<long long>(nbm) * nbk;
  if (nblocks == 0) return 0;
  requantize_kernel<<<grid_for(nblocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(ci), static_cast<const uint8_t*>(si), M, K,
      fbm, fbk, tbm, tbk, nbk, nblocks, static_cast<uint8_t*>(codes),
      static_cast<uint8_t*>(scales));
  return cudaGetLastError();
}
