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
// writes 1 + 1/(tbm*tbk).
//
// Quantizer design.  The block shapes the paths use -- (8,8) (2D weights
// and gradients), (64,1) (1D weights) and (1,64) (activations) -- are
// template instances of quantize_tiled: a 256-thread block takes a tile of
// 8 RPT rows x 32 V columns (V = 16 / element bytes: one 16-byte piece a
// lane, neighbouring lanes on neighbouring addresses), each thread RPT rows
// of one piece (8 for (8,8) and (64,1), 2 for (1,64)), all loaded before
// any is used and kept raw, so x is read from device memory once.  The
// block amax comes from registers: (1,64) by shuffles
// over the 64 / V lanes of a row block, (8,8) within the thread (and its
// neighbour lane for f32), (64,1) by a column reduction over the 8 warps
// through shared memory.  The encoder is the branch-free encode_mxsf_fast
// (mxsf_mma.cuh; bit for bit encode_mxsf), codes go out as V-byte stores
// and scales as neighbouring bytes.  Every other (bm, bk) the JAX kernel
// takes runs quantize_kernel, one thread per MX block (a pass for the amax
// and a second to encode), chosen by shape and never on a failure.  The
// requantizer is one thread per to-block, likewise.
#include "mxsf_mma.cuh"

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

// The tiled quantizer: instance (BM, BK) in {(8,8), (64,1), (1,64)}, ES
// bytes an element, RPT rows a thread (8 for (8,8) and (64,1): one block's
// rows; 2 for (1,64): more, smaller tiles).  Thread (warp w, lane l) of
// block (bx, by) holds rows 8 RPT by + RPT w .. + RPT - 1 of columns
// 32 V bx + V l .. + V - 1, kept as the raw 16-byte pieces.  vec_in: rows
// may be read in 16-byte pieces (K * ES % 16 == 0, x aligned).
template <int BM, int BK, int ES, int RPT>
__global__ void __launch_bounds__(256, BM == 64 ? 3 : 4)
quantize_tiled(const void* __restrict__ x, int M, int K, int Mb, int Kb,
               int vec_in, uint8_t* __restrict__ codes,
               uint8_t* __restrict__ scales) {
  constexpr int V = 16 / ES;  // elements per piece
  constexpr int TC = 32 * V;  // tile columns
  static_assert((BM == 8 && BK == 8 && RPT == 8) ||
                (BM == 64 && BK == 1 && RPT == 8) ||
                (BM == 1 && BK == 64), "tiled instances");
  __shared__ float colmax[BM == 64 ? 8 : 1][BM == 64 ? TC : 1];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  const int r0 = blockIdx.y * 8 * RPT + RPT * w;
  const int c0 = blockIdx.x * TC + V * lane;

  uint32_t raw[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + i;
    if (vec_in && r < M && c0 + V <= K) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(
          xb + (static_cast<size_t>(r) * K + c0) * ES));
      raw[i][0] = q.x;
      raw[i][1] = q.y;
      raw[i][2] = q.z;
      raw[i][3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) raw[i][k] = 0u;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (r >= M || c0 + j >= K) continue;
        const size_t at = static_cast<size_t>(r) * K + c0 + j;
        if constexpr (ES == 4)
          raw[i][j] = __float_as_uint(static_cast<const float*>(x)[at]);
        else
          raw[i][j >> 1] |= static_cast<uint32_t>(__bfloat16_as_ushort(
                                static_cast<const __nv_bfloat16*>(x)[at]))
                            << (16 * (j & 1));
      }
    }
  }
  // element j of row i's piece as f32
  const auto val = [&](int i, int j) {
    return ES == 4 ? __uint_as_float(raw[i][j])
                   : __uint_as_float(j & 1 ? raw[i][j >> 1] & 0xffff0000u
                                           : raw[i][j >> 1] << 16);
  };

  // the shared exponent of each value's block
  int se[RPT][BM == 64 ? V : 1];  // (1,64): per row; (8,8): se[0][0]
  if constexpr (BM == 1) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) a = fmaxf(a, fabsf(val(i, j)));
#pragma unroll
      for (int o = 1; o < 64 / V; o <<= 1)
        a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      se[i][0] = a > 0.f ? mxsf::flog2(a) : -127;
    }
  } else if constexpr (BM == 8) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) a = fmaxf(a, fabsf(val(i, j)));
    if constexpr (V == 4) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1));
    se[0][0] = a > 0.f ? mxsf::flog2(a) : -127;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) a = fmaxf(a, fabsf(val(i, j)));
      colmax[w][V * lane + j] = a;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) a = fmaxf(a, colmax[k][V * lane + j]);
      se[0][j] = a > 0.f ? mxsf::flog2(a) : -127;
    }
  }

  // codes, V bytes a row; scales
  const bool vec_out = c0 + V <= Kb && Kb % V == 0;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + i;
    if (r >= Mb || c0 >= Kb) continue;
    uint32_t cw[2] = {0u, 0u};
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int e = BM == 1 ? se[i][0] : (BM == 8 ? se[0][0] : se[0][j]);
      const uint32_t code =
          mxmma::encode_mxsf_fast(mxsf::scale_by_exp2(val(i, j), -e));
      cw[j >> 2] |= code << (8 * (j & 3));
    }
    uint8_t* dst = codes + static_cast<size_t>(r) * Kb + c0;
    if (vec_out) {
      if constexpr (V == 8)
        *reinterpret_cast<uint2*>(dst) = make_uint2(cw[0], cw[1]);
      else
        *reinterpret_cast<uint32_t*>(dst) = cw[0];
    } else {
      for (int j = 0; j < V && c0 + j < Kb; ++j)
        dst[j] = static_cast<uint8_t>(cw[j >> 2] >> (8 * (j & 3)));
    }
  }
  const auto byte = [](int e) {
    return static_cast<uint8_t>(min(max(e + mxsf::kScaleBias, 0), 255));
  };
  if constexpr (BM == 1) {
    if (lane % (64 / V) == 0 && c0 < Kb)
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (r0 + i < Mb)
          scales[static_cast<size_t>(r0 + i) * (Kb / 64) + c0 / 64] =
              byte(se[i][0]);
  } else if constexpr (BM == 8) {
    if ((V == 8 || (lane & 1) == 0) && r0 < Mb && c0 < Kb)
      scales[static_cast<size_t>(r0 / 8) * (Kb / 8) + c0 / 8] =
          byte(se[0][0]);
  } else {
    if (w == 0)
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (c0 + j < Kb)
          scales[static_cast<size_t>(blockIdx.y) * Kb + c0 + j] =
              byte(se[0][j]);
  }
}

template <int BM, int BK>
cudaError_t launch_tiled(const void* x, int x_bf16, int M, int K, int Mb,
                         int Kb, uint8_t* codes, uint8_t* scales,
                         cudaStream_t stream) {
  constexpr int RPT = BM == 1 ? 2 : 8;
  const int es = x_bf16 ? 2 : 4;
  const int vec_in = (static_cast<long long>(K) * es) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((Kb + 32 * (16 / es) - 1) / (32 * (16 / es)),
                  (Mb + 8 * RPT - 1) / (8 * RPT));
  if (x_bf16)
    quantize_tiled<BM, BK, 2, RPT><<<grid, 256, 0, stream>>>(
        x, M, K, Mb, Kb, vec_in, codes, scales);
  else
    quantize_tiled<BM, BK, 4, RPT><<<grid, 256, 0, stream>>>(
        x, M, K, Mb, Kb, vec_in, codes, scales);
  return cudaGetLastError();
}

unsigned grid_for(long long nblocks) {
  return static_cast<unsigned>((nblocks + kThreads - 1) / kThreads);
}

}  // namespace

// x: (M, K) f32 or bf16, row-major.  codes: (Mb, Kb) and scales:
// (Mb/bm, Kb/bk), Mb = ceil(M/bm)*bm, Kb = ceil(K/bk)*bk (the wrapper
// allocates both and checks the shapes).  The instance follows the block
// shape (kernels/mxsf_quant.py::quantize_instance names it).
extern "C" int mxsf_quantize(const void* x, int x_bf16, int M, int K, int bm,
                             int bk, void* codes, void* scales,
                             void* stream) {
  const int nbm = (M + bm - 1) / bm, nbk = (K + bk - 1) / bk;
  const long long nblocks = static_cast<long long>(nbm) * nbk;
  if (nblocks == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* c = static_cast<uint8_t*>(codes);
  uint8_t* s = static_cast<uint8_t*>(scales);
  if (bm == 8 && bk == 8)
    return launch_tiled<8, 8>(x, x_bf16, M, K, nbm * bm, nbk * bk, c, s, st);
  if (bm == 64 && bk == 1)
    return launch_tiled<64, 1>(x, x_bf16, M, K, nbm * bm, nbk * bk, c, s, st);
  if (bm == 1 && bk == 64)
    return launch_tiled<1, 64>(x, x_bf16, M, K, nbm * bm, nbk * bk, c, s, st);
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
