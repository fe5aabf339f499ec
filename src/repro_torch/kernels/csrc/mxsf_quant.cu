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
//               (Mb, Kb) padded to the to-block, or with `transpose` the
//               transposed grids (Kb, Mb) and (Kb/tbk, Mb/tbm).  The decode
//               is the plain dequantize (code value times 2^(byte - 127),
//               the exponent clipped to [-126, 127] as in the JAX package),
//               so the result is bit for bit quantize(dequantize(qt),
//               to_block).
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
// and a second to encode), chosen by shape and never on a failure.
//
// Requantizer design.  The two re-blockings of the 1D backward -- (B,1) ->
// (1,B) (the weight re-blocked along N) and (1,B) -> (B,1) (the
// activations along M), B in {32, 64} -- are instances of
// requantize_tiled<B, DIR, TR>: tiles of 64 rows x 512 codes, thread (warp
// w, lane l) rows 8 w .. 8 w + 7 of the 16-byte piece at column 16 l, all
// loaded (__ldg, uint4) before any is used; a persistent grid of 2 blocks
// an SM walks the tiles, each row's registers taking the next tile's piece
// as soon as the row is coded, so the loads run under the compute.  The
// work is issue-bound (half-rate integer ops), so the byte path is short:
// * decode: a table of decode_mxsf in shared memory, entry (code, lane) at
//   code * 64 + lane (no two lanes share a bank; one prmt forms the
//   address), times 2^S; S from 16 bytes of the band's scale row a lane
//   ((B,1) in) or one byte a row ((1,B) in);
// * the new shared exponent from the float amax: (1,B) out by shuffles over
//   the B/16 lanes of a row block; (B,1) out by a column reduction through
//   shared memory (each warp its column maxima, swizzled so no store
//   conflicts, then each thread two columns of each band), handed back as
//   int16;
// * encode: one byte lookup in the re-encode table (below), which codes
//   as scale_by_exp2 + encode_mxsf_fast would, bit for bit; codes out as
//   16-byte stores, scales as neighbouring bytes.
// TR (transpose): the coded tile is staged in shared memory (16-byte
// chunks swizzled by row so the column reads are conflict-free) and each
// thread reads a 16-row x 4-column block of it as 4-byte words, transposes
// it with byte permutes and stores four 16-byte pieces of the transposed
// rows, four lanes filling 64 contiguous bytes of a row.  Shared memory
// (dynamic): decode table 64 KB, re-encode table 6.4 KB, stage 32 KB.
// Every other block pair runs requantize_kernel, one thread per to-block
// (transposed writes index-swapped).
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
                  int fbk, int tbm, int tbk, int nbm, int nbk,
                  long long nblocks, int tr, uint8_t* __restrict__ codes,
                  uint8_t* __restrict__ scales) {
  __shared__ float lut[256];
  lut[threadIdx.x] = mxsf::decode_mxsf(threadIdx.x);
  __syncthreads();
  const long long b = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (b >= nblocks) return;
  const int bi = static_cast<int>(b / nbk), bj = static_cast<int>(b % nbk);
  const int r0 = bi * tbm, c0 = bj * tbk;
  const size_t mb = static_cast<size_t>(nbm) * tbm;
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
      codes[tr ? (c0 + j) * mb + r0 + i : (r0 + i) * kb + c0 + j] =
          static_cast<uint8_t>(mxsf::encode_mxsf(mxsf::scale_by_exp2(v, -se)));
    }
  scales[tr ? static_cast<long long>(bj) * nbm + bi : b] =
      static_cast<uint8_t>(min(max(se + mxsf::kScaleBias, 0), 255));
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

// ---------------------------------------------------------------------------
// The tiled requantizer: requantize_tiled<B, DIR, TR>
// ---------------------------------------------------------------------------

constexpr int kRqTileRows = 64;    // 8 warps x 8 rows
constexpr int kRqTileCols = 512;   // 32 lanes x one 16-byte piece
constexpr int kRqLutBytes = 256 * 256;  // decode table: code * 256 + 4 lane
constexpr int kRqStageBytes = kRqTileRows * kRqTileCols;  // TR: coded tile
constexpr int kRqColmaxBytes = 8 * kRqTileCols * 4;       // DIR 1: amax
constexpr int kRqSmallBytes = 2048;  // exponents / transposed scale rows
constexpr int kRqBlocksPerSm = 2;    // the persistent grid: 2 blocks an SM

// The re-encode table.  With S = clip(s - 127) an element's from-exponent
// and e its new block's exponent, the float path codes v = lut[c] 2^S as
// encode(v 2^e1 2^e2) (e1 = floor_div2(-e), e2 = -e - e1).  Every product
// there is exact but for codes that end as zero: a nonzero code's value
// has at most 6 significant bits and v >= 2^-11 2^-126, so v is exact;
// v 2^e1 can round only for e >= 0 (e1 <= 0) below 2^-126, and then the
// code's magnitude is 0 by either path.  So the code is encode(lut[c] 2^d)
// with d = S - e alone: row d - kReDMin of the table.  d <= kReDMin rounds
// every magnitude to 0 (lut < 2, so lut 2^d < 2^-12); d > kReDMax only for
// zero codes (|v| < 2^(e+1)), so d is clamped to the table's rows.
// mxsf_reencode_check holds the table to the float path on every (code,
// scale byte, block exponent) triple a block can hold.
constexpr int kReDMin = -13;
constexpr int kReDMax = 11;
constexpr int kReRows = kReDMax - kReDMin + 1;
constexpr int kReBytes = kReRows * 256;
constexpr int kReEMin = -149;  // the block exponents: flog2 of a subnormal
constexpr int kReEMax = 127;   // amax, up to 127

__device__ __forceinline__ int clip_exp(uint32_t s) {
  return min(max(static_cast<int>(s) - mxsf::kScaleBias, -126), 127);
}

// the table row of exponent difference S - e
__device__ __forceinline__ int reencode_row(int S, int e) {
  return min(max(S - e - kReDMin, 0), kReRows - 1);
}

// table row d - kReDMin, code c: the code of decode(c) 2^d
__device__ __forceinline__ uint32_t reencode_entry(int d, float dc) {
  return mxmma::encode_mxsf_fast(dc * mxsf::exp2i(d));
}

// 16 bytes of row[c0 .. c0 + 16), `fill` at and past column n (the ragged
// edge: a rolled loop, so the hot path stays small)
__device__ __noinline__ uint4 load16_tail(const uint8_t* __restrict__ row,
                                          int c0, int n, uint32_t fill) {
  unsigned long long lo = 0ull, hi = 0ull;
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    const unsigned long long b = c0 + j < n ? row[c0 + j] : fill;
    if (j < 8)
      lo |= b << (8 * j);
    else
      hi |= b << (8 * (j - 8));
  }
  return make_uint4(static_cast<uint32_t>(lo), static_cast<uint32_t>(lo >> 32),
                    static_cast<uint32_t>(hi), static_cast<uint32_t>(hi >> 32));
}

__device__ __forceinline__ uint32_t word_of(const uint4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

// byte j of a 16-byte piece
__device__ __forceinline__ uint32_t byte_of(const uint4& q, int j) {
  return (word_of(q, j >> 2) >> (8 * (j & 3))) & 0xffu;
}

// byte k of `w` placed at bits 8..15 over the low byte of `lo` (bytes
// 2, 3 of `lo` zero): the byte offset w_k * 256 + lo, one prmt
__device__ __forceinline__ uint32_t at_byte1(uint32_t w, int k, uint32_t lo) {
  return __byte_perm(w, lo, 0x7604u | static_cast<uint32_t>(k) << 4);
}

// byte k of `w` placed under byte 1 of `hi` (bytes 0, 2, 3 of `hi` zero):
// the byte offset (hi >> 8) * 256 + w_k, one prmt
__device__ __forceinline__ uint32_t at_byte0(uint32_t w, int k, uint32_t hi) {
  return __byte_perm(w, hi, 0x7650u | static_cast<uint32_t>(k));
}

// the two factors of scale_by_exp2(v, -e), applied as v * f1 * f2
__device__ __forceinline__ void unscale_factors(int e, float& f1, float& f2) {
  const int e1 = mxsf::floor_div2(-e);
  f1 = mxsf::exp2i(e1);
  f2 = mxsf::exp2i(-e - e1);
}

__device__ __forceinline__ int amax_exponent(float a) {
  return a > 0.f ? mxsf::flog2(a) : -127;
}

__device__ __forceinline__ uint32_t scale_byte(int e) {
  return static_cast<uint32_t>(min(max(e + mxsf::kScaleBias, 0), 255));
}

// stage swizzle (TR): row `row`'s 16-byte chunk `chunk` lives at chunk
// chunk ^ (2 * (row / 16 % 4)) of its 512-byte stage row
__device__ __forceinline__ int stage_chunk(int row, int chunk) {
  return chunk ^ (((row >> 4) & 3) << 1);
}

// column-maximum swizzle (DIR 1): the 16-byte chunk `chunk` (4 columns) of
// a warp's row of 512 floats
__device__ __forceinline__ int colmax_chunk(int chunk) {
  return chunk ^ ((chunk >> 3) & 7);
}

__device__ __forceinline__ float dec_at(const uint8_t* lutb, uint32_t w,
                                        int k, uint32_t lane4) {
  return *reinterpret_cast<const float*>(lutb + at_byte1(w, k, lane4));
}

// A persistent block: tiles t = blockIdx.x, + gridDim.x, ... of the (Mo,
// Ko) output grid (to-block padded), 64 rows x 512 codes each, tile t at
// row tile t / tx and column tile t % tx.  DIR 0: (B,1) -> (1,B), M % B ==
// 0, Mo = M; DIR 1: (1,B) -> (B,1), K % B == 0, Ko = K.  vec_in: rows (and,
// DIR 0, scale rows) may be read as aligned 16-byte pieces.  As each row
// of a tile is coded, its registers take the next tile's piece, so the
// loads run under the compute (a block that waited for its tile's loads
// before coding it left the memory idle half the time).
template <int B, int DIR, bool TR>
__global__ void __launch_bounds__(256, 2)
requantize_tiled(const uint8_t* __restrict__ ci,
                 const uint8_t* __restrict__ si, int M, int K, int Mo,
                 int Ko, int vec_in, uint8_t* __restrict__ codes,
                 uint8_t* __restrict__ scales) {
  static_assert((B == 32 || B == 64) && (DIR == 0 || DIR == 1),
                "tiled instances");
  constexpr int NB = kRqTileRows / B;  // DIR 1: bands of B rows a tile
  constexpr int WPB = 8 / NB;          // warps a band
  extern __shared__ uint4 rq_smem[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(rq_smem);
  float* lut = reinterpret_cast<float*>(sm);  // [256][64], lanes 0..31 used
  uint8_t* tab = sm + kRqLutBytes;              // the re-encode table
  uint8_t* stage = tab + kReBytes;              // TR: the coded tile
  float* colmax = reinterpret_cast<float*>(stage);  // DIR 1, before it
  uint8_t* small = stage + (TR ? kRqStageBytes
                               : (DIR == 1 ? kRqColmaxBytes : 0));
  int16_t* ecol = reinterpret_cast<int16_t*>(small);  // DIR 1: [NB][512]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int tx = (Ko + kRqTileCols - 1) / kRqTileCols;
  const int ntiles = tx * ((Mo + kRqTileRows - 1) / kRqTileRows);
  const uint32_t lane4 = 4u * lane;

  // tile t's code piece of row i and its from-scales (zero past M and K)
  const auto load_row = [&](int t, int i) {
    const int r = t / tx * kRqTileRows + 8 * w + i;
    const int c0 = t % tx * kRqTileCols + 16 * lane;
    const uint8_t* row = ci + static_cast<size_t>(r) * K;
    if (vec_in && r < M && c0 + 16 <= K)
      return __ldg(reinterpret_cast<const uint4*>(row + c0));
    return r < M && c0 < K ? load16_tail(row, c0, K, 0u) : make_uint4(0, 0, 0, 0);
  };
  // Past M or K the codes are zero and the from-scales read as byte 127
  // (2^0): the value is the same zero, and the table's guard still holds.
  constexpr uint32_t kPad = 0x7f7f7f7fu;
  const auto load_col_scales = [&](int t) {  // DIR 0: the lane's 16 columns
    const int r0 = t / tx * kRqTileRows + 8 * w;
    const int c0 = t % tx * kRqTileCols + 16 * lane;
    const uint8_t* srow = si + static_cast<size_t>(r0 / B) * K;
    if (vec_in && r0 < M && c0 + 16 <= K)
      return __ldg(reinterpret_cast<const uint4*>(srow + c0));
    return r0 < M && c0 < K ? load16_tail(srow, c0, K, kPad & 0xffu)
                            : make_uint4(kPad, kPad, kPad, kPad);
  };
  const auto load_row_scale = [&](int t, int i) {  // DIR 1: row i's scale
    const int r = t / tx * kRqTileRows + 8 * w + i;
    const int c0 = t % tx * kRqTileCols + 16 * lane;
    return r < M && c0 < K
               ? static_cast<uint32_t>(
                     __ldg(si + static_cast<size_t>(r) * (K / B) + c0 / B))
               : kPad & 0xffu;
  };

  // the first tile's pieces and scales, all issued before any is used
  int t = blockIdx.x;
  uint4 q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = load_row(t, i);
  uint4 sq = make_uint4(0, 0, 0, 0);  // DIR 0: the lane's 16 column scales
  uint32_t sr[8];                     // DIR 1: one scale a row
  if constexpr (DIR == 0) {
    sq = load_col_scales(t);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) sr[i] = load_row_scale(t, i);
  }
  // the tables while they are in flight: the decode table (lane l of warp
  // w decodes code 8 l + w; entry (code, lane) at code * 64 + lane, so a
  // lane's bank is its own and one prmt forms the address), and the
  // re-encode table, thread tid coding magnitude tid % 128 in every other
  // row (a code and its negation differ in the sign bit alone)
  {
    const float d = mxsf::decode_mxsf(8 * lane + w);
#pragma unroll 8
    for (int k = 0; k < 32; ++k)
      lut[(w + 8 * k) * 64 + lane] = __shfl_sync(0xffffffffu, d, k);
    const int m = tid & 127;
    const float dm = mxsf::decode_mxsf(m);
#pragma unroll 1
    for (int r = tid >> 7; r < kReRows; r += 2) {
      const uint32_t code = reencode_entry(kReDMin + r, dm);
      tab[r * 256 + m] = static_cast<uint8_t>(code);
      tab[r * 256 + 128 + m] = static_cast<uint8_t>(code | 0x80u);
    }
  }
  __syncthreads();

  const auto dec = [&](const uint4& p, int j) {
    return dec_at(sm, word_of(p, j >> 2), j & 3, lane4);
  };
  // code j of piece p re-encoded from the table row at byte offset `off`
  const auto reenc = [&](const uint4& p, int j, uint32_t off) {
    return static_cast<uint32_t>(tab[at_byte0(word_of(p, j >> 2), j & 3, off)]);
  };
  // four code bytes to a word by multiply-adds (the FMA pipe has room; the
  // integer pipe, at half rate, sets this kernel's pace)
  const auto pack4 = [](uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
    return b0 + b1 * 0x100u + b2 * 0x10000u + b3 * 0x1000000u;
  };
  // the table row's byte offset: (S - kReDMin) * 256 plus -e * 256,
  // clamped to the rows in one Hopper DPX instruction (max(min(a + b, c), 0))
  const auto row_off = [](int sb, int neb) {
    return static_cast<uint32_t>(__viaddmin_s32_relu(sb, neb, (kReRows - 1) * 256));
  };

  for (; t < ntiles; t += gridDim.x) {
    const int rt = t / tx * kRqTileRows, ct = t % tx * kRqTileCols;
    const int r0 = rt + 8 * w, c0 = ct + 16 * lane;
    const int tn = t + gridDim.x;  // the next tile, loaded as rows free up
    const bool more = tn < ntiles;
    // row i's coded piece: to the output, or (TR) to its swizzled stage
    // row (DIR 1: over the column maxima, all read before the last barrier)
    const auto put = [&](int i, uint4 piece) {
      if constexpr (TR) {
        const int row = 8 * w + i;
        *reinterpret_cast<uint4*>(stage + row * kRqTileCols +
                                  16 * stage_chunk(row, lane)) = piece;
      } else if (r0 + i < Mo && c0 < Ko) {
        *reinterpret_cast<uint4*>(codes + static_cast<size_t>(r0 + i) * Ko +
                                  c0) = piece;
      }
    };

    if constexpr (DIR == 0) {
      float fs[16];  // each column's 2^S
      int sb[16];    // each column's (S - kReDMin) * 256
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int S = clip_exp(byte_of(sq, j));
        fs[j] = mxsf::exp2i(S);
        sb[j] = (S - kReDMin) * 256;
      }
      if (more) sq = load_col_scales(tn);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint4 qi = q[i];
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) a = fmaxf(a, fabsf(dec(qi, j) * fs[j]));
#pragma unroll
        for (int o = 1; o < B / 16; o <<= 1)
          a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
        const int e = amax_exponent(a);
        const int eb = -e * 256;
        uint32_t ow[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          ow[k] = pack4(reenc(qi, 4 * k, row_off(sb[4 * k], eb)),
                        reenc(qi, 4 * k + 1, row_off(sb[4 * k + 1], eb)),
                        reenc(qi, 4 * k + 2, row_off(sb[4 * k + 2], eb)),
                        reenc(qi, 4 * k + 3, row_off(sb[4 * k + 3], eb)));
        put(i, make_uint4(ow[0], ow[1], ow[2], ow[3]));
        if (more) q[i] = load_row(tn, i);
        // the scale byte: (Mo, Ko/B), or TR a row of 64 staged for (Ko/B, Mo)
        if (lane % (B / 16) == 0 && c0 < Ko && r0 + i < Mo) {
          if constexpr (TR)
            small[(16 * lane / B) * kRqTileRows + 8 * w + i] =
                static_cast<uint8_t>(scale_byte(e));
          else
            scales[static_cast<size_t>(r0 + i) * (Ko / B) + c0 / B] =
                static_cast<uint8_t>(scale_byte(e));
        }
      }
    } else {
      int sb[8];    // each row's (S - kReDMin) * 256
      float fr[8];  // each row's 2^S
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int S = clip_exp(sr[i]);
        sb[i] = (S - kReDMin) * 256;
        fr[i] = mxsf::exp2i(S);
        if (more) sr[i] = load_row_scale(tn, i);
      }
      // column maxima over the thread's 8 rows, then over the band's warps
      float cm[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) cm[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          cm[j] = fmaxf(cm[j], fabsf(dec(q[i], j) * fr[i]));
#pragma unroll
      for (int k = 0; k < 4; ++k)
        reinterpret_cast<float4*>(colmax + w * kRqTileCols)[colmax_chunk(
            4 * lane + k)] = make_float4(cm[4 * k], cm[4 * k + 1],
                                         cm[4 * k + 2], cm[4 * k + 3]);
      __syncthreads();
      {
        const int at = colmax_chunk(tid >> 1) * 4 + 2 * (tid & 1);
        const int c = ct + 2 * tid;  // this thread's two columns
#pragma unroll
        for (int h = 0; h < NB; ++h) {
          float a0 = 0.f, a1 = 0.f;
#pragma unroll
          for (int k = 0; k < WPB; ++k) {
            const float2 p = *reinterpret_cast<const float2*>(
                colmax + (h * WPB + k) * kRqTileCols + at);
            a0 = fmaxf(a0, p.x);
            a1 = fmaxf(a1, p.y);
          }
          const int e0 = amax_exponent(a0), e1 = amax_exponent(a1);
          ecol[h * kRqTileCols + 2 * tid] = static_cast<int16_t>(e0);
          ecol[h * kRqTileCols + 2 * tid + 1] = static_cast<int16_t>(e1);
          const int band = t / tx * NB + h;
          if (band < Mo / B && c < Ko) {
            if constexpr (TR) {  // (Ko, Mo/B)
              scales[static_cast<size_t>(c) * (Mo / B) + band] =
                  static_cast<uint8_t>(scale_byte(e0));
              scales[static_cast<size_t>(c + 1) * (Mo / B) + band] =
                  static_cast<uint8_t>(scale_byte(e1));
            } else {  // (Mo/B, Ko)
              *reinterpret_cast<uint16_t*>(
                  scales + static_cast<size_t>(band) * Ko + c) =
                  static_cast<uint16_t>(scale_byte(e0) | scale_byte(e1) << 8);
            }
          }
        }
      }
      __syncthreads();
      int eb[16];  // each column's -e * 256
      {
        const int16_t* ep = ecol + (w / WPB) * kRqTileCols + 16 * lane;
        const uint4 elo = *reinterpret_cast<const uint4*>(ep);
        const uint4 ehi = *reinterpret_cast<const uint4*>(ep + 8);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t wd = word_of(j < 8 ? elo : ehi, (j & 7) >> 1);
          eb[j] = -static_cast<int16_t>(j & 1 ? wd >> 16 : wd & 0xffffu) * 256;
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t ow[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          ow[k] = pack4(reenc(q[i], 4 * k, row_off(sb[i], eb[4 * k])),
                        reenc(q[i], 4 * k + 1, row_off(sb[i], eb[4 * k + 1])),
                        reenc(q[i], 4 * k + 2, row_off(sb[i], eb[4 * k + 2])),
                        reenc(q[i], 4 * k + 3, row_off(sb[i], eb[4 * k + 3])));
        put(i, make_uint4(ow[0], ow[1], ow[2], ow[3]));
        if (more) q[i] = load_row(tn, i);
      }
    }

    if constexpr (TR) {  // the transposed (Ko, Mo) grid from the stage
      __syncthreads();
      // thread: rows 16 b .. 16 b + 15 of columns 4 qq .. 4 qq + 3; the
      // four lanes of one qq fill 64 contiguous bytes of each transposed row
      const int b = lane & 3;
      const int rr = rt + 16 * b;
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int qq = (2 * w + it) * 8 + (lane >> 2);
        const int at = 16 * stage_chunk(16 * b, qq >> 2) + 4 * (qq & 3);
        uint32_t wv[16];
#pragma unroll
        for (int i = 0; i < 16; ++i)
          wv[i] = *reinterpret_cast<const uint32_t*>(
              stage + (16 * b + i) * kRqTileCols + at);
        uint32_t tw[4][4];  // tw[k][g]: column k, rows 4 g .. 4 g + 3
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const uint32_t x0 = __byte_perm(wv[4 * g], wv[4 * g + 1], 0x5140);
          const uint32_t x1 = __byte_perm(wv[4 * g], wv[4 * g + 1], 0x7362);
          const uint32_t x2 = __byte_perm(wv[4 * g + 2], wv[4 * g + 3], 0x5140);
          const uint32_t x3 = __byte_perm(wv[4 * g + 2], wv[4 * g + 3], 0x7362);
          tw[0][g] = __byte_perm(x0, x2, 0x5410);
          tw[1][g] = __byte_perm(x0, x2, 0x7632);
          tw[2][g] = __byte_perm(x1, x3, 0x5410);
          tw[3][g] = __byte_perm(x1, x3, 0x7632);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = ct + 4 * qq + k;
          if (c < Ko && rr < Mo)
            *reinterpret_cast<uint4*>(codes + static_cast<size_t>(c) * Mo +
                                      rr) =
                make_uint4(tw[k][0], tw[k][1], tw[k][2], tw[k][3]);
        }
      }
      if constexpr (DIR == 0) {  // the staged scale rows of (Ko/B, Mo)
        if (tid < (kRqTileCols / B) * 4) {
          const int cb = ct / B + (tid >> 2), rs = rt + 16 * (tid & 3);
          if (cb * B < Ko && rs < Mo)
            *reinterpret_cast<uint4*>(scales + static_cast<size_t>(cb) * Mo +
                                      rs) =
                *reinterpret_cast<const uint4*>(small + (tid >> 2) * kRqTileRows +
                                                16 * (tid & 3));
        }
      }
      __syncthreads();  // the stage is the next tile's
    }
  }
}

template <int B, int DIR, bool TR>
cudaError_t run_requant(const uint8_t* ci, const uint8_t* si, int M, int K,
                        int Mo, int Ko, int vec_in, uint8_t* codes,
                        uint8_t* scales, cudaStream_t stream) {
  constexpr int smem = kRqLutBytes + kReBytes +
                       (TR ? kRqStageBytes : (DIR == 1 ? kRqColmaxBytes : 0)) +
                       kRqSmallBytes;
  const auto kernel = requantize_tiled<B, DIR, TR>;
  // once a device: the shared-memory opt-in and the SM count
  static unsigned opted = 0u;
  static int sms[32];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(opted >> dev & 1u)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
    opted |= 1u << dev;
  }
  const long long ntiles =
      static_cast<long long>((Ko + kRqTileCols - 1) / kRqTileCols) *
      ((Mo + kRqTileRows - 1) / kRqTileRows);
  const long long cap = static_cast<long long>(kRqBlocksPerSm) * sms[dev];
  const unsigned grid = static_cast<unsigned>(ntiles < cap ? ntiles : cap);
  kernel<<<grid, 256, smem, stream>>>(ci, si, M, K, Mo, Ko, vec_in, codes,
                                      scales);
  return cudaGetLastError();
}

template <int B, int DIR>
cudaError_t launch_requant(const uint8_t* ci, const uint8_t* si, int M,
                           int K, int Mo, int Ko, int tr, uint8_t* codes,
                           uint8_t* scales, cudaStream_t stream) {
  const int vec_in = K % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(ci) % 16 == 0 &&
                     (DIR == 1 || reinterpret_cast<uintptr_t>(si) % 16 == 0);
  if (tr)
    return run_requant<B, DIR, true>(ci, si, M, K, Mo, Ko, vec_in, codes,
                                     scales, stream);
  return run_requant<B, DIR, false>(ci, si, M, K, Mo, Ko, vec_in, codes,
                                    scales, stream);
}

__global__ void reencode_check_kernel(uint8_t* __restrict__ tab_out,
                                      uint8_t* __restrict__ flt_out,
                                      uint8_t* __restrict__ fits) {
  const uint32_t i = blockIdx.x * 256u + threadIdx.x;
  const uint32_t c = i & 255u;
  const int S = clip_exp((i >> 8) & 255u);
  const int e = kReEMin + static_cast<int>(i >> 16);
  const float v = mxsf::decode_mxsf(c) * mxsf::exp2i(S);
  float f1, f2;
  unscale_factors(e, f1, f2);
  flt_out[i] = static_cast<uint8_t>(mxmma::encode_mxsf_fast(v * f1 * f2));
  tab_out[i] = static_cast<uint8_t>(reencode_entry(
      kReDMin + reencode_row(S, e), mxsf::decode_mxsf(c)));
  fits[i] = v == 0.f || mxsf::flog2(fabsf(v)) <= e;
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
// codes: (Mb, Kb) and scales: (Mb/tbm, Kb/tbk), padded to the to-block, or
// with `transpose` (Kb, Mb) and (Kb/tbk, Mb/tbm).  The instance follows the
// block pair (kernels/mxsf_quant.py::requantize_instance names it).
extern "C" int mxsf_requantize(const void* ci, const void* si, int M, int K,
                               int fbm, int fbk, int tbm, int tbk,
                               int transpose, void* codes, void* scales,
                               void* stream) {
  const int nbm = (M + tbm - 1) / tbm, nbk = (K + tbk - 1) / tbk;
  const long long nblocks = static_cast<long long>(nbm) * nbk;
  if (nblocks == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(ci);
  const uint8_t* s = static_cast<const uint8_t*>(si);
  uint8_t* oc = static_cast<uint8_t*>(codes);
  uint8_t* os = static_cast<uint8_t*>(scales);
  const int Mo = nbm * tbm, Ko = nbk * tbk;
  if (fbk == 1 && tbm == 1 && tbk == fbm) {  // (B,1) -> (1,B)
    if (fbm == 64)
      return launch_requant<64, 0>(c, s, M, K, Mo, Ko, transpose, oc, os, st);
    if (fbm == 32)
      return launch_requant<32, 0>(c, s, M, K, Mo, Ko, transpose, oc, os, st);
  }
  if (fbm == 1 && tbk == 1 && tbm == fbk) {  // (1,B) -> (B,1)
    if (fbk == 64)
      return launch_requant<64, 1>(c, s, M, K, Mo, Ko, transpose, oc, os, st);
    if (fbk == 32)
      return launch_requant<32, 1>(c, s, M, K, Mo, Ko, transpose, oc, os, st);
  }
  requantize_kernel<<<grid_for(nblocks), kThreads, 0, st>>>(
      c, s, M, K, fbm, fbk, tbm, tbk, nbm, nbk, nblocks, transpose, oc, os);
  return cudaGetLastError();
}

// The re-encode table against the float path on every (code c, from-scale
// byte s, block exponent e in [kReEMin, kReEMax]) triple, at index (e -
// kReEMin) << 16 | s << 8 | c: the table's code, the float path's code,
// and whether |v| < 2^(e+1) (a value a block of exponent e can hold).
// Three uint8 arrays of (kReEMax - kReEMin + 1) << 16.
extern "C" int mxsf_reencode_check(void* tab_out, void* flt_out, void* fits,
                                   void* stream) {
  reencode_check_kernel<<<(kReEMax - kReEMin + 1) << 8, 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(tab_out), static_cast<uint8_t*>(flt_out),
      static_cast<uint8_t*>(fits));
  return cudaGetLastError();
}
