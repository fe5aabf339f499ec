// Fused MXSF quantize -> matmul for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/mxsf_fused_matmul.py::mxsf_fused_matmul_pallas (body _fused_kernel):
//
//   y[M,N] (f32) = A @ decode(w codes[Kp,N], E8M0 scales; wblk)
//
// with A = qdq_MXSF(x[M,K]; xblk) (quantize_lhs) or the raw x, and the
// serving and training switches of the JAX kernel:
//   xmode 0: raw x (quantize_lhs=False: the backward's unquantized g);
//   xmode 1: x quantized in (1, 64) row blocks;
//   xmode 2: x quantized in (8, 8) tiles (the training layout);
//   wblk (64, 1) or (8, 8) (wb8);
//   emit_codes: x's codes (Mb, Kb) and scales, cropped to x's block-padded
//   shape, are written as well -- the packed residual of the backward.
// x columns K..Kp-1 and weight rows past Kp read as zero.
//
// Bound on the H100: the weight bytes at serving shapes (a few to ~64 rows,
// far below the ~295 op/byte ridge), operations at training shapes (2048
// rows).  Design: one 256-thread block per (TM x 64) output tile loops over
// K in steps of 64 -- one (1,64)/(64,1) MX block on both sides, or eight
// (8,8) tiles along K, so every shared exponent is local to the step.  Each
// step quantizes x[TM,64] in the prologue: (1,64) rows by one warp per row
// (warp amax -> flog2 -> encode -> decode back to f32, the same byte path as
// the reference); (8,8) tiles by staging the raw tile in shared memory, one
// thread per tile for its amax across 8 rows x 8 columns, then every thread
// encoding its 16 elements.  The weight codes of the step are staged with
// one 16-byte load per thread and decoded through a 256-entry table, and
// the products accumulate with f32 FMAs.  A decoded MXSF value has at most
// 6 significant bits, so with a quantized x every product is exact in f32,
// as in the reference f32 dot; only the summation order differs (the raw-x
// path rounds each product, as the reference does).  The codes are emitted
// by the blocks of N tile 0 only: CUDA blocks revisit no output, unlike the
// TPU grid that rewrites them once per N tile.
#include "mxsf_codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTN = 64;
constexpr int kBK = 64;

struct Emit {
  uint8_t* codes;   // (Mb, Kb) or nullptr
  uint8_t* scales;  // (Mb/bm, Kb/bk)
  int mb, kb;
};

// XMODE and WB8 are template parameters, so the serving instance
// (XMODE 1, (64,1) weights) carries no code of the training switches.
template <int TM, int XMODE, bool WB8>
__global__ void __launch_bounds__(kThreads)
fused_matmul_kernel(const void* __restrict__ x, int x_bf16,
                    const uint8_t* __restrict__ wc,
                    const uint8_t* __restrict__ ws, float* __restrict__ y,
                    int M, int K, int Kp, int N, int vec_ok, Emit emit) {
  constexpr int kRowsPerThread = TM / 4;
  __shared__ float lut[256];
  __shared__ float xs[TM][kBK];
  __shared__ __align__(16) float wsm[kBK][kTN];
  __shared__ int tse[TM];  // (8,8) mode: shared exponent per tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * kTN;
  const int col = tid % kTN, rg = tid / kTN;
  const bool emits = emit.codes != nullptr && blockIdx.x == 0;
  lut[tid] = mxsf::decode_mxsf(static_cast<uint32_t>(tid));

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < Kp; k0 += kBK) {
    if constexpr (XMODE == 1) {
      // --- MXSF converter, (1,64) rows: one warp per row, 2 per lane ----
      for (int r = warp; r < TM; r += kThreads / 32) {
        const int m = m0 + r;
        float v0 = 0.f, v1 = 0.f;
        if (m < M) {
          const size_t base = static_cast<size_t>(m) * K;
          if (k0 + lane < K) v0 = mxsf::load_act(x, x_bf16, base + k0 + lane);
          if (k0 + lane + 32 < K)
            v1 = mxsf::load_act(x, x_bf16, base + k0 + lane + 32);
        }
        float amax = fmaxf(fabsf(v0), fabsf(v1));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
        const int se = amax > 0.f ? mxsf::flog2(amax) : -127;
        const float sc = mxsf::exp2i(se);
        const uint32_t c0 = mxsf::encode_mxsf(mxsf::scale_by_exp2(v0, -se));
        const uint32_t c1 = mxsf::encode_mxsf(mxsf::scale_by_exp2(v1, -se));
        xs[r][lane] = lut[c0] * sc;
        xs[r][lane + 32] = lut[c1] * sc;
        if (emits && m < emit.mb && k0 < emit.kb) {
          uint8_t* row = emit.codes + static_cast<size_t>(m) * emit.kb + k0;
          row[lane] = static_cast<uint8_t>(c0);
          row[lane + 32] = static_cast<uint8_t>(c1);
          if (lane == 0)
            emit.scales[static_cast<size_t>(m) * (emit.kb / kBK) + k0 / kBK] =
                static_cast<uint8_t>(min(max(se + mxsf::kScaleBias, 0), 255));
        }
      }
    } else {
      // --- raw x tile (the (8,8) converter starts from it too) ----------
      for (int e = tid; e < TM * kBK; e += kThreads) {
        const int r = e / kBK, c = e % kBK;
        const int m = m0 + r, k = k0 + c;
        xs[r][c] = (m < M && k < K)
                       ? mxsf::load_act(x, x_bf16, static_cast<size_t>(m) * K + k)
                       : 0.f;
      }
      if constexpr (XMODE == 2) {
        __syncthreads();
        // --- MXSF converter, (8,8) tiles: amax across 8 rows x 8 cols ---
        if (tid < TM) {
          const int tr = (tid / 8) * 8, tc = (tid % 8) * 8;
          float amax = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              amax = fmaxf(amax, fabsf(xs[tr + i][tc + j]));
          const int se = amax > 0.f ? mxsf::flog2(amax) : -127;
          tse[tid] = se;
          const int gm = (m0 + tr) / 8, gk = (k0 + tc) / 8;
          if (emits && gm < emit.mb / 8 && gk < emit.kb / 8)
            emit.scales[static_cast<size_t>(gm) * (emit.kb / 8) + gk] =
                static_cast<uint8_t>(min(max(se + mxsf::kScaleBias, 0), 255));
        }
        __syncthreads();
        for (int e = tid; e < TM * kBK; e += kThreads) {
          const int r = e / kBK, c = e % kBK;
          const int se = tse[(r / 8) * 8 + c / 8];
          const uint32_t code =
              mxsf::encode_mxsf(mxsf::scale_by_exp2(xs[r][c], -se));
          xs[r][c] = lut[code] * mxsf::exp2i(se);
          const int m = m0 + r, k = k0 + c;
          if (emits && m < emit.mb && k < emit.kb)
            emit.codes[static_cast<size_t>(m) * emit.kb + k] =
                static_cast<uint8_t>(code);
        }
      }
    }
    // --- weight codes of this K step: 64 rows x 64 columns, 16 B/thread --
    {
      const int kk = tid >> 2, seg = (tid & 3) * 16;
      const int n = n0 + seg, k = k0 + kk;
      float* dst = &wsm[kk][seg];
      if (k >= Kp) {
#pragma unroll
        for (int j = 0; j < 16; ++j) dst[j] = 0.f;
      } else {
        const uint8_t* crow = wc + static_cast<size_t>(k) * N;
        const uint8_t* srow =
            WB8 ? ws + static_cast<size_t>(k / 8) * (N / 8)
                : ws + static_cast<size_t>(k0 / kBK) * N;
        if (vec_ok && n + 16 <= N) {
          const uint4 c4 = *reinterpret_cast<const uint4*>(crow + n);
          const uint32_t cw[4] = {c4.x, c4.y, c4.z, c4.w};
          uint32_t sw[4];
          if constexpr (WB8) {  // columns n..n+7 share a scale, n+8.. the next
            const uint32_t s0 = srow[n / 8] * 0x01010101u;
            const uint32_t s1 = srow[n / 8 + 1] * 0x01010101u;
            sw[0] = sw[1] = s0;
            sw[2] = sw[3] = s1;
          } else {
            const uint4 s4 = *reinterpret_cast<const uint4*>(srow + n);
            sw[0] = s4.x; sw[1] = s4.y; sw[2] = s4.z; sw[3] = s4.w;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float4 o;
            o.x = lut[cw[q] & 0xFF] *
                  mxsf::exp2i(static_cast<int>(sw[q] & 0xFF) -
                              mxsf::kScaleBias);
            o.y = lut[(cw[q] >> 8) & 0xFF] *
                  mxsf::exp2i(static_cast<int>((sw[q] >> 8) & 0xFF) -
                              mxsf::kScaleBias);
            o.z = lut[(cw[q] >> 16) & 0xFF] *
                  mxsf::exp2i(static_cast<int>((sw[q] >> 16) & 0xFF) -
                              mxsf::kScaleBias);
            o.w = lut[cw[q] >> 24] *
                  mxsf::exp2i(static_cast<int>(sw[q] >> 24) - mxsf::kScaleBias);
            reinterpret_cast<float4*>(dst)[q] = o;
          }
        } else {
#pragma unroll 4
          for (int j = 0; j < 16; ++j) {
            const int nj = n + j;
            dst[j] = (nj < N)
                         ? lut[crow[nj]] *
                               mxsf::exp2i(static_cast<int>(
                                               WB8 ? srow[nj / 8] : srow[nj]) -
                                           mxsf::kScaleBias)
                         : 0.f;
          }
        }
      }
    }
    __syncthreads();
    // --- f32 FMAs: thread owns column `col`, rows rg, rg+4, ... ---------
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float w = wsm[kk][col];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] = fmaf(xs[rg + 4 * i][kk], w, acc[i]);
    }
    __syncthreads();
  }

  const int n = n0 + col;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int m = m0 + rg + 4 * i;
    if (m < M && n < N) y[static_cast<size_t>(m) * N + n] = acc[i];
  }
}

template <int TM, int XMODE, bool WB8>
cudaError_t launch(const void* x, int x_bf16, const uint8_t* wc,
                   const uint8_t* ws, float* y, int M, int K, int Kp, int N,
                   int vec_ok, Emit emit, cudaStream_t stream) {
  const dim3 grid((N + kTN - 1) / kTN, (M + TM - 1) / TM);
  fused_matmul_kernel<TM, XMODE, WB8><<<grid, kThreads, 0, stream>>>(
      x, x_bf16, wc, ws, y, M, K, Kp, N, vec_ok, emit);
  return cudaGetLastError();
}

// the row tile: 4, 16 or 64 rows by M; (8,8) tiles need whole tiles
template <int XMODE, bool WB8>
cudaError_t launch_m(const void* x, int x_bf16, const uint8_t* wc,
                     const uint8_t* ws, float* y, int M, int K, int Kp,
                     int N, int vec_ok, Emit emit, cudaStream_t stream) {
  if constexpr (XMODE != 2) {
    if (M <= 4)
      return launch<4, XMODE, WB8>(x, x_bf16, wc, ws, y, M, K, Kp, N, vec_ok,
                                   emit, stream);
  }
  if (M <= 16)
    return launch<16, XMODE, WB8>(x, x_bf16, wc, ws, y, M, K, Kp, N, vec_ok,
                                  emit, stream);
  return launch<64, XMODE, WB8>(x, x_bf16, wc, ws, y, M, K, Kp, N, vec_ok,
                                emit, stream);
}

}  // namespace

// x: (M, K) f32 or bf16, row-major; wc: (Kp, N) uint8; ws: (Kp/64, N) for
// (64,1) weight blocks or (Kp/8, N/8) for (8,8); y: (M, N) f32.  K <= Kp,
// Kp a multiple of the weight block's rows (checked by the wrapper).
// vec_ok: N % 16 == 0 and the weight pointers 16-byte aligned.  xmode: 0
// raw x, 1 (1,64) blocks, 2 (8,8) tiles (with (8,8) weights).
// xcodes/xscales: nullptr, or the (Mb, Kb) codes and scales of x under its
// block, to be written.
extern "C" int mxsf_fused_matmul(const void* x, int x_bf16, const void* wc,
                                 const void* ws, void* y, int M, int K,
                                 int Kp, int N, int vec_ok, int xmode,
                                 int wb8, void* xcodes, void* xscales,
                                 int mb, int kb, void* stream) {
  const auto* c = static_cast<const uint8_t*>(wc);
  const auto* s = static_cast<const uint8_t*>(ws);
  auto* out = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  const Emit emit{static_cast<uint8_t*>(xcodes),
                  static_cast<uint8_t*>(xscales), mb, kb};
  if (xmode == 1 && !wb8)
    return launch_m<1, false>(x, x_bf16, c, s, out, M, K, Kp, N, vec_ok, emit,
                              st);
  if (xmode == 2 && wb8)
    return launch_m<2, true>(x, x_bf16, c, s, out, M, K, Kp, N, vec_ok, emit,
                             st);
  if (xmode == 0 && wb8)
    return launch_m<0, true>(x, x_bf16, c, s, out, M, K, Kp, N, vec_ok, emit,
                             st);
  if (xmode == 0 && !wb8)
    return launch_m<0, false>(x, x_bf16, c, s, out, M, K, Kp, N, vec_ok,
                              emit, st);
  return cudaErrorInvalidValue;  // the wrapper admits no other pairing
}
