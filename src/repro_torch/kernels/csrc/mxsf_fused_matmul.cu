// Fused MXSF quantize -> matmul for Hopper (sm_90a), serving switches only.
//
// Replaces the JAX package's Pallas TPU kernel
// kernels/mxsf_fused_matmul.py::mxsf_fused_matmul_pallas (body _fused_kernel)
// with quantize_lhs=True, emit_codes=False, xblk=(1,64), wblk=(64,1):
//
//   y[M,N] (f32) = qdq_MXSF(x[M,K]; (1,64) blocks) @ decode(w codes[Kp,N],
//                  E8M0 scales[Kp/64,N]; (64,1) blocks)
//
// x columns K..Kp-1 read as zero (packed weights are block-padded along K).
//
// Bound on the H100: at serving shapes M is the slot batch (decode) or
// slots x chunk (prefill), a few to ~64 rows, far below the ~295 op/byte
// ridge, so the weight bytes (1 code byte + 1/64 scale byte per element)
// bound it.  Design: one 256-thread block per (TM x 64) output tile loops
// over K in steps of 64 -- one MX block on both sides, so both shared
// exponents are local to the step.  Each step quantizes x[TM,64] in the
// prologue (warp amax -> flog2 -> encode -> decode back to f32, the same
// byte path as the reference), stages the weight codes of the step with one
// 16-byte load per thread and decodes them through a 256-entry table, and
// accumulates with f32 FMAs.  A decoded MXSF value has at most 6
// significant bits, so every product is exact in f32, as in the reference
// f32 dot; only the summation order differs.  Every weight byte is read
// once per M tile, so for M <= TM the kernel streams the weights once.
#include "mxsf_codec.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTN = 64;
constexpr int kBK = 64;

template <int TM>
__global__ void __launch_bounds__(kThreads)
fused_matmul_kernel(const void* __restrict__ x, int x_bf16,
                    const uint8_t* __restrict__ wc,
                    const uint8_t* __restrict__ ws, float* __restrict__ y,
                    int M, int K, int Kp, int N, int vec_ok) {
  constexpr int kRowsPerThread = TM / 4;
  __shared__ float lut[256];
  __shared__ float xs[TM][kBK];
  __shared__ __align__(16) float wsm[kBK][kTN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * kTN;
  const int col = tid % kTN, rg = tid / kTN;
  lut[tid] = mxsf::decode_mxsf(static_cast<uint32_t>(tid));

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < Kp; k0 += kBK) {
    // --- MXSF converter on x: one warp per row, two elements per lane ----
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
      xs[r][lane] = lut[mxsf::encode_mxsf(mxsf::scale_by_exp2(v0, -se))] * sc;
      xs[r][lane + 32] =
          lut[mxsf::encode_mxsf(mxsf::scale_by_exp2(v1, -se))] * sc;
    }
    // --- weight codes of this K step: 64 rows x 64 columns, 16 B/thread --
    {
      const int kk = tid >> 2, seg = (tid & 3) * 16;
      const int n = n0 + seg;
      const uint8_t* crow = wc + static_cast<size_t>(k0 + kk) * N;
      const uint8_t* srow = ws + static_cast<size_t>(k0 / kBK) * N;
      float* dst = &wsm[kk][seg];
      if (vec_ok && n + 16 <= N) {
        const uint4 c4 = *reinterpret_cast<const uint4*>(crow + n);
        const uint4 s4 = *reinterpret_cast<const uint4*>(srow + n);
        const uint32_t cw[4] = {c4.x, c4.y, c4.z, c4.w};
        const uint32_t sw[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float4 o;
          o.x = lut[cw[q] & 0xFF] *
                mxsf::exp2i(static_cast<int>(sw[q] & 0xFF) - mxsf::kScaleBias);
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
          dst[j] = (n + j < N)
                       ? lut[crow[n + j]] *
                             mxsf::exp2i(static_cast<int>(srow[n + j]) -
                                         mxsf::kScaleBias)
                       : 0.f;
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

template <int TM>
cudaError_t launch(const void* x, int x_bf16, const uint8_t* wc,
                   const uint8_t* ws, float* y, int M, int K, int Kp, int N,
                   int vec_ok, cudaStream_t stream) {
  const dim3 grid((N + kTN - 1) / kTN, (M + TM - 1) / TM);
  fused_matmul_kernel<TM><<<grid, kThreads, 0, stream>>>(
      x, x_bf16, wc, ws, y, M, K, Kp, N, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) f32 or bf16, row-major; wc: (Kp, N) uint8; ws: (Kp/64, N) uint8;
// y: (M, N) f32.  Kp % 64 == 0 and K <= Kp (checked by the wrapper).
// vec_ok: N % 16 == 0 and both weight pointers 16-byte aligned.
extern "C" int mxsf_fused_matmul(const void* x, int x_bf16, const void* wc,
                                 const void* ws, void* y, int M, int K,
                                 int Kp, int N, int vec_ok, void* stream) {
  const auto* c = static_cast<const uint8_t*>(wc);
  const auto* s = static_cast<const uint8_t*>(ws);
  auto* out = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 4) return launch<4>(x, x_bf16, c, s, out, M, K, Kp, N, vec_ok, st);
  if (M <= 16)
    return launch<16>(x, x_bf16, c, s, out, M, K, Kp, N, vec_ok, st);
  return launch<64>(x, x_bf16, c, s, out, M, K, Kp, N, vec_ok, st);
}
