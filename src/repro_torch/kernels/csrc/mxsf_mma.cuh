// Tensor-core MXSF matmul engine for Hopper (sm_90a), shared by
// mx_matmul.cu (packed x packed) and mxsf_fused_matmul.cu (quantize ->
// matmul).  Each file's note says which TPU kernel it replaces, its bound
// and its instances; this header holds the design they share:
//
//   y[M,N] (f32) = A[M,Kp] @ decode(B codes[Kp,N], E8M0 scales; wblk)
//
// * Tiles.  One 256-thread block (8 warps) per BM x BN output tile (and
//   per K split, below); K in steps of 64.  A step holds one (1,64)/(64,1)
//   block or eight (8,8) tiles along K, so every shared exponent a step
//   needs is local to it.
// * Staging.  A ring of kStages = 3 stages in dynamic shared memory holds
//   each step's raw operands -- the A codes (or the raw f32/bf16 x, 16-byte
//   chunks XOR-swizzled by row) and the uint8 B codes, 1 byte an element --
//   copied with cp.async (16 bytes a thread where the rows allow, else 8 or
//   4; ragged edges zero-filled): steps i+1 .. i+3 are in flight while step
//   i computes.  Step i+3's E8M0 scales are read into registers during step
//   i and stored into their stage at the end of step i+1.
// * Decode.  Step i+1's codes become bf16 tiles in a second buffer while
//   step i's are multiplied (one barrier a step): value = table[code] *
//   2^(scale - 127) in f32, exact, packed to bf16 (exact: see the
//   predicate).  The table is replicated once per lane (no bank conflicts);
//   block edges are template parameters (no division per element); loads
//   are batched four 8-element chunks at a time.  Tiles are in wgmma's
//   canonical 128-byte-swizzled layouts: A K-major, B MN-major (one 8 KB
//   block per 64 columns).  The fused kernel's x goes through the MXSF
//   converter instead (lanes of a block share its amax by shuffles; flog2,
//   a branch-free bit-exact encoder, the table), which also keeps the codes
//   for the f32 path and writes the emitted residual.
// * Tensor cores.  Instances with 64-row warpgroup tiles use wgmma
//   m64n128k16 (bf16 in, f32 out, both operands from shared memory via
//   matrix descriptors), issued asynchronously so that step i+1's B decode
//   runs while step i's products are computed.  The small-M serving
//   instance uses mma.sync m16n8k16 on ldmatrix fragments, with step i+1's
//   decode interleaved between its four k16 chunks.
// * Prepared A (PREP).  Producer blocks at the front of the grid build each
//   A tile once per call -- the quantized x of the fused kernel, the
//   decoded A of mx_matmul -- into a global scratch of bf16 tiles in the
//   shared-memory layout, and publish each (row tile, step) with a release
//   store of 2 epoch + its out-of-range bit.  An output block reads the
//   word (acquire) two steps ahead and, if it is this launch's, copies the
//   tile with cp.async straight into the step's buffer (three buffers);
//   otherwise it builds the tile itself from global memory.  No block
//   waits on another, so no launch order can deadlock it.
// * Two-level accumulation.  Each step's k16 products sum into a fragment
//   the first of them overwrites (or a zeroed one), which is then added to
//   the f32 accumulator with an ordinary round-to-nearest f32 add: the
//   tensor cores' internal adds (not specified as IEEE) act on at most 64
//   products at a time.
// * The predicate and the f32 path.  A decoded MXSF value is rel * 2^S,
//   rel with at most 6 significant bits in [2^-11, 1.97], S = scale - 127.
//   If every nonzero block of both tiles of a step has S in
//   [kTcMinExp, kTcMaxExp] = [-52, 63], every decoded value is a normal
//   bf16 and every product of two lies in [2^-126, 2^128): exact and normal
//   in f32, so the tensor cores compute the plain version's products and
//   only the summation order differs.  A block is nonzero if any of its
//   codes in the step has a nonzero magnitude (zero blocks carry scale 0
//   and do not count).  Otherwise the whole step (one uniform branch per
//   block of threads, decided by __syncthreads_or) runs f32 FMAs on values
//   decoded from the codes, in k order, into the same fragment; each such
//   step adds one to a device counter the wrapper reads.
// * K splits.  Where the output tiles are fewer than 264 (two waves of
//   132 SMs; serving shapes), the wrapper splits K into whole steps; each
//   split writes its partial tile to a workspace, and the last block of
//   the tile to arrive (a counter per tile, reset by that block) sums the
//   splits in index order into y: deterministic, no atomics on y.
#pragma once

#include "mxsf_codec.cuh"

namespace mxmma {

constexpr int kBK = 64;
constexpr int kStages = 3;
constexpr int kTcMinExp = -52;  // nonzero blocks' S_e range of the
constexpr int kTcMaxExp = 63;   // tensor-core path
constexpr int kMinCtas = 264;   // the wrapper's K-split target

// A operand modes
constexpr int kAPacked = 0;  // codes + E8M0 scales (mx_matmul)
constexpr int kARow64 = 1;   // raw x quantized in (1,64) row blocks
constexpr int kATile8 = 2;   // raw x quantized in (8,8) tiles
constexpr int kARaw = 3;     // raw x unquantized: f32 FMAs

struct Params {
  const void* a;          // codes (M, K) uint8, or x (M, K) f32/bf16
  const uint8_t* as;      // kAPacked: A scales (M/ABM, K/ABK)
  const uint8_t* bc;      // B codes (Kp, N)
  const uint8_t* bs;      // B scales (Kp/WBM, N/WBN)
  float* y;               // (M, N)
  float* work;            // (splits, M, N) partials when splits > 1
  int* counters;          // one per output tile, zero between launches
  int* f32_steps;         // steps that took the f32 path
  uint8_t* emit_codes;    // quantized x: (mb, kb) codes or nullptr
  uint8_t* emit_scales;
  int emit_mb, emit_kb;
  int M, K, Kp, N;        // K: A's columns; Kp: B's rows (K <= Kp)
  int a_bf16;             // raw x is bf16 (else f32)
  int a_cp, b_cp;         // cp.async widths in bytes: 16, 8 or 4
  int per;                // K steps per split
  int splits;
  // prepared A (PREP instances): the decoded bf16 A tile of every (row
  // tile, step), in the shared-memory layout, published by producer blocks
  uint8_t* prep;          // [row tiles][steps][BM * 64 * 2]
  int* ready;             // [row tiles][steps]: 2 epoch (+1: out of range)
  int epoch;              // this launch's; flags of earlier launches differ
  int prep_steps;         // steps per producer block
  const uint8_t* acodes;  // A's codes and scales in global memory, for a
  const uint8_t* ascales; // consumer's f32 path: (arows, ald) and blocks
  int arows, ald;
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (16, 8 or 4; the source aligned to it), of which the
// first `valid` are read and the rest zero-filled.
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, int valid) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start,
// leading and stride byte offsets (16-byte units), layout type 1 (SW128).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared-memory writes of the generic proxy, made visible to wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accesses of r across an async MMA
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// wgmma m64n128k16, bf16 x bf16 -> f32, both operands from shared memory
// (A K-major, B MN-major, both 128-byte swizzled); D = A B (+ D if
// accumulate).  d[4 j + c]: the m16n8 fragment j of mma.sync's layout
// (rows 16 w + g (+8), columns 8 j + 2 t (+1)) for warp w of the group.
__device__ __forceinline__ void wgmma_128(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the scale byte of a nonzero block admits the tensor-core path
__device__ __forceinline__ bool tc_scale_ok(int s) {
  return s >= mxsf::kScaleBias + kTcMinExp && s <= mxsf::kScaleBias + kTcMaxExp;
}

__device__ __forceinline__ float scale_mult(int s) {
  return mxsf::exp2i(s - mxsf::kScaleBias);
}

// Byte offset of byte `byte` of row `r` in a row-swizzled tile.
__device__ __forceinline__ int swz(int r, int row_bytes, int byte) {
  return r * row_bytes + ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15);
}

// Byte offset of the 16-byte chunk of columns 8 c .. 8 c + 7 of row k in
// the bf16 B tile (MN-major, 64 columns per 8 KB block).
__device__ __forceinline__ int b_off(int k, int c) {
  return (c >> 3) * (kBK * 128) + k * 128 + (((c & 7) ^ (k & 7)) << 4);
}

__host__ __device__ constexpr int align(int x) { return (x + 127) & ~127; }
__host__ __device__ constexpr int align1k(int x) { return (x + 1023) & ~1023; }

// Dynamic shared memory of one block (from a 1024-byte aligned start, as
// the 128-byte swizzle needs): the stage ring, two buffers (three with
// PREP) of the decoded tiles (bf16 A and B; the f32 B tile for a raw x)
// with, for a quantized x, its code and scale tiles, and the decode table
// replicated once per lane (entry code * 32 + lane: lanes never share a
// bank).
//
// Tile layouts (128-byte swizzle: 16-byte chunk c of a 128-byte row r sits
// at chunk c ^ (r & 7)): the bf16 A tile is K-major, a row of 64 k per m;
// the bf16 B tile is MN-major, one 8 KB block per 64 columns, a row of 64
// n per k -- the canonical layouts of wgmma, which ldmatrix reads too.
template <int BM, int BN, int AMODE, int ABM, int ABK, int WBM, int WBN,
          bool PREP = false>
struct Layout {
  static constexpr int kARowBytes = AMODE == kAPacked ? kBK : kBK * 4;
  static constexpr int kAStage = PREP ? 0 : BM * kARowBytes;
  static constexpr int kBStage = kBK * BN;
  static constexpr int kASc = (BM / ABM) * (kBK / ABK);  // per step
  static constexpr int kBSc = (kBK / WBM) * (BN / WBN);
  static constexpr int kAScStage = AMODE == kAPacked && !PREP ? kASc : 0;
  static constexpr int oB = align(kAStage);
  static constexpr int oASc = oB + align(kBStage);
  static constexpr int oBSc = oASc + align(kAScStage);
  static constexpr int kStage = oBSc + align(kBSc);
  static constexpr bool kQuant = AMODE == kARow64 || AMODE == kATile8;
  static constexpr int kATile = AMODE == kARaw ? 0 : BM * kBK * 2;
  static constexpr int kBTile = kBK * BN * (AMODE == kARaw ? 4 : 2);
  static constexpr int kBuf = align1k(
      align1k(kATile) + align1k(kBTile) +
      (kQuant ? align(BM * kBK) + align(kASc) : 0));
  static constexpr int oBufs = align1k(kStages * kStage);  // + j kBuf
  static constexpr int kNBuf = PREP ? 3 : 2;  // PREP: A lands 2 steps ahead
  static constexpr int oLut = oBufs + kNBuf * kBuf;
  static constexpr int kBytes = oLut + 256 * 32 * 4 + 1024;  // + alignment
};

__device__ __forceinline__ float lut32(const float* lut, uint32_t code,
                                       int lane) {
  return lut[code * 32 + lane];
}

// Copy `rows` rows of `row_bytes` (the first `valid_bytes` of each of the
// first `valid_rows` read, the rest zero) from global rows `gstride` bytes
// apart into shared rows of `row_bytes`, swizzled or not, in `cp`-byte
// pieces; a piece that reads nothing names `safe`, the tensor's start.
template <int NT>
__device__ __forceinline__ void copy_rows(uint32_t dst, const uint8_t* g,
                                          const void* safe,
                                          size_t gstride, int rows,
                                          int row_bytes, int valid_rows,
                                          int valid_bytes, int cp, bool sw,
                                          int tid) {
  const int lg = cp == 16 ? 4 : (cp == 8 ? 3 : 2);
  const int per_row_lg = 31 - __clz(row_bytes) - lg;  // row_bytes: 2^j
  const int total = rows << per_row_lg;
  for (int c = tid; c < total; c += NT) {
    const int r = c >> per_row_lg;
    const int off = (c & ((1 << per_row_lg) - 1)) << lg;
    int nb = (r < valid_rows) ? min(max(valid_bytes - off, 0), cp) : 0;
    const void* src = nb > 0 ? g + static_cast<size_t>(r) * gstride + off
                             : safe;
    const uint32_t d = dst + (sw ? swz(r, row_bytes, off) : r * row_bytes + off);
    cp_async(d, src, cp, nb);
  }
}

// MXSF byte of a relative value (|xa| < 2), bit for bit encode_mxsf of
// mxsf_codec.cuh without its branches and its IEEE division (a division by
// the power-of-two step is exact, so rounding the bits is the same RNE):
// E2M5 rounds the f32 significand to 5 bits, E3M2 to 2 bits (a carry into
// the exponent is the reference's overflow step), the E3M2 subnormal range
// to multiples of 2^-11.
__device__ __forceinline__ uint32_t encode_mxsf_fast(float xa) {
  const uint32_t bits = __float_as_uint(xa);
  const uint32_t ab = bits & 0x7fffffffu;
  const uint32_t r5 = ab + 0x1ffffu + ((ab >> 18) & 1u);
  const int e5 = static_cast<int>(r5 >> 23) - 127;  // -2 .. 1
  const uint32_t c25 =
      e5 > 0 ? 0x7fu : (static_cast<uint32_t>(e5 + 3) << 5) | ((r5 >> 18) & 31u);
  const uint32_t r2 = ab + 0xfffffu + ((ab >> 21) & 1u);
  const int e2 = static_cast<int>(r2 >> 23) - 127;  // -9 .. -2
  const uint32_t c32 =
      e2 >= -2 ? 0x20u : (static_cast<uint32_t>(e2 + 10) << 2) | ((r2 >> 21) & 3u);
  const float q = rintf(__uint_as_float(ab) * 2048.f);  // 0 .. 4
  const uint32_t csub = q >= 4.f ? 4u : static_cast<uint32_t>(q);
  const uint32_t code = ab >= 0x3e800000u ? c25            // >= 2^-2
                        : ab >= 0x3b000000u ? c32          // >= 2^-9
                                            : csub;
  return code | ((bits >> 31) << 7);
}

// x[r][c0 .. c0 + E) of a stage of ES-byte (4: f32, 2: bf16) elements, by
// 16-byte (or, for 4 bf16, 8-byte) pieces.
template <int ES, int E>
__device__ __forceinline__ void load_x_row(const uint8_t* st, int r, int c0,
                                           float* out) {
  constexpr int kBytes = E * ES;
  if constexpr (kBytes == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(st + swz(r, kBK * ES, c0 * ES));
    const uint32_t w[2] = {q.x, q.y};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[j] = __uint_as_float((j & 1 ? w[j >> 1] & 0xffff0000u : w[j >> 1] << 16));
  } else {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 q = *reinterpret_cast<const uint4*>(
          st + swz(r, kBK * ES, c0 * ES + 16 * c));
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 16 / ES; ++j)
        out[c * (16 / ES) + j] =
            ES == 4 ? __uint_as_float(w[j])
                    : __uint_as_float(j & 1 ? w[j >> 1] & 0xffff0000u
                                            : w[j >> 1] << 16);
    }
  }
}

// x[m][k .. k + E) from global memory (zero past M and K), element by
// element: the path of a step no producer block has published yet.
template <int ES, int E>
__device__ __forceinline__ void load_x_global(const Params& p, int m, int k,
                                              float* out) {
#pragma unroll
  for (int j = 0; j < E; ++j) {
    float v = 0.f;
    if (m < p.M && k + j < p.K) {
      const size_t i = static_cast<size_t>(m) * p.K + k + j;
      v = ES == 2 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.a)[i])
                  : static_cast<const float*>(p.a)[i];
    }
    out[j] = v;
  }
}

// The MXSF converter of one step: x[BM, 64] from the stage -> codes (the
// code tile, and the emitted residual), the block's scale byte (the scale
// tile, and the residual's), and the decoded values as the bf16 A tile.
// Each block is held by a group of lanes (4 lanes of 16 elements for
// BM = 64, 16 lanes of 4 for BM = 16) that share its amax by shuffles.
// Returns whether a nonzero block's S_e leaves the tensor-core range.
// BM rows from row0 of the tile; x from the stage or (GLOBAL) from global
// memory.
template <int BM, int AMODE, int ES, int NT, bool GLOBAL = false>
__device__ __forceinline__ bool quantize_x(const uint8_t* st,
                                           uint8_t* tA, uint8_t* acode,
                                           uint8_t* ascq, const float* lut,
                                           const Params& p, int m0, int k0,
                                           bool emits, int tid, int row0 = 0) {
  const int lane = tid & 31;
  constexpr int E = BM * kBK / NT;  // elements per thread
  constexpr int LPB = 64 / E;       // lanes per block
  constexpr int RPT = AMODE == kATile8 ? E / 8 : 1;  // rows per thread
  constexpr int EPR = E / RPT;                       // elements per row
  static_assert(AMODE != kATile8 || (E % 8 == 0 && BM % 8 == 0),
                "(8,8) mode: whole tiles");
  int r0, c0, blk;
  if constexpr (AMODE == kATile8) {
    const int tt = tid / LPB, q = tid % LPB;
    r0 = row0 + (tt >> 3) * 8 + RPT * q;
    c0 = (tt & 7) * 8;
    blk = row0 + tt;  // (tile row, tile column) = (blk / 8, blk % 8)
  } else {
    r0 = row0 + tid / LPB;
    c0 = (tid % LPB) * E;
    blk = r0;
  }
  float v[E];
#pragma unroll
  for (int h = 0; h < RPT; ++h) {
    if constexpr (GLOBAL) load_x_global<ES, EPR>(p, m0 + r0 + h, k0 + c0, v + h * EPR);
    else load_x_row<ES, EPR>(st, r0 + h, c0, v + h * EPR);
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < E; ++j) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
  for (int o = 1; o < LPB; o <<= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const int se = amax > 0.f ? mxsf::flog2(amax) : -127;
  const int sb = min(max(se + mxsf::kScaleBias, 0), 255);
  const float sc = mxsf::exp2i(se);
  const int e1 = mxsf::floor_div2(-se);  // scale_by_exp2(v, -se), hoisted
  const float f1 = mxsf::exp2i(e1), f2 = mxsf::exp2i(-se - e1);
#pragma unroll
  for (int h = 0; h < RPT; ++h) {
    const int r = r0 + h;
    uint32_t cw[(EPR + 3) / 4] = {};
    uint32_t bw[EPR / 2];
#pragma unroll
    for (int j = 0; j < EPR; j += 2) {
      const uint32_t a = encode_mxsf_fast(v[h * EPR + j] * f1 * f2);
      const uint32_t b = encode_mxsf_fast(v[h * EPR + j + 1] * f1 * f2);
      cw[j / 4] |= (a << (8 * (j & 3))) | (b << (8 * ((j + 1) & 3)));
      bw[j / 2] = pack_bf16x2(lut32(lut, a, lane) * sc, lut32(lut, b, lane) * sc);
    }
    uint8_t* crow = acode + r * kBK + c0;
    const int m = m0 + r, k = k0 + c0;
    const bool em = emits && m < p.emit_mb && k < p.emit_kb;
    uint8_t* erow = em ? p.emit_codes + static_cast<size_t>(m) * p.emit_kb + k
                       : nullptr;
    if constexpr (EPR == 16) {
      const uint4 c4 = make_uint4(cw[0], cw[1], cw[2], cw[3]);
      *reinterpret_cast<uint4*>(crow) = c4;
      if (em) *reinterpret_cast<uint4*>(erow) = c4;
      *reinterpret_cast<uint4*>(tA + swz(r, kBK * 2, c0 * 2)) =
          make_uint4(bw[0], bw[1], bw[2], bw[3]);
      *reinterpret_cast<uint4*>(tA + swz(r, kBK * 2, c0 * 2 + 16)) =
          make_uint4(bw[4], bw[5], bw[6], bw[7]);
    } else if constexpr (EPR == 8) {
      const uint2 c2 = make_uint2(cw[0], cw[1]);
      *reinterpret_cast<uint2*>(crow) = c2;
      if (em) *reinterpret_cast<uint2*>(erow) = c2;
      *reinterpret_cast<uint4*>(tA + swz(r, kBK * 2, c0 * 2)) =
          make_uint4(bw[0], bw[1], bw[2], bw[3]);
    } else {
      static_assert(EPR == 4, "4, 8 or 16 elements per row");
      *reinterpret_cast<uint32_t*>(crow) = cw[0];
      if (em) *reinterpret_cast<uint32_t*>(erow) = cw[0];
      *reinterpret_cast<uint2*>(tA + swz(r, kBK * 2, c0 * 2)) =
          make_uint2(bw[0], bw[1]);
    }
  }
  if (tid % LPB == 0) {
    ascq[blk] = static_cast<uint8_t>(sb);
    if (emits) {
      int gm, gk, ld;
      if constexpr (AMODE == kATile8) {
        gm = m0 / 8 + (blk >> 3);
        gk = k0 / 8 + (blk & 7);
        ld = p.emit_kb / 8;
        if (gm < p.emit_mb / 8 && gk < ld)
          p.emit_scales[static_cast<size_t>(gm) * ld + gk] = sb;
      } else {
        gm = m0 + blk;
        gk = k0 / kBK;
        ld = p.emit_kb / kBK;
        if (gm < p.emit_mb && gk < ld)
          p.emit_scales[static_cast<size_t>(gm) * ld + gk] = sb;
      }
    }
  }
  return amax > 0.f && (se < kTcMinExp || se > kTcMaxExp);
}


// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Step i's loop body, after one barrier: decode step i+1 into the other
// buffer while this step's tiles go through the tensor cores (or the f32
// path).  One barrier a step; a step on the f32 path, and every step of a
// raw x (whose product reads the stage), adds one before the stage is
// refilled.
template <int BM, int BN, int WM, int WN, int AMODE, int ABM, int ABK,
          int WBM, int WBN, bool WGMMA, bool PREP>
__global__ void __launch_bounds__(WM * WN * 32, 1) mxsf_gemm(Params p) {
  using L = Layout<BM, BN, AMODE, ABM, ABK, WBM, WBN, PREP>;
  static_assert(!PREP || (AMODE != kARaw && BM % 64 == 0), "prepared A");
  constexpr int kThreads = WM * WN * 32;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(MI >= 1 && NI % 2 == 0 && WTM % 16 == 0, "warp tile");
  static_assert(kBK % ABK == 0 && kBK % WBM == 0, "blocks inside a step");
  static_assert(kThreads % (BN / 8) == 0, "fixed B columns per thread");
  constexpr int kScTotal = L::kAScStage + L::kBSc;
  constexpr int kScPer = (kScTotal + kThreads - 1) / kThreads;
  constexpr int oBT = align1k(L::kATile);
  constexpr int oAC = oBT + align1k(L::kBTile);
  constexpr int oASQ = oAC + align(BM * kBK);

  static_assert(!WGMMA || (WTM == 16 && WTN == 128 && AMODE != kARaw),
                "wgmma: warp w of a group holds rows 16 w of m64n128");
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // aligned by an offset from the array itself, so that the compiler
  // keeps shared-memory instructions for every access
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float* lut = reinterpret_cast<float*>(smem + L::oLut);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp % WM) * WTM, wn0 = (warp / WM) * WTN;
  const int g = lane >> 2, t = lane & 3;
  const int steps = (p.Kp + kBK - 1) / kBK;
  // PREP: the first blocks are producers (pps per row tile, each for
  // prep_steps steps of one K split, from the split's first step); then
  // the output tiles, row tile major
  const int cps = (p.per + p.prep_steps - 1) / p.prep_steps;  // per split
  int mtile = blockIdx.y, ntile = blockIdx.x, pblk = -1;
  if constexpr (PREP) {
    const int pps = cps * p.splits;
    const int nprod = (p.M + BM - 1) / BM * pps;
    const int nt = (p.N + BN - 1) / BN;
    const int b = blockIdx.x;
    if (b < nprod) {
      mtile = b / pps;
      pblk = b % pps;
      ntile = 0;
    } else {
      mtile = (b - nprod) / nt;
      ntile = (b - nprod) % nt;
    }
  }
  const bool producer = PREP && pblk >= 0;
  if (producer && blockIdx.z > 0) return;  // producers live in z = 0 only
  const int m0 = mtile * BM, n0 = ntile * BN;
  const int s0 = blockIdx.z * p.per, s1 = min(steps, s0 + p.per);
  const int es = (AMODE == kAPacked) ? 1 : (p.a_bf16 ? 2 : 4);
  const bool emits = p.emit_codes != nullptr && (PREP ? producer : ntile == 0);
  __shared__ float dec[256];
  if (tid < 256) dec[tid] = mxsf::decode_mxsf(static_cast<uint32_t>(tid));
  __syncthreads();
#pragma unroll 8
  for (int e = tid; e < 256 * 32; e += kThreads) lut[e] = dec[e >> 5];

  auto stage = [&](int i) { return smem + ((i - s0) % kStages) * L::kStage; };
  auto buf = [&](int i) {
    return smem + L::oBufs + ((i - s0) % L::kNBuf) * L::kBuf;
  };

  // global scale byte j of step i (0 past the edges)
  auto scale_at = [&](int i, int j) -> uint32_t {
    const int k0 = i * kBK;
    if (AMODE == kAPacked && j < L::kAScStage) {
      const int r = j / (kBK / ABK), c = j % (kBK / ABK);
      const int gr = m0 / ABM + r, gc = k0 / ABK + c;
      if (gr < p.M / ABM && gc < p.K / ABK)
        return p.as[static_cast<size_t>(gr) * (p.K / ABK) + gc];
      return 0;
    }
    j -= L::kAScStage;
    const int r = j / (BN / WBN), c = j % (BN / WBN);
    const int gr = k0 / WBM + r, gc = n0 / WBN + c;
    if (gr < p.Kp / WBM && gc < p.N / WBN)
      return p.bs[static_cast<size_t>(gr) * (p.N / WBN) + gc];
    return 0;
  };
  auto store_scale = [&](int i, int j, uint32_t v) {
    uint8_t* st = stage(i);
    if (j < L::kAScStage) st[L::oASc + j] = static_cast<uint8_t>(v);
    else st[L::oBSc + j - L::kAScStage] = static_cast<uint8_t>(v);
  };
  auto issue = [&](int i) {
    uint8_t* st = stage(i);
    const int k0 = i * kBK;
    if (PREP) {  // A arrives prepared, or is built from global memory
    } else if (AMODE == kAPacked) {
      copy_rows<kThreads>(
          smem_u32(st),
          static_cast<const uint8_t*>(p.a) + static_cast<size_t>(m0) * p.K + k0,
          p.a, p.K, BM, kBK, p.M - m0, p.K - k0, p.a_cp, false, tid);
    } else {
      const uint8_t* xa = static_cast<const uint8_t*>(p.a) +
                          (static_cast<size_t>(m0) * p.K + k0) * es;
      copy_rows<kThreads>(smem_u32(st), xa, p.a,
                          static_cast<size_t>(p.K) * es, BM, kBK * es,
                          p.M - m0, (p.K - k0) * es, p.a_cp, true, tid);
    }
    copy_rows<kThreads>(smem_u32(st + L::oB),
              p.bc + static_cast<size_t>(k0) * p.N + n0, p.bc, p.N, kBK, BN,
              p.Kp - k0, p.N - n0, p.b_cp, false, tid);
  };

  // ---- (K,1) weight blocks: a thread's 8 columns share one scale row per
  //      step, so their multipliers and out-of-range masks are read once
  float cmul[8];
  uint2 cbad;
  auto colscales = [&](int i) {
    if constexpr (WBN == 1 && WBM >= kBK) {
      const uint2 sw = *reinterpret_cast<const uint2*>(
          stage(i) + L::oBSc + (tid % (BN / 8)) * 8);
      cbad = make_uint2(0, 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = ((j < 4 ? sw.x : sw.y) >> (8 * (j & 3))) & 0xff;
        cmul[j] = scale_mult(s);
        const uint32_t m = tc_scale_ok(s) ? 0u : (0x7fu << (8 * (j & 3)));
        if (j < 4) cbad.x |= m; else cbad.y |= m;
      }
    }
  };

  // ---- PREP: step i's A tile built from global memory (a producer's work,
  //      or a consumer's for a step not yet published); true if a nonzero
  //      block leaves the tensor-core range
  auto local_a = [&](int i, uint8_t* tA, bool emit) -> bool {
    bool bad = false;
    const int k0 = i * kBK;
    if constexpr (AMODE == kAPacked) {
      const uint8_t* ac = static_cast<const uint8_t*>(p.a);
      constexpr int U = BM * 8 / kThreads;  // chunks per thread: loads first
      uint2 cw[U];
      int sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = tid + u * kThreads;
        const int m = m0 + (c >> 3), k = k0 + (c & 7) * 8;
        cw[u] = make_uint2(0u, 0u);
        sc[u] = 0;
        if (m < p.M && k < p.K) {  // K is a multiple of 8: whole chunks
          const uint32_t* q = reinterpret_cast<const uint32_t*>(
              ac + static_cast<size_t>(m) * p.K + k);
          cw[u] = make_uint2(q[0], q[1]);
          sc[u] = p.as[static_cast<size_t>(m / ABM) * (p.K / ABK) + k / ABK];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = tid + u * kThreads, r = c >> 3, kc = c & 7;
        const float mul = scale_mult(sc[u]);
        bad |= !tc_scale_ok(sc[u]) && ((cw[u].x | cw[u].y) & 0x7f7f7f7fu) != 0;
        float v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = lut32(lut, ((j < 4 ? cw[u].x : cw[u].y) >> (8 * (j & 3))) & 0xff,
                       lane) * mul;
        *reinterpret_cast<uint4*>(tA + swz(r, kBK * 2, kc * 16)) =
            make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                       pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
      }
    } else if constexpr (PREP) {
#pragma unroll 1
      for (int r0 = 0; r0 < BM; r0 += 64)
        bad |= es == 2 ? quantize_x<64, AMODE, 2, kThreads, true>(
                             nullptr, tA, tA + oAC, tA + oASQ, lut, p, m0,
                             k0, emit, tid, r0)
                       : quantize_x<64, AMODE, 4, kThreads, true>(
                             nullptr, tA, tA + oAC, tA + oASQ, lut, p, m0,
                             k0, emit, tid, r0);
    }
    return bad;
  };
  // PREP: per step (mod 3), -1 if the step's A is built locally, else the
  // producer's out-of-range bit (its tile arrives by cp.async)
  int a_st[3] = {-1, -1, -1};
  __shared__ int rdy[4];  // ready words read ahead by thread 0

  // ---- decode step i into its buffer: all of it (kAll), its A or B tile
  //      alone, or part `part` of kParts (so that the parts interleave
  //      with the previous step's mma.sync); true if a nonzero block
  //      leaves the tensor-core range ---------------------------------------
  constexpr int kParts = kBK / 16;
  constexpr int kAll = -1, kAOnly = -2, kBOnly = -3;
  auto decode = [&](int i, int part) -> bool {
    const uint8_t* st = stage(i);
    uint8_t* tA = buf(i);
    uint8_t* tB = tA + oBT;
    const uint8_t* sB = st + L::oB;
    const uint8_t* sBSc = st + L::oBSc;
    bool bad = false;
    if (part == kBOnly) {
    } else if constexpr (PREP) {
      if (part < 0 || part == 0) {
        const int a = a_st[(i - s0) % 3];
        bad |= a >= 0 ? a != 0 : local_a(i, tA, false);
      }
    } else if constexpr (AMODE == kAPacked) {
      // in batches of 4 chunks: all code loads, then all table loads, then
      // the arithmetic and stores, so the loads' latencies overlap
      const uint8_t* sASc = st + L::oASc;
      constexpr int UA = BM * 8 / kThreads;
      static_assert(UA % 4 == 0 || UA < 4, "whole A chunks per thread");
#pragma unroll
      for (int u0 = 0; u0 < UA; u0 += 4) {
        uint2 cw[4];
        int sc[4];
        float v[4][8];
#pragma unroll
        for (int b = 0; b < 4 && u0 + b < UA; ++b) {
          const int u = u0 + b;
          if (part >= 0 && u * kParts / UA != part) continue;
          const int c = tid + u * kThreads, r = c >> 3, kc = c & 7;
          cw[b] = *reinterpret_cast<const uint2*>(st + r * kBK + kc * 8);
          sc[b] = sASc[(r / ABM) * (kBK / ABK) + (kc * 8) / ABK];
        }
#pragma unroll
        for (int b = 0; b < 4 && u0 + b < UA; ++b) {
          if (part >= 0 && (u0 + b) * kParts / UA != part) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[b][j] = lut32(
                lut, ((j < 4 ? cw[b].x : cw[b].y) >> (8 * (j & 3))) & 0xff, lane);
        }
#pragma unroll
        for (int b = 0; b < 4 && u0 + b < UA; ++b) {
          const int u = u0 + b;
          if (part >= 0 && u * kParts / UA != part) continue;
          const int c = tid + u * kThreads, r = c >> 3, kc = c & 7;
          const float mul = scale_mult(sc[b]);
          bad |= !tc_scale_ok(sc[b]) && ((cw[b].x | cw[b].y) & 0x7f7f7f7fu) != 0;
          *reinterpret_cast<uint4*>(tA + swz(r, kBK * 2, kc * 16)) =
              make_uint4(pack_bf16x2(v[b][0] * mul, v[b][1] * mul),
                         pack_bf16x2(v[b][2] * mul, v[b][3] * mul),
                         pack_bf16x2(v[b][4] * mul, v[b][5] * mul),
                         pack_bf16x2(v[b][6] * mul, v[b][7] * mul));
        }
      }
    } else if constexpr (L::kQuant) {
      if (part < 0 || part == 0)
        bad |= es == 2 ? quantize_x<BM, AMODE, 2, kThreads>(
                             st, tA, tA + oAC, tA + oASQ, lut, p, m0,
                             i * kBK, emits, tid)
                       : quantize_x<BM, AMODE, 4, kThreads>(
                             st, tA, tA + oAC, tA + oASQ, lut, p, m0,
                             i * kBK, emits, tid);
    }
    // B: each thread keeps one 8-column chunk of every row it decodes; in
    // batches of 4 chunks, loads first, as for A
    const int nc = tid % (BN / 8);
    constexpr int UB = kBK * (BN / 8) / kThreads;
    static_assert(UB % 4 == 0 || UB < 4, "whole B chunks per thread");
#pragma unroll
    for (int u0 = 0; u0 < UB; u0 += 4) {
      uint2 cw[4];
      int sc[4];
      float v[4][8];
      auto skip = [&](int u) {
        return part == kAOnly || (part >= 0 && u * kParts / UB != part);
      };
#pragma unroll
      for (int b = 0; b < 4 && u0 + b < UB; ++b) {
        if (skip(u0 + b)) continue;
        const int kr = (tid + (u0 + b) * kThreads) / (BN / 8);
        cw[b] = *reinterpret_cast<const uint2*>(sB + kr * BN + nc * 8);
        if constexpr (WBN == 8) sc[b] = sBSc[(kr / WBM) * (BN / 8) + nc];
      }
#pragma unroll
      for (int b = 0; b < 4 && u0 + b < UB; ++b) {
        if (skip(u0 + b)) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[b][j] = lut32(
              lut, ((j < 4 ? cw[b].x : cw[b].y) >> (8 * (j & 3))) & 0xff, lane);
      }
#pragma unroll
      for (int b = 0; b < 4 && u0 + b < UB; ++b) {
        if (skip(u0 + b)) continue;
        const int kr = (tid + (u0 + b) * kThreads) / (BN / 8);
        if constexpr (WBN == 8) {
          const float mul = scale_mult(sc[b]);
          bad |= !tc_scale_ok(sc[b]) && ((cw[b].x | cw[b].y) & 0x7f7f7f7fu) != 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) v[b][j] *= mul;
        } else if constexpr (WBM >= kBK) {
          bad |= ((cw[b].x & cbad.x) | (cw[b].y & cbad.y)) != 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) v[b][j] *= cmul[j];
        } else {
          static_assert(WBN == 1, "weight blocks (8,8) or (K,1)");
          const uint2 sw = *reinterpret_cast<const uint2*>(
              sBSc + (kr / WBM) * BN + nc * 8);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int s = ((j < 4 ? sw.x : sw.y) >> (8 * (j & 3))) & 0xff;
            const uint32_t code =
                ((j < 4 ? cw[b].x : cw[b].y) >> (8 * (j & 3))) & 0x7f;
            bad |= !tc_scale_ok(s) && code != 0;
            v[b][j] *= scale_mult(s);
          }
        }
        if constexpr (AMODE == kARaw) {
          float4* d = reinterpret_cast<float4*>(tB + (kr * BN + nc * 8) * 4);
          d[0] = make_float4(v[b][0], v[b][1], v[b][2], v[b][3]);
          d[1] = make_float4(v[b][4], v[b][5], v[b][6], v[b][7]);
        } else {
          *reinterpret_cast<uint4*>(tB + b_off(kr, nc)) =
              make_uint4(pack_bf16x2(v[b][0], v[b][1]),
                         pack_bf16x2(v[b][2], v[b][3]),
                         pack_bf16x2(v[b][4], v[b][5]),
                         pack_bf16x2(v[b][6], v[b][7]));
        }
      }
    }
    if constexpr (WGMMA) fence_async_smem();
    return bad;
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int b = 0; b < NI; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  if constexpr (PREP) {
    if (producer) {  // publish prep_steps steps of row tile mtile
      const int sa = pblk / cps * p.per + pblk % cps * p.prep_steps;
      const int sb = min(min(steps, (pblk / cps + 1) * p.per),
                         sa + p.prep_steps);
      uint8_t* tA = smem + L::oBufs;
      __syncthreads();  // the table
      for (int i = sa; i < sb; ++i) {
        const bool bad = __syncthreads_or(local_a(i, tA, emits));
        uint4* dst = reinterpret_cast<uint4*>(
            p.prep + (static_cast<size_t>(mtile) * steps + i) * (BM * kBK * 2));
        for (int c = tid; c < BM * kBK * 2 / 16; c += kThreads)
          dst[c] = reinterpret_cast<const uint4*>(tA)[c];
        __syncthreads();
        if (tid == 0) {
          __threadfence();
          st_release(p.ready + static_cast<size_t>(mtile) * steps + i,
                     2 * p.epoch + bad);
        }
      }
      return;
    }
  }
  // PREP: step j's A tile, if a producer has published it (thread 0 read the
  // ready word into rdy earlier; every thread sees the same value)
  auto issue_a = [&](int j) -> int {
    const int v = rdy[j & 3];
    if ((v >> 1) != p.epoch) return -1;
    const uint8_t* src =
        p.prep + (static_cast<size_t>(mtile) * steps + j) * (BM * kBK * 2);
    const uint32_t dst = smem_u32(buf(j));
    for (int c = tid; c < BM * kBK * 2 / 16; c += kThreads)
      cp_async(dst + c * 16, src + c * 16, 16, 16);
    return v & 1;
  };
  auto read_ready = [&](int j) {
    if (tid == 0 && j < s1)
      rdy[j & 3] = ld_acquire(p.ready + static_cast<size_t>(mtile) * steps + j);
  };
  if constexpr (PREP) {  // groups: A(s0), the stages, then A(s0 + 1)
    read_ready(s0);
    read_ready(s0 + 1);
    read_ready(s0 + 2);
    __syncthreads();
    if (s0 < s1) a_st[0] = issue_a(s0);
    cp_commit();
  }

  // prologue: steps s0 .. s0+2 in flight (one group each), s0 decoded
  for (int i = s0; i < s0 + kStages; ++i) {
    if (i < s1) {
      issue(i);
      for (int j = tid; j < kScTotal; j += kThreads)
        store_scale(i, j, scale_at(i, j));
    }
    cp_commit();
  }
  if constexpr (PREP) {
    if (s0 + 1 < s1) a_st[1] = issue_a(s0 + 1);
    cp_commit();
    cp_wait<kStages>();
  } else {
    cp_wait<kStages - 1>();
  }
  __syncthreads();
  if (s0 < s1) colscales(s0);
  bool bad = s0 < s1 ? decode(s0, kAll) : false;
  uint32_t spend[kScPer];

  for (int i = s0; i < s1; ++i) {
    if constexpr (PREP) cp_wait<kStages - 1>();
    else cp_wait<kStages - 2>();
    const bool f32_path = __syncthreads_or(bad);
    if constexpr (PREP) {  // step i + 2's A tile, if published (own group)
      read_ready(i + 3);
      a_st[(i + 2 - s0) % 3] = i + 2 < s1 ? issue_a(i + 2) : -1;
      cp_commit();
    }
    // scales: step i + 3's read during this step, step i + 2's (read one
    // step ago) stored at its end, so no load latency is waited for (the
    // wgmma path reads them after its MMAs are issued: wgmma.fence waits
    // for pending register loads)
    uint32_t snew[kScPer];
    auto load_scales = [&] {
#pragma unroll
      for (int u = 0; u < kScPer; ++u) {
        const int j = tid + u * kThreads;
        snew[u] = (i + kStages < s1 && j < kScTotal)
                      ? scale_at(i + kStages, j) : 0u;
      }
    };
    if (!WGMMA || f32_path) load_scales();
    const bool next = i + 1 < s1;
    if (next) colscales(i + 1);
    bool nbad = false;

    // ---- this step's products, into a zeroed fragment (step i + 1's
    //      decode interleaved with them) ------------------------------------
    const uint8_t* st = stage(i);
    const uint8_t* tA = buf(i);
    const uint8_t* tB = tA + oBT;
    float fr[MI][NI][4];  // zeroed below, or overwritten by wgmma
    if (!WGMMA || f32_path) {
#pragma unroll
      for (int a = 0; a < MI; ++a)
#pragma unroll
        for (int b = 0; b < NI; ++b)
#pragma unroll
          for (int c = 0; c < 4; ++c) fr[a][b][c] = 0.f;
    }

    if constexpr (AMODE == kARaw) {
      if (next) nbad = decode(i + 1, kAll);
      // raw f32 x: FMAs, x from the swizzled stage (every row of this
      // thread has row & 7 == g, so 4 k's are one float4), w from the f32
      // tile
      const float* wf = reinterpret_cast<const float*>(tB);
      const uint8_t* xr = st + (wm0 + g) * kBK * 4;
#pragma unroll 2
      for (int k4 = 0; k4 < kBK / 4; ++k4) {
        float4 xv[MI][2];
#pragma unroll
        for (int a = 0; a < MI; ++a)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xv[a][h] = *reinterpret_cast<const float4*>(
                xr + (a * 16 + 8 * h) * kBK * 4 + ((k4 ^ g) << 4));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[NI][2];
#pragma unroll
          for (int b = 0; b < NI; ++b) {
            const float2 w2 = *reinterpret_cast<const float2*>(
                wf + (4 * k4 + kk) * BN + wn0 + b * 8 + 2 * t);
            bv[b][0] = w2.x;
            bv[b][1] = w2.y;
          }
#pragma unroll
          for (int a = 0; a < MI; ++a)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 q = xv[a][h];
              const float av = kk == 0 ? q.x : kk == 1 ? q.y : kk == 2 ? q.z : q.w;
#pragma unroll
              for (int b = 0; b < NI; ++b)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                  fr[a][b][2 * h + j] = fmaf(av, bv[b][j], fr[a][b][2 * h + j]);
            }
        }
      }
    } else if (WGMMA && !f32_path) {
      if constexpr (WGMMA) {
      // step i on the tensor cores, asynchronously, while this warpgroup
      // decodes step i + 1: the converter (register-heavy) before the MMAs
      // are in flight, the weight decode while they run
      if (next) nbad = decode(i + 1, kAOnly);
      constexpr int ND = WTN / 2;  // accumulator registers per thread
      float(&d)[ND] = reinterpret_cast<float(&)[ND]>(fr);
      const uint32_t sa = smem_u32(tA) + (wm0 - 16 * (warp & 3)) * 128;
      const uint32_t sb = smem_u32(tB) + (wn0 / 64) * (kBK * 128);
#pragma unroll
      for (int r = 0; r < ND; ++r) fence_reg(d[r]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = gmma_desc(sa + kk * 32, 16, 1024);
        const uint64_t db = gmma_desc(sb + kk * 16 * 128, kBK * 128, 1024);
        wgmma_128(d, da, db, kk > 0);
      }
      wgmma_commit();
      load_scales();
      if (next) nbad |= decode(i + 1, kBOnly);
      wgmma_wait0();
#pragma unroll
      for (int r = 0; r < ND; ++r) fence_reg(d[r]);
      }
    } else if (!f32_path) {
      const uint32_t sa = smem_u32(tA), sb = smem_u32(tB);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if (next) nbad |= decode(i + 1, kk);
        uint32_t af[MI][4], bf[NI][2];
#pragma unroll
        for (int a = 0; a < MI; ++a) {
          const int r = wm0 + a * 16 + (lane & 15);
          ldsm_x4(af[a], sa + swz(r, kBK * 2, (kk * 2 + (lane >> 4)) * 16));
        }
#pragma unroll
        for (int b = 0; b < NI / 2; ++b) {
          const int kr = kk * 16 + (lane & 15);
          const int c16 = (wn0 >> 3) + b * 2 + (lane >> 4);
          uint32_t r4[4];
          ldsm_x4_t(r4, sb + b_off(kr, c16));
          bf[2 * b][0] = r4[0];
          bf[2 * b][1] = r4[1];
          bf[2 * b + 1][0] = r4[2];
          bf[2 * b + 1][1] = r4[3];
        }
#pragma unroll
        for (int a = 0; a < MI; ++a)
#pragma unroll
          for (int b = 0; b < NI; ++b)
            mma_bf16(fr[a][b], af[a], bf[b][0], bf[b][1]);
      }
    } else {
      // f32 path: values decoded from the codes, f32 FMAs in k order
      const uint8_t* ac = AMODE == kAPacked ? st : tA + oAC;
      const uint8_t* asc = AMODE == kAPacked ? st + L::oASc : tA + oASQ;
      // PREP: A's codes from global memory unless this block built them
      const bool aglob = PREP && (AMODE == kAPacked || a_st[(i - s0) % 3] >= 0);
      auto a_val = [&](int r, int k) -> float {
        if (aglob) {
          const int m = m0 + r, kk = i * kBK + k;
          if (m >= p.arows || kk >= p.ald) return 0.f;
          return lut32(lut, p.acodes[static_cast<size_t>(m) * p.ald + kk], lane) *
                 scale_mult(p.ascales[static_cast<size_t>(m / ABM) * (p.ald / ABK) +
                                      kk / ABK]);
        }
        return lut32(lut, ac[r * kBK + k], lane) *
               scale_mult(asc[(r / ABM) * (kBK / ABK) + k / ABK]);
      };
      const uint8_t* sB = st + L::oB;
      const uint8_t* sBSc = st + L::oBSc;
      if (next) nbad = decode(i + 1, kAll);
      if (tid == 0) atomicAdd(p.f32_steps, 1);
#pragma unroll 1
      for (int k = 0; k < kBK; ++k) {
        float av[MI][2], bv[NI][2];
#pragma unroll
        for (int a = 0; a < MI; ++a)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm0 + a * 16 + g + 8 * h;
            av[a][h] = a_val(r, k);
          }
#pragma unroll
        for (int b = 0; b < NI; ++b)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = wn0 + b * 8 + 2 * t + h;
            bv[b][h] = lut32(lut, sB[k * BN + n], lane) *
                       scale_mult(sBSc[(k / WBM) * (BN / WBN) + n / WBN]);
          }
#pragma unroll
        for (int a = 0; a < MI; ++a)
#pragma unroll
          for (int b = 0; b < NI; ++b)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              fr[a][b][c] = fmaf(av[a][c >> 1], bv[b][c & 1], fr[a][b][c]);
      }
    }
#pragma unroll
    for (int a = 0; a < MI; ++a)
#pragma unroll
      for (int b = 0; b < NI; ++b)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][b][c] += fr[a][b][c];

    bad = nbad;

    // refill this step's stage with step i + kStages
    if (AMODE == kARaw || f32_path) __syncthreads();
    if (i + kStages < s1) issue(i + kStages);
    cp_commit();
    if (i > s0 && i + kStages - 1 < s1) {
#pragma unroll
      for (int u = 0; u < kScPer; ++u) {
        const int j = tid + u * kThreads;
        if (j < kScTotal) store_scale(i + kStages - 1, j, spend[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kScPer; ++u) spend[u] = snew[u];
  }
  cp_wait<0>();

  // ---- epilogue: y, or this split's partial and the ordered reduction ----
  const bool split = p.splits > 1;
  float* dst = split ? p.work + static_cast<size_t>(blockIdx.z) * p.M * p.N
                     : p.y;
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm0 + a * 16 + g + 8 * h;
      if (r >= p.M) continue;
#pragma unroll
      for (int b = 0; b < NI; ++b) {
        const int n = n0 + wn0 + b * 8 + 2 * t;
        float* row = dst + static_cast<size_t>(r) * p.N;
        if (n + 1 < p.N) {
          *reinterpret_cast<float2*>(row + n) =
              make_float2(acc[a][b][2 * h], acc[a][b][2 * h + 1]);
        } else if (n < p.N) {
          row[n] = acc[a][b][2 * h];
        }
      }
    }
  if (!split) return;
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* cnt = p.counters + mtile * ((p.N + BN - 1) / BN) + ntile;
  if (tid == 0) last = atomicAdd(cnt, 1) == p.splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int rows = min(BM, p.M - m0), cols = min(BN, p.N - n0);
  const size_t plane = static_cast<size_t>(p.M) * p.N;
  for (int e = tid; e < rows * cols; e += kThreads) {
    const size_t o = static_cast<size_t>(m0 + e / cols) * p.N + n0 + e % cols;
    float v = __ldcg(p.work + o);
    for (int s = 1; s < p.splits; ++s) v += __ldcg(p.work + s * plane + o);
    p.y[o] = v;
  }
  if (tid == 0) *cnt = 0;
}

// One launch of an instance, after raising its dynamic shared memory limit.
template <int BM, int BN, int WM, int WN, int AMODE, int ABM, int ABK,
          int WBM, int WBN, bool WGMMA, bool PREP = false>
cudaError_t launch_gemm(const Params& p, cudaStream_t stream) {
  constexpr int bytes =
      Layout<BM, BN, AMODE, ABM, ABK, WBM, WBN, PREP>::kBytes;
  auto kern = mxsf_gemm<BM, BN, WM, WN, AMODE, ABM, ABK, WBM, WBN, WGMMA, PREP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const int nt = (p.N + BN - 1) / BN, mt = (p.M + BM - 1) / BM;
  const int steps = (p.Kp + kBK - 1) / kBK;
  const dim3 grid =
      PREP ? dim3(mt * p.splits * ((p.per + p.prep_steps - 1) / p.prep_steps) +
                      mt * nt,
                  1, p.splits)
           : dim3(nt, mt, p.splits);
  kern<<<grid, WM * WN * 32, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace mxmma
