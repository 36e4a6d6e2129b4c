// Weight streaming on mma.sync: the helpers shared by the decode kernels (m
// <= 32 token rows) of the quantized projections and FFNs -- K5
// (int4_matmul.cu), K7 (int4_ffn.cu), K4 (int8_matmul.cu) and K6
// (int8_ffn.cu).
//
// In all of them the weights are the mma A operand (16 output columns x k)
// and the tokens the 8-wide N side, so m = 4 pads to 8, not 16.  A warp
// owns 32 output columns; lane (g, t) = (lane / 4, lane % 4) reads 4-byte
// words of weight rows at its columns 4g .. 4g + 3, and the A rows of its
// two 16-column tiles i are those columns: row g of tile i is column
// 4g + 2i, row g + 8 column 4g + 2i + 1.  No dequantized tile ever sits in
// shared memory: a lane builds its A registers from the raw words.
//
//   int4 (ctpa's packed layout, prefill_wgmma.cuh): a byte holds rows j and
//   j + G/2 of one column, so
//     w4:   m16n8k16 bf16 takes that pair as the two k of one bf16
//           register, and x is read in the same order (a permutation of k
//           inside a group leaves every group dot the same; it changes only
//           w4's fp32 sum order).  Each nibble becomes q exactly as (2^23 +
//           q + 8) - (2^23 + 8), is multiplied by its column's scale in fp32
//           and rounded to bf16, as ctpa rounds its dequantized tile.
//     w4a8: m16n8k32 s8.  Four int8 k of a register are (j, j + 1, j + G/2,
//           j + 1 + G/2) of one column, built from two packed rows by byte
//           permutes with each nibble as 16 q in its byte's high half; the
//           int32 group dot (16 times the exact one) times a sixteenth of
//           the group's scale is the exact dot times the scale, rounded once.
//   int8 (ctpa's quantize_int8 layout, (k, n) bytes):
//     w8:   m16n8k16 bf16 in natural k order: k pairs (2t, 2t + 1) and
//           (2t + 8, 2t + 9) of each 16 are rows r0, r0 + 1 and r0 + 8,
//           r0 + 9, each int8 converted to bf16 exactly by a byte permute
//           under 2^23; x's B registers are the same bf16 pairs of x.
//     w8a8: m16n8k32 s8; the k slots 4t .. 4t + 3 of each 16 are rows r0,
//           r0 + 1, r0 + 8, r0 + 9 (a 4 x 4 byte transpose), and x8's B
//           registers take the same four k; a permutation inside a k-step
//           leaves its exact int32 dot unchanged.
//
// The weights, their scales and the tokens' rows arrive in shared memory by
// 16-byte cp.async into a ring of stages (stage_weights, stage_tokens), so
// several stages are in flight while one is multiplied.  Where a
// contraction is split across blocks, the splits of one output strip run as
// one thread-block cluster (launch_clusters; active_clusters asks how many
// fit the card at once): each block keeps its split's sums in its shared
// memory and a finishing block adds them in split order through distributed
// shared memory (split_sum), so no partial leaves the chip and every call
// gives the same bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "warp_mma.cuh"

namespace wstream {
namespace {  // each kernel source gets its own copy

namespace cg = cooperative_groups;

// the most splits of a contraction: a cluster's portable size
constexpr int kMaxSplits = 8;

__device__ __forceinline__ uint32_t ld_u32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_u16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// ------------------------------------------------------------------ int4

// The bf16 A register of packed byte `byte` of a word: lo and hi hold the
// word's low and high nibbles, each as q + 8 in its own byte (nibbles(),
// below); a byte permute puts one under the exponent of 2^23, so the float
// 2^23 + (q + 8) minus 2^23 + 8 is q exactly.  (q_lo * s, q_hi * s), each
// product in fp32 rounded to bf16, as ctpa rounds its dequantized tile.
__device__ __forceinline__ uint32_t dequant_pair(uint32_t lo, uint32_t hi, int byte, float s) {
  const uint32_t sel = 0x7650u | static_cast<uint32_t>(byte);   // (byte, 0, 0, 0x4B)
  const float ql = __uint_as_float(__byte_perm(lo, 0x4B000000u, sel)) - 8388616.f;
  const float qh = __uint_as_float(__byte_perm(hi, 0x4B000000u, sel)) - 8388616.f;
  return warp_mma::pack_bf16(__fmul_rn(ql, s), __fmul_rn(qh, s));
}

// a packed word's low and high nibbles as q + 8, one to a byte
__device__ __forceinline__ void nibbles(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x88888888u;
  lo = u & 0x0F0F0F0Fu;
  hi = (u >> 4) & 0x0F0F0F0Fu;
}

// The s8 A registers of the four columns of two packed rows' words w0
// (row 2p) and w1 (row 2p + 1): col[c] = (lo of w0, lo of w1, hi of w0, hi
// of w1) of byte c, each nibble as 16 q in the byte's high half (so the
// product is 16 times the dot, exactly).
__device__ __forceinline__ void int8_columns(uint32_t (&col)[4], uint32_t w0, uint32_t w1) {
  const uint32_t l0 = (w0 << 4) & 0xF0F0F0F0u, h0 = w0 & 0xF0F0F0F0u;
  const uint32_t l1 = (w1 << 4) & 0xF0F0F0F0u, h1 = w1 & 0xF0F0F0F0u;
  const uint32_t x01 = __byte_perm(l0, h0, 0x5140), y01 = __byte_perm(l1, h1, 0x5140);
  const uint32_t x23 = __byte_perm(l0, h0, 0x7362), y23 = __byte_perm(l1, h1, 0x7362);
  col[0] = __byte_perm(x01, y01, 0x5140);
  col[1] = __byte_perm(x01, y01, 0x7362);
  col[2] = __byte_perm(x23, y23, 0x5140);
  col[3] = __byte_perm(x23, y23, 0x7362);
}

// an int32 of magnitude below 2^22 as fp32, exactly, without the slow
// conversion unit: 1.5 * 2^23 + v is exact in fp32
__device__ __forceinline__ float exact_float(int v) {
  return __int_as_float(v + 0x4B400000) - 12582912.f;
}

// The w4 products of one int4 scale group of G rows: its G/2 packed rows
// (k j and j + G/2 in a byte) at a row stride kLdW (wl: this lane's 4
// columns of the first one), sc the 4 columns' scales, xs token g's staged
// row of the group's G values (kLdX bytes a token row).  With KH = 2 it
// takes the k-steps kh, kh + 2, ... (two sets of warps share a group);
// acc[i][nt]: tile i, tokens 8 nt + 2t, + 1.
template <int G, int NT, int KH, int kLdW, int kLdX>
__device__ __forceinline__ void int4_w4_products(float (&acc)[2][NT][4], const unsigned char* wl,
                                                 const float (&sc)[4], const unsigned char* xs,
                                                 int t, int kh) {
#pragma unroll
  for (int s2 = 0; s2 < G / 16 / KH; ++s2) {
    const int s = s2 * KH + kh;
    const int r0 = 8 * s + t;   // packed rows r0 and r0 + 4: k pairs t and t + 4
    uint32_t l0, h0, l1, h1;
    nibbles(ld_u32(wl + r0 * kLdW), l0, h0);
    nibbles(ld_u32(wl + (r0 + 4) * kLdW), l1, h1);
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i][0] = dequant_pair(l0, h0, 2 * i, sc[2 * i]);
      a[i][1] = dequant_pair(l0, h0, 2 * i + 1, sc[2 * i + 1]);
      a[i][2] = dequant_pair(l1, h1, 2 * i, sc[2 * i]);
      a[i][3] = dequant_pair(l1, h1, 2 * i + 1, sc[2 * i + 1]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const unsigned char* xr = xs + 8 * j * kLdX;
      const uint32_t b0 = ld_u16(xr + 2 * r0) | ld_u16(xr + 2 * (r0 + G / 2)) << 16;
      const uint32_t b1 = ld_u16(xr + 2 * (r0 + 4)) | ld_u16(xr + 2 * (r0 + 4 + G / 2)) << 16;
      warp_mma::mma_bf16_16816(acc[0][j], a[0], b0, b1);
      warp_mma::mma_bf16_16816(acc[1][j], a[1], b0, b1);
    }
  }
}

// The w4a8 int32 dot of one int4 scale group (as int4_w4_products), 16
// times the exact one, added to ci; int4_a8_flush then scales it: a
// group's dot is exact before it is scaled.
template <int G, int NT, int kLdW, int kLdX>
__device__ __forceinline__ void int4_a8_dot(int (&ci)[2][NT][4], const unsigned char* wl,
                                            const unsigned char* xs, int t) {
#pragma unroll
  for (int s = 0; s < G / 32; ++s) {
    const int r0 = 16 * s + 2 * t;   // packed rows r0, r0 + 1 and r0 + 8, r0 + 9
    uint32_t lo[4], hi[4];
    int8_columns(lo, ld_u32(wl + r0 * kLdW), ld_u32(wl + (r0 + 1) * kLdW));
    int8_columns(hi, ld_u32(wl + (r0 + 8) * kLdW), ld_u32(wl + (r0 + 9) * kLdW));
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const unsigned char* xr = xs + 8 * j * kLdX;
      const uint32_t b0 = ld_u16(xr + r0) | ld_u16(xr + r0 + G / 2) << 16;
      const uint32_t b1 = ld_u16(xr + r0 + 8) | ld_u16(xr + r0 + 8 + G / 2) << 16;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint32_t a[4] = {lo[2 * i], lo[2 * i + 1], hi[2 * i], hi[2 * i + 1]};
        warp_mma::mma_s8_16832(ci[i][j], a, b0, b1);
      }
    }
  }
}

// A group's exact dot (ci, 16 times it) times its scale, and with kRowScale
// times rs[2 nt + e % 2] (the token's scale), each product rounded, added
// to the fp32 sums.  16 times the dot times a sixteenth of the scale is the
// same real number, rounded once.
template <int NT, bool kRowScale = false>
__device__ __forceinline__ void int4_a8_flush(float (&acc)[2][NT][4], const int (&ci)[2][NT][4],
                                              const float (&sc)[4], const float* rs = nullptr) {
  const float sc16[4] = {sc[0] * 0.0625f, sc[1] * 0.0625f, sc[2] * 0.0625f, sc[3] * 0.0625f};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = __fmul_rn(exact_float(ci[i][j][e]), sc16[2 * i + (e >> 1)]);
        if constexpr (kRowScale) v = __fmul_rn(v, rs[2 * j + (e & 1)]);
        acc[i][j][e] = __fadd_rn(acc[i][j][e], v);
      }
}

// The products of one int4 scale group of G rows (a ring stage of K5 or of
// K7's gate/up): w4 as int4_w4_products; w4a8 its exact dot times its
// scale, added to acc.
template <int G, int NT, bool A8, int KH, int kLdW, int kLdX>
__device__ __forceinline__ void int4_group_products(float (&acc)[2][NT][4],
                                                    const unsigned char* wl, const float (&sc)[4],
                                                    const unsigned char* xs, int t, int kh) {
  static_assert(KH == 1 || (KH == 2 && !A8), "w4 alone splits a group's k-steps");
  if constexpr (!A8) {
    int4_w4_products<G, NT, KH, kLdW, kLdX>(acc, wl, sc, xs, t, kh);
  } else {
    int ci[2][NT][4] = {};
    int4_a8_dot<G, NT, kLdW, kLdX>(ci, wl, xs, t);
    int4_a8_flush<NT>(acc, ci, sc);
  }
}

// ------------------------------------------------------------------ int8

// The bf16 pair (byte c of u0, byte c of u1) of two words whose bytes hold
// int8 q as q + 128 (w ^ 0x80808080): a byte under the exponent of 2^23 is
// the float 2^23 + q + 128, minus 2^23 + 128 it is q exactly, and the high
// half of that float is q's exact bf16.
__device__ __forceinline__ uint32_t s8_pair_bf16(uint32_t u0, uint32_t u1, int c) {
  const uint32_t sel = 0x7650u | static_cast<uint32_t>(c);
  const float f0 = __uint_as_float(__byte_perm(u0, 0x4B000000u, sel)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u1, 0x4B000000u, sel)) - 8388736.f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
}

// Words r0..r3 of four weight rows, 4 columns each, as 4 column words:
// col[c] = (byte c of r0, r1, r2, r3), the first row in the low byte.
__device__ __forceinline__ void columns4(uint32_t (&col)[4], uint32_t r0, uint32_t r1,
                                         uint32_t r2, uint32_t r3) {
  const uint32_t x01 = __byte_perm(r0, r1, 0x5140), x23 = __byte_perm(r0, r1, 0x7362);
  const uint32_t y01 = __byte_perm(r2, r3, 0x5140), y23 = __byte_perm(r2, r3, 0x7362);
  col[0] = __byte_perm(x01, y01, 0x5410);
  col[1] = __byte_perm(x01, y01, 0x7632);
  col[2] = __byte_perm(x23, y23, 0x5410);
  col[3] = __byte_perm(x23, y23, 0x7632);
}

// The products of KC int8 contraction rows of a ring stage: kMats weight
// windows mat_stride bytes apart (wl points at this lane's 4 columns of the
// first row, ld_w bytes a row); xs at token g's staged row, ld_x bytes a
// token row.  acc[mat][i][nt]: tile i, tokens 8 nt + 2t, + 1 (C's layout);
// fp32 for w8, exact int32 for w8a8.
template <int NT, bool A8, int kMats, int KC, typename Acc>
__device__ __forceinline__ void int8_stage_products(Acc (&acc)[kMats][2][NT][4],
                                                    const unsigned char* wl, int mat_stride,
                                                    int ld_w, const unsigned char* xs, int ld_x,
                                                    int t) {
  if constexpr (!A8) {
#pragma unroll
    for (int k0 = 0; k0 < KC; k0 += 16) {
      const int r0 = k0 + 2 * t;
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b[nt][0] = ld_u32(xs + 8 * nt * ld_x + 2 * r0);
        b[nt][1] = ld_u32(xs + 8 * nt * ld_x + 2 * (r0 + 8));
      }
#pragma unroll
      for (int mat = 0; mat < kMats; ++mat) {
        const unsigned char* w = wl + mat * mat_stride;
        const uint32_t u0 = ld_u32(w + r0 * ld_w) ^ 0x80808080u;
        const uint32_t u1 = ld_u32(w + (r0 + 1) * ld_w) ^ 0x80808080u;
        const uint32_t u2 = ld_u32(w + (r0 + 8) * ld_w) ^ 0x80808080u;
        const uint32_t u3 = ld_u32(w + (r0 + 9) * ld_w) ^ 0x80808080u;
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a[i][0] = s8_pair_bf16(u0, u1, 2 * i);
          a[i][1] = s8_pair_bf16(u0, u1, 2 * i + 1);
          a[i][2] = s8_pair_bf16(u2, u3, 2 * i);
          a[i][3] = s8_pair_bf16(u2, u3, 2 * i + 1);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            warp_mma::mma_bf16_16816(acc[mat][i][nt], a[i], b[nt][0], b[nt][1]);
      }
    }
  } else {
#pragma unroll
    for (int k0 = 0; k0 < KC; k0 += 32) {
      const int r0 = k0 + 2 * t;
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const unsigned char* xr = xs + 8 * nt * ld_x;
        b[nt][0] = ld_u16(xr + r0) | ld_u16(xr + r0 + 8) << 16;
        b[nt][1] = ld_u16(xr + r0 + 16) | ld_u16(xr + r0 + 24) << 16;
      }
#pragma unroll
      for (int mat = 0; mat < kMats; ++mat) {
        const unsigned char* w = wl + mat * mat_stride;
        uint32_t lo[4], hi[4];
        columns4(lo, ld_u32(w + r0 * ld_w), ld_u32(w + (r0 + 1) * ld_w),
                 ld_u32(w + (r0 + 8) * ld_w), ld_u32(w + (r0 + 9) * ld_w));
        columns4(hi, ld_u32(w + (r0 + 16) * ld_w), ld_u32(w + (r0 + 17) * ld_w),
                 ld_u32(w + (r0 + 24) * ld_w), ld_u32(w + (r0 + 25) * ld_w));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint32_t a[4] = {lo[2 * i], lo[2 * i + 1], hi[2 * i], hi[2 * i + 1]};
            warp_mma::mma_s8_16832(acc[mat][i][nt], a, b[nt][0], b[nt][1]);
          }
      }
    }
  }
}

// One ring stage of int8 weights: kMats windows of KC rows of kWidth bytes
// (at a row stride kLdW), then NT * 8 token rows (rows >= m zero) over the
// same KC contraction columns, at a row stride kLdX; kStages stages.  The
// strides spread a warp's reads over the 32 banks: a k-step reads rows 2t
// apart (t = lane % 4), 32 bytes each, and token rows 8 apart.
template <int NT, bool A8, int kMats, int kWidth, int KC, int kStages>
struct Int8Stage {
  static constexpr int kXB = A8 ? 1 : 2;
  static constexpr int kLdW = kWidth + 16;
  static constexpr int kLdX = KC * kXB + 16;
  static constexpr int kW = KC * kLdW;
  static constexpr int kStage = kMats * kW + NT * 8 * kLdX;
  static constexpr int kBytes = kStages * kStage;
  static_assert(kW % 16 == 0 && kStage % 16 == 0, "16-byte aligned copies");
};

// Copies KC rows of a weight window (columns [col0, col0 + kWidth) of a
// (rows, ncols) int8 matrix, starting at row k0) into a stage, rows >=
// rows or columns >= ncols zero; `vec` (ncols % 16 == 0, 16-byte aligned
// base) by 16-byte cp.async, else one byte a copy.
template <int kWidth, int kLdW, int kThreads, int KC>
__device__ __forceinline__ void stage_weights(unsigned char* dst, const int8_t* w, int k0,
                                              int rows, int col0, int ncols, bool vec) {
  const int8_t* src = w + static_cast<long long>(min(k0, rows - 1)) * ncols + col0;
  const int live = rows - k0;
  if (vec) {
    for (int e = threadIdx.x; e < KC * (kWidth / 16); e += kThreads) {
      const int r = e / (kWidth / 16);
      const int c = (e - r * (kWidth / 16)) * 16;
      const bool ok = r < live && col0 + c < ncols;
      warp_mma::cp_async16(dst + r * kLdW + c, ok ? src + static_cast<long long>(r) * ncols + c
                                                  : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < KC * kWidth; e += kThreads) {
      const int r = e / kWidth;
      const int c = e - r * kWidth;
      dst[r * kLdW + c] = r < live && col0 + c < ncols
          ? static_cast<unsigned char>(src[static_cast<long long>(r) * ncols + c]) : 0;
    }
  }
}

// NT * 8 token rows of a (m, ld) matrix of kXB-byte values, columns [k0,
// k0 + KC), into a stage (rows >= m and columns >= ld zero): with `vec`
// (ld * kXB % 16 == 0, a 16-byte aligned base) by 16-byte cp.async, else
// one value a copy.
template <int NT, int kXB, int kLdX, int kThreads, int KC>
__device__ __forceinline__ void stage_tokens(unsigned char* dst, const void* x, int m, int ld,
                                             int k0, bool vec = true) {
  const unsigned char* src =
      static_cast<const unsigned char*>(x) + static_cast<long long>(k0) * kXB;
  if (vec) {
    constexpr int kChunks = KC * kXB / 16;
    for (int e = threadIdx.x; e < NT * 8 * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * 16;
      const bool ok = r < m && k0 + c / kXB < ld;
      warp_mma::cp_async16(dst + r * kLdX + c,
                           ok ? src + static_cast<long long>(r) * ld * kXB + c : src, ok ? 16 : 0);
    }
  } else {
    using V = typename std::conditional<kXB == 2, uint16_t, uint8_t>::type;
    const V* sv = reinterpret_cast<const V*>(src);
    for (int e = threadIdx.x; e < NT * 8 * KC; e += kThreads) {
      const int r = e / KC;
      const int c = e - r * KC;
      reinterpret_cast<V*>(dst + r * kLdX)[c] =
          r < m && k0 + c < ld ? sv[static_cast<long long>(r) * ld + c] : V(0);
    }
  }
}

// ------------------------------------------------------------------ clusters

// A launch in clusters of (1, grid.y, 1): the splits of one output strip
// share a cluster.
template <typename K, typename... Args>
cudaError_t launch_clusters(K kernel, dim3 grid, int threads, int smem, cudaStream_t st,
                            const Args&... args) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = grid.y;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// How many clusters of (1, splits, 1) blocks of a kernel the card runs at
// once (its occupancy for the kernel's registers, threads and shared
// memory, and how the blocks of a cluster fit its GPCs), or -1 on a CUDA
// error.
template <typename K>
int active_clusters(K kernel, int threads, int smem, int splits) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = splits;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, splits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return clusters;
}

// Element idx of `part` (in each block's shared memory) summed over the
// cluster's first `splits` blocks in rank order, read through distributed
// shared memory: every value is loaded first, then added in order.
template <typename T>
__device__ __forceinline__ T split_sum(const cg::cluster_group& cluster, T* part, int idx,
                                       int splits) {
  T p[kMaxSplits];
#pragma unroll
  for (int z = 0; z < kMaxSplits; ++z)
    if (z < splits) p[z] = cluster.map_shared_rank(part, z)[idx];
  T sum = 0;
#pragma unroll
  for (int z = 0; z < kMaxSplits; ++z)
    if (z < splits) sum += p[z];
  return sum;
}

}  // namespace
}  // namespace wstream
