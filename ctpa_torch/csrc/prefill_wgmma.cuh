// The prefill kernels (m > 32 token rows) of the quantized projections, K4
// (int8_matmul.cu: w8, w8a8) and K5 (int4_matmul.cu: w4, w4a8), and of the
// fused quantized SwiGLU FFNs, K6 (int8_ffn.cu: w8, w8a8) and K7
// (int4_ffn.cu: w4, w4a8): Hopper kernels that feed warpgroup MMA (wgmma)
// from a ring of shared-memory stages filled by the Tensor Memory
// Accelerator (TMA).  The PTX they use is hopper_ptx.cuh's.
//
// What they compute is ctpa's (ctpa/ops/quant.py `_q_kernel`,
// `_q_kernel_a8`, `_q4_kernel`, `_q4_kernel_a8`, `_ffn_kernel`,
// `_ffn_kernel_a8`, `_ffn_kernel_q4`, `_ffn_kernel_q4_a8`; the headers of the
// four .cu files spell it out).  ctpa keeps the FFN's h = silu(x Wg) (x Wu)
// in VMEM because its j grid axis runs in order; on the card that axis
// would leave an fp32 partial of (n_j, m, hidden) per call.  Here h goes to
// device memory once in the layout the decode kernels give it, (m, n_j bj)
// bf16, or int8 per row per j-block with its row scales sh (m, n_j): 45 MB
// or 22.5 MB at Meditron-7B and m = 2,048, about 27 us of traffic beside a
// 0.28-0.56 ms bound.
//
//   proj_kernel: grid (token tiles x 256-column strips of the output,
//     splits), in clusters of the splits.  A block owns 256 output columns
//     and BN tokens (ProjForm: 128 for w8, w8a8 and w4, 64 for w4a8) over
//     its split of the contraction: w8 and w4 sum in fp32, w8a8 one exact
//     int32 dot, w4a8 each scale group's exact dot times its scale row in
//     group order; then w8 times scale[column], w8a8 (float(dot) * sx[token])
//     * scale[column], w4a8 times sx[token].  Where the token tiles and
//     strips alone are fewer than the card runs at once (m 33-128), the
//     contraction is split across the blocks of a thread-block cluster
//     (ops/quant.py asks the card's cluster occupancy): each block leaves
//     its split's sums in its shared memory and block z finishes token rows
//     z, z + splits, ... of the tile, adding the splits in split order
//     through distributed shared memory.  One launch, no reduction kernel,
//     no atomics, the same bits on every call.
//   gateup_kernel: grid (token tiles, j-blocks).  A block owns one j-block
//     (its window of 256 columns of both gate and up; a j-block is 256
//     columns, or one narrower j-block when inter <= 256) and BN tokens,
//     over the whole hidden axis; its epilogue applies the form's scales,
//     h = silu(g) u, and for a8 requantizes each token's row over exactly
//     the j-block's columns (the two consumer warpgroups' row maxima meet in
//     shared memory), then writes h (and sh).
//   down_kernel: grid (token tiles, 256-column strips of the output).  A
//     block owns 256 output columns and BN tokens over K = n_j bj: w8 and w4
//     sum straight through K in fp32 (ctpa adds per j-block; the bound of
//     that reordering is the fp32 sum's), w8a8 adds each j-block's exact
//     int32 dot times sh[token, j] in j order, w4a8 each down scale group's
//     exact dot times sd[group, column] inside its j-block, then times sh,
//     in j order; w8 times sd[column] at the end.  Each output tile is one
//     block's: no split of K, no atomics, no reduction launch, the same bits
//     on every call.
//
// Block: three warpgroups.  Warpgroup 0 is the producer: it gives up
// registers (setmaxnreg), and its thread 0 keeps the ring full with TMA
// copies (x or h in the 128-byte swizzle that the wgmma B descriptor names,
// the weight window's 128-byte rows in the same swizzle, int4's scale rows
// unswizzled), each stage bound to a `full` mbarrier; the consumers free a
// stage through an `empty` mbarrier.  Warpgroups 1 and 2 are the consumers,
// 128 columns each.  Where TMA cannot describe a tile (a row of x not a
// multiple of 16 bytes: K4 at k % 8 != 0, or k % 16 != 0 for w8a8; weight
// rows of n or inter % 16 != 0 bytes), the producer's 128 threads copy that
// stage's part by plain loads into the same layout.
//
// Operand majorness.  8-bit wgmma reads only K-major operands from shared
// memory, and the weights are stored (in, out) with the output column
// contiguous.  So the weights are the M side and the tokens the N side:
// out^T = W^T x^T.  The weights are A, built in registers from the raw
// bytes in shared memory (the RS form); the tokens are B, read by the
// descriptor from their TMA tile, k contiguous as x and h lie in memory.  A
// warp's share of A has the layout of mma.sync's A fragment, so the decode
// kernels' register builders serve (stream_common.cuh): lane (g, t) reads
// 4-byte words at its columns 4g .. 4g + 3 of the warp's 32, and tile i of a
// warp takes column 4g + 2i as its row g and 4g + 2i + 1 as row g + 8.
//   w8:   bf16 m64nNk16, rows k0 + 2t, + 1, + 8, + 9 (natural k order), each
//         int8 converted exactly by a byte permute under 2^23;
//   w8a8: s8 m64nNk32, the 4 x 4 byte transpose of rows k0 + 4t .. + 3 and
//         k0 + 16 + 4t .. + 3 (natural order: B cannot be permuted);
//   w4:   a packed byte holds rows j and j + G/2 of its scale group (ctpa's
//         quantize_int4 layout: byte j of group g holds row g G + j in its
//         low nibble and row g G + G/2 + j in its high nibble, signed in
//         [-7, 7]), so the low nibbles of a stage's packed rows contract
//         against x's first G/2 columns of the group and the high nibbles
//         against the next G/2, both in natural order; each nibble times its
//         column's scale, rounded to bf16 (ctpa's dequantized tile);
//   w4a8: s8 m64nNk32 on nibbles held as 16 q (an exact int32 dot, 16 times
//         the true one), the four k of a register from four packed rows of
//         one nibble half; a scale group's dot (G / 32 k-steps) is complete,
//         waited for, before float(dot) * s / 16 joins the fp32 sum, so two
//         accumulator sets live in registers and the token tile is smaller
//         (32 in the FFN, whose gate/up keeps two matrices, 64 in the
//         projection).
// The lanes' weight reads go through the same 128-byte swizzle, which puts a
// bf16 k-step's rows on distinct banks.
//
// Bounds on the H100 (989 TFLOP/s bf16, 1,979 TOPS int8, 3.35 TB/s) at
// Meditron-7B, m = 2,048: the FFN's 6 m hidden inter = 554 GFLOP, 0.56 ms in
// bf16 (w8, w4) and 0.28 ms in int8 (w8a8, w4a8); the fused qkv_proj's 2 m
// 4096 12288 = 206 GFLOP, 0.21 ms and 0.10 ms; o_proj's 69 GFLOP, 0.069 ms
// and 0.035 ms.  The design is a first form that overlaps the loads with
// the products: no persistent blocks, and a block's epilogue does not
// overlap the next block's loads.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "hopper_ptx.cuh"
#include "stream_common.cuh"

namespace prefill_wgmma {
namespace {  // each kernel source gets its own copy

namespace cg = cooperative_groups;

constexpr int kThreads = 384;      // warpgroup 0 produces, 1 and 2 consume
constexpr int kCols = 256;         // a block's weight columns: a j-block's window, or a strip
constexpr int kProducerRegs = 40;  // setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kMaxStages = 8;
constexpr int kRingBudget = 220 * 1024;

// A form of the kernels: int4 or int8 weights, int8 activations (a8), the
// int4 scale group G (0 for int8), the token tile kBN (wgmma's N; the FFN's
// by default)
template <bool kInt4, bool kA8, int kG, int kBN = kInt4 && kA8 ? 32 : 64>
struct Form {
  static constexpr bool int4 = kInt4;
  static constexpr bool a8 = kA8;
  static constexpr int G = kG;
  static constexpr int KS = kInt4 || kA8 ? 128 : 64;   // contraction rows a ring stage
  static constexpr int XB = kA8 ? 1 : 2;               // bytes of an x or h value
  static constexpr int XAtom = 128 / XB;               // values in a 128-byte row of a box
  static constexpr int XAtoms = KS / XAtom;            // x boxes a stage
  static constexpr int WRows = kInt4 ? KS / 2 : KS;    // weight rows a stage (packed for int4)
  static constexpr int SRows = kInt4 ? KS / kG : 0;    // scale rows a stage (int4)
  static constexpr int BN = kBN;                       // tokens a block: wgmma's N
  static constexpr int Regs = BN / 2;                  // accumulators of one 64 x BN tile
  static_assert(!kInt4 || kG == 32 || kG == 64 || kG == 128, "int4 groups are 32, 64 or 128");
};

// A ring stage of a kernel with kMats weight matrices: their windows (two
// 128-column halves each, WRows rows of 128 bytes), the tokens' boxes,
// int4's scale rows ([kMats][SRows][256] fp32); each part 1024-byte aligned.
template <class F, int kMats>
struct Ring {
  static constexpr int kW = kMats * 2 * F::WRows * 128;
  static constexpr int kX = F::XAtoms * F::BN * 128;
  static constexpr int kS = kMats * F::SRows * kCols * 4;
  static constexpr int kStage = (kW + kX + kS + 1023) / 1024 * 1024;
  static constexpr int kStages =
      kRingBudget / kStage < kMaxStages ? kRingBudget / kStage : kMaxStages;
  static constexpr int kSmem = kStages * kStage + 1024;   // and the slack to align the ring
  static_assert(kStages >= 2 && kW % 1024 == 0 && kX % 1024 == 0, "ring layout");
};

struct Args {
  const float* sx;      // (m,) row scales of x (a8)
  const float* sg;      // int8: (inter,) column scales of gate, up
  const float* su;
  const float* sd;      // int8: (hidden,) column scales of down
  const int8_t* wg;     // int8 gate/up (hidden, inter), for the producer's copies (copy_w)
  const int8_t* wu;
  void* h;              // (m, ld_h): bf16, or int8 with sh (a8); 0 past inter
  float* sh;            // (m, n_j)
  __nv_bfloat16* out;   // (m, hidden)
  int m, hidden, inter, bj, n_j, ld_h;
  int copy_w;           // gate/up weights by the producer's loads, not TMA
};

extern __shared__ unsigned char smem_wgmma[];

__device__ __forceinline__ unsigned char* ring_base() {
  const uint32_t a = hopper::smem_u32(smem_wgmma);
  return smem_wgmma + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  const float sig = 1.f / (1.f + expf(-g));
  return __fmul_rn(__fmul_rn(g, sig), u);
}

__device__ __forceinline__ uint32_t ld_w(const unsigned char* win, int row, int cb) {
  return *reinterpret_cast<const uint32_t*>(win + hopper::swizzle128(row, cb));
}

// a packed word's nibbles of one half as 16 q in each byte (int8)
__device__ __forceinline__ uint32_t nibbles16(uint32_t w, bool high) {
  return high ? w & 0xF0F0F0F0u : (w << 4) & 0xF0F0F0F0u;
}

// the token box's byte at contraction value kx of a stage (a 128-byte row
// holds F::XAtom values; box q of the stage BN rows after box q - 1)
template <class F>
__device__ __forceinline__ uint64_t x_desc(const unsigned char* xs, int kx) {
  return hopper::desc_sw128(xs + (kx / F::XAtom) * (F::BN * 128) + (kx % F::XAtom) * F::XB);
}

template <class F, int kMats, typename Acc>
__device__ __forceinline__ void wait_products(Acc (&acc)[kMats][2][F::Regs]) {
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int mat = 0; mat < kMats; ++mat)
#pragma unroll
    for (int i = 0; i < 2; ++i) hopper::fence_regs(acc[mat][i]);
}

template <class F, int kMats, typename Acc>
__device__ __forceinline__ void zero(Acc (&acc)[kMats][2][F::Regs]) {
#pragma unroll
  for (int mat = 0; mat < kMats; ++mat)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < F::Regs; ++r) acc[mat][i][r] = 0;
}

// ------------------------------------------------------------------ products of a stage
// win[mat]: this warpgroup's 128-column window of matrix mat in the stage;
// cb = 32 w + 4 g, this lane's 4 columns; xs: the stage's token boxes.

// w8: KS rows of int8 weights as bf16, fp32 sums
template <class F, int kMats>
__device__ __forceinline__ void stage_w8(float (&acc)[kMats][2][F::Regs],
                                         const unsigned char* const (&win)[kMats],
                                         const unsigned char* xs, int cb, int t) {
#pragma unroll
  for (int k0 = 0; k0 < F::KS; k0 += 16) {
    const int r0 = k0 + 2 * t;
    uint32_t am[kMats][2][4];
#pragma unroll
    for (int mat = 0; mat < kMats; ++mat) {
      const uint32_t u0 = ld_w(win[mat], r0, cb) ^ 0x80808080u;
      const uint32_t u1 = ld_w(win[mat], r0 + 1, cb) ^ 0x80808080u;
      const uint32_t u2 = ld_w(win[mat], r0 + 8, cb) ^ 0x80808080u;
      const uint32_t u3 = ld_w(win[mat], r0 + 9, cb) ^ 0x80808080u;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        am[mat][i][0] = wstream::s8_pair_bf16(u0, u1, 2 * i);
        am[mat][i][1] = wstream::s8_pair_bf16(u0, u1, 2 * i + 1);
        am[mat][i][2] = wstream::s8_pair_bf16(u2, u3, 2 * i);
        am[mat][i][3] = wstream::s8_pair_bf16(u2, u3, 2 * i + 1);
      }
    }
    const uint64_t d = x_desc<F>(xs, k0);
    hopper::wgmma_fence();
#pragma unroll
    for (int mat = 0; mat < kMats; ++mat)
#pragma unroll
      for (int i = 0; i < 2; ++i) hopper::wgmma_bf16<F::BN>(acc[mat][i], am[mat][i], d);
  }
  wait_products<F, kMats>(acc);
}

// w8a8: KS rows of int8 weights against int8 tokens, exact int32 sums
template <class F, int kMats>
__device__ __forceinline__ void stage_w8a8(int (&acc)[kMats][2][F::Regs],
                                           const unsigned char* const (&win)[kMats],
                                           const unsigned char* xs, int cb, int t) {
#pragma unroll
  for (int k0 = 0; k0 < F::KS; k0 += 32) {
    const int r0 = k0 + 4 * t;
    uint32_t am[kMats][2][4];
#pragma unroll
    for (int mat = 0; mat < kMats; ++mat) {
      uint32_t lo[4], hi[4];
      wstream::columns4(lo, ld_w(win[mat], r0, cb), ld_w(win[mat], r0 + 1, cb),
                        ld_w(win[mat], r0 + 2, cb), ld_w(win[mat], r0 + 3, cb));
      wstream::columns4(hi, ld_w(win[mat], r0 + 16, cb), ld_w(win[mat], r0 + 17, cb),
                        ld_w(win[mat], r0 + 18, cb), ld_w(win[mat], r0 + 19, cb));
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        am[mat][i][0] = lo[2 * i];
        am[mat][i][1] = lo[2 * i + 1];
        am[mat][i][2] = hi[2 * i];
        am[mat][i][3] = hi[2 * i + 1];
      }
    }
    const uint64_t d = x_desc<F>(xs, k0);
    hopper::wgmma_fence();
#pragma unroll
    for (int mat = 0; mat < kMats; ++mat)
#pragma unroll
      for (int i = 0; i < 2; ++i) hopper::wgmma_s8<F::BN>(acc[mat][i], am[mat][i], d);
  }
  wait_products<F, kMats>(acc);
}

// the scales of this lane's 4 columns in scale row `row` of a stage
__device__ __forceinline__ float4 lane_scales(const float* srow, int row) {
  return *reinterpret_cast<const float4*>(srow + row * kCols);
}

// w4: the stage's first `groups` scale groups, each weight q * s rounded to
// bf16, fp32 sums; sw[mat] this lane's scales in the stage's first scale row
template <class F, int kMats>
__device__ __forceinline__ void stage_w4(float (&acc)[kMats][2][F::Regs],
                                         const unsigned char* const (&win)[kMats],
                                         const float* const (&sw)[kMats],
                                         const unsigned char* xs, int cb, int t, int groups) {
  constexpr int G = F::G;
#pragma unroll
  for (int gl = 0; gl < F::KS / G; ++gl) {
    if (gl >= groups) break;
    float sc[kMats][4];
#pragma unroll
    for (int mat = 0; mat < kMats; ++mat) {
      const float4 v = lane_scales(sw[mat], gl);
      sc[mat][0] = v.x, sc[mat][1] = v.y, sc[mat][2] = v.z, sc[mat][3] = v.w;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)   // the low nibbles, then the high ones
#pragma unroll
      for (int kk = 0; kk < G / 2; kk += 16) {
        const int r0 = gl * (G / 2) + kk + 2 * t;
        uint32_t am[kMats][2][4];
#pragma unroll
        for (int mat = 0; mat < kMats; ++mat) {
          uint32_t n[4];   // rows r0, + 1, + 8, + 9: the half's nibbles as q + 8
          const int rows[4] = {r0, r0 + 1, r0 + 8, r0 + 9};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            uint32_t lo, hi;
            wstream::nibbles(ld_w(win[mat], rows[k], cb), lo, hi);
            n[k] = hh ? hi : lo;
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            am[mat][i][0] = wstream::dequant_pair(n[0], n[1], 2 * i, sc[mat][2 * i]);
            am[mat][i][1] = wstream::dequant_pair(n[0], n[1], 2 * i + 1, sc[mat][2 * i + 1]);
            am[mat][i][2] = wstream::dequant_pair(n[2], n[3], 2 * i, sc[mat][2 * i]);
            am[mat][i][3] = wstream::dequant_pair(n[2], n[3], 2 * i + 1, sc[mat][2 * i + 1]);
          }
        }
        const uint64_t d = x_desc<F>(xs, gl * G + hh * (G / 2) + kk);
        hopper::wgmma_fence();
#pragma unroll
        for (int mat = 0; mat < kMats; ++mat)
#pragma unroll
          for (int i = 0; i < 2; ++i) hopper::wgmma_bf16<F::BN>(acc[mat][i], am[mat][i], d);
      }
  }
  wait_products<F, kMats>(acc);
}

// w4a8: the stage's first `groups` scale groups, each group's exact int32
// dot (16 times it) times its scale row (a sixteenth of it: the same real
// number, rounded once), added to acc in group order; then after(gl)
template <class F, int kMats, typename After>
__device__ __forceinline__ void stage_w4a8(float (&acc)[kMats][2][F::Regs],
                                           const unsigned char* const (&win)[kMats],
                                           const float* const (&sw)[kMats],
                                           const unsigned char* xs, int cb, int t, int groups,
                                           After after) {
  constexpr int G = F::G;
#pragma unroll
  for (int gl = 0; gl < F::KS / G; ++gl) {
    if (gl >= groups) break;
    int ci[kMats][2][F::Regs];
    zero<F, kMats>(ci);
#pragma unroll
    for (int s = 0; s < G / 32; ++s) {
      // k slots 4t .. 4t + 3 and 16 + 4t .. of the step: k of the group
      // kg, packed row gl G/2 + kg % (G/2), nibble half kg / (G/2)
      const int kg0 = 32 * s + 4 * t, kg1 = kg0 + 16;
      const int p0 = gl * (G / 2) + kg0 % (G / 2), p1 = gl * (G / 2) + kg1 % (G / 2);
      const bool h0 = kg0 >= G / 2, h1 = kg1 >= G / 2;
      uint32_t am[kMats][2][4];
#pragma unroll
      for (int mat = 0; mat < kMats; ++mat) {
        uint32_t lo[4], hi[4];
        wstream::columns4(lo, nibbles16(ld_w(win[mat], p0, cb), h0),
                          nibbles16(ld_w(win[mat], p0 + 1, cb), h0),
                          nibbles16(ld_w(win[mat], p0 + 2, cb), h0),
                          nibbles16(ld_w(win[mat], p0 + 3, cb), h0));
        wstream::columns4(hi, nibbles16(ld_w(win[mat], p1, cb), h1),
                          nibbles16(ld_w(win[mat], p1 + 1, cb), h1),
                          nibbles16(ld_w(win[mat], p1 + 2, cb), h1),
                          nibbles16(ld_w(win[mat], p1 + 3, cb), h1));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          am[mat][i][0] = lo[2 * i];
          am[mat][i][1] = lo[2 * i + 1];
          am[mat][i][2] = hi[2 * i];
          am[mat][i][3] = hi[2 * i + 1];
        }
      }
      const uint64_t d = x_desc<F>(xs, gl * G + 32 * s);
      hopper::wgmma_fence();
#pragma unroll
      for (int mat = 0; mat < kMats; ++mat)
#pragma unroll
        for (int i = 0; i < 2; ++i) hopper::wgmma_s8<F::BN>(ci[mat][i], am[mat][i], d);
    }
    wait_products<F, kMats>(ci);
#pragma unroll
    for (int mat = 0; mat < kMats; ++mat) {
      const float4 v = lane_scales(sw[mat], gl);
      const float s16[4] = {v.x * 0.0625f, v.y * 0.0625f, v.z * 0.0625f, v.w * 0.0625f};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < F::Regs; ++r)
          acc[mat][i][r] = __fadd_rn(acc[mat][i][r], __fmul_rn(wstream::exact_float(ci[mat][i][r]),
                                                               s16[2 * i + ((r >> 1) & 1)]));
    }
    after(gl);
  }
}

// ------------------------------------------------------------------ the ring

// barriers: full[s] takes the producer's 128 arrivals and the stage's TMA
// bytes, empty[s] the 8 consumer warps' arrivals
template <int kStages>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 128);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
}

// a consumer warp is done with stage it
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(empty);
}

// The windows of kWRows rows from row r0 and 256 columns from column c0 of
// kMats byte matrices w0 (and w1), each rows x cols with rows of cols bytes,
// by the producer's plain loads (rows not a multiple of 16 bytes), zero past
// their edges, in the TMA layout: two 128-byte-swizzled halves of kWRows
// rows each, matrix after matrix
template <int kWRows, int kMats>
__device__ __forceinline__ void copy_window(unsigned char* st, const int8_t* w0, const int8_t* w1,
                                            int rows, int cols, int r0, int c0) {
  for (int e = threadIdx.x; e < kMats * kWRows * kCols; e += 128) {
    const int mat = e / (kWRows * kCols);
    const int rem = e - mat * kWRows * kCols;
    const int r = rem / kCols;
    const int col = rem - r * kCols;
    const int k = r0 + r, j = c0 + col;
    const int8_t* w = mat ? w1 : w0;
    st[(mat * 2 + col / 128) * kWRows * 128 + hopper::swizzle128(r, col & 127)] =
        k < rows && j < cols ? static_cast<unsigned char>(w[static_cast<long long>(k) * cols + j])
                             : 0;
  }
}

// ------------------------------------------------------------------ gate/up

// grid (ceil(m / BN), n_j), kThreads threads, Ring<F, 2>::kSmem bytes of
// dynamic shared memory.  tx: x (m, hidden), bf16 or int8; twg, twu: the
// weights (hidden or hidden/2 rows of inter bytes), boxes of 128 columns x
// WRows rows; tsg, tsu: int4's scales (hidden/G, inter) fp32, boxes 256 x
// SRows.  Writes h and, for a8, sh.
template <class F>
__global__ void __launch_bounds__(kThreads, 1)
    gateup_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap twg,
                  const __grid_constant__ CUtensorMap twu,
                  const __grid_constant__ CUtensorMap tsg,
                  const __grid_constant__ CUtensorMap tsu, const Args a) {
  using R = Ring<F, 2>;
  __shared__ __align__(8) uint64_t full[R::kStages], empty[R::kStages];
  __shared__ float red[8][F::BN];
  unsigned char* ring = ring_base();
  const int m0 = blockIdx.x * F::BN;
  const int jb = blockIdx.y;
  const int j0 = jb * a.bj;
  const int n_it = (a.hidden + F::KS - 1) / F::KS;
  init_ring<R::kStages>(full, empty);

  if (threadIdx.x < 128) {   // the producer
    hopper::regs_dec<kProducerRegs>();
    for (int it = 0; it < n_it; ++it) {
      const int s = it % R::kStages;
      hopper::mbar_wait(&empty[s], ((it / R::kStages) & 1) ^ 1);
      unsigned char* st = ring + s * R::kStage;
      const int k0 = it * F::KS;
      if constexpr (!F::int4) {
        if (a.copy_w)   // K6's gate/up rows of inter % 16 != 0 bytes
          copy_window<F::WRows, 2>(st, a.wg, a.wu, a.hidden, a.inter, k0, j0);
      }
      if (threadIdx.x == 0) {
        hopper::mbar_arrive_expect_tx(&full[s], (a.copy_w ? 0 : R::kW) + R::kX + R::kS);
#pragma unroll
        for (int q = 0; q < F::XAtoms; ++q)
          hopper::tma_load_2d(st + R::kW + q * F::BN * 128, &tx, k0 + q * F::XAtom, m0, &full[s]);
        if (!a.copy_w) {
          const int wr = F::int4 ? k0 / 2 : k0;
#pragma unroll
          for (int part = 0; part < 4; ++part)   // gate's halves, then up's
            hopper::tma_load_2d(st + part * F::WRows * 128, part < 2 ? &twg : &twu,
                                j0 + (part & 1) * 128, wr, &full[s]);
        }
        if constexpr (F::int4) {
          unsigned char* ss = st + R::kW + R::kX;
          hopper::tma_load_2d(ss, &tsg, j0, k0 / F::G, &full[s]);
          hopper::tma_load_2d(ss + F::SRows * kCols * 4, &tsu, j0, k0 / F::G, &full[s]);
        }
      } else {
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  hopper::regs_inc<kConsumerRegs>();
  const int c = threadIdx.x / 128 - 1;   // columns [128 c, 128 c + 128) of the window
  const int w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cb = 32 * w + 4 * g;
  using Acc = typename std::conditional<F::a8 && !F::int4, int, float>::type;
  Acc acc[2][2][F::Regs];   // [gate, up][tile i][register]
  zero<F, 2>(acc);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % R::kStages;
    hopper::mbar_wait(&full[s], (it / R::kStages) & 1);
    const unsigned char* st = ring + s * R::kStage;
    const unsigned char* const win[2] = {st + c * F::WRows * 128,
                                         st + (2 + c) * F::WRows * 128};
    const unsigned char* xs = st + R::kW;
    if constexpr (F::int4) {
      const float* ss = reinterpret_cast<const float*>(st + R::kW + R::kX);
      const float* const sw[2] = {ss + 128 * c + cb, ss + F::SRows * kCols + 128 * c + cb};
      const int groups = min(F::KS / F::G, a.hidden / F::G - it * (F::KS / F::G));
      if constexpr (F::a8)
        stage_w4a8<F, 2>(acc, win, sw, xs, cb, t, groups, [](int) {});
      else
        stage_w4<F, 2>(acc, win, sw, xs, cb, t, groups);
    } else if constexpr (F::a8) {
      stage_w8a8<F, 2>(acc, win, xs, cb, t);
    } else {
      stage_w8<F, 2>(acc, win, xs, cb, t);
    }
    release(&empty[s]);
  }

  // h = silu(g) u: register r of tile i is window column 128 c + cb + 2 i +
  // (r / 2) % 2 and token m0 + 8 (r / 4) + 2t + r % 2
  const int lc = 128 * c + cb;        // the lane's first window column
  const int col = j0 + lc;
  float csg[4], csu[4];               // int8's column scales (0 past inter)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    csg[q] = !F::int4 && col + q < a.inter ? a.sg[col + q] : 0.f;
    csu[q] = !F::int4 && col + q < a.inter ? a.su[col + q] : 0.f;
  }
  float sxv[F::Regs / 2];             // a8: the row scales of the lane's tokens
#pragma unroll
  for (int ts = 0; ts < F::Regs / 2; ++ts) {
    const int tok = m0 + 8 * (ts >> 1) + 2 * t + (ts & 1);
    sxv[ts] = F::a8 && tok < a.m ? a.sx[tok] : 0.f;
  }
  float hv[2][F::Regs];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < F::Regs; ++r) {
      const int q = 2 * i + ((r >> 1) & 1);
      const int ts = 2 * (r >> 2) + (r & 1);
      float gv, uv;
      if constexpr (F::int4) {
        gv = F::a8 ? __fmul_rn(acc[0][i][r], sxv[ts]) : acc[0][i][r];
        uv = F::a8 ? __fmul_rn(acc[1][i][r], sxv[ts]) : acc[1][i][r];
      } else if constexpr (F::a8) {
        gv = __fmul_rn(__fmul_rn(static_cast<float>(acc[0][i][r]), sxv[ts]), csg[q]);
        uv = __fmul_rn(__fmul_rn(static_cast<float>(acc[1][i][r]), sxv[ts]), csu[q]);
      } else {
        gv = __fmul_rn(acc[0][i][r], csg[q]);
        uv = __fmul_rn(acc[1][i][r], csu[q]);
      }
      hv[i][r] = silu_mul(gv, uv);
    }
  // a token's 4 columns lc .. lc + 3: tile 0's rows g, g + 8, tile 1's
  const bool live = lc < a.bj;        // inside the j-block (h has n_j bj columns)
  if constexpr (!F::a8) {
#pragma unroll
    for (int ts = 0; ts < F::Regs / 2; ++ts) {
      const int tok = m0 + 8 * (ts >> 1) + 2 * t + (ts & 1);
      const int r = 4 * (ts >> 1) + (ts & 1);
      if (live && tok < a.m) {
        uint2 v;
        v.x = warp_mma::pack_bf16(hv[0][r], hv[0][r + 2]);
        v.y = warp_mma::pack_bf16(hv[1][r], hv[1][r + 2]);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.h) +
                                  static_cast<long long>(tok) * a.ld_h + col) = v;
      }
    }
  } else {
    // each token's row maximum of |h| over the window (columns past the
    // j-block lie past inter, where h is 0): the lane's 4 columns, the
    // warp's 8 lanes of one t, then the 8 warps through shared memory
    float mx[F::Regs / 2];
#pragma unroll
    for (int ts = 0; ts < F::Regs / 2; ++ts) {
      const int r = 4 * (ts >> 1) + (ts & 1);
      mx[ts] = fmaxf(fmaxf(fabsf(hv[0][r]), fabsf(hv[0][r + 2])),
                     fmaxf(fabsf(hv[1][r]), fabsf(hv[1][r + 2])));
#pragma unroll
      for (int off = 4; off < 32; off *= 2)
        mx[ts] = fmaxf(mx[ts], __shfl_xor_sync(0xffffffffu, mx[ts], off));
      if (g == 0) red[4 * c + w][8 * (ts >> 1) + 2 * t + (ts & 1)] = mx[ts];
    }
    hopper::named_barrier(1, 256);
#pragma unroll
    for (int ts = 0; ts < F::Regs / 2; ++ts) {
      const int tl = 8 * (ts >> 1) + 2 * t + (ts & 1);
      const int tok = m0 + tl;
      float m = red[0][tl];
#pragma unroll
      for (int k = 1; k < 8; ++k) m = fmaxf(m, red[k][tl]);
      const float sh = fmaxf(m / 127.f, 1e-12f);
      const int r = 4 * (ts >> 1) + (ts & 1);
      const float v[4] = {hv[0][r], hv[0][r + 2], hv[1][r], hv[1][r + 2]};
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        word |= (static_cast<uint32_t>(min(127, max(-127, __float2int_rn(v[q] / sh)))) & 0xFFu)
                << (8 * q);
      if (live && tok < a.m)
        *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.h) +
                                     static_cast<long long>(tok) * a.ld_h + col) = word;
      if (c == 0 && w == 0 && g == 0 && tok < a.m) a.sh[tok * a.n_j + jb] = sh;
    }
  }
}

// ------------------------------------------------------------------ down

// grid (ceil(m / BN), ceil(hidden / 256)), kThreads threads,
// Ring<F, 1>::kSmem bytes of dynamic shared memory.  th: h (m, ld_h); twd:
// the down weight (inter or inter/2 rows of hidden bytes), boxes of 128
// columns x WRows rows; tsd: int4's scales (inter/G, hidden) fp32, boxes
// 256 x SRows.  Writes out.
template <class F>
__global__ void __launch_bounds__(kThreads, 1)
    down_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap twd,
                const __grid_constant__ CUtensorMap tsd, const Args a) {
  using R = Ring<F, 1>;
  __shared__ __align__(8) uint64_t full[R::kStages], empty[R::kStages];
  unsigned char* ring = ring_base();
  const int m0 = blockIdx.x * F::BN;
  const int n0 = blockIdx.y * kCols;
  const int n_it = (a.ld_h + F::KS - 1) / F::KS;
  init_ring<R::kStages>(full, empty);

  if (threadIdx.x < 128) {   // the producer
    hopper::regs_dec<kProducerRegs>();
    for (int it = 0; it < n_it; ++it) {
      const int s = it % R::kStages;
      hopper::mbar_wait(&empty[s], ((it / R::kStages) & 1) ^ 1);
      unsigned char* st = ring + s * R::kStage;
      const int k0 = it * F::KS;
      if (threadIdx.x == 0) {
        hopper::mbar_arrive_expect_tx(&full[s], R::kW + R::kX + R::kS);
        const int wr = F::int4 ? k0 / 2 : k0;
        hopper::tma_load_2d(st, &twd, n0, wr, &full[s]);
        hopper::tma_load_2d(st + F::WRows * 128, &twd, n0 + 128, wr, &full[s]);
#pragma unroll
        for (int q = 0; q < F::XAtoms; ++q)
          hopper::tma_load_2d(st + R::kW + q * F::BN * 128, &th, k0 + q * F::XAtom, m0, &full[s]);
        if constexpr (F::int4) hopper::tma_load_2d(st + R::kW + R::kX, &tsd, n0, k0 / F::G, &full[s]);
      } else {
        hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  hopper::regs_inc<kConsumerRegs>();
  const int c = threadIdx.x / 128 - 1;
  const int w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cb = 32 * w + 4 * g;

  // the row scales sh of the lane's tokens in j-block jb, times a j-block's
  // sums, added to acc (a8)
  auto add_j_block = [&](float (&acc)[1][2][F::Regs], const auto& part, int jb) {
    float shv[F::Regs / 2];
#pragma unroll
    for (int ts = 0; ts < F::Regs / 2; ++ts) {
      const int tok = m0 + 8 * (ts >> 1) + 2 * t + (ts & 1);
      shv[ts] = tok < a.m ? a.sh[tok * a.n_j + jb] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < F::Regs; ++r)
        acc[0][i][r] = __fadd_rn(acc[0][i][r], __fmul_rn(static_cast<float>(part[0][i][r]),
                                                         shv[2 * (r >> 2) + (r & 1)]));
  };

  float acc[1][2][F::Regs];   // the output tile's fp32 sums
  zero<F, 1>(acc);
  // w8a8: a j-block's exact int32 dot (two stages of 128); w4a8: a j-block's
  // fp32 sum of its groups' scaled dots
  using Part = typename std::conditional<F::int4, float, int>::type;
  Part part[1][2][F::Regs];
  zero<F, 1>(part);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % R::kStages;
    hopper::mbar_wait(&full[s], (it / R::kStages) & 1);
    const unsigned char* st = ring + s * R::kStage;
    const unsigned char* const win[1] = {st + c * F::WRows * 128};
    const unsigned char* xs = st + R::kW;
    if constexpr (F::int4) {
      const float* const sw[1] = {reinterpret_cast<const float*>(st + R::kW + R::kX) + 128 * c +
                                  cb};
      const int q0 = it * (F::KS / F::G);   // the stage's first scale group
      const int groups = min(F::KS / F::G, a.ld_h / F::G - q0);
      if constexpr (F::a8) {
        stage_w4a8<F, 1>(part, win, sw, xs, cb, t, groups, [&](int gl) {
          const int q = q0 + gl;
          if ((q + 1) * F::G % a.bj == 0) {   // the last group of j-block q G / bj
            add_j_block(acc, part, q * F::G / a.bj);
            zero<F, 1>(part);
          }
        });
      } else {
        stage_w4<F, 1>(acc, win, sw, xs, cb, t, groups);
      }
    } else if constexpr (F::a8) {
      stage_w8a8<F, 1>(part, win, xs, cb, t);
      if ((it + 1) * F::KS % a.bj == 0) {   // the end of j-block (it + 1) KS / bj - 1
        add_j_block(acc, part, (it + 1) * F::KS / a.bj - 1);
        zero<F, 1>(part);
      }
    } else {
      stage_w8<F, 1>(acc, win, xs, cb, t);
    }
    release(&empty[s]);
  }

  // out: the lane's 4 columns of each of its tokens, times sd for int8
  const int col = n0 + 128 * c + cb;
  if (col >= a.hidden) return;
  float sd[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) sd[q] = F::int4 ? 1.f : a.sd[col + q];
#pragma unroll
  for (int ts = 0; ts < F::Regs / 2; ++ts) {
    const int tok = m0 + 8 * (ts >> 1) + 2 * t + (ts & 1);
    const int r = 4 * (ts >> 1) + (ts & 1);
    if (tok >= a.m) continue;
    const float v[4] = {acc[0][0][r], acc[0][0][r + 2], acc[0][1][r], acc[0][1][r + 2]};
    uint2 o;
    o.x = warp_mma::pack_bf16(F::int4 ? v[0] : __fmul_rn(v[0], sd[0]),
                              F::int4 ? v[1] : __fmul_rn(v[1], sd[1]));
    o.y = warp_mma::pack_bf16(F::int4 ? v[2] : __fmul_rn(v[2], sd[2]),
                              F::int4 ? v[3] : __fmul_rn(v[3], sd[3]));
    *reinterpret_cast<uint2*>(a.out + static_cast<long long>(tok) * a.hidden + col) = o;
  }
}

// ------------------------------------------------------------------ projection

// the projection's token tile (wgmma's N): w8, w8a8 and w4 keep one set of
// accumulators (2 x 64 registers a consumer thread at 128 tokens), w4a8 two
// (each group's int32 dot beside the fp32 sum)
constexpr int kProjBN = 128;
constexpr int kProjBNA8 = 64;
// the unit of a split contraction: 128 rows, one to two ring stages
constexpr int kProjKC = 128;

template <bool kInt4, bool kA8, int kG>
using ProjForm = Form<kInt4, kA8, kG, kInt4 && kA8 ? kProjBNA8 : kProjBN>;

struct ProjArgs {
  const void* x;        // (m, k) bf16, or int8 (a8): the producer's copies (copy_x)
  const float* sx;      // (m,) row scales of x (a8)
  const int8_t* w;      // (k, n) int8 or (k/2, n) packed int4: the producer's copies (copy_w)
  const float* scale;   // int8: (n,) column scales; int4: (k/G, n), the producer's copies
  __nv_bfloat16* out;   // (m, n)
  int m, k, n;
  int tiles;            // token tiles, ceil(m / BN)
  int per;              // kProjKC-row chunks of the contraction a split
  int copy_x;           // x's rows by the producer's loads, not TMA
  int copy_w;           // the weight rows (and int4's scales) by the producer's loads
};

// x's box of stage k0 (BN rows x KS values) by the producer's plain loads,
// zero past m and k, in the TMA layout; then the proxy fence that makes the
// writes visible to wgmma's reads of B
template <class F>
__device__ __forceinline__ void copy_tokens(unsigned char* xs, const ProjArgs& a, int m0, int k0) {
  const unsigned char* x = static_cast<const unsigned char*>(a.x);
  for (int e = threadIdx.x; e < F::BN * F::KS; e += 128) {
    const int r = e / F::KS;
    const int kx = e - r * F::KS;
    const int tok = m0 + r, k = k0 + kx;
    unsigned char* dst =
        xs + (kx / F::XAtom) * (F::BN * 128) + hopper::swizzle128(r, (kx % F::XAtom) * F::XB);
    const bool in = tok < a.m && k < a.k;
    const long long at = (static_cast<long long>(tok) * a.k + k) * F::XB;
    if constexpr (F::XB == 2)
      *reinterpret_cast<uint16_t*>(dst) = in ? *reinterpret_cast<const uint16_t*>(x + at) : 0;
    else
      *dst = in ? x[at] : 0;
  }
  hopper::fence_proxy_async();
}

// int4's scale rows [q0, q0 + SRows) of the block's 256 columns by the
// producer's plain loads, zero past k/G and n
template <class F>
__device__ __forceinline__ void copy_scales(float* ss, const ProjArgs& a, int q0, int n0) {
  for (int e = threadIdx.x; e < F::SRows * kCols; e += 128) {
    const int r = e / kCols;
    const int col = e - r * kCols;
    ss[e] = q0 + r < a.k / F::G && n0 + col < a.n
                ? a.scale[static_cast<long long>(q0 + r) * a.n + n0 + col] : 0.f;
  }
}

// grid (tiles x ceil(n / 256), splits) in clusters of (1, splits, 1),
// kThreads threads, Ring<F, 1>::kSmem bytes of dynamic shared memory.  Block
// (x, z) owns token tile x % tiles, the 256 output columns of strip x /
// tiles and the kProjKC-row chunks [z per, (z + 1) per) of the contraction.
// tx: x (m, k) bf16 or int8, boxes of XAtom values x BN rows; tw: the weight
// (k or k/2 rows of n bytes), boxes of 128 columns x WRows rows; ts: int4's
// scales (k/G, n) fp32, boxes of 256 x SRows.  Writes out.
template <class F>
__global__ void __launch_bounds__(kThreads, 1)
    proj_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                const __grid_constant__ CUtensorMap ts, const ProjArgs a) {
  using R = Ring<F, 1>;
  __shared__ __align__(8) uint64_t full[R::kStages], empty[R::kStages];
  unsigned char* ring = ring_base();
  const int m0 = (blockIdx.x % a.tiles) * F::BN;
  const int n0 = (blockIdx.x / a.tiles) * kCols;
  const int splits = gridDim.y;
  const int n_it = (a.k + F::KS - 1) / F::KS;
  const int it0 = blockIdx.y * a.per * (kProjKC / F::KS);   // the split's first stage
  const int cnt = min(n_it, it0 + a.per * (kProjKC / F::KS)) - it0;
  init_ring<R::kStages>(full, empty);

  if (threadIdx.x < 128) {   // the producer
    hopper::regs_dec<kProducerRegs>();
    for (int j = 0; j < cnt; ++j) {
      const int s = j % R::kStages;
      hopper::mbar_wait(&empty[s], ((j / R::kStages) & 1) ^ 1);
      unsigned char* st = ring + s * R::kStage;
      const int k0 = (it0 + j) * F::KS;
      const int wr = F::int4 ? k0 / 2 : k0;
      if (a.copy_x) copy_tokens<F>(st + R::kW, a, m0, k0);
      if (a.copy_w) {
        copy_window<F::WRows, 1>(st, a.w, nullptr, F::int4 ? a.k / 2 : a.k, a.n, wr, n0);
        if constexpr (F::int4)
          copy_scales<F>(reinterpret_cast<float*>(st + R::kW + R::kX), a, k0 / F::G, n0);
      }
      if (threadIdx.x == 0) {
        hopper::mbar_arrive_expect_tx(&full[s],
                                      (a.copy_w ? 0 : R::kW + R::kS) + (a.copy_x ? 0 : R::kX));
        if (!a.copy_w) {
          hopper::tma_load_2d(st, &tw, n0, wr, &full[s]);
          hopper::tma_load_2d(st + F::WRows * 128, &tw, n0 + 128, wr, &full[s]);
          if constexpr (F::int4)
            hopper::tma_load_2d(st + R::kW + R::kX, &ts, n0, k0 / F::G, &full[s]);
        }
        if (!a.copy_x) {
#pragma unroll
          for (int q = 0; q < F::XAtoms; ++q)
            hopper::tma_load_2d(st + R::kW + q * F::BN * 128, &tx, k0 + q * F::XAtom, m0,
                                &full[s]);
        }
      } else {
        hopper::mbar_arrive(&full[s]);
      }
    }
    if (splits > 1) {   // the consumers' two cluster barriers
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
    return;
  }

  hopper::regs_inc<kConsumerRegs>();
  const int c = threadIdx.x / 128 - 1;
  const int w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cb = 32 * w + 4 * g;
  using Acc = typename std::conditional<F::a8 && !F::int4, int, float>::type;
  // the 256 consumer threads' sums, 2 x Regs each, are split_sum's source
  static_assert(2 * F::Regs * 256 * sizeof(Acc) <= R::kStages * R::kStage,
                "a split's sums fit the ring");
  Acc acc[1][2][F::Regs];   // the split's sums: fp32, or w8a8's exact int32 dot
  zero<F, 1>(acc);
  for (int j = 0; j < cnt; ++j) {
    const int s = j % R::kStages;
    hopper::mbar_wait(&full[s], (j / R::kStages) & 1);
    const unsigned char* st = ring + s * R::kStage;
    const unsigned char* const win[1] = {st + c * F::WRows * 128};
    const unsigned char* xs = st + R::kW;
    if constexpr (F::int4) {
      const float* const sw[1] = {reinterpret_cast<const float*>(st + R::kW + R::kX) + 128 * c +
                                  cb};
      const int groups = min(F::KS / F::G, a.k / F::G - (it0 + j) * (F::KS / F::G));
      if constexpr (F::a8)
        stage_w4a8<F, 1>(acc, win, sw, xs, cb, t, groups, [](int) {});
      else
        stage_w4<F, 1>(acc, win, sw, xs, cb, t, groups);
    } else if constexpr (F::a8) {
      stage_w8a8<F, 1>(acc, win, xs, cb, t);
    } else {
      stage_w8<F, 1>(acc, win, xs, cb, t);
    }
    release(&empty[s]);
  }

  // token slot ts of the lane: token m0 + 8 (ts / 2) + 2t + ts % 2, its sums
  // v0 .. v3 over the lane's columns col .. col + 3 (registers r, r + 2 of
  // tiles 0 and 1, r = 4 (ts / 2) + ts % 2), scaled and written
  const int col = n0 + 128 * c + cb;
  float cs[4];   // int8's column scales, 0 past n
#pragma unroll
  for (int q = 0; q < 4; ++q) cs[q] = !F::int4 && col + q < a.n ? a.scale[col + q] : 0.f;
  auto put = [&](int ts, Acc v0, Acc v1, Acc v2, Acc v3) {
    const int tok = m0 + 8 * (ts >> 1) + 2 * t + (ts & 1);
    if (tok >= a.m || col >= a.n) return;
    const float rs = F::a8 ? a.sx[tok] : 1.f;
    const Acc v[4] = {v0, v1, v2, v3};
    float y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (F::int4)
        y[q] = F::a8 ? __fmul_rn(v[q], rs) : v[q];
      else if constexpr (F::a8)
        y[q] = __fmul_rn(__fmul_rn(static_cast<float>(v[q]), rs), cs[q]);
      else
        y[q] = __fmul_rn(v[q], cs[q]);
    }
    __nv_bfloat16* o = a.out + static_cast<long long>(tok) * a.n + col;
    if (a.n % 4 == 0) {
      *reinterpret_cast<uint2*>(o) =
          make_uint2(warp_mma::pack_bf16(y[0], y[1]), warp_mma::pack_bf16(y[2], y[3]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (col + q < a.n) o[q] = __float2bfloat16_rn(y[q]);
    }
  };
  if (splits == 1) {
#pragma unroll
    for (int ts = 0; ts < F::Regs / 2; ++ts) {
      const int r = 4 * (ts >> 1) + (ts & 1);
      put(ts, acc[0][0][r], acc[0][0][r + 2], acc[0][1][r], acc[0][1][r + 2]);
    }
    return;
  }

  // the split's sums into this block's ring, register-major over the 256
  // consumer threads, once both warpgroups are done with it; block z then
  // finishes token slots z, z + splits, ..., adding the splits in order
  hopper::named_barrier(1, 256);
  Acc* part = reinterpret_cast<Acc*>(ring);
  const int ct = threadIdx.x - 128;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < F::Regs; ++r) part[(i * F::Regs + r) * 256 + ct] = acc[0][i][r];
  const cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int ts = static_cast<int>(cluster.block_rank()); ts < F::Regs / 2; ts += splits) {
    const int at = (4 * (ts >> 1) + (ts & 1)) * 256 + ct;   // register r's sums
    put(ts, wstream::split_sum(cluster, part, at, splits),
        wstream::split_sum(cluster, part, at + 2 * 256, splits),
        wstream::split_sum(cluster, part, at + F::Regs * 256, splits),
        wstream::split_sum(cluster, part, at + (F::Regs + 2) * 256, splits));
  }
  cluster.sync();   // the other blocks read this block's sums until here
}

// ------------------------------------------------------------------ host

// the tensor map of a (rows, inner) matrix of `bytes`-byte values cut into
// boxes of box_inner x box_rows, swizzled or not
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* base,
                       int inner, int rows, int box_inner, int box_rows, bool swizzle) {
  return hopper::encode_2d(map, type, base, static_cast<uint64_t>(inner),
                           static_cast<uint64_t>(rows), static_cast<uint64_t>(inner) * bytes,
                           static_cast<uint32_t>(box_inner), static_cast<uint32_t>(box_rows),
                           swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE) ==
         CUDA_SUCCESS;
}

// The gate/up launch on `st`: x (m, hidden) bf16 or int8; wg, wu the
// (hidden or hidden/2, inter) weights; sg, su int4's (hidden/G, inter)
// scales (int8's column scales travel in `a`).  cudaSuccess, the launch's
// error, or cudaErrorInvalidValue where a tensor map cannot be made.
template <class F>
cudaError_t launch_gateup(const void* x, const int8_t* wg, const int8_t* wu, const float* sg,
                          const float* su, const Args& a, cudaStream_t st) {
  using R = Ring<F, 2>;
  const CUtensorMapDataType xt =
      F::a8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tx, twg, twu, tsg, tsu;
  bool ok = tensor_map(&tx, xt, F::XB, x, a.hidden, a.m, F::XAtom, F::BN, true);
  twg = twu = tsg = tsu = tx;   // the maps a form does not read
  const int wrows = F::int4 ? a.hidden / 2 : a.hidden;
  if (!a.copy_w) {
    ok = ok && tensor_map(&twg, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wg, a.inter, wrows, 128, F::WRows,
                          true);
    ok = ok && tensor_map(&twu, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wu, a.inter, wrows, 128, F::WRows,
                          true);
  }
  if constexpr (F::int4) {
    const int srows = a.hidden / F::G;
    ok = ok && tensor_map(&tsg, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sg, a.inter, srows, kCols,
                          F::SRows, false);
    ok = ok && tensor_map(&tsu, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, su, a.inter, srows, kCols,
                          F::SRows, false);
  }
  if (!ok) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      gateup_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return err;
  gateup_kernel<F><<<dim3((a.m + F::BN - 1) / F::BN, a.n_j), kThreads, R::kSmem, st>>>(
      tx, twg, twu, tsg, tsu, a);
  return cudaGetLastError();
}

// The down launch on `st`: wd the (inter or inter/2, hidden) weight, sd
// int4's (inter/G, hidden) scales (int8's column scales travel in `a`).
template <class F>
cudaError_t launch_down(const int8_t* wd, const float* sd, const Args& a, cudaStream_t st) {
  using R = Ring<F, 1>;
  const CUtensorMapDataType ht =
      F::a8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap th, twd, tsd;
  bool ok = tensor_map(&th, ht, F::XB, a.h, a.ld_h, a.m, F::XAtom, F::BN, true);
  ok = ok && tensor_map(&twd, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, wd, a.hidden,
                        F::int4 ? a.inter / 2 : a.inter, 128, F::WRows, true);
  tsd = th;
  if constexpr (F::int4)
    ok = ok && tensor_map(&tsd, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sd, a.hidden, a.inter / F::G,
                          kCols, F::SRows, false);
  if (!ok) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      down_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return err;
  down_kernel<F><<<dim3((a.m + F::BN - 1) / F::BN, (a.hidden + kCols - 1) / kCols), kThreads,
                   R::kSmem, st>>>(th, twd, tsd, a);
  return cudaGetLastError();
}

// The projection's launch on `st`, in clusters of `splits` blocks: x (m, k)
// bf16 or int8; w the (k or k/2, n) weight; scale int8's (n,) or int4's
// (k/G, n) scales.  cudaSuccess, the launch's error, or
// cudaErrorInvalidValue where a tensor map cannot be made.
template <class F>
cudaError_t launch_proj(const ProjArgs& a, int splits, cudaStream_t st) {
  using R = Ring<F, 1>;
  CUtensorMap tx{}, tw{}, ts{};   // the maps a call does not read stay zero
  bool ok = true;
  if (!a.copy_x)
    ok = tensor_map(&tx, F::a8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    F::XB, a.x, a.k, a.m, F::XAtom, F::BN, true);
  if (!a.copy_w) {
    ok = ok && tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.w, a.n,
                          F::int4 ? a.k / 2 : a.k, 128, F::WRows, true);
    if constexpr (F::int4)
      ok = ok && tensor_map(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.scale, a.n, a.k / F::G,
                            kCols, F::SRows, false);
  }
  if (!ok) return cudaErrorInvalidValue;
  return wstream::launch_clusters(proj_kernel<F>, dim3(a.tiles * ((a.n + kCols - 1) / kCols),
                                                       splits),
                                  kThreads, R::kSmem, st, tx, tw, ts, a);
}

// How many clusters of `splits` blocks of the projection's form the card
// runs at once, or -1 on a CUDA error.
template <class F>
int proj_clusters(int splits) {
  return wstream::active_clusters(proj_kernel<F>, kThreads, Ring<F, 1>::kSmem, splits);
}

}  // namespace
}  // namespace prefill_wgmma
