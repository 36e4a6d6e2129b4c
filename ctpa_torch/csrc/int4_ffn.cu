// Fused int4 SwiGLU FFN: out = down(silu(x . Wg) * (x . Wu)) in one launch
// (and a fixed-order reduction), with gate/up (hidden/2, inter) and down
// (inter/2, hidden) stored as packed int4 with fp32 scales per (input group,
// output column) (ctpa's quantize_int4 layout, int4_common.cuh).
//
// Replaces the TPU kernels ctpa/ops/quant.py:int4_ffn, `_ffn_kernel_q4`
// (weight-only, "w4") and `_ffn_kernel_q4_a8` (int8 activations, "w4a8").
// The intermediate axis is cut into j-blocks of bj columns (ctpa's rule,
// ctpa_torch/ops/quant.py:ffn_block_j; 256 at Meditron-7B, 43 blocks):
//
//   w4:   dequantized weights rounded to bf16, g and u fp32, h = silu(g) u
//         rounded to bf16, the down product in fp32;
//   w4a8: x8, sx per row (ctpa's quantize_act_int8, computed by the caller
//         in plain PyTorch as ctpa computes it outside its Pallas kernel);
//         g and u as sums over the hidden scale groups of exact int32 dots
//         times sg / su, then times sx; h = silu(g) u in fp32, requantized
//         per row over the j-block's bj columns (sh = max|h| / 127); the
//         down product per down scale group as int32 dots times sd, summed,
//         then times sh.
//   Both: the j-blocks' down products summed in j order in fp32, as ctpa's
//   sequential j axis sums them, and rounded to bf16.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOPS int8) at
// Meditron-7B (hidden 4096, inter 11008): a decode step (m = 4 to 32 rows)
// is bound by the weight bytes, 67.6 MB of packed weights and 4.2 MB of
// scales, 21.4 us; at prefill (m = 2,048) the 554 GFLOP bound it, 0.56 ms in
// bf16 and 0.28 ms in int8.
//
// Design (simple and right first).  On the TPU the j grid axis runs in order
// and carries the down sum in VMEM; on the card blocks run in no order.  So
// each j-block belongs to a cluster of two blocks (BM rows each: 16 for
// m <= 16, else 64), grid (2 n_j, rows / BM): each computes g and u for one
// 128-column half of the j-block on the tensor cores (WMMA bf16 with fp32
// accumulators for w4; WMMA s8 x s8 -> s32 per scale group for w4a8, scaled
// per column into fp32 sums each thread owns), keeps its half of h in
// shared memory and takes the other half from the other block's shared
// memory (distributed shared memory); for w4a8 the two halves' row maxima
// meet the same way before h is requantized.  Each block then runs the down
// product for alternate 128-column chunks of the output.  h never leaves
// the chip.  The blocks write their j-block's fp32 partial (n_j, rows,
// hidden); a second kernel adds the partials in j order, so the result is
// deterministic.  At decode that is 2.8 MB (m = 4); at prefill it would be
// 1.4 GB for m = 2,048, so the caller cuts the rows into chunks whose
// partials stay under 1 GiB, one kernel pair per chunk
// (ctpa_torch/ops/quant.py:ffn_row_chunk) -- no atomics.  Weight tiles are
// unpacked 16 bytes a load into shared memory; the int8 tiles sit there as
// 16x16 slabs of 256 bytes so every fragment address is 32-byte aligned.
// At decode 86 blocks run (43 j-blocks), each reading 0.75 MB of weights:
// still short of 132 SMs, and the loads are not overlapped with the
// products; both are the next steps for speed.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "int4_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kJT = kWarps * 16;     // j columns per pass, 16 per warp
constexpr int kNC = kWarps * 16;     // down output columns per chunk, 16 per warp
constexpr int kSeg = kJT / 16;       // 16-byte segments per packed row of a tile
constexpr int kMaxG = 128;           // the largest scale group
constexpr int kBJ = 256;             // the widest j-block
constexpr int kLdX = kMaxG + 8;      // bf16 row strides
constexpr int kLdW = kJT + 8;
constexpr int kLdH = kBJ + 8;
constexpr int kLdC = kJT + 4;        // fp32 / int32 staging row stride

__device__ __forceinline__ float silu_mul(float g, float u) {
  const float sig = 1.f / (1.f + expf(-g));
  return __fmul_rn(__fmul_rn(g, sig), u);
}

__device__ __forceinline__ uint4 load_or_zero(const int8_t* p, bool in_range) {
  return in_range ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

struct Args {
  const void* x;         // (m, hidden) bf16 (w4) or int8 (w4a8), rows of this chunk
  const float* sx;       // (m,) w4a8 row scales
  const int8_t* wg;      // (hidden/2, inter)
  const float* sg;       // (hidden/gh, inter)
  const int8_t* wu;
  const float* su;
  const int8_t* wd;      // (inter/2, hidden)
  const float* sd;       // (inter/gi, hidden)
  float* partial;        // (n_j, ld_rows, hidden)
  int m, ld_rows, hidden, inter, gh, gi, bj;
};

// shared memory of the w4 form, in bytes: x [BM][kLdX], the gate and up
// tiles [kMaxG][kLdW] (reused for the fp32 staging of g and u and for the
// down tiles), h [BM][kLdH] bf16, two scale rows
template <int BM> struct W4Smem {
  static constexpr int x = 0;
  static constexpr int wg = x + BM * kLdX * 2;
  static constexpr int wu = wg + kMaxG * kLdW * 2;
  static constexpr int h = wu + kMaxG * kLdW * 2;
  static constexpr int sc = h + BM * kLdH * 2;
  static constexpr int bytes = sc + 2 * kJT * 4;
  static_assert(BM * kLdC * 4 <= kMaxG * kLdW * 2, "staging must fit a weight tile");
};

template <int BM>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads)
int4_ffn_w4_kernel(Args a) {
  using L = W4Smem<BM>;
  constexpr int kFr = BM / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem + L::x);
  __nv_bfloat16* wg_s = reinterpret_cast<__nv_bfloat16*>(smem + L::wg);
  __nv_bfloat16* wu_s = reinterpret_cast<__nv_bfloat16*>(smem + L::wu);
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem + L::h);
  float* sg_s = reinterpret_cast<float*>(smem + L::sc);
  float* su_s = sg_s + kJT;
  float* c_s = reinterpret_cast<float*>(smem + L::wg);    // staging, after a pass's loop

  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j = blockIdx.x / 2;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int j0 = j * a.bj;
  const int jend = min(j0 + a.bj, a.inter);     // the j-block's real columns [j0, jend)
  const int hg = a.gh / 2;

  // this block's half of the j-block: columns [p0, p0 + kJT) of it
  const int p0 = rank * kJT;
  if (p0 < a.bj) {
    const int c0 = j0 + p0;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_g[kFr], acc_u[kFr];
#pragma unroll
    for (int i = 0; i < kFr; ++i) {
      wmma::fill_fragment(acc_g[i], 0.f);
      wmma::fill_fragment(acc_u[i], 0.f);
    }
    for (int g = 0; g < a.hidden / a.gh; ++g) {
      const int cpr = a.gh / 8;
      for (int e = tid; e < BM * cpr; e += kThreads) {
        const int r = e / cpr;
        const int c = (e - r * cpr) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < a.m)
          v = *reinterpret_cast<const uint4*>(x + static_cast<long long>(m0 + r) * a.hidden +
                                              g * a.gh + c);
        *reinterpret_cast<uint4*>(x_s + r * kLdX + c) = v;
      }
      for (int c = tid; c < kJT; c += kThreads) {
        const bool in = c0 + c < jend;
        const long long o = static_cast<long long>(g) * a.inter + c0 + c;
        sg_s[c] = in ? a.sg[o] : 0.f;
        su_s[c] = in ? a.su[o] : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < 2 * hg * kSeg; e += kThreads) {
        const int mat = e / (hg * kSeg);
        const int rem = e - mat * hg * kSeg;
        const int jj = rem / kSeg;
        const int c = (rem - jj * kSeg) * 16;
        const int8_t* src = (mat ? a.wu : a.wg) + static_cast<long long>(g * hg + jj) * a.inter;
        const uint4 v = load_or_zero(src + c0 + c, c0 + c < jend);
        __nv_bfloat16* dst = mat ? wu_s : wg_s;
        const float* s = (mat ? su_s : sg_s) + c;
        q4::store_dequant(dst + jj * kLdW + c, v, false, s);
        q4::store_dequant(dst + (jj + hg) * kLdW + c, v, true, s);
      }
      __syncthreads();
      for (int k0 = 0; k0 < a.gh; k0 += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bg, bu;
        wmma::load_matrix_sync(bg, wg_s + k0 * kLdW + warp * 16, kLdW);
        wmma::load_matrix_sync(bu, wu_s + k0 * kLdW + warp * 16, kLdW);
#pragma unroll
        for (int i = 0; i < kFr; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::load_matrix_sync(af, x_s + i * 16 * kLdX + k0, kLdX);
          wmma::mma_sync(acc_g[i], af, bg, acc_g[i]);
          wmma::mma_sync(acc_u[i], af, bu, acc_u[i]);
        }
      }
      __syncthreads();
    }
    // h = silu(g) u: the g and u fragments share one element layout
#pragma unroll
    for (int i = 0; i < kFr; ++i) {
      for (int t = 0; t < acc_g[i].num_elements; ++t)
        acc_g[i].x[t] = silu_mul(acc_g[i].x[t], acc_u[i].x[t]);
      wmma::store_matrix_sync(c_s + i * 16 * kLdC + warp * 16, acc_g[i], kLdC,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = tid; e < BM * kJT; e += kThreads) {
      const int r = e / kJT;
      const int c = e - r * kJT;
      h_s[r * kLdH + p0 + c] = __float2bfloat16_rn(c_s[r * kLdC + c]);
    }
  }
  // the other half of h, from the other block's shared memory
  cluster.sync();
  const int q0 = (rank ^ 1) * kJT;
  if (q0 < a.bj) {
    const __nv_bfloat16* other = cluster.map_shared_rank(h_s, rank ^ 1);
    for (int e = tid; e < BM * kJT / 8; e += kThreads) {
      const int r = e / (kJT / 8);
      const int c = q0 + (e - r * (kJT / 8)) * 8;
      *reinterpret_cast<uint4*>(h_s + r * kLdH + c) =
          *reinterpret_cast<const uint4*>(other + r * kLdH + c);
    }
  }
  cluster.sync();

  // down: h (BM, bj) against the j-block's bj rows of Wd, 128 columns a
  // chunk, the two blocks taking alternate chunks
  __nv_bfloat16* wd_s = wg_s;
  float* o_s = reinterpret_cast<float*>(smem + L::wu);
  float* sd_s = sg_s;
  const int hgi = a.gi / 2;
  for (int o0 = rank * kNC; o0 < a.hidden; o0 += 2 * kNC) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFr];
#pragma unroll
    for (int i = 0; i < kFr; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int q = 0; q < a.bj / a.gi; ++q) {
      const int r0 = j0 + q * a.gi;           // the group's first intermediate row
      if (r0 >= a.inter) break;               // a pad group: h and the weights are 0
      for (int c = tid; c < kNC; c += kThreads)
        sd_s[c] = o0 + c < a.hidden ? a.sd[static_cast<long long>(r0 / a.gi) * a.hidden + o0 + c]
                                    : 0.f;
      __syncthreads();
      for (int e = tid; e < hgi * kSeg; e += kThreads) {
        const int jj = e / kSeg;
        const int c = (e - jj * kSeg) * 16;
        const uint4 v = load_or_zero(
            a.wd + static_cast<long long>(r0 / 2 + jj) * a.hidden + o0 + c, o0 + c < a.hidden);
        q4::store_dequant(wd_s + jj * kLdW + c, v, false, sd_s + c);
        q4::store_dequant(wd_s + (jj + hgi) * kLdW + c, v, true, sd_s + c);
      }
      __syncthreads();
      for (int k0 = 0; k0 < a.gi; k0 += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, wd_s + k0 * kLdW + warp * 16, kLdW);
#pragma unroll
        for (int i = 0; i < kFr; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
          wmma::load_matrix_sync(af, h_s + i * 16 * kLdH + q * a.gi + k0, kLdH);
          wmma::mma_sync(acc[i], af, bf, acc[i]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kFr; ++i)
      wmma::store_matrix_sync(o_s + i * 16 * kLdC + warp * 16, acc[i], kLdC, wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < BM * kNC; e += kThreads) {
      const int r = e / kNC;
      const int c = e - r * kNC;
      if (o0 + c < a.hidden)
        a.partial[(static_cast<long long>(j) * a.ld_rows + m0 + r) * a.hidden + o0 + c] =
            o_s[r * kLdC + c];
    }
    __syncthreads();
  }
}

// shared memory of the w4a8 form, in bytes: int8 slabs of x [kMaxG/16][BM][16]
// and of the gate and up tiles [kJT/16][kMaxG][16] (the up tile's region
// also holds the down tiles), int32 staging of g and u [BM][kLdC], h in fp32
// [BM][kBJ], h in int8 slabs [kBJ/16][BM][16], the scale rows, sx, sh and
// the row maxima of this block's half of h
template <int BM> struct A8Smem {
  static constexpr int x = 0;
  static constexpr int wg = x + BM * kMaxG;
  static constexpr int wu = wg + kJT * kMaxG;
  static constexpr int ig = wu + kJT * kMaxG;
  static constexpr int iu = ig + BM * kLdC * 4;
  static constexpr int hf = iu + BM * kLdC * 4;
  static constexpr int h8 = hf + BM * kBJ * 4;
  static constexpr int sc = h8 + BM * kBJ;
  static constexpr int bytes = sc + (2 * kJT + 3 * BM) * 4;
};

template <int BM>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads)
int4_ffn_a8_kernel(Args a) {
  using L = A8Smem<BM>;
  constexpr int kFr = BM / 16;
  constexpr int kPer = BM * kJT / kThreads;   // fp32 sums a thread owns (kJT == kNC)
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* x_s = reinterpret_cast<int8_t*>(smem + L::x);
  int8_t* wg_s = reinterpret_cast<int8_t*>(smem + L::wg);
  int8_t* wu_s = reinterpret_cast<int8_t*>(smem + L::wu);
  int* ig_s = reinterpret_cast<int*>(smem + L::ig);
  int* iu_s = reinterpret_cast<int*>(smem + L::iu);
  float* hf_s = reinterpret_cast<float*>(smem + L::hf);
  int8_t* h8_s = reinterpret_cast<int8_t*>(smem + L::h8);
  float* sg_s = reinterpret_cast<float*>(smem + L::sc);
  float* su_s = sg_s + kJT;
  float* sx_s = su_s + kJT;
  float* sh_s = sx_s + BM;
  float* rmax_s = sh_s + BM;

  const int8_t* x8 = static_cast<const int8_t*>(a.x);
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int j = blockIdx.x / 2;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int j0 = j * a.bj;
  const int jend = min(j0 + a.bj, a.inter);
  const int hg = a.gh / 2;

  for (int r = tid; r < BM; r += kThreads) sx_s[r] = m0 + r < a.m ? a.sx[m0 + r] : 0.f;

  // this block's half of the j-block: columns [p0, p0 + kJT) of it
  const int p0 = rank * kJT;
  if (p0 < a.bj) {
    const int c0 = j0 + p0;
    float acc_g[kPer], acc_u[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) acc_g[t] = acc_u[t] = 0.f;
    for (int g = 0; g < a.hidden / a.gh; ++g) {
      const int spr = a.gh / 16;
      for (int e = tid; e < BM * spr; e += kThreads) {
        const int r = e / spr;
        const int kb = e - r * spr;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < a.m)
          v = *reinterpret_cast<const uint4*>(x8 + static_cast<long long>(m0 + r) * a.hidden +
                                              g * a.gh + kb * 16);
        *reinterpret_cast<uint4*>(x_s + (kb * BM + r) * 16) = v;
      }
      for (int c = tid; c < kJT; c += kThreads) {
        const bool in = c0 + c < jend;
        const long long o = static_cast<long long>(g) * a.inter + c0 + c;
        sg_s[c] = in ? a.sg[o] : 0.f;
        su_s[c] = in ? a.su[o] : 0.f;
      }
      for (int e = tid; e < 2 * hg * kSeg; e += kThreads) {
        const int mat = e / (hg * kSeg);
        const int rem = e - mat * hg * kSeg;
        const int jj = rem / kSeg;
        const int cb = rem - jj * kSeg;
        const int8_t* src = (mat ? a.wu : a.wg) + static_cast<long long>(g * hg + jj) * a.inter;
        const uint4 v = load_or_zero(src + c0 + cb * 16, c0 + cb * 16 < jend);
        int8_t* dst = mat ? wu_s : wg_s;
        *reinterpret_cast<uint4*>(dst + (cb * kMaxG + jj) * 16) = q4::unpack16(v, false);
        *reinterpret_cast<uint4*>(dst + (cb * kMaxG + jj + hg) * 16) = q4::unpack16(v, true);
      }
      __syncthreads();
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> fg[kFr], fu[kFr];
#pragma unroll
      for (int i = 0; i < kFr; ++i) {
        wmma::fill_fragment(fg[i], 0);
        wmma::fill_fragment(fu[i], 0);
      }
      for (int kk = 0; kk < a.gh / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bg, bu;
        wmma::load_matrix_sync(bg, reinterpret_cast<const signed char*>(
                                       wg_s + (warp * kMaxG + kk * 16) * 16), 16);
        wmma::load_matrix_sync(bu, reinterpret_cast<const signed char*>(
                                       wu_s + (warp * kMaxG + kk * 16) * 16), 16);
#pragma unroll
        for (int i = 0; i < kFr; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af;
          wmma::load_matrix_sync(af, reinterpret_cast<const signed char*>(
                                         x_s + (kk * BM + i * 16) * 16), 16);
          wmma::mma_sync(fg[i], af, bg, fg[i]);
          wmma::mma_sync(fu[i], af, bu, fu[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kFr; ++i) {
        wmma::store_matrix_sync(ig_s + i * 16 * kLdC + warp * 16, fg[i], kLdC,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(iu_s + i * 16 * kLdC + warp * 16, fu[i], kLdC,
                                wmma::mem_row_major);
      }
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int e = tid + t * kThreads;
        const int r = e / kJT;
        const int c = e - r * kJT;
        acc_g[t] = __fadd_rn(acc_g[t], __fmul_rn(static_cast<float>(ig_s[r * kLdC + c]), sg_s[c]));
        acc_u[t] = __fadd_rn(acc_u[t], __fmul_rn(static_cast<float>(iu_s[r * kLdC + c]), su_s[c]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int e = tid + t * kThreads;
      const int r = e / kJT;
      const int c = e - r * kJT;
      if (p0 + c < kBJ)
        hf_s[r * kBJ + p0 + c] = silu_mul(__fmul_rn(acc_g[t], sx_s[r]),
                                          __fmul_rn(acc_u[t], sx_s[r]));
    }
  }
  __syncthreads();

  // requantize h per row over the j-block's bj columns (the pad columns are
  // 0): the row maximum of |h| over this block's columns, then over both
  const int pend = min(p0 + kJT, a.bj);
  for (int r = warp; r < BM; r += kWarps) {
    float mx = 0.f;
    for (int c = p0 + lane; c < pend; c += 32) mx = fmaxf(mx, fabsf(hf_s[r * kBJ + c]));
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) rmax_s[r] = mx;
  }
  cluster.sync();
  const float* other_max = cluster.map_shared_rank(rmax_s, rank ^ 1);
  for (int r = tid; r < BM; r += kThreads)
    sh_s[r] = fmaxf(fmaxf(rmax_s[r], other_max[r]) / 127.f, 1e-12f);
  __syncthreads();
  for (int e = tid; e < BM * kJT; e += kThreads) {
    const int r = e / kJT;
    const int c = p0 + e - r * kJT;
    if (c >= a.bj) continue;
    const int q = min(127, max(-127, __float2int_rn(hf_s[r * kBJ + c] / sh_s[r])));
    h8_s[((c / 16) * BM + r) * 16 + c % 16] = static_cast<int8_t>(q);
  }
  // the other half's int8 h: its kJT / 16 slabs, contiguous
  cluster.sync();
  const int q0 = (rank ^ 1) * kJT;
  if (q0 < a.bj) {
    const uint4* other = reinterpret_cast<const uint4*>(
        cluster.map_shared_rank(h8_s, rank ^ 1) + (q0 / 16) * BM * 16);
    uint4* mine = reinterpret_cast<uint4*>(h8_s + (q0 / 16) * BM * 16);
    for (int e = tid; e < BM * kJT / 16; e += kThreads) mine[e] = other[e];
  }
  cluster.sync();

  // down: per down group, int32 dots times sd; the sum times sh
  int8_t* wd_s = wu_s;
  int* id_s = ig_s;
  float* sd_s = sg_s;
  const int hgi = a.gi / 2;
  for (int o0 = rank * kNC; o0 < a.hidden; o0 += 2 * kNC) {
    float acc[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) acc[t] = 0.f;
    for (int q = 0; q < a.bj / a.gi; ++q) {
      const int r0 = j0 + q * a.gi;
      if (r0 >= a.inter) break;               // a pad group: h and the weights are 0
      for (int c = tid; c < kNC; c += kThreads)
        sd_s[c] = o0 + c < a.hidden ? a.sd[static_cast<long long>(r0 / a.gi) * a.hidden + o0 + c]
                                    : 0.f;
      for (int e = tid; e < hgi * kSeg; e += kThreads) {
        const int jj = e / kSeg;
        const int cb = e - jj * kSeg;
        const uint4 v = load_or_zero(
            a.wd + static_cast<long long>(r0 / 2 + jj) * a.hidden + o0 + cb * 16,
            o0 + cb * 16 < a.hidden);
        *reinterpret_cast<uint4*>(wd_s + (cb * kMaxG + jj) * 16) = q4::unpack16(v, false);
        *reinterpret_cast<uint4*>(wd_s + (cb * kMaxG + jj + hgi) * 16) = q4::unpack16(v, true);
      }
      __syncthreads();
      wmma::fragment<wmma::accumulator, 16, 16, 16, int> fd[kFr];
#pragma unroll
      for (int i = 0; i < kFr; ++i) wmma::fill_fragment(fd[i], 0);
      for (int kk = 0; kk < a.gi / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, reinterpret_cast<const signed char*>(
                                       wd_s + (warp * kMaxG + kk * 16) * 16), 16);
#pragma unroll
        for (int i = 0; i < kFr; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af;
          wmma::load_matrix_sync(af, reinterpret_cast<const signed char*>(
                                         h8_s + ((q * a.gi / 16 + kk) * BM + i * 16) * 16), 16);
          wmma::mma_sync(fd[i], af, bf, fd[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kFr; ++i)
        wmma::store_matrix_sync(id_s + i * 16 * kLdC + warp * 16, fd[i], kLdC,
                                wmma::mem_row_major);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int e = tid + t * kThreads;
        const int r = e / kNC;
        const int c = e - r * kNC;
        acc[t] = __fadd_rn(acc[t], __fmul_rn(static_cast<float>(id_s[r * kLdC + c]), sd_s[c]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int e = tid + t * kThreads;
      const int r = e / kNC;
      const int c = e - r * kNC;
      if (o0 + c < a.hidden)
        a.partial[(static_cast<long long>(j) * a.ld_rows + m0 + r) * a.hidden + o0 + c] =
            __fmul_rn(acc[t], sh_s[r]);
    }
  }
}

template <int BM>
cudaError_t launch_rows(const Args& a, int n_j, bool a8, cudaStream_t stream) {
  const dim3 grid(2 * n_j, (a.m + BM - 1) / BM);       // clusters of two blocks a j-block
  cudaError_t err;
  if (a8) {
    err = cudaFuncSetAttribute(int4_ffn_a8_kernel<BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, A8Smem<BM>::bytes);
    if (err != cudaSuccess) return err;
    int4_ffn_a8_kernel<BM><<<grid, kThreads, A8Smem<BM>::bytes, stream>>>(a);
  } else {
    err = cudaFuncSetAttribute(int4_ffn_w4_kernel<BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, W4Smem<BM>::bytes);
    if (err != cudaSuccess) return err;
    int4_ffn_w4_kernel<BM><<<grid, kThreads, W4Smem<BM>::bytes, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches the fused kernel and the reduction on `stream` for one chunk of
// m rows; returns the first CUDA error (0 when both launches were accepted).
// x is bf16 (w4) or int8 with sx (w4a8), (m, hidden); out (m, hidden) bf16;
// partial (n_j, ld_rows, hidden) fp32 scratch with ld_rows >= m rounded up
// to 64 (16 when m <= 16).  The caller has checked the shapes and dtypes,
// and that every buffer is contiguous and 16-byte aligned.
extern "C" int int4_ffn_launch(const void* x, const void* sx, const void* wg, const void* sg,
                               const void* wu, const void* su, const void* wd, const void* sd,
                               void* out, void* partial, int m, int ld_rows, int hidden,
                               int inter, int gh, int gi, int bj, int act_quant, void* stream) {
  const auto group_ok = [](int g) { return g == 32 || g == 64 || g == 128; };
  const int tile = m <= 16 ? 16 : 64;
  if (!group_ok(gh) || !group_ok(gi) || m <= 0 || hidden % gh != 0 || inter % gi != 0 ||
      bj % gi != 0 || bj > kBJ || bj <= 0 || ld_rows < (m + tile - 1) / tile * tile ||
      (act_quant && sx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, static_cast<const float*>(sx), static_cast<const int8_t*>(wg),
               static_cast<const float*>(sg), static_cast<const int8_t*>(wu),
               static_cast<const float*>(su), static_cast<const int8_t*>(wd),
               static_cast<const float*>(sd), static_cast<float*>(partial),
               m, ld_rows, hidden, inter, gh, gi, bj};
  const int n_j = (inter + bj - 1) / bj;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = m <= 16 ? launch_rows<16>(a, n_j, act_quant != 0, s)
                                  : launch_rows<64>(a, n_j, act_quant != 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(q4::reduce_partials(static_cast<const float*>(partial), n_j, ld_rows,
                                                nullptr, nullptr, static_cast<__nv_bfloat16*>(out),
                                                m, hidden, s));
}
