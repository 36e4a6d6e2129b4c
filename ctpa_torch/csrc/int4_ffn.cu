// Fused int4 SwiGLU FFN: out = down(silu(x . Wg) * (x . Wu)), with gate/up
// (hidden/2, inter) and down (inter/2, hidden) stored as packed int4 with
// fp32 scales per (input group, output column) (ctpa's quantize_int4
// layout, int4_common.cuh).
//
// Replaces the TPU kernels ctpa/ops/quant.py:int4_ffn, `_ffn_kernel_q4`
// (weight-only, "w4") and `_ffn_kernel_q4_a8` (int8 activations, "w4a8").
// The intermediate axis is cut into j-blocks of bj columns (ctpa's rule,
// ctpa_torch/ops/quant.py:ffn_block_j; 256 at Meditron-7B, 43 blocks):
//
//   w4:   dequantized weights rounded to bf16, g and u fp32, h = silu(g) u
//         rounded to bf16, the down product in fp32;
//   w4a8: x8, sx per row (ctpa's quantize_act_int8; ctpa computes it
//         outside its Pallas kernel, the port in one launch of
//         int4_matmul.cu's quantize_act_int8_kernel, with its bits);
//         g and u as sums over the hidden scale groups of exact int32 dots
//         times sg / su, then times sx; h = silu(g) u in fp32, requantized
//         per row over the j-block's bj columns (sh = max|h| / 127); the
//         down product per down scale group as int32 dots times sd, summed,
//         then times sh.
//   Both: the j-blocks' down products summed in j order in fp32, as ctpa's
//   sequential j axis sums them (at decode in the fixed order below), and
//   rounded to bf16.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOPS int8) at
// Meditron-7B (hidden 4096, inter 11008): a decode step (m = 4 to 32 rows)
// is bound by the weight bytes: gate and up 45.1 MB packed and 2.8 MB of
// scales, 14.3 us; down 22.5 MB and 1.4 MB, 7.1 us; 21.5 us for the FFN.  At
// prefill (m = 2,048) the 554 GFLOP bound it, 0.56 ms in bf16 and 0.28 ms in
// int8.
//
// Two designs; ops/quant.py:int4_ffn_plan picks one by the row count m.
//
// Decode (m <= 32): weight streaming on mma.sync, two launches, K6's decode
// design (int8_ffn.cu) on K5's int4 registers (int4_matmul.cu), with the
// helpers they share (stream_common.cuh).
//   Gate/up (`int4_ffn_gateup_stream_kernel`, 16 warps): a block owns one
//   j-block of both gate and up (warps 0-7 gate's 256-column window, 8-15
//   up's, 32 columns a warp) and a split of the hidden scale groups, whole
//   groups.  A ring stage is one group: its packed rows of both windows,
//   their scale rows and x's rows over the group, by 16-byte cp.async, four
//   stages deep; a group's w4a8 int32 dot is complete inside its stage
//   before it is scaled.
//   Down (`int4_ffn_down_stream_kernel`, 8 warps): a block owns 128 output
//   columns and a split of whole j-blocks, walked in j order, two down scale
//   groups a ring stage, one for each set of 4 warps (the sets' sums added
//   at the end, set 0's plus set 1's); w4a8 scales each group's exact dot by
//   sd, then by the row's sh of its j-block.
//   The splits of a j-block (gate/up) or column strip (down) run as one
//   thread-block cluster, as many (at most 8) as let every cluster run at
//   once (ops/quant.py asks the card's cluster occupancy).  Each block keeps
//   its split's sums in its shared memory; block z of the cluster finishes
//   rows z, z + splits, ..., adding the splits' sums in split order through
//   distributed shared memory, so no partial leaves the chip, no atomics,
//   the same bits on every call.  Gate/up then writes h to device memory
//   (bf16, or for w4a8 its int8 form per row over exactly the j-block's bj
//   columns and sh; 88 KB or 44 KB at m = 4, read back from L2).
//
// Prefill (simple and right first).  On the TPU the j grid axis runs in order
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
// deterministic.  At prefill the partials would be 1.4 GB for m = 2,048, so
// the caller cuts the rows into chunks whose partials stay under 1 GiB, one
// kernel pair per chunk (ctpa_torch/ops/quant.py:ffn_row_chunk) -- no
// atomics.  Weight tiles are unpacked 16 bytes a load into shared memory;
// the int8 tiles sit there as 16x16 slabs of 256 bytes so every fragment
// address is 32-byte aligned.  The loads are not overlapped with the
// products.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "int4_common.cuh"
#include "stream_common.cuh"
#include "warp_mma.cuh"

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

// ------------------------------------------------------------ decode: streaming

constexpr int kSStages = 4;          // ring depth
constexpr int kGuWarps = 16;         // gate/up: warps 0-7 the gate window, 8-15 the up one
constexpr int kGuThreads = 32 * kGuWarps;
constexpr int kDnBN = 128;           // down: a block owns 128 output columns, 32 a warp,
constexpr int kDnSets = 2;           // in two sets of 4 warps, each one group of a stage
constexpr int kDnThreads = 32 * 4 * kDnSets;
using wstream::kMaxSplits;
static_assert(kGuThreads == 2 * kBJ, "a gate/up warp owns 32 columns of one matrix");
static_assert(kDnThreads == kDnSets * kDnBN, "down threads finish kDnSets rows at once");

struct StreamArgs {
  const void* x;          // (m, hidden) bf16 (w4) or int8 with sx (w4a8)
  const float* sx;        // (m,)
  const int8_t* wg;       // (hidden/2, inter) packed
  const float* sg;        // (hidden/gh, inter)
  const int8_t* wu;
  const float* su;
  const int8_t* wd;       // (inter/2, hidden) packed
  const float* sd;        // (inter/gi, hidden)
  __nv_bfloat16* out;     // (m, hidden)
  void* h;                // (m, ld_h): bf16 (w4) or int8 (w4a8), ld_h = n_j bj, 0 past inter
  float* sh;              // (m, n_j) w4a8 row scales of h per j-block
  int m, hidden, inter, bj, n_j, ld_h, gu_per, dn_per;
};

// A ring stage of the gate/up kernel, one hidden scale group of G rows: its
// G/2 packed rows of the 256-column window of gate, then of up (kLdW bytes a
// row), their scale rows (256 fp32 each), then x's NT * 8 rows over the
// group's G columns.  A w4 k-step reads packed rows 8s + t, a w4a8 one rows
// 16s + 2t (t = lane % 4), 32 bytes each: kLdW of 288 or 272 bytes puts
// them on distinct banks.  The block's sums ([2][m][256] fp32) reuse the
// ring once it is drained.
template <int G, int NT, bool A8>
struct GuStage {
  static constexpr int kLdW = kBJ + (A8 ? 16 : 32);
  static constexpr int kXB = A8 ? 1 : 2;
  static constexpr int kLdX = G * kXB + 16;
  static constexpr int kW = G / 2 * kLdW;
  static constexpr int kS = kBJ * 4;
  static constexpr int kStage = 2 * kW + 2 * kS + NT * 8 * kLdX;
  static constexpr int kSums = 2 * NT * 8 * kBJ * 4;
  static constexpr int kSmem = kSStages * kStage > kSums ? kSStages * kStage : kSums;
  static_assert(kW % 16 == 0 && kStage % 16 == 0, "16-byte aligned copies");
};

// A ring stage of the down kernel: two down scale groups (one a warp set),
// each its G/2 packed rows of the block's 128 columns, their scale row and
// h's NT * 8 rows over the group's G columns.
template <int G, int NT, bool A8>
struct DnStage {
  static constexpr int kLdW = kDnBN + (A8 ? 16 : 32);
  static constexpr int kXB = A8 ? 1 : 2;
  static constexpr int kLdX = G * kXB + 16;
  static constexpr int kW = G / 2 * kLdW;
  static constexpr int kS = kDnBN * 4;
  static constexpr int kSlot = kW + kS + NT * 8 * kLdX;
  static constexpr int kStage = kDnSets * kSlot;
  static constexpr int kSums = 2 * kDnBN * 8 * NT * 4;
  static constexpr int kSmem = kSStages * kStage > kSums ? kSStages * kStage : kSums;
  static_assert(kW % 16 == 0 && kSlot % 16 == 0, "16-byte aligned copies");
};

extern __shared__ __align__(16) unsigned char smem_stream4[];

// grid (n_j, splits) in clusters of (1, splits, 1); block kGuThreads;
// dynamic shared memory GuStage<G, NT, A8>::kSmem.  Block (jb, z) owns
// j-block jb (inter columns [bj jb, bj jb + bj); the 256-column window from
// bj jb, whose columns past the j-block it computes and drops) of both gate
// and up and the hidden scale groups [z gu_per, (z + 1) gu_per); warp w
// owns 32 columns of gate (w < 8) or up.  w4: fp32 sums of x times bf16(q
// s); w4a8: each group's exact int32 dot times its scale row, summed over
// the groups in order.  Its sums stay in its shared memory; once the
// cluster holds them all, block z finishes the j-block's rows z, z +
// splits, ... (256 threads a row, two rows at once), one column a thread:
// g and u add the splits' sums in split order (distributed shared memory);
// w4 writes h = bf16(silu(g) u); w4a8 h = silu(g sx) (u sx), then its int8
// form over the row's bj columns and the row scale sh.
template <int G, int NT, bool A8>
__global__ void __launch_bounds__(kGuThreads, 1) int4_ffn_gateup_stream_kernel(const StreamArgs a) {
  using S = GuStage<G, NT, A8>;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int mat = warp >> 3;         // 0 gate, 1 up
  const int wc = warp & 7;           // its 32 columns of the window
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int jb = blockIdx.x;
  const int j0 = jb * a.bj;
  const int groups = a.hidden / G;
  const int g0 = blockIdx.y * a.gu_per;
  const int cnt = min(groups, g0 + a.gu_per) - g0;

  auto fetch = [&](int slot, int grp) {
    unsigned char* st = smem_stream4 + slot * S::kStage;
    const int r0 = grp * (G / 2);
    wstream::stage_weights<kBJ, S::kLdW, kGuThreads, G / 2>(st, a.wg, r0, a.hidden / 2, j0,
                                                            a.inter, true);
    wstream::stage_weights<kBJ, S::kLdW, kGuThreads, G / 2>(st + S::kW, a.wu, r0, a.hidden / 2,
                                                            j0, a.inter, true);
    for (int e = tid; e < 2 * kBJ / 4; e += kGuThreads) {
      const int m2 = e / (kBJ / 4);
      const int col = j0 + 4 * (e - m2 * (kBJ / 4));
      const bool ok = col < a.inter;
      const float* src = (m2 ? a.su : a.sg) + static_cast<long long>(grp) * a.inter + col;
      warp_mma::cp_async16(st + 2 * S::kW + m2 * S::kS + (col - j0) * 4, ok ? src : a.sg,
                           ok ? 16 : 0);
    }
    wstream::stage_tokens<NT, S::kXB, S::kLdX, kGuThreads, G>(st + 2 * S::kW + 2 * S::kS, a.x,
                                                             a.m, a.hidden, grp * G);
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kSStages - 1; ++s) {
    if (s < cnt) fetch(s, g0 + s);
    warp_mma::cp_async_commit();
  }
  for (int it = 0; it < cnt; ++it) {
    warp_mma::cp_async_wait<kSStages - 2>();   // group g0 + it is in
    __syncthreads();                           // and every warp is done with slot it - 1
    if (it + kSStages - 1 < cnt) fetch((it + kSStages - 1) % kSStages, g0 + it + kSStages - 1);
    warp_mma::cp_async_commit();
    const unsigned char* st = smem_stream4 + (it % kSStages) * S::kStage;
    const float4 sc4 = *reinterpret_cast<const float4*>(st + 2 * S::kW + mat * S::kS +
                                                        (32 * wc + 4 * g) * 4);
    const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
    wstream::int4_group_products<G, NT, A8, 1, S::kLdW, S::kLdX>(
        acc, st + mat * S::kW + 32 * wc + 4 * g, sc, st + 2 * S::kW + 2 * S::kS + g * S::kLdX, t,
        0);
  }

  // this block's sums into its shared memory, [mat][tok][256]
  __syncthreads();   // every warp is done with the ring
  float* part = reinterpret_cast<float*>(smem_stream4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * nt + 2 * t + (e & 1);
        if (tok < a.m)
          part[(mat * a.m + tok) * kBJ + 32 * wc + 4 * g + 2 * i + (e >> 1)] = acc[i][nt][e];
      }
  const cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();

  // rows tok0 + splits * sub: thread tid their column j0 + tid % 256 (h 0
  // past inter; a column past the j-block is the next j-block's, not written)
  const int cl = tid & (kBJ - 1);
  const int sub = tid / kBJ;
  const bool real = cl < a.bj;
  const bool live = real && j0 + cl < a.inter;
  __shared__ float red[2][kBJ / 32];
  for (int tok0 = rank; tok0 < a.m; tok0 += 2 * splits) {
    const int tok = tok0 + splits * sub;
    const bool row = tok < a.m;
    float h = 0.f;
    if (row && live) {
      float gv = wstream::split_sum(cluster, part, tok * kBJ + cl, splits);
      float uv = wstream::split_sum(cluster, part, (a.m + tok) * kBJ + cl, splits);
      if constexpr (A8) {
        gv = __fmul_rn(gv, a.sx[tok]);
        uv = __fmul_rn(uv, a.sx[tok]);
      }
      h = silu_mul(gv, uv);
    }
    const long long o = static_cast<long long>(tok) * a.ld_h + j0 + cl;
    if constexpr (!A8) {
      if (row && real) static_cast<__nv_bfloat16*>(a.h)[o] = __float2bfloat16_rn(h);
    } else {
      // requantize the row over the j-block's bj columns (pad columns 0)
      float mx = fabsf(h);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) red[sub][warp & 7] = mx;
      __syncthreads();
      mx = red[sub][0];
#pragma unroll
      for (int w = 1; w < kBJ / 32; ++w) mx = fmaxf(mx, red[sub][w]);
      const float sh = fmaxf(mx / 127.f, 1e-12f);
      const int q = min(127, max(-127, __float2int_rn(h / sh)));
      if (row && real) static_cast<int8_t*>(a.h)[o] = static_cast<int8_t>(q);
      if (row && cl == 0) a.sh[tok * a.n_j + jb] = sh;
      __syncthreads();   // red is the next rows'
    }
  }
  cluster.sync();   // the other blocks read this block's sums until here
}

// grid (ceil(hidden / 128), splits) in clusters of (1, splits, 1); block
// kDnThreads; dynamic shared memory DnStage<G, NT, A8>::kSmem.  Block (x, z)
// owns output columns [128 x, 128 x + 128) and the j-blocks [z dn_per,
// (z + 1) dn_per), whose down scale groups (bj / G a j-block, those past
// inter left out) it walks in order, two a ring stage: set s of warps (w /
// 4) takes group s of each stage, warp w % 4 its 32 columns.  w4: h times
// bf16(q sd) in fp32; w4a8: each group's exact int32 dot h8 . q times sd,
// times the row's sh of the group's j-block, added in fp32.  The sets' sums
// are added (set 0's plus set 1's) and stay in the block's shared memory;
// block z then finishes rows z, z + splits, ..., one column a thread: the
// splits' sums added in split order (distributed shared memory), rounded to
// bf16.
template <int G, int NT, bool A8>
__global__ void __launch_bounds__(kDnThreads, 2) int4_ffn_down_stream_kernel(const StreamArgs a) {
  using S = DnStage<G, NT, A8>;
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3;   // its 32 columns
  const int set = tid >> 7;          // its group of each stage
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kDnBN;
  const int per_j = a.bj / G;                                  // down groups a j-block
  const int q0 = blockIdx.y * a.dn_per * per_j;                // the split's first group
  const int q1 = min(min(a.n_j, (static_cast<int>(blockIdx.y) + 1) * a.dn_per) * per_j,
                     a.inter / G);                             // past its last real one
  const int cnt = (q1 - q0 + kDnSets - 1) / kDnSets;

  auto fetch = [&](int slot, int ch) {
    unsigned char* st = smem_stream4 + slot * S::kStage;
#pragma unroll
    for (int s = 0; s < kDnSets; ++s) {
      const int q = q0 + kDnSets * ch + s;   // past q1: zero weights and scales
      unsigned char* sl = st + s * S::kSlot;
      wstream::stage_weights<kDnBN, S::kLdW, kDnThreads, G / 2>(sl, a.wd, q * (G / 2),
                                                                q1 * (G / 2), n0, a.hidden, true);
      if (tid < kDnBN / 4) {
        const bool ok = q < q1 && n0 + 4 * tid < a.hidden;
        warp_mma::cp_async16(sl + S::kW + 16 * tid,
                             ok ? a.sd + static_cast<long long>(q) * a.hidden + n0 + 4 * tid
                                : a.sd, ok ? 16 : 0);
      }
      wstream::stage_tokens<NT, S::kXB, S::kLdX, kDnThreads, G>(sl + S::kW + S::kS, a.h, a.m,
                                                               a.ld_h, q * G);
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kSStages - 1; ++s) {
    if (s < cnt) fetch(s, s);
    warp_mma::cp_async_commit();
  }
  for (int it = 0; it < cnt; ++it) {
    warp_mma::cp_async_wait<kSStages - 2>();
    __syncthreads();
    if (it + kSStages - 1 < cnt) fetch((it + kSStages - 1) % kSStages, it + kSStages - 1);
    warp_mma::cp_async_commit();
    const unsigned char* sl = smem_stream4 + (it % kSStages) * S::kStage + set * S::kSlot;
    const float4 sc4 = *reinterpret_cast<const float4*>(sl + S::kW + (32 * warp + 4 * g) * 4);
    const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
    const unsigned char* wl = sl + 32 * warp + 4 * g;
    const unsigned char* xs = sl + S::kW + S::kS + g * S::kLdX;
    if constexpr (A8) {
      const int q = q0 + kDnSets * it + set;
      const int jb = q * G / a.bj;
      float rs[2 * NT];
#pragma unroll
      for (int r = 0; r < 2 * NT; ++r) {
        const int tok = 8 * (r >> 1) + 2 * t + (r & 1);
        rs[r] = q < q1 && tok < a.m ? a.sh[tok * a.n_j + jb] : 0.f;
      }
      int ci[2][NT][4] = {};
      wstream::int4_a8_dot<G, NT, S::kLdW, S::kLdX>(ci, wl, xs, t);
      wstream::int4_a8_flush<NT, true>(acc, ci, sc, rs);
    } else {
      wstream::int4_w4_products<G, NT, 1, S::kLdW, S::kLdX>(acc, wl, sc, xs, t, 0);
    }
  }

  // set 1's sums through shared memory, added to set 0's; the block's sums
  // then in its shared memory, [tok][128], after set 1's
  __syncthreads();   // every warp is done with the ring
  float* other = reinterpret_cast<float*>(smem_stream4) + (warp * 32 + lane) * (8 * NT);
  float* part = reinterpret_cast<float*>(smem_stream4) + kDnBN * 8 * NT;
  if (set == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) other[(i * NT + nt) * 4 + e] = acc[i][nt][e];
  }
  __syncthreads();
  if (set == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = 8 * nt + 2 * t + (e & 1);
          if (tok < a.m)
            part[tok * kDnBN + 32 * warp + 4 * g + 2 * i + (e >> 1)] =
                acc[i][nt][e] + other[(i * NT + nt) * 4 + e];
        }
  }
  const cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();

  // rows rank + splits (2 i + tid / 128): thread tid their column n0 + tid % 128
  const int cl = tid & (kDnBN - 1);
  const int col = n0 + cl;
  if (col < a.hidden) {
    for (int tok = rank + splits * (tid / kDnBN); tok < a.m; tok += kDnSets * splits)
      a.out[static_cast<long long>(tok) * a.hidden + col] =
          __float2bfloat16_rn(wstream::split_sum(cluster, part, tok * kDnBN + cl, splits));
  }
  cluster.sync();   // the other blocks read this block's sums until here
}

template <int G, int NT, bool A8>
cudaError_t launch_gateup(const StreamArgs& a, int splits, cudaStream_t st) {
  return wstream::launch_clusters(int4_ffn_gateup_stream_kernel<G, NT, A8>, dim3(a.n_j, splits),
                                  kGuThreads, GuStage<G, NT, A8>::kSmem, st, a);
}

template <int G, int NT, bool A8>
cudaError_t launch_down(const StreamArgs& a, int splits, cudaStream_t st) {
  return wstream::launch_clusters(int4_ffn_down_stream_kernel<G, NT, A8>,
                                  dim3((a.hidden + kDnBN - 1) / kDnBN, splits), kDnThreads,
                                  DnStage<G, NT, A8>::kSmem, st, a);
}

template <int G, bool A8>
cudaError_t stream_rows(const StreamArgs& a, bool down, int splits, cudaStream_t st) {
  if (down)
    return a.m <= 8 ? launch_down<G, 1, A8>(a, splits, st)
         : a.m <= 16 ? launch_down<G, 2, A8>(a, splits, st) : launch_down<G, 4, A8>(a, splits, st);
  return a.m <= 8 ? launch_gateup<G, 1, A8>(a, splits, st)
       : a.m <= 16 ? launch_gateup<G, 2, A8>(a, splits, st)
                   : launch_gateup<G, 4, A8>(a, splits, st);
}

template <bool A8>
cudaError_t stream_group(const StreamArgs& a, int group, bool down, int splits, cudaStream_t st) {
  return group == 32 ? stream_rows<32, A8>(a, down, splits, st)
       : group == 64 ? stream_rows<64, A8>(a, down, splits, st)
                     : stream_rows<128, A8>(a, down, splits, st);
}

template <int G, int NT, bool A8>
int clusters_of(bool down, int splits) {
  return down ? wstream::active_clusters(int4_ffn_down_stream_kernel<G, NT, A8>, kDnThreads,
                                         DnStage<G, NT, A8>::kSmem, splits)
              : wstream::active_clusters(int4_ffn_gateup_stream_kernel<G, NT, A8>, kGuThreads,
                                         GuStage<G, NT, A8>::kSmem, splits);
}

template <int G, bool A8>
int clusters_rows(int m, bool down, int splits) {
  return m <= 8 ? clusters_of<G, 1, A8>(down, splits)
       : m <= 16 ? clusters_of<G, 2, A8>(down, splits) : clusters_of<G, 4, A8>(down, splits);
}

template <bool A8>
int clusters_group(int group, int m, bool down, int splits) {
  return group == 32 ? clusters_rows<32, A8>(m, down, splits)
       : group == 64 ? clusters_rows<64, A8>(m, down, splits)
                     : clusters_rows<128, A8>(m, down, splits);
}

}  // namespace

// The tiled kernel (prefill): launches the fused kernel and the reduction
// on `stream` for one chunk of m rows; returns the first CUDA error (0 when
// both launches were accepted).  x is bf16 (w4) or int8 with sx (w4a8), (m, hidden); out (m, hidden) bf16;
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

// The decode kernels (m <= 32): two launches on `stream`, gate/up then
// down, each in clusters of its splits; returns the first CUDA error (0
// when both were accepted).  x is bf16 (w4) or int8 with sx (w4a8), (m,
// hidden); out (m, hidden) bf16; h (m, ld_h) bf16 or int8 scratch with
// ld_h = bj n_j, n_j = ceil(inter / bj); sh (m, n_j) fp32 (w4a8).  The
// gate/up kernel's splits cut the hidden / gh scale groups gu_per at a
// time, the down kernel's the n_j j-blocks dn_per at a time, at most 8
// each.  Every buffer contiguous and 16-byte aligned.
extern "C" int int4_ffn_stream_launch(const void* x, const void* sx, const void* wg,
                                      const void* sg, const void* wu, const void* su,
                                      const void* wd, const void* sd, void* out, void* h, void* sh,
                                      int m, int hidden, int inter, int gh, int gi, int bj,
                                      int gu_per, int gu_splits, int dn_per, int dn_splits,
                                      int act_quant, void* stream) {
  const auto group_ok = [](int g) { return g == 32 || g == 64 || g == 128; };
  if (!group_ok(gh) || !group_ok(gi) || m <= 0 || m > 32 || hidden <= 0 || hidden % gh != 0 ||
      inter <= 0 || inter % gi != 0 || bj <= 0 || bj > kBJ || bj % gi != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_j = (inter + bj - 1) / bj;
  const int groups = hidden / gh;
  if (gu_per <= 0 || gu_splits < 1 || gu_splits > kMaxSplits ||
      (gu_splits - 1) * gu_per >= groups || gu_splits * gu_per < groups || dn_per <= 0 || dn_splits < 1 || dn_splits > kMaxSplits ||
      (dn_splits - 1) * dn_per >= n_j || dn_splits * dn_per < n_j ||
      (act_quant && (sx == nullptr || sh == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamArgs a{x, static_cast<const float*>(sx), static_cast<const int8_t*>(wg),
                     static_cast<const float*>(sg), static_cast<const int8_t*>(wu),
                     static_cast<const float*>(su), static_cast<const int8_t*>(wd),
                     static_cast<const float*>(sd), static_cast<__nv_bfloat16*>(out), h,
                     static_cast<float*>(sh), m, hidden, inter, bj, n_j, n_j * bj, gu_per, dn_per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a8 = act_quant != 0;
  cudaError_t err = a8 ? stream_group<true>(a, gh, false, gu_splits, s)
                       : stream_group<false>(a, gh, false, gu_splits, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = a8 ? stream_group<true>(a, gi, true, dn_splits, s)
           : stream_group<false>(a, gi, true, dn_splits, s);
  return static_cast<int>(err);
}

// How many clusters of `splits` blocks (1 to 8) of the gate/up (down = 0,
// scale group gh) or the down kernel (scale group gi) for m rows, w4 or
// w4a8, the card runs at once, or -1 on a CUDA error.
extern "C" int int4_ffn_stream_clusters(int m, int gh, int gi, int act_quant, int down,
                                        int splits) {
  const int group = down ? gi : gh;
  if (m <= 0 || m > 32 || splits < 1 || splits > kMaxSplits ||
      (group != 32 && group != 64 && group != 128))
    return -1;
  return act_quant ? clusters_group<true>(group, m, down != 0, splits)
                   : clusters_group<false>(group, m, down != 0, splits);
}
