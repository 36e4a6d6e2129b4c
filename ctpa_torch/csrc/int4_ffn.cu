// Fused int4 SwiGLU FFN: out = down(silu(x . Wg) * (x . Wu)), with gate/up
// (hidden/2, inter) and down (inter/2, hidden) stored as packed int4 with
// fp32 scales per (input group, output column) (ctpa's quantize_int4
// layout, prefill_wgmma.cuh).
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
//   sequential j axis sums them (at decode in the fixed order below; at
//   prefill w4 sums straight through the contraction), and rounded to bf16.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOPS int8) at
// Meditron-7B (hidden 4096, inter 11008): a decode step (m = 4 to 32 rows)
// is bound by the weight bytes: gate and up 45.1 MB packed and 2.8 MB of
// scales, 14.3 us; down 22.5 MB and 1.4 MB, 7.1 us; 21.5 us for the FFN.  At
// prefill (m = 2,048) the 554 GFLOP bound it, 0.56 ms in bf16 and 0.28 ms in
// int8.
//
// Two designs, each two launches; ops/quant.py:int4_ffn_plan picks one by
// the row count m.
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
// Prefill (m > 32): prefill_wgmma.cuh's Hopper kernels, shared with K6.  A
// gate/up kernel (grid: token tiles x j-blocks) computes g and u for one
// j-block's window of 256 columns over the whole hidden axis and writes h
// (bf16, or for w4a8 its int8 form over exactly the j-block's bj columns
// and sh) to device memory; a down kernel (grid: token tiles x 256-column
// strips of the output) takes h . Wd over n_j * bj rows.  Each is a
// producer warpgroup whose one thread keeps a ring of shared-memory stages
// full by TMA (x or h, the packed weight windows, 128-byte swizzled, and
// the stage's scale rows, under mbarriers) and two consumer warpgroups that
// build the weights' wgmma A registers from the packed bytes and multiply
// them against the tokens' tile on the tensor cores.  A ring stage is 128
// contraction rows (64 packed rows, whole scale groups).  ctpa's packing
// puts rows j and j + G/2 of a group in one byte; the B operand cannot be
// permuted in shared memory, so the low nibbles of a group's packed rows
// contract against x's first G/2 columns of the group and the high nibbles
// against the next G/2, both in natural order.  w4: bf16 m64n64k16, each
// nibble times its column's scale rounded to bf16, fp32 sums; w4a8: s8
// m64n32k32 on nibbles as 16 q, each scale group's exact int32 dot waited
// for and scaled before it joins the fp32 sum (two accumulator sets, 32
// tokens a block).  On the card (NVIDIA H100 80GB HBM3, 700 W;
// profile_quant_prefill.py) at 2,048 rows: 1.62 ms (w4) and 1.64-1.67 ms
// (w4a8), gate/up at 0.33 / 0.19 of its bound, down at 0.37 / 0.14.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "prefill_wgmma.cuh"
#include "stream_common.cuh"
#include "warp_mma.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kBJ = 256;             // the widest j-block

__device__ __forceinline__ float silu_mul(float g, float u) {
  const float sig = 1.f / (1.f + expf(-g));
  return __fmul_rn(__fmul_rn(g, sig), u);
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

namespace {

template <bool A8, int G>
cudaError_t prefill_gateup(const void* x, const void* wg, const void* wu, const void* sg,
                           const void* su, const prefill_wgmma::Args& a, cudaStream_t s) {
  return prefill_wgmma::launch_gateup<prefill_wgmma::Form<true, A8, G>>(
      x, static_cast<const int8_t*>(wg), static_cast<const int8_t*>(wu),
      static_cast<const float*>(sg), static_cast<const float*>(su), a, s);
}

template <bool A8, int G>
cudaError_t prefill_down(const void* wd, const void* sd, const prefill_wgmma::Args& a,
                         cudaStream_t s) {
  return prefill_wgmma::launch_down<prefill_wgmma::Form<true, A8, G>>(
      static_cast<const int8_t*>(wd), static_cast<const float*>(sd), a, s);
}

}  // namespace

// The prefill kernels (prefill_wgmma.cuh): two launches on `stream`, gate/up
// (scale group gh) then down (gi); returns the first CUDA error (0 when both
// were accepted).  x is bf16 (w4) or int8 with sx (w4a8), (m, hidden); out
// (m, hidden) bf16; h (m, bj n_j) bf16 or int8 scratch, n_j = ceil(inter /
// bj), bj ctpa's j-block (ops/quant.py:ffn_block_j: 256, or the whole
// padded width when inter <= 256); sh (m, n_j) fp32 (w4a8).  Every buffer
// contiguous and 16-byte aligned.
extern "C" int int4_ffn_prefill_launch(const void* x, const void* sx, const void* wg,
                                       const void* sg, const void* wu, const void* su,
                                       const void* wd, const void* sd, void* out, void* h,
                                       void* sh, int m, int hidden, int inter, int gh, int gi,
                                       int bj, int act_quant, void* stream) {
  const auto group_ok = [](int g) { return g == 32 || g == 64 || g == 128; };
  if (!group_ok(gh) || !group_ok(gi) || m <= 0 || hidden <= 0 || hidden % gh != 0 ||
      inter <= 0 || inter % gi != 0 || bj <= 0 || bj > kBJ || bj % gi != 0 ||
      ((inter + bj - 1) / bj > 1 && bj != kBJ) || (act_quant && (sx == nullptr || sh == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_j = (inter + bj - 1) / bj;
  const prefill_wgmma::Args a{static_cast<const float*>(sx), nullptr, nullptr, nullptr, nullptr,
                          nullptr, h, static_cast<float*>(sh), static_cast<__nv_bfloat16*>(out),
                          m, hidden, inter, bj, n_j, n_j * bj, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a8 = act_quant != 0;
  cudaError_t err;
  if (a8)
    err = gh == 32 ? prefill_gateup<true, 32>(x, wg, wu, sg, su, a, s)
        : gh == 64 ? prefill_gateup<true, 64>(x, wg, wu, sg, su, a, s)
                   : prefill_gateup<true, 128>(x, wg, wu, sg, su, a, s);
  else
    err = gh == 32 ? prefill_gateup<false, 32>(x, wg, wu, sg, su, a, s)
        : gh == 64 ? prefill_gateup<false, 64>(x, wg, wu, sg, su, a, s)
                   : prefill_gateup<false, 128>(x, wg, wu, sg, su, a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a8)
    err = gi == 32 ? prefill_down<true, 32>(wd, sd, a, s)
        : gi == 64 ? prefill_down<true, 64>(wd, sd, a, s) : prefill_down<true, 128>(wd, sd, a, s);
  else
    err = gi == 32 ? prefill_down<false, 32>(wd, sd, a, s)
        : gi == 64 ? prefill_down<false, 64>(wd, sd, a, s)
                   : prefill_down<false, 128>(wd, sd, a, s);
  return static_cast<int>(err);
}
