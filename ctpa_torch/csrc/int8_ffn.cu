// Fused int8 SwiGLU FFN: out = down(silu(x . Wg) * (x . Wu)), with gate/up
// (hidden, inter) and down (inter, hidden) stored as int8 with one fp32
// scale per output column (ctpa's quantize_int8 layout).  Two designs, each
// two launches; ops/quant.py:int8_ffn_plan picks one by the row count m.
//
// Replaces the TPU kernels ctpa/ops/quant.py:int8_ffn, `_ffn_kernel`
// (weight-only, "w8") and `_ffn_kernel_a8` (int8 activations, "w8a8").
// The intermediate axis is cut into j-blocks of 256 columns (ctpa's
// block_j; 43 blocks at Meditron-7B, the last padded with zeros elsewhere):
//
//   w8:   the int8 weights converted to bf16 (exact); g = (x . Wg) * sg and
//         u = (x . Wu) * su in fp32, h = silu(g) u rounded to bf16, the
//         j-block's down product h . Wd in fp32;
//   w8a8: x8, sx per row (ctpa's quantize_act_int8; ctpa computes it
//         outside its Pallas kernel, the port in one launch of
//         int4_matmul.cu's quantize_act_int8_kernel, with its bits);
//         g = float(x8 . Wg) * sx * sg from an exact int32 dot, u alike;
//         h = silu(g) u in fp32, requantized per row over the j-block's 256
//         columns (sh = max|h| / 127, h8 = round(h / sh)); the j-block's down
//         product float(h8 . Wd) * sh from an exact int32 dot.
//   Both: the j-blocks' down products summed in fp32, as ctpa's sequential
//   j axis sums them (at decode in the fixed order below; at prefill w8 sums
//   straight through the contraction), times sd[col], rounded to bf16.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOPS int8) at
// Meditron-7B (hidden 4096, inter 11008): a decode step (m = 4 to 32 rows)
// is bound by the weight bytes, 135.3 MB, 40.4 us (gate and up 26.9 us,
// down 13.5); at prefill (m = 2,048) the 554 GFLOP bound it, 0.56 ms in
// bf16 (w8) and 0.28 ms in int8 (w8a8).
//
// Decode (m <= 32): weight streaming on mma.sync, two launches, as K5's
// decode kernel (int4_matmul.cu) streams its weights.
//   Gate/up (`int8_ffn_gateup_stream_kernel`, 8 warps): a block owns one
//   j-block of both gate and up (256 columns, 32 a warp) and a split of the
//   hidden rows.  Each ring stage holds 32 rows of both weight windows and
//   x's rows over them, by 16-byte cp.async, four stages deep.  The down
//   kernel (`int8_ffn_down_stream_kernel`, 8 warps): a block owns 128
//   output columns and a split of whole j-blocks, the ring stages 64 rows
//   of Wd and h's rows over them, each set of 4 warps 32 of them (the two
//   sets' sums added at the end, set 0's plus set 1's): twice the warps
//   and the bytes in flight of one set, where the cluster limit of 8
//   splits leaves about 2 blocks an SM.  In both the weights are the A operand
//   (16 output columns x k) and the tokens the 8-wide N side, so m = 4
//   pads to 8; a lane reads 4-byte words of 4 weight rows (its 4 columns)
//   and builds its A registers in registers: w8 converts each int8 to bf16
//   exactly by a byte permute under 2^23 (m16n8k16); w8a8 transposes the 4
//   x 4 bytes into 4 k of one column (m16n8k32 s8), the k slots of a
//   k-step permuted for the weights and x alike.  The row strides put a
//   k-step's reads on distinct banks.
//   The register building, ring copies and cluster sums are
//   stream_common.cuh's, shared with K4's decode kernel.
//   Sums, in a fixed order and with no atomics: the splits of one j-block
//   (gate/up) or column strip (down) run as one thread-block cluster, as
//   many splits (at most 8) as let every cluster run at once (ops/quant.py
//   asks the card's cluster occupancy).  Each block keeps its split's sums
//   (fp32, or exact int32 for w8a8's g and u) in its shared memory; then
//   block z of the cluster finishes rows z, z + splits, ... by reading the
//   other blocks' sums through distributed shared memory and adding them in
//   split order, so no partial leaves the chip.  Gate/up then writes h
//   (bf16, or for w8a8 its int8 form per row over the j-block's 256
//   columns and sh) to device memory (90 KB or 45 KB at m = 4, read back
//   from L2); the down kernel adds each j-block's int32 dot times sh in j
//   order inside a split, the splits in order, times sd.
//   On the card (NVIDIA H100 80GB HBM3, 700 W; profile_int8_decode.py):
//   5 gate/up and 8 down splits at Meditron-7B; at m = 4 the gate/up
//   kernel runs at 0.67-0.72 of its byte bound and the down kernel at
//   0.47-0.59, 0.063-0.073 ms for the FFN; at m = 32 0.50-0.57 and
//   0.38-0.41, 0.083-0.092 ms.  A first form that added the splits through
//   device memory (the last block of each j-block or strip, found by a
//   counter) took 0.064-0.066 ms at m = 4 and 0.113-0.116 at m = 32.  The
//   down kernel's splits stop at 8 and 43 j-blocks fill 48 split slots;
//   its w8 form is the slowest part at m = 4.
//
// Prefill (m > 32): prefill_wgmma.cuh's Hopper kernels, shared with K7.  A
// gate/up kernel (grid: token tiles of 64 x the 43 j-blocks) computes g and
// u for one j-block's 256 columns over the whole hidden axis and writes h
// (bf16, or for w8a8 its int8 form over the j-block's 256 columns and sh)
// to device memory; a down kernel (grid: token tiles x 256-column strips of
// the output) takes h . Wd over n_j * 256 rows.  Each is a producer
// warpgroup whose one thread keeps a ring of shared-memory stages full by
// TMA (x or h and the weight windows, 128-byte swizzled, under mbarriers)
// and two consumer warpgroups that build the weights' wgmma A registers from
// the raw int8 bytes (stream_common.cuh's permutes) and multiply them
// against the tokens' tile on the tensor cores (wgmma bf16 m64n64k16 with
// fp32 sums for w8; s8 m64n64k32 with exact int32 sums for w8a8, rings of
// 64 or 128 contraction rows a stage).  TMA cannot describe gate/up rows of
// inter bytes when inter % 16 != 0; the producer's threads then copy those
// windows by plain loads.  On the card (NVIDIA H100 80GB HBM3, 700 W;
// profile_quant_prefill.py) at 2,048 rows: 1.35-1.37 ms (w8) and 0.81 ms
// (w8a8), gate/up at 0.42 / 0.39 of its bound, down at 0.38 / 0.28.

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

constexpr int kBJ = 256;             // the j-block: ctpa's block_j

__device__ __forceinline__ float silu_mul(float g, float u) {
  const float sig = 1.f / (1.f + expf(-g));
  return __fmul_rn(__fmul_rn(g, sig), u);
}

// ------------------------------------------------------------ decode: streaming

constexpr int kSKC = 32;             // contraction rows a warp takes from a ring stage
constexpr int kSStages = 4;          // ring depth
constexpr int kGuWarps = 8;          // gate/up: a block owns one j-block, 32 columns a warp
constexpr int kGuThreads = 32 * kGuWarps;
constexpr int kDnBN = 128;           // down: a block owns 128 output columns, 32 a warp,
constexpr int kDnSets = 2;           // in two sets of 4 warps, each taking kSKC of a
constexpr int kDnThreads = 32 * 4 * kDnSets;   // stage's kDnSets kSKC rows
constexpr int kDnKC = kDnSets * kSKC;
constexpr int kJChunks = kBJ / kDnKC;  // ring stages a j-block of the down product
using wstream::kMaxSplits;   // the most splits of each kernel
static_assert(kDnThreads == kDnSets * kDnBN, "down threads finish kDnSets rows at once");
static_assert(kGuWarps * 32 == kBJ, "a gate/up block owns one j-block");

template <bool A8> struct AccOf { using type = float; };
template <> struct AccOf<true> { using type = int; };

struct StreamArgs {
  const void* x;          // (m, hidden) bf16 (w8) or int8 with sx (w8a8)
  const float* sx;        // (m,)
  const int8_t* wg;       // (hidden, inter)
  const float* sg;        // (inter,)
  const int8_t* wu;
  const float* su;
  const int8_t* wd;       // (inter, hidden)
  const float* sd;        // (hidden,)
  __nv_bfloat16* out;     // (m, hidden)
  void* h;                // (m, ld_h): bf16 (w8) or int8 (w8a8), 0 past inter
  float* sh;              // (m, n_j) w8a8 row scales of h per j-block
  int m, hidden, inter, n_j, ld_h, gu_per, dn_per;
};

template <int NT, bool A8, int kMats, int kWidth, int KC>
using StageOf = wstream::Int8Stage<NT, A8, kMats, kWidth, KC, kSStages>;

extern __shared__ __align__(16) unsigned char smem_stream8[];

// grid (n_j, splits) in clusters of (1, splits, 1); block kGuThreads;
// dynamic shared memory StageOf<NT, A8, 2, kBJ, kSKC>::kBytes.  Block (jb, z)
// owns j-block jb (inter columns [256 jb, 256 jb + 256)) of both gate and
// up and the hidden rows of ring stages [z gu_per, (z + 1) gu_per); warp w
// owns 32 columns.  Its sums stay in its shared memory; once the cluster
// holds them all, block z finishes the j-block's rows z, z + splits, ...,
// one column a thread: g and u add the splits' sums in split order (read
// through distributed shared memory); w8 writes h = bf16(silu(g sg) (u
// su)); w8a8 h = silu(g) u from g = float(int32 dot) sx sg, then its int8
// form over the row's 256 columns and the row scale sh.
template <int NT, bool A8>
__global__ void __launch_bounds__(kGuThreads, 2) int8_ffn_gateup_stream_kernel(const StreamArgs a) {
  using S = StageOf<NT, A8, 2, kBJ, kSKC>;
  using Acc = typename AccOf<A8>::type;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int jb = blockIdx.x;
  const int j0 = jb * kBJ;
  const int stages = (a.hidden + kSKC - 1) / kSKC;
  const int c0 = blockIdx.y * a.gu_per;
  const int cnt = min(stages, c0 + a.gu_per) - c0;
  const bool wvec = a.inter % 16 == 0;

  auto fetch = [&](int slot, int ch) {
    unsigned char* st = smem_stream8 + slot * S::kStage;
    const int k0 = ch * kSKC;
    wstream::stage_weights<kBJ, S::kLdW, kGuThreads, kSKC>(st, a.wg, k0, a.hidden, j0, a.inter,
                                                           wvec);
    wstream::stage_weights<kBJ, S::kLdW, kGuThreads, kSKC>(st + S::kW, a.wu, k0, a.hidden, j0,
                                                           a.inter, wvec);
    wstream::stage_tokens<NT, S::kXB, S::kLdX, kGuThreads, kSKC>(st + 2 * S::kW, a.x, a.m,
                                                                 a.hidden, k0);
  };

  Acc acc[2][2][NT][4];
#pragma unroll
  for (int mat = 0; mat < 2; ++mat)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        acc[mat][i][nt][0] = acc[mat][i][nt][1] = acc[mat][i][nt][2] = acc[mat][i][nt][3] = 0;

#pragma unroll
  for (int s = 0; s < kSStages - 1; ++s) {
    if (s < cnt) fetch(s, c0 + s);
    warp_mma::cp_async_commit();
  }
  for (int it = 0; it < cnt; ++it) {
    warp_mma::cp_async_wait<kSStages - 2>();   // stage c0 + it is in
    __syncthreads();                           // and every warp is done with slot it - 1
    if (it + kSStages - 1 < cnt) fetch((it + kSStages - 1) % kSStages, c0 + it + kSStages - 1);
    warp_mma::cp_async_commit();
    const unsigned char* st = smem_stream8 + (it % kSStages) * S::kStage;
    wstream::int8_stage_products<NT, A8, 2, kSKC>(acc, st + 32 * warp + 4 * g, S::kW, S::kLdW,
                              st + 2 * S::kW + g * S::kLdX, S::kLdX, t);
  }

  // this block's sums into its shared memory, [mat][tok][256]
  __syncthreads();   // every warp is done with the ring
  Acc* part = reinterpret_cast<Acc*>(smem_stream8);
#pragma unroll
  for (int mat = 0; mat < 2; ++mat)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = 8 * nt + 2 * t + (e & 1);
          if (tok < a.m)
            part[(mat * a.m + tok) * kBJ + 32 * warp + 4 * g + 2 * i + (e >> 1)] =
                acc[mat][i][nt][e];
        }
  const cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();

  // rows rank, rank + splits, ...: thread tid its column j0 + tid (0 past
  // inter)
  const int col = j0 + tid;
  const bool in = col < a.inter;
  const float sg = in ? a.sg[col] : 0.f;
  const float su = in ? a.su[col] : 0.f;
  __shared__ float red[kGuWarps];
  for (int tok = rank; tok < a.m; tok += splits) {
    const Acc gs = wstream::split_sum(cluster, part, tok * kBJ + tid, splits);
    const Acc us = wstream::split_sum(cluster, part, (a.m + tok) * kBJ + tid, splits);
    float gv, uv;
    if constexpr (A8) {
      const float sx = a.sx[tok];
      gv = __fmul_rn(__fmul_rn(static_cast<float>(gs), sx), sg);
      uv = __fmul_rn(__fmul_rn(static_cast<float>(us), sx), su);
    } else {
      gv = __fmul_rn(gs, sg);
      uv = __fmul_rn(us, su);
    }
    const float h = silu_mul(gv, uv);
    if constexpr (!A8) {
      static_cast<__nv_bfloat16*>(a.h)[static_cast<long long>(tok) * a.ld_h + col] =
          __float2bfloat16_rn(h);
    } else {
      // requantize the row over the j-block's 256 columns (pad columns 0)
      float mx = fabsf(h);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) red[warp] = mx;
      __syncthreads();
      mx = red[0];
#pragma unroll
      for (int w = 1; w < kGuWarps; ++w) mx = fmaxf(mx, red[w]);
      const float sh = fmaxf(mx / 127.f, 1e-12f);
      const int q = min(127, max(-127, __float2int_rn(h / sh)));
      static_cast<int8_t*>(a.h)[static_cast<long long>(tok) * a.ld_h + col] =
          static_cast<int8_t>(q);
      if (tid == 0) a.sh[tok * a.n_j + jb] = sh;
      __syncthreads();   // red is the next row's
    }
  }
  cluster.sync();   // the other blocks read this block's sums until here
}

// grid (ceil(hidden / 128), splits) in clusters of (1, splits, 1); block
// kDnThreads; dynamic shared memory StageOf<NT, A8, 1, kDnBN, kDnKC>::kBytes.
// Block (x, z) owns output columns [128 x, 128 x + 128) and the j-blocks
// [z dn_per, (z + 1) dn_per), in order; warp w owns 32 columns, and set s
// of warps (w / 4) the rows [32 s, 32 s + 32) of each 64-row stage.  w8:
// h . Wd in fp32 on the tensor cores; w8a8: each j-block's exact int32 dot
// h8 . Wd over a set's rows times its row scale sh, added in j order in
// fp32.  The sets' sums are added (set 0's plus set 1's) and stay in the
// block's shared memory; block z then finishes rows z, z + splits, ...,
// one column a thread: the splits' sums added in split order (distributed
// shared memory), times sd.
template <int NT, bool A8>
__global__ void __launch_bounds__(kDnThreads, 2) int8_ffn_down_stream_kernel(const StreamArgs a) {
  using S = StageOf<NT, A8, 1, kDnBN, kDnKC>;
  using Acc = typename AccOf<A8>::type;
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3;   // its 32 columns
  const int set = tid >> 7;          // its 32 rows of each stage
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kDnBN;
  const int jb0 = blockIdx.y * a.dn_per;
  const int c0 = jb0 * kJChunks;
  const int cnt = (min(a.n_j, jb0 + a.dn_per) - jb0) * kJChunks;

  auto fetch = [&](int slot, int ch) {
    unsigned char* st = smem_stream8 + slot * S::kStage;
    const int k0 = ch * kDnKC;
    wstream::stage_weights<kDnBN, S::kLdW, kDnThreads, kDnKC>(st, a.wd, k0, a.inter, n0,
                                                              a.hidden, true);
    wstream::stage_tokens<NT, S::kXB, S::kLdX, kDnThreads, kDnKC>(st + S::kW, a.h, a.m, a.ld_h,
                                                                  k0);
  };

  float acc[2][NT][4];   // w8a8: the j-blocks' dots times sh, added in j order
  Acc ci[1][2][NT][4];   // the products' accumulators (w8a8: one j-block's)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = ci[0][i][nt][e] = 0;

#pragma unroll
  for (int s = 0; s < kSStages - 1; ++s) {
    if (s < cnt) fetch(s, c0 + s);
    warp_mma::cp_async_commit();
  }
  for (int it = 0; it < cnt; ++it) {
    warp_mma::cp_async_wait<kSStages - 2>();
    __syncthreads();
    if (it + kSStages - 1 < cnt) fetch((it + kSStages - 1) % kSStages, c0 + it + kSStages - 1);
    warp_mma::cp_async_commit();
    const unsigned char* st = smem_stream8 + (it % kSStages) * S::kStage;
    wstream::int8_stage_products<NT, A8, 1, kSKC>(ci, st + set * kSKC * S::kLdW + 32 * warp + 4 * g,
                                                  S::kW, S::kLdW,
                              st + S::kW + g * S::kLdX + set * kSKC * S::kXB, S::kLdX, t);
    if constexpr (A8) {
      if ((it + 1) % kJChunks == 0) {   // the end of j-block jb: its dot times sh, in j order
        const int jb = (c0 + it) / kJChunks;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int tok = 8 * nt + 2 * t + h;
            const float sh = tok < a.m ? a.sh[tok * a.n_j + jb] : 0.f;
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int e = 2 * r + h;
                acc[i][nt][e] = __fadd_rn(acc[i][nt][e],
                                          __fmul_rn(static_cast<float>(ci[0][i][nt][e]), sh));
                ci[0][i][nt][e] = 0;
              }
          }
      }
    }
  }

  // set 1's sums through shared memory, added to set 0's; the block's sums
  // (w8: the products' fp32 accumulators themselves) then in its shared
  // memory, [tok][128], after set 1's
  __syncthreads();   // every warp is done with the ring
  float* other = reinterpret_cast<float*>(smem_stream8) + (warp * 32 + lane) * (8 * NT);
  float* part = reinterpret_cast<float*>(smem_stream8) + kDnBN * 8 * NT;
  if (set == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          other[(i * NT + nt) * 4 + e] = A8 ? acc[i][nt][e] : static_cast<float>(ci[0][i][nt][e]);
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
                (A8 ? acc[i][nt][e] : static_cast<float>(ci[0][i][nt][e])) +
                other[(i * NT + nt) * 4 + e];
        }
  }
  const cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();

  // rows rank + splits (2 i + tid / 128): thread tid their column n0 + tid % 128
  const int col = n0 + (tid & (kDnBN - 1));
  if (col < a.hidden) {
    const float sd = a.sd[col];
    for (int tok = rank + splits * (tid / kDnBN); tok < a.m; tok += kDnSets * splits) {
      const float sum = wstream::split_sum(cluster, part, tok * kDnBN + (tid & (kDnBN - 1)),
                                           splits);
      a.out[static_cast<long long>(tok) * a.hidden + col] =
          __float2bfloat16_rn(__fmul_rn(sum, sd));
    }
  }
  cluster.sync();   // the other blocks read this block's sums until here
}

template <int NT, bool A8>
cudaError_t launch_stream(const StreamArgs& a, int gu_splits, int dn_splits, cudaStream_t st) {
  const cudaError_t err =
      wstream::launch_clusters(int8_ffn_gateup_stream_kernel<NT, A8>, dim3(a.n_j, gu_splits),
                               kGuThreads, StageOf<NT, A8, 2, kBJ, kSKC>::kBytes, st, a);
  if (err != cudaSuccess) return err;
  return wstream::launch_clusters(int8_ffn_down_stream_kernel<NT, A8>,
                                  dim3((a.hidden + kDnBN - 1) / kDnBN, dn_splits), kDnThreads,
                                  StageOf<NT, A8, 1, kDnBN, kDnKC>::kBytes, st, a);
}

template <int NT, bool A8>
int stream_clusters(bool down, int splits) {
  return down ? wstream::active_clusters(int8_ffn_down_stream_kernel<NT, A8>, kDnThreads,
                                         StageOf<NT, A8, 1, kDnBN, kDnKC>::kBytes, splits)
              : wstream::active_clusters(int8_ffn_gateup_stream_kernel<NT, A8>, kGuThreads,
                                         StageOf<NT, A8, 2, kBJ, kSKC>::kBytes, splits);
}

template <bool A8>
int rows_clusters(int m, bool down, int splits) {
  return m <= 8 ? stream_clusters<1, A8>(down, splits)
       : m <= 16 ? stream_clusters<2, A8>(down, splits) : stream_clusters<4, A8>(down, splits);
}

template <bool A8>
cudaError_t stream_rows(const StreamArgs& a, int gu_splits, int dn_splits, cudaStream_t st) {
  return a.m <= 8 ? launch_stream<1, A8>(a, gu_splits, dn_splits, st)
       : a.m <= 16 ? launch_stream<2, A8>(a, gu_splits, dn_splits, st)
                   : launch_stream<4, A8>(a, gu_splits, dn_splits, st);
}

}  // namespace

// The decode kernels (m <= 32): two launches on `stream`, gate/up then
// down, each in clusters of its splits; returns the first CUDA error (0
// when both were accepted).  x is bf16 (w8) or int8 with sx (w8a8), (m,
// hidden); out (m, hidden) bf16; h (m, ld_h) bf16 or int8 scratch with
// ld_h = 256 n_j, n_j = ceil(inter / 256); sh (m, n_j) fp32 (w8a8).  The
// gate/up kernel's splits cut the ceil(hidden / 32) ring stages gu_per at
// a time, the down kernel's the n_j j-blocks dn_per at a time, at most 8
// each.  hidden % 16 == 0; every buffer contiguous and 16-byte aligned.
extern "C" int int8_ffn_stream_launch(const void* x, const void* sx, const void* wg,
                                      const void* sg, const void* wu, const void* su,
                                      const void* wd, const void* sd, void* out, void* h, void* sh,
                                      int m, int hidden, int inter, int gu_per, int gu_splits,
                                      int dn_per, int dn_splits, int act_quant, void* stream) {
  const int n_j = (inter + kBJ - 1) / kBJ;
  const int stages = (hidden + kSKC - 1) / kSKC;
  if (m <= 0 || m > 32 || hidden <= 0 || hidden % 16 != 0 || inter <= 0 || gu_per <= 0 ||
      gu_splits < 1 || (gu_splits - 1) * gu_per >= stages || gu_splits * gu_per < stages ||
      dn_per <= 0 || dn_splits < 1 || (dn_splits - 1) * dn_per >= n_j ||
      dn_splits * dn_per < n_j || gu_splits > kMaxSplits || dn_splits > kMaxSplits ||
      (act_quant && (sx == nullptr || sh == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamArgs a{x, static_cast<const float*>(sx), static_cast<const int8_t*>(wg),
                     static_cast<const float*>(sg), static_cast<const int8_t*>(wu),
                     static_cast<const float*>(su), static_cast<const int8_t*>(wd),
                     static_cast<const float*>(sd), static_cast<__nv_bfloat16*>(out), h,
                     static_cast<float*>(sh), m, hidden, inter, n_j, n_j * kBJ, gu_per, dn_per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(act_quant ? stream_rows<true>(a, gu_splits, dn_splits, s)
                                    : stream_rows<false>(a, gu_splits, dn_splits, s));
}

// How many clusters of `splits` blocks (1 to 8) of the gate/up (down = 0)
// or the down kernel for m rows, w8 or w8a8, the card runs at once (its
// occupancy for their registers, threads and shared memory, and how the
// blocks of a cluster fit its GPCs), or -1 on a CUDA error.
extern "C" int int8_ffn_stream_clusters(int m, int act_quant, int down, int splits) {
  if (m <= 0 || m > 32 || splits < 1 || splits > kMaxSplits) return -1;
  return act_quant ? rows_clusters<true>(m, down != 0, splits)
                   : rows_clusters<false>(m, down != 0, splits);
}

// The prefill kernels (prefill_wgmma.cuh): two launches on `stream`, gate/up
// then down; returns the first CUDA error (0 when both were accepted).  x is
// bf16 (w8) or int8 with sx (w8a8), (m, hidden); out (m, hidden) bf16; h
// (m, 256 n_j) bf16 or int8 scratch, n_j = ceil(inter / 256); sh (m, n_j)
// fp32 (w8a8).  hidden % 16 == 0; every buffer contiguous and 16-byte
// aligned.
extern "C" int int8_ffn_prefill_launch(const void* x, const void* sx, const void* wg,
                                       const void* sg, const void* wu, const void* su,
                                       const void* wd, const void* sd, void* out, void* h,
                                       void* sh, int m, int hidden, int inter, int act_quant,
                                       void* stream) {
  if (m <= 0 || hidden <= 0 || hidden % 16 != 0 || inter <= 0 ||
      (act_quant && (sx == nullptr || sh == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_j = (inter + kBJ - 1) / kBJ;
  const prefill_wgmma::Args a{static_cast<const float*>(sx), static_cast<const float*>(sg),
                          static_cast<const float*>(su), static_cast<const float*>(sd),
                          static_cast<const int8_t*>(wg), static_cast<const int8_t*>(wu), h,
                          static_cast<float*>(sh), static_cast<__nv_bfloat16*>(out), m, hidden,
                          inter, kBJ, n_j, n_j * kBJ, inter % 16 != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w_g = static_cast<const int8_t*>(wg);
  const auto* w_u = static_cast<const int8_t*>(wu);
  const auto* w_d = static_cast<const int8_t*>(wd);
  cudaError_t err;
  if (act_quant) {
    using F = prefill_wgmma::Form<false, true, 0>;
    err = prefill_wgmma::launch_gateup<F>(x, w_g, w_u, nullptr, nullptr, a, s);
    if (err == cudaSuccess) err = prefill_wgmma::launch_down<F>(w_d, nullptr, a, s);
  } else {
    using F = prefill_wgmma::Form<false, false, 0>;
    err = prefill_wgmma::launch_gateup<F>(x, w_g, w_u, nullptr, nullptr, a, s);
    if (err == cudaSuccess) err = prefill_wgmma::launch_down<F>(w_d, nullptr, a, s);
  }
  return static_cast<int>(err);
}
