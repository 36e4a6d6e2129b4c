// int8 projection: y = (x . W) * scale[col] with W stored as int8 (k, n)
// and one fp32 scale per output column (ctpa's quantize_int8 layout).
//
// Replaces the TPU kernels ctpa/ops/quant.py:int8_matmul, `_q_kernel`
// (weight-only, "w8") and `_q_kernel_a8` (int8 activations, "w8a8").  x is
// (m, k), the weight (k, n) int8, scale (n,) fp32.
//
//   w8:   the int8 weight converted to bf16 (exact), y = x . w with fp32
//         sums, times scale[col] after the sum (ctpa applies the scale at
//         the flush), out in bf16.
//   w8a8: x8, sx per row from ctpa's quantize_act_int8 (ctpa computes it
//         outside its Pallas kernel; here one launch of int4_matmul.cu's
//         quantize_act_int8_kernel, with its bits); one exact int8 x int8
//         -> int32 dot over the whole contraction (|sum| <= 11008 * 127^2 <
//         2^31), then (float(sum) * sx[row]) * scale[col], as the plain
//         version computes it: the same bits.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOPS int8) at
// Meditron-7B (k 4096; n 12288 for the fused qkv_proj, 4096 for o_proj,
// 32000 for lm_head; k 4096, n 22016 for gateup_proj and k 11008, n 4096 for
// down_proj without the fused FFN): a decode step (m = 4 to 32 rows) is
// bound by the bytes of the weights: qkv_proj reads 50.3 MB, 15.0 us;
// o_proj 16.8 MB, 5.0 us; lm_head 131 MB, 39.1 us.  Prefill (m = 2,048 rows
// for 4 x 512 tokens) is bound by the operations: qkv_proj is 206 GFLOP,
// 0.21 ms in bf16 (w8) and 0.10 ms in int8 (w8a8); o_proj 69 GFLOP, 0.069 ms
// and 0.035 ms.
//
// Two kernels; ops/quant.py:int8_matmul_plan picks one by m.
//
// Decode (m <= 32), `int8_matmul_stream_kernel`: weight streaming on
// mma.sync, K6's decode design (int8_ffn.cu) for one matrix.  A block owns
// 128 output columns (128 contiguous bytes of every weight row, 32 columns
// a warp) and a split of the contraction, in ring stages of 64 rows: each
// stage's weight rows and x's rows over them arrive by 16-byte cp.async
// (byte copies where n is not a multiple of 16, element copies where x's
// rows are not 16-byte multiples), four stages deep.  8 warps in two sets of
// 4, each set 32 rows of a stage; its A registers built from 4-byte reads
// of the weight rows (stream_common.cuh: w8 converts each int8 to bf16
// exactly, m16n8k16; w8a8 transposes 4 x 4 bytes, m16n8k32 s8).  The
// sets' sums are added at the end, set 0's plus set 1's (exact int32 for
// w8a8).  The splits of a column strip (as many, up to 8, as let every
// strip's cluster run at once: ops/quant.py asks the card's cluster
// occupancy) form one thread-block cluster; each block keeps its sums in
// its shared memory and block z finishes rows z, z + splits, ... adding
// the splits in split order through distributed shared memory, then
// scaling: one launch, no partial leaves the chip, the same bits on every
// call.
//
// Prefill (m > 32), `prefill_wgmma::proj_kernel` (prefill_wgmma.cuh, the
// design of K6's and K7's prefill kernels for one matrix): a block of three
// warpgroups owns 256 output columns and 128 tokens; a producer warpgroup
// keeps a TMA ring of 64-row (w8) or 128-row (w8a8) stages full (6 or 4
// deep), and two consumer warpgroups build wgmma's A registers from the
// raw weight bytes (out^T = W^T x^T: bf16 m64n128k16 for w8, s8 m64n128k32
// for w8a8, whose int32 accumulators hold the whole dot).  Where the token
// tiles and strips are fewer than the card runs at once (m 33-128), the
// contraction splits across a thread-block cluster, added in split order
// through distributed shared memory.  x's rows not a multiple of 16 bytes
// (k % 8 != 0 for w8, k % 16 != 0 for w8a8) and weight rows of n % 16 != 0
// bytes are copied by the producer's plain loads into the same layout.  The
// w8a8 sums are exact and scaled as the plain version scales them: its bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "prefill_wgmma.cuh"
#include "stream_common.cuh"
#include "warp_mma.cuh"

namespace {

namespace cg = cooperative_groups;

// ------------------------------------------------------------ decode: streaming

constexpr int kSKC = 32;                  // contraction rows a warp set takes from a stage
constexpr int kSSets = 2;                 // two sets of 4 warps
constexpr int kSRows = kSSets * kSKC;     // contraction rows a ring stage
constexpr int kSStages = 4;               // ring depth
constexpr int kSBN = 128;                 // output columns of a block, 32 a warp
constexpr int kSThreads = 32 * 4 * kSSets;
using wstream::kMaxSplits;
static_assert(kSThreads == kSSets * kSBN, "the finishing threads take kSSets rows at once");

template <bool A8> struct AccOf { using type = float; };
template <> struct AccOf<true> { using type = int; };

struct StreamArgs {
  const void* x;          // (m, k) bf16 (w8) or int8 with sx (w8a8)
  const float* sx;        // (m,)
  const int8_t* w8;       // (k, n)
  const float* scale;     // (n,)
  __nv_bfloat16* out;     // (m, n)
  int m, k, n, per;
};

template <int NT, bool A8>
using SStage = wstream::Int8Stage<NT, A8, 1, kSBN, kSRows, kSStages>;

extern __shared__ __align__(16) unsigned char smem_stream8[];

// grid (ceil(n / 128), splits) in clusters of (1, splits, 1); block
// kSThreads; dynamic shared memory SStage<NT, A8>::kBytes.  Block (x, z)
// owns output columns [128 x, 128 x + 128) and the ring stages [z per,
// (z + 1) per) of 64 contraction rows; warp w % 4 owns 32 columns and set
// w / 4 the rows [32 s, 32 s + 32) of each stage.  The sets' sums (fp32, or
// exact int32 for w8a8) are added, set 0's plus set 1's, and stay in the
// block's shared memory; block z then finishes rows z, z + splits, ..., one
// column a thread: the splits' sums added in split order (distributed
// shared memory), then w8: sum * scale[col]; w8a8: float(sum) * sx[row] *
// scale[col]; rounded to bf16.
template <int NT, bool A8>
__global__ void __launch_bounds__(kSThreads, 2) int8_matmul_stream_kernel(const StreamArgs a) {
  using S = SStage<NT, A8>;
  using Acc = typename AccOf<A8>::type;
  static_assert(2 * kSBN * 8 * NT * 4 <= S::kBytes, "the sums fit the ring");
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & 3;   // its 32 columns
  const int set = tid >> 7;          // its 32 rows of each stage
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kSBN;
  const int stages = (a.k + kSRows - 1) / kSRows;
  const int c0 = blockIdx.y * a.per;
  const int cnt = min(stages, c0 + a.per) - c0;
  const bool wvec = a.n % 16 == 0;
  const bool xvec = a.k * S::kXB % 16 == 0;

  auto fetch = [&](int slot, int ch) {
    unsigned char* st = smem_stream8 + slot * S::kStage;
    const int k0 = ch * kSRows;
    wstream::stage_weights<kSBN, S::kLdW, kSThreads, kSRows>(st, a.w8, k0, a.k, n0, a.n, wvec);
    wstream::stage_tokens<NT, S::kXB, S::kLdX, kSThreads, kSRows>(st + S::kW, a.x, a.m, a.k, k0,
                                                                  xvec);
  };

  Acc acc[1][2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][i][nt][e] = 0;

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
    wstream::int8_stage_products<NT, A8, 1, kSKC>(
        acc, st + set * kSKC * S::kLdW + 32 * warp + 4 * g, S::kW, S::kLdW,
        st + S::kW + g * S::kLdX + set * kSKC * S::kXB, S::kLdX, t);
  }

  // set 1's sums through shared memory, added to set 0's; the block's sums
  // then in its shared memory, [tok][128], after set 1's
  __syncthreads();   // every warp is done with the ring
  Acc* other = reinterpret_cast<Acc*>(smem_stream8) + (warp * 32 + lane) * (8 * NT);
  Acc* part = reinterpret_cast<Acc*>(smem_stream8) + kSBN * 8 * NT;
  if (set == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) other[(i * NT + nt) * 4 + e] = acc[0][i][nt][e];
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
            part[tok * kSBN + 32 * warp + 4 * g + 2 * i + (e >> 1)] =
                acc[0][i][nt][e] + other[(i * NT + nt) * 4 + e];
        }
  }
  const cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster.sync();

  // rows rank + splits (2 i + tid / 128): thread tid their column n0 + tid % 128
  const int cl = tid & (kSBN - 1);
  const int col = n0 + cl;
  if (col < a.n) {
    const float sc = a.scale[col];
    for (int tok = rank + splits * (tid / kSBN); tok < a.m; tok += kSSets * splits) {
      const Acc sum = wstream::split_sum(cluster, part, tok * kSBN + cl, splits);
      const float y = A8 ? __fmul_rn(__fmul_rn(static_cast<float>(sum), a.sx[tok]), sc)
                         : __fmul_rn(static_cast<float>(sum), sc);
      a.out[static_cast<long long>(tok) * a.n + col] = __float2bfloat16_rn(y);
    }
  }
  cluster.sync();   // the other blocks read this block's sums until here
}

template <int NT, bool A8>
cudaError_t launch_stream(const StreamArgs& a, int splits, cudaStream_t st) {
  return wstream::launch_clusters(int8_matmul_stream_kernel<NT, A8>,
                                  dim3((a.n + kSBN - 1) / kSBN, splits), kSThreads,
                                  SStage<NT, A8>::kBytes, st, a);
}

template <bool A8>
cudaError_t stream_rows(const StreamArgs& a, int splits, cudaStream_t st) {
  return a.m <= 8 ? launch_stream<1, A8>(a, splits, st)
       : a.m <= 16 ? launch_stream<2, A8>(a, splits, st) : launch_stream<4, A8>(a, splits, st);
}

template <int NT, bool A8>
int stream_clusters(int splits) {
  return wstream::active_clusters(int8_matmul_stream_kernel<NT, A8>, kSThreads,
                                  SStage<NT, A8>::kBytes, splits);
}

template <bool A8>
int rows_clusters(int m, int splits) {
  return m <= 8 ? stream_clusters<1, A8>(splits)
       : m <= 16 ? stream_clusters<2, A8>(splits) : stream_clusters<4, A8>(splits);
}

}  // namespace

// The decode kernel (m <= 32): one launch on `stream` in clusters of its
// splits; returns the CUDA error of the launch (0 when it was accepted).  x
// is bf16 (w8) or int8 with sx (w8a8), (m, k); w8 (k, n) int8; scale (n,)
// fp32; out (m, n) bf16.  The splits cut the ceil(k / 64) ring stages per at
// a time, at most 8.  Every buffer contiguous and 16-byte aligned.
extern "C" int int8_matmul_stream_launch(const void* x, const void* sx, const void* w8,
                                         const void* scale, void* out, int m, int k, int n,
                                         int per, int splits, int act_quant, void* stream) {
  const int stages = (k + kSRows - 1) / kSRows;
  if (m <= 0 || m > 32 || n <= 0 || k <= 0 || per <= 0 || splits < 1 || splits > kMaxSplits ||
      (splits - 1) * per >= stages || splits * per < stages || (act_quant && sx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamArgs a{x, static_cast<const float*>(sx), static_cast<const int8_t*>(w8),
                     static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), m, k, n,
                     per};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(act_quant ? stream_rows<true>(a, splits, s)
                                    : stream_rows<false>(a, splits, s));
}

// How many clusters of `splits` blocks (1 to 8) of the decode kernel for m
// rows, w8 or w8a8, the card runs at once, or -1 on a CUDA error.
extern "C" int int8_matmul_stream_clusters(int m, int act_quant, int splits) {
  if (m <= 0 || m > 32 || splits < 1 || splits > kMaxSplits) return -1;
  return act_quant ? rows_clusters<true>(m, splits) : rows_clusters<false>(m, splits);
}

// The prefill kernel (prefill_wgmma.cuh): one launch on `stream` in
// clusters of its splits; returns the CUDA error of the launch (0 when it
// was accepted).  x is bf16 (w8) or int8 with sx (w8a8), (m, k); w8 (k, n)
// int8; scale (n,) fp32; out (m, n) bf16.  The splits cut the ceil(k / 128)
// chunks of 128 contraction rows per at a time, at most 8.  Every buffer
// contiguous and 16-byte aligned.
extern "C" int int8_matmul_prefill_launch(const void* x, const void* sx, const void* w8,
                                          const void* scale, void* out, int m, int k, int n,
                                          int per, int splits, int act_quant, void* stream) {
  const int chunks = (k + prefill_wgmma::kProjKC - 1) / prefill_wgmma::kProjKC;
  if (m <= 0 || n <= 0 || k <= 0 || per <= 0 || splits < 1 || splits > kMaxSplits ||
      (splits - 1) * per >= chunks || splits * per < chunks || (act_quant && sx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int xb = act_quant ? 1 : 2;
  const int bn = prefill_wgmma::kProjBN;
  const prefill_wgmma::ProjArgs a{x, static_cast<const float*>(sx), static_cast<const int8_t*>(w8),
                                  static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
                                  m, k, n, (m + bn - 1) / bn, per, k * xb % 16 != 0, n % 16 != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      act_quant ? prefill_wgmma::launch_proj<prefill_wgmma::ProjForm<false, true, 0>>(a, splits, s)
                : prefill_wgmma::launch_proj<prefill_wgmma::ProjForm<false, false, 0>>(a, splits,
                                                                                       s));
}

// How many clusters of `splits` blocks (1 to 8) of the prefill kernel, w8 or
// w8a8, the card runs at once, or -1 on a CUDA error.
extern "C" int int8_matmul_prefill_clusters(int act_quant, int splits) {
  if (splits < 1 || splits > kMaxSplits) return -1;
  return act_quant ? prefill_wgmma::proj_clusters<prefill_wgmma::ProjForm<false, true, 0>>(splits)
                   : prefill_wgmma::proj_clusters<prefill_wgmma::ProjForm<false, false, 0>>(splits);
}
