// Flash-attention backward (kernel K3) for the CTViT spatial fold.
//
// Replaces the TPU kernel ctpa/ops/pallas/flash_attention.py:_flash_bwd
// (`_dkv_kernel`, `_dq_kernel` and `_db_kernel`, with the probability
// recompute `_bwd_p`).  Given q (b, h, n, d), k and v (b, h, m, d), an optional
// additive bias shaped (h, n, m), (1, n, m) or (b, h, n, m), the fp32 row
// logsumexp `lse` (b, h, n) of the forward (flash_attention.cu) and dO, the
// gradient of the output O, it computes
//
//   p_ij     = exp(scale * q_i . k_j + bias_ij - lse_i)   (recomputed, never stored)
//   delta_i  = dO_i . O_i                                  (pre-pass, fp32 (b, h, n))
//   ds_ij    = p_ij * (dO_i . v_j - delta_i)
//   dV_j     = sum_i p_ij dO_i
//   dK_j     = scale * sum_i ds_ij q_i
//   dQ_i     = scale * sum_j ds_ij k_j
//   dbias_ij = sum of ds_ij over the batch items that share the bias slab
//              (without the scale: the bias adds to the post-scale logits)
//
// Sums are fp32; dq, dk, dv and dbias are written in the input dtype (bf16 or
// fp32).  ctpa's masks (`causal` with `q_offset`, `kv_mask`;
// flash_masks.cuh) zero p and ds on masked cells, and tiles they mask
// whole are skipped: dQ and d(bias) stop at the block's last causal key,
// dK/dV starts its query walk at the first query row that sees the block's
// first key.  The dK/dV pass adds the 1/m share of the rows with no valid
// key to every dv row, once per block.  The logit bound of the forward's
// flat softmax plays no part here: lse is the true logsumexp, whatever the
// shift the forward used.
//
// At head dim 128 (the LLM's: report training's flash prefill, b 2, h 32,
// n = m = 512, causal with right padding, 896 of 1024 keys real) dQ and
// dK/dV are bound by the bytes: q, dO, k and v over the real keys, lse and
// delta read and their gradients written, 40.1 MB (dQ) and 48.5 MB (dK/dV),
// 12.0 and 14.5 us at 3.35 TB/s (chip_smoke.py computes these bounds from
// the run's mask); their products over the visited tiles are smaller.
//
// Bound on the H100 at the shipped training shape (b*h = 48*8 at batch 2,
// n = m = 576, d = 32, bf16, bias (8, 576, 576)): the whole backward reads q,
// k, v, O, dO (5 x 14.2 MB), lse (0.9 MB) and the bias (5.3 MB) and writes dq,
// dk, dv (3 x 14.2 MB) and dbias (5.3 MB), 125 MB or 37 us at 3.35 TB/s; its
// five products (s, dp, dV, dK, dQ; 5 * 2 * 384 * 576^2 * 32 = 40.8 GFLOP)
// take 41 us at the bf16 tensor-core rate.  Bytes and operations are close,
// so a kernel near the floor needs both the tensor cores and few passes over
// the inputs.  The passes below recompute s and dp each and read their
// inputs once more each; with dS taken as two bf16 fragments they run 11
// products (89.7 GFLOP, 91 us at the tensor-core rate).  A fused pass is
// later work.
//
// bf16 design (the `_mma` kernels), FlashAttention-2's backward on mma.sync
// m16n8k16 (warp_mma.cuh), tiles staged as in the forward (flash_tiles.cuh):
// blocks of 4 warps, 16 rows a warp, 64-row tiles, rows padded by 8
// elements for ldmatrix, a two-stage cp.async ring (element copies where a
// row is not 16-byte aligned).  Every product runs on the tensor cores and
// S, P, dP and dS live in registers: a product's fp32 accumulator tiles,
// rounded to bf16, are the next product's A fragments as they lie.  dS
// enters dQ and dK as two bf16 fragments, its rounding and the rest
// (to_a_split): a row of ds sums to 0, and one rounding of its terms would
// leave errors of 2^-9 of the terms, not of the much smaller result (ctpa
// rounds dS once; the port is held to its fp32 plain version).  Nothing is
// added with atomics: every sum is a loop inside one block, in a fixed
// order, so two calls give the same bits.
//   * delta: several lanes a row, 16 bytes each, a fixed-order shuffle sum.
//   * dQ: a block owns 64 query rows (Q and dO as A fragments for the whole
//     walk) and walks the key tiles as the forward does, 16 keys at a time:
//     S = Q K^T and dP = dO V^T, ds = p (dp - delta), dQ += dS K (K by
//     ldmatrix .trans).  Blocks run batch item fastest, the last query
//     tiles first (causal: the longest walks).
//   * dK/dV: a block owns 64 key rows (K and V as A fragments) and walks the
//     query tiles (Q, dO, lse, delta and the bias tile in the ring), 16
//     queries at a time, on the transposed tile: S^T = K Q^T and dP^T =
//     V dO^T are accumulators; rounded, P^T and dS^T are the A operands of
//     dV += P^T dO and dK += dS^T Q (dO and Q by ldmatrix .trans).  The bias
//     is read transposed out of the (query, key) tile.
//   * d(bias): a block owns a 64 x 64 tile of one bias slab, keeps its fp32
//     sum in registers (32 floats a lane) and walks the batch items that
//     broadcast the slab in order, each item's Q, dO, K, V, lse and delta in
//     the ring.
// The exponentials run in log2 units on ex2.approx.  A masked or ragged
// cell gets p = 0 by a select (never exp of a huge argument times 0).
// Head dim 128 runs the same dQ and dK/dV kernels at D = 128 (one 64-row
// tile is 17 KB with its padding, six of them 104 KB: two blocks an SM
// without a bias, one with): a warp's 16 x 128 dQ, or dK and dV,
// accumulators take 64 or 128 registers a lane, so the A operands (Q and
// dO, or K and V) are not held for the walk but read from the block's
// shared tiles by ldmatrix at every k-step (mma_abt_rows), as
// FlashAttention-2 does at this head dim.  d(bias) has no kernel at d 128.
//
// fp32 design (the FMA kernels; no main path runs fp32 on the card, and it
// keeps the 1e-4 gate that TF32 tensor cores would not meet): one thread a
// row.  dK/dV: a block of 64 threads owns 64 key rows (k_j, v_j, dk_j, dv_j
// in registers) and walks the queries in tiles of 32, staging q, dO, lse,
// delta and the 32 x 64 bias tile in shared memory.  dQ: 64 query rows, as
// the forward.  d(bias): a block owns a 32 x 64 tile of one slab, one key
// column a thread, and loops over the batch items that broadcast the slab.
// The delta pre-pass and the dQ and dK/dV passes here serve head dim 128
// too, as flash_attention.cu's forward does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_masks.cuh"
#include "flash_tiles.cuh"
#include "warp_mma.cuh"

namespace {

using namespace flash;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Everything a launcher passes on; each kernel reads what it needs.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  const unsigned char* kv_mask;   // (b, m), nonzero = real key; may be null
  const int* q_offset;            // one int32 (causal only); may be null
  const void* out;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  void* dbias;
  int batch, heads, n, m;
  int bias_stride_b, bias_stride_h;   // per batch item, per head (elements)
  int items, item_stride;             // d(bias): items per slab, their stride in b*h
  int causal;
  float scale;
  int vec;         // bf16: q, k, v, dO and the outputs 16-byte aligned
  int vec_bias;    // the bias (and dbias) too, with rows a multiple of 8 keys
};

// ------------------------------------------------------------------ delta

// delta_r = dO_r . O_r over the (rows, D) layout: kLanes = D / kPer lanes a
// row (a power of two, at most 32), each reading kPer = 16 bytes of O and
// of dO (by one 16-byte load where `kVec`), the lanes' partial sums added by
// a fixed butterfly of shuffles.
template <typename T, int D, bool kVec>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  constexpr int kPer = 16 / (int)sizeof(T);
  constexpr int kLanes = D / kPer;
  static_assert(kLanes >= 1 && kLanes <= 32 && (kLanes & (kLanes - 1)) == 0, "lanes a row");
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = idx / kLanes;
  const int part = (int)(idx - r * kLanes);
  float acc = 0.f;
  if (r < rows) {
    const long long at = r * D + part * kPer;
    if (kVec) {
      const uint4 ov = *reinterpret_cast<const uint4*>(out + at);
      const uint4 gv = *reinterpret_cast<const uint4*>(dout + at);
      const T* o = reinterpret_cast<const T*>(&ov);
      const T* g = reinterpret_cast<const T*>(&gv);
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc += to_float(o[e]) * to_float(g[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc += to_float(out[at + e]) * to_float(dout[at + e]);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && part == 0) delta[r] = acc;
}

// ------------------------------------------------------------------ fp32: FMA

constexpr int kRows = 64;  // rows (or key columns) a block owns, one per thread
constexpr int kTile = 32;  // rows of the walked axis staged per step

// a . b over D fp32 values; `a` lies in shared memory (a broadcast read) and
// is 16-byte aligned, `b` in registers
template <int D>
__device__ __forceinline__ float dot_shared(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    acc += x.x * b[d] + x.y * b[d + 1] + x.z * b[d + 2] + x.w * b[d + 3];
  }
  return acc;
}

// grid (b*h, ceil(n / kRows)); block kRows.  Thread i owns query row i.  The
// masks are compiled in only where a launch has one (kMasked), here and in
// the passes below: the unmasked paths keep their registers.
template <int D, bool kMasked>
__global__ void __launch_bounds__(kRows)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const unsigned char* __restrict__ kv_mask,
                    const int* __restrict__ q_offset, const float* __restrict__ lse,
                    const float* __restrict__ delta, const float* __restrict__ dout,
                    float* __restrict__ dq, int heads, int n, int m, int bias_stride_b,
                    int bias_stride_h, int causal, float scale) {
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int hd = bh - b * heads;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int row = row0 + tid;
  const bool live = row < n;

  const float* kg = k + (long long)bh * m * D;
  const float* vg = v + (long long)bh * m * D;
  const float* bg = bias == nullptr
                    ? nullptr
                    : bias + (long long)b * bias_stride_b + (long long)hd * bias_stride_h;
  const unsigned char* kvg = kMasked ? key_row(kv_mask, b, m) : nullptr;
  const int qoff = kMasked ? query_offset(q_offset) : 0;
  const int qpos = row + qoff;
  const int m_end = causal_key_end(kMasked && causal, row0, kRows, qoff, m);

  __shared__ __align__(16) float k_s[kTile][D];
  __shared__ __align__(16) float v_s[kTile][D];
  __shared__ float b_s[kRows][kTile + 1];
  __shared__ unsigned char kv_s[kTile];

  float qr[D], dor[D], acc[D];
  const long long base = ((long long)bh * n + row) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? q[base + d] : 0.f;
    dor[d] = live ? dout[base + d] : 0.f;
    acc[d] = 0.f;
  }
  const float lse_r = live ? lse[(long long)bh * n + row] : 0.f;
  const float delta_r = live ? delta[(long long)bh * n + row] : 0.f;

  for (int j0 = 0; j0 < m_end; j0 += kTile) {
    const int jn = min(kTile, m - j0);
    if (kMasked && kvg != nullptr) {
      if (tid < kTile) kv_s[tid] = tid < jn ? kvg[j0 + tid] : 0;
      if (!__syncthreads_or(tid < kTile && kv_s[tid])) continue;
    }
    for (int e = tid; e < kTile * D; e += kRows) {
      const int j = e / D;
      const int d = e - j * D;
      const bool in = j < jn;
      k_s[j][d] = in ? kg[(long long)(j0 + j) * D + d] : 0.f;
      v_s[j][d] = in ? vg[(long long)(j0 + j) * D + d] : 0.f;
    }
    if (bg != nullptr) {
      for (int e = tid; e < kRows * kTile; e += kRows) {
        const int r = e / kTile;
        const int j = e - r * kTile;
        b_s[r][j] = (row0 + r < n && j < jn) ? bg[(long long)(row0 + r) * m + j0 + j]
                                              : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float s = dot_shared<D>(k_s[j], qr) * scale;
      if (bg != nullptr) s += b_s[tid][j];
      const bool ok = j < jn && (!kMasked || cell_ok(causal, j0 + j, qpos,
                                                     kvg == nullptr || kv_s[j]));
      const float p = ok ? expf(s - lse_r) : 0.f;
      const float ds = p * (dot_shared<D>(v_s[j], dor) - delta_r);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[j][d]);
        acc[d] += ds * kk.x;
        acc[d + 1] += ds * kk.y;
        acc[d + 2] += ds * kk.z;
        acc[d + 3] += ds * kk.w;
      }
    }
    __syncthreads();
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) dq[base + d] = acc[d] * scale;
  }
}

// grid (b*h, ceil(m / kRows)); block kRows.  Thread j owns key row j.
template <int D, bool kMasked>
__global__ void __launch_bounds__(kRows)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const unsigned char* __restrict__ kv_mask,
                     const int* __restrict__ q_offset, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ dout,
                     float* __restrict__ dk, float* __restrict__ dv, int heads, int n, int m,
                     int bias_stride_b, int bias_stride_h, int causal, float scale) {
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int hd = bh - b * heads;
  const int tid = threadIdx.x;
  const int col0 = blockIdx.y * kRows;
  const int col = col0 + tid;
  const bool live = col < m;

  const float* qg = q + (long long)bh * n * D;
  const float* dog = dout + (long long)bh * n * D;
  const float* lg = lse + (long long)bh * n;
  const float* dg = delta + (long long)bh * n;
  const float* bg = bias == nullptr
                    ? nullptr
                    : bias + (long long)b * bias_stride_b + (long long)hd * bias_stride_h;
  const unsigned char* kvg = kMasked ? key_row(kv_mask, b, m) : nullptr;
  const int qoff = kMasked ? query_offset(q_offset) : 0;
  const bool key_ok = live && (kvg == nullptr || kvg[col]);

  __shared__ __align__(16) float q_s[kTile][D];
  __shared__ __align__(16) float do_s[kTile][D];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  __shared__ float b_s[kTile][kRows];

  float kr[D], vr[D], dk_acc[D], dv_acc[D];
  const long long base = ((long long)bh * m + col) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    kr[d] = live ? k[base + d] : 0.f;
    vr[d] = live ? v[base + d] : 0.f;
    dk_acc[d] = 0.f;
    dv_acc[d] = 0.f;
  }

  const int first = first_query_row(kMasked && causal, col0, qoff);
  // a block whose keys are all masked out gets no p and no ds
  const bool any_key = kvg == nullptr ? true : __syncthreads_or(key_ok);
  const int i_begin = any_key ? first / kTile * kTile : n;
  for (int i0 = i_begin; i0 < n; i0 += kTile) {
    const int in_rows = min(kTile, n - i0);
    for (int e = tid; e < kTile * D; e += kRows) {
      const int i = e / D;
      const int d = e - i * D;
      const bool in = i < in_rows;
      q_s[i][d] = in ? qg[(long long)(i0 + i) * D + d] : 0.f;
      do_s[i][d] = in ? dog[(long long)(i0 + i) * D + d] : 0.f;
    }
    if (tid < kTile) {
      lse_s[tid] = tid < in_rows ? lg[i0 + tid] : 0.f;
      delta_s[tid] = tid < in_rows ? dg[i0 + tid] : 0.f;
    }
    if (bg != nullptr) {
      for (int e = tid; e < kTile * kRows; e += kRows) {
        const int i = e / kRows;
        const int j = e - i * kRows;
        b_s[i][j] = (i < in_rows && col0 + j < m)
                        ? bg[(long long)(i0 + i) * m + col0 + j]
                        : 0.f;
      }
    }
    __syncthreads();

    // staged rows past n hold zeros, so their ds and p * dO vanish
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      float s = dot_shared<D>(q_s[i], kr) * scale;
      if (bg != nullptr) s += b_s[i][tid];
      const bool ok = i < in_rows && (!kMasked || cell_ok(causal, col, i0 + i + qoff, key_ok));
      const float p = ok ? expf(s - lse_s[i]) : 0.f;
      const float ds = p * (dot_shared<D>(do_s[i], vr) - delta_s[i]);
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(&q_s[i][d]);
        const float4 gg = *reinterpret_cast<const float4*>(&do_s[i][d]);
        dk_acc[d] += ds * qq.x;
        dk_acc[d + 1] += ds * qq.y;
        dk_acc[d + 2] += ds * qq.z;
        dk_acc[d + 3] += ds * qq.w;
        dv_acc[d] += p * gg.x;
        dv_acc[d + 1] += p * gg.y;
        dv_acc[d + 2] += p * gg.z;
        dv_acc[d + 3] += p * gg.w;
      }
    }
    __syncthreads();
  }

  // rows with no valid key spread their dO over all m keys (weights 1/m)
  if (kMasked) {
    __shared__ float e_s[D];
    if (__syncthreads_or(some_empty_row(lg, n, tid, kRows))) {
      if (tid < D) e_s[tid] = empty_rows_dout_share(lg, dog, n, m, D, tid);
      __syncthreads();
#pragma unroll
      for (int d = 0; d < D; ++d) dv_acc[d] += e_s[d];
    }
  }

  if (live) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dk[base + d] = dk_acc[d] * scale;
      dv[base + d] = dv_acc[d];
    }
  }
}

// grid (bias slabs, ceil(n / kTile), ceil(m / kRows)); block kRows.  Thread j
// owns key column j of a kTile x kRows tile of one slab; the block loops over
// the `items` batch items g = slab + t * item_stride that share the slab.
template <int D, bool kMasked>
__global__ void __launch_bounds__(kRows)
flash_bwd_dbias_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ bias,
                       const unsigned char* __restrict__ kv_mask,
                       const int* __restrict__ q_offset, const float* __restrict__ lse,
                       const float* __restrict__ delta, const float* __restrict__ dout,
                       float* __restrict__ dbias, int heads, int n, int m, int items,
                       int item_stride, int causal, float scale) {
  const int slab = blockIdx.x;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.z * kRows;
  const int tid = threadIdx.x;
  const int col = col0 + tid;
  const bool live = col < m;
  const int in_rows = min(kTile, n - row0);
  const float* bg = bias + (long long)slab * n * m;
  const int qoff = kMasked ? query_offset(q_offset) : 0;

  __shared__ __align__(16) float q_s[kTile][D];
  __shared__ __align__(16) float do_s[kTile][D];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];
  __shared__ float b_s[kTile][kRows];

  float acc[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) acc[i] = 0.f;

  // causal: a tile wholly above the diagonal has ds = 0 everywhere
  const bool run = !kMasked || !causal || col0 <= row0 + kTile - 1 + qoff;
  if (run) {
    for (int e = tid; e < kTile * kRows; e += kRows) {
      const int i = e / kRows;
      const int j = e - i * kRows;
      b_s[i][j] = (i < in_rows && col0 + j < m)
                      ? bg[(long long)(row0 + i) * m + col0 + j]
                      : 0.f;
    }
  }
  for (int t = 0; run && t < items; ++t) {
    const long long g = slab + (long long)t * item_stride;
    const bool key_ok = !kMasked || kv_mask == nullptr || (live && kv_mask[(g / heads) * m + col]);
    float kr[D], vr[D];
    const long long kbase = (g * m + col) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      kr[d] = live ? k[kbase + d] : 0.f;
      vr[d] = live ? v[kbase + d] : 0.f;
    }
    const long long qbase = (g * n + row0) * D;
    for (int e = tid; e < kTile * D; e += kRows) {
      const int i = e / D;
      const bool in = i < in_rows;
      q_s[i][e - i * D] = in ? q[qbase + e] : 0.f;
      do_s[i][e - i * D] = in ? dout[qbase + e] : 0.f;
    }
    if (tid < kTile) {
      lse_s[tid] = tid < in_rows ? lse[g * n + row0 + tid] : 0.f;
      delta_s[tid] = tid < in_rows ? delta[g * n + row0 + tid] : 0.f;
    }
    __syncthreads();

    // rows past n: q and dO staged as zeros, so p * (dp - delta) = p * 0
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const float s = dot_shared<D>(q_s[i], kr) * scale + b_s[i][tid];
      const bool ok = !kMasked || cell_ok(causal, col, row0 + i + qoff, key_ok);
      const float p = ok ? expf(s - lse_s[i]) : 0.f;
      acc[i] += p * (dot_shared<D>(do_s[i], vr) - delta_s[i]);
    }
    __syncthreads();
  }

  if (live) {
    float* out = dbias + (long long)slab * n * m;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (i < in_rows) out[(long long)(row0 + i) * m + col] = acc[i];
    }
  }
}

// ---------------------------------------------------------------- bf16: mma.sync

using bf16 = flash_tiles::bf16;
using flash_tiles::kLdBias;
using flash_tiles::kPad;
using flash_tiles::kThreads;
using flash_tiles::next_live_tile;
using flash_tiles::stage_bias;
using flash_tiles::stage_rows;

constexpr int kBlk = flash_tiles::kTile;   // rows a block owns, and rows of a walked tile
constexpr float kLog2e = 1.4426950408889634f;

extern __shared__ __align__(16) unsigned char smem_bwd[];

// the two bf16 values of a 32-bit word as fp32, the lower column first
__device__ __forceinline__ float2 bf_pair(const bf16* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// 64 fp32 values of a row vector (a tile's lse or delta) into dst by 4-byte
// cp.async, one a thread of threads [first, first + kBlk); past `rows` zero
__device__ __forceinline__ void stage_vector(float* dst, const float* src, int rows, int first) {
  const int i = (int)threadIdx.x - first;
  if (i >= 0 && i < kBlk) warp_mma::cp_async4(dst + i, i < rows ? src + i : src, i < rows ? 4 : 0);
}

// The warp's A fragments of a 16 x D tile at `rows` (row stride D + kPad):
// ldmatrix's matrices 0-3 are (rows 0-7, 8-15) x (columns 16kk + 0-7, + 8-15)
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const bf16* rows) {
  const int lane = threadIdx.x & 31;
  const bf16* p = rows + (lane & 15) * (D + kPad) + 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) warp_mma::ldsm_x4(a[kk], p + 16 * kk);
}

// c (16 x 16, two 16 x 8 tiles) += A B^T: A the 16 x D fragments, B the 16
// rows (keys, or queries) x D at `rows` in shared memory; ldmatrix's
// matrices are rows 0-7, 8-15 times the column halves of each k-step
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[2][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* rows) {
  const int lane = threadIdx.x & 31;
  const bf16* p = rows + (8 * (lane >> 4) + (lane & 7)) * (D + kPad) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t f[4];
    warp_mma::ldsm_x4(f, p + 16 * kk);
    warp_mma::mma_bf16_16816(c[0], a[kk], f[0], f[1]);
    warp_mma::mma_bf16_16816(c[1], a[kk], f[2], f[3]);
  }
}

// the same with A's fragments read from the warp's 16 rows at `a_rows` in
// shared memory at each k-step (head dim 128: the registers cannot hold
// them for the whole walk beside the 16 x 128 accumulators)
template <int D>
__device__ __forceinline__ void mma_abt_rows(float (&c)[2][4], const bf16* a_rows,
                                             const bf16* rows) {
  const int lane = threadIdx.x & 31;
  const bf16* pa = a_rows + (lane & 15) * (D + kPad) + 8 * (lane >> 4);
  const bf16* p = rows + (8 * (lane >> 4) + (lane & 7)) * (D + kPad) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4], f[4];
    warp_mma::ldsm_x4(a, pa + 16 * kk);
    warp_mma::ldsm_x4(f, p + 16 * kk);
    warp_mma::mma_bf16_16816(c[0], a, f[0], f[1]);
    warp_mma::mma_bf16_16816(c[1], a, f[2], f[3]);
  }
}

// whether a kernel holds its A operands (Q and dO, or K and V) in registers
// for its whole walk: up to head dim 64; at 128 they are read per k-step
template <int D>
constexpr bool kHoldA = D <= 64;

// o (16 x D) += A B: A the sum of N 16 x 16 fragments, B the 16 rows x D
// at `rows` in shared memory, read transposed (matrices: rows 0-7, 8-15
// times the column blocks i, i + 1)
template <int D, int N>
__device__ __forceinline__ void mma_ab(float (&o)[D / 8][4], const uint32_t (&a)[N][4],
                                       const bf16* rows) {
  const int lane = threadIdx.x & 31;
  const bf16* p = rows + (lane & 15) * (D + kPad) + 8 * (lane >> 4);
#pragma unroll
  for (int i = 0; i < D / 8; i += 2) {
    uint32_t f[4];
    warp_mma::ldsm_x4_trans(f, p + 8 * i);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      warp_mma::mma_bf16_16816(o[i], a[k], f[0], f[1]);
      warp_mma::mma_bf16_16816(o[i + 1], a[k], f[2], f[3]);
    }
  }
}

// two 16 x 8 accumulator tiles (columns 0-7, 8-15), rounded to bf16: the A
// fragment of a product over those 16 columns
__device__ __forceinline__ void to_a(uint32_t (&f)[4], const float (&x)[2][4]) {
  f[0] = warp_mma::pack_bf16(x[0][0], x[0][1]);
  f[1] = warp_mma::pack_bf16(x[0][2], x[0][3]);
  f[2] = warp_mma::pack_bf16(x[1][0], x[1][1]);
  f[3] = warp_mma::pack_bf16(x[1][2], x[1][3]);
}

// the same as two fragments whose sum is x to about 2^-16: f[0] x rounded,
// f[1] the rest rounded.  dS goes to the tensor cores so: its terms cancel
// in dQ and dK (each row of ds sums to 0), and one bf16 rounding of them
// leaves errors of 2^-9 of the terms, not of the result
__device__ __forceinline__ void to_a_split(uint32_t (&f)[2][4], const float (&x)[2][4]) {
  to_a(f[0], x);
  float rest[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t w = f[0][2 * j + r];
      rest[j][2 * r] = x[j][2 * r] - __uint_as_float(w << 16);
      rest[j][2 * r + 1] = x[j][2 * r + 1] - __uint_as_float(w & 0xffff0000u);
    }
  to_a(f[1], rest);
}

// The warp's 16 x D accumulator times `mul` into its 16 rows of `tile`
// (bf16, row stride D + kPad), then rows [0, rows) of it to dst (row stride
// D), 16 bytes a copy with `vec`
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, bf16* tile, const float (&o)[D / 8][4],
                                           float mul, int rows, bool vec) {
  constexpr int kLd = D + kPad;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(tile + (g + 8 * r) * kLd + 8 * i + 2 * t) =
          warp_mma::pack_bf16(o[i][2 * r] * mul, o[i][2 * r + 1] * mul);
  __syncwarp();
  if (vec) {
    constexpr int kChunks = D / 8;
    for (int e = lane; e < rows * kChunks; e += 32) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * 8;
      *reinterpret_cast<uint4*>(dst + (long long)r * D + c) =
          *reinterpret_cast<const uint4*>(tile + r * kLd + c);
    }
  } else {
    for (int e = lane; e < rows * D; e += 32) {
      const int r = e / D;
      dst[(long long)r * D + e - r * D] = tile[r * kLd + e - r * D];
    }
  }
}

// ---- dQ

// Shared memory: the block's Q (later dQ) and dO, two K, two V tiles, two
// tiles' key flags, two bias tiles.
template <int D>
struct DqSmem {
  static constexpr int kLd = D + kPad;
  static constexpr int kRowsT = kBlk * kLd;   // elements of one 64-row tile
  static constexpr int kBias = kBlk * kLdBias;
  static constexpr size_t kFlags = (size_t)6 * kRowsT * 2;   // byte offsets
  static constexpr size_t kBiasAt = kFlags + 2 * kBlk;
  static size_t bytes(bool bias) { return kBiasAt + (bias ? (size_t)2 * kBias * 2 : 0); }
};

// grid (batch * heads * ceil(n / kBlk)), batch item fastest, the last query
// tiles first; block kThreads; dynamic shared memory DqSmem<D>::bytes.
template <int D, bool kMasked>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_mma_kernel(const BwdArgs a) {
  using Smem = DqSmem<D>;
  constexpr int kLd = Smem::kLd;
  const int n = a.n, m = a.m;
  int id = blockIdx.x;
  const int b = id % a.batch;
  id /= a.batch;
  const int hd = id % a.heads;
  const int row0 = (cdiv(n, kBlk) - 1 - id / a.heads) * kBlk;
  const int bh = b * a.heads + hd;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  bf16* q_s = reinterpret_cast<bf16*>(smem_bwd);
  bf16* do_s = q_s + Smem::kRowsT;
  bf16* k_s = do_s + Smem::kRowsT;       // [2][kRowsT]
  bf16* v_s = k_s + 2 * Smem::kRowsT;    // [2][kRowsT]
  unsigned char* kv_s = smem_bwd + Smem::kFlags;                  // [2][kBlk]
  bf16* b_s = reinterpret_cast<bf16*>(smem_bwd + Smem::kBiasAt);  // [2][kBias]

  const long long qrow = (long long)bh * n + row0;
  const bf16* kg = static_cast<const bf16*>(a.k) + (long long)bh * m * D;
  const bf16* vg = static_cast<const bf16*>(a.v) + (long long)bh * m * D;
  const bf16* bg = a.bias == nullptr
                       ? nullptr
                       : static_cast<const bf16*>(a.bias) + (long long)b * a.bias_stride_b +
                             (long long)hd * a.bias_stride_h + (long long)row0 * m;
  const unsigned char* kvg = kMasked ? key_row(a.kv_mask, b, m) : nullptr;
  const int qoff = kMasked ? query_offset(a.q_offset) : 0;
  const int m_end = causal_key_end(kMasked && a.causal, row0, kBlk, qoff, m);
  const int q_rows = min(kBlk, n - row0);
  const bool vec = a.vec != 0;

  // the copies of key tile j0 into ring slot `slot`
  auto fetch = [&](int slot, int j0) {
    const int jn = min(kBlk, m - j0);
    stage_rows<D>(k_s + slot * Smem::kRowsT, kg + (long long)j0 * D, jn, vec);
    stage_rows<D>(v_s + slot * Smem::kRowsT, vg + (long long)j0 * D, jn, vec);
    if (bg != nullptr)
      stage_bias(b_s + slot * Smem::kBias, bg + j0, q_rows, jn, m, a.vec_bias != 0);
  };
  // kv_mask: thread t < kBlk holds the flag of key j + t (0 past m), loaded
  // one tile ahead, as in the forward
  const bool kv_masked = kMasked && kvg != nullptr;
  auto kv_flag = [&](int j) -> unsigned char {
    return threadIdx.x < kBlk && j + (int)threadIdx.x < m ? kvg[j + threadIdx.x] : 0;
  };
  unsigned char kv_ahead = 0;

  stage_rows<D>(q_s, static_cast<const bf16*>(a.q) + qrow * D, q_rows, vec);
  stage_rows<D>(do_s, static_cast<const bf16*>(a.dout) + qrow * D, q_rows, vec);
  int j0 = kv_masked ? next_live_tile(0, m_end, m, kvg) : 0;
  if (j0 < m_end) {
    fetch(0, j0);
    if (kv_masked) {
      if (threadIdx.x < kBlk) kv_s[threadIdx.x] = kv_flag(j0);
      kv_ahead = kv_flag(j0 + kBlk);
    }
  }
  warp_mma::cp_async_commit();
  warp_mma::cp_async_wait<0>();
  __syncthreads();

  constexpr int kA = kHoldA<D> ? D / 16 : 1;
  uint32_t qf[kA][4], dof[kA][4];
  const bf16* q_w = q_s + warp * 16 * kLd;
  const bf16* do_w = do_s + warp * 16 * kLd;
  if constexpr (kHoldA<D>) {
    load_a<D>(qf, q_w);
    load_a<D>(dof, do_w);
  }

  // this lane's two rows: g and g + 8 of the warp's 16 (r = 0, 1)
  const int qi0 = row0 + warp * 16 + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qi0 + 8 * r;
    lse2[r] = qi < n ? a.lse[(long long)bh * n + qi] * kLog2e : 0.f;
    dl[r] = qi < n ? a.delta[(long long)bh * n + qi] : 0.f;
  }
  const float scale2 = a.scale * kLog2e;
  float dq[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  int slot = 0;
  while (j0 < m_end) {
    const int jn = min(kBlk, m - j0);
    int j1 = j0 + kBlk;
    if (kv_masked && j1 < m_end && !__syncthreads_or(kv_ahead != 0))
      j1 = next_live_tile(j1 + kBlk, m_end, m, kvg);
    if (j1 < m_end) {
      fetch(slot ^ 1, j1);
      if (kv_masked) {
        if (threadIdx.x < kBlk)
          kv_s[(slot ^ 1) * kBlk + threadIdx.x] = j1 == j0 + kBlk ? kv_ahead : kv_flag(j1);
        kv_ahead = kv_flag(j1 + kBlk);
      }
    }
    warp_mma::cp_async_commit();
    warp_mma::cp_async_wait<1>();   // all but the copies just started: tile j0 is in
    __syncthreads();

    const bf16* kt = k_s + slot * Smem::kRowsT;
    const bf16* vt = v_s + slot * Smem::kRowsT;
    const bf16* bt = b_s + slot * Smem::kBias + (warp * 16 + g) * kLdBias + 2 * t;
    const unsigned char* kvt = kv_s + slot * kBlk + 2 * t;
    // cell (r, col) is valid when col <= lim[r] (the tile's last key and,
    // causal, the row's last visible key) and its key is real
    int lim[2] = {jn - 1, jn - 1};
    if (kMasked && a.causal) {
      lim[0] = min(lim[0], qi0 + qoff - j0);
      lim[1] = min(lim[1], qi0 + 8 + qoff - j0);
    }
#pragma unroll
    for (int c = 0; c < kBlk / 16; ++c) {
      if (16 * c >= jn) break;
      float s[2][4] = {}, dp[2][4] = {};
      if constexpr (kHoldA<D>) {
        mma_abt<D>(s, qf, kt + 16 * c * kLd);
        mma_abt<D>(dp, dof, vt + 16 * c * kLd);
      } else {
        mma_abt_rows<D>(s, q_w, kt + 16 * c * kLd);
        mma_abt_rows<D>(dp, do_w, vt + 16 * c * kLd);
      }
      // s becomes ds = p (dp - delta), p = exp2(s scale log2e + bias log2e - lse log2e)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = 16 * c + 8 * j + 2 * t;
          float2 bias = make_float2(0.f, 0.f);
          if (bg != nullptr) bias = bf_pair(bt + r * 8 * kLdBias + 16 * c + 8 * j);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * r + h;
            bool ok = col + h <= lim[r];
            if (kv_masked) ok = ok && kvt[16 * c + 8 * j + h] != 0;
            const float x = fmaf(s[j][e], scale2, fmaf(h ? bias.y : bias.x, kLog2e, -lse2[r]));
            const float p = ok ? warp_mma::exp2_approx(x) : 0.f;
            s[j][e] = p * (dp[j][e] - dl[r]);
          }
        }
      }
      uint32_t dsf[2][4];
      to_a_split(dsf, s);
      mma_ab<D, 2>(dq, dsf, kt + 16 * c * kLd);   // dQ += dS K
    }
    __syncthreads();   // this slot is refilled by the next tile's copies
    slot ^= 1;
    j0 = j1;
  }

  // dQ = scale * the sum, through the warp's own rows of q_s
  const int w_row = row0 + warp * 16;
  store_rows<D>(static_cast<bf16*>(a.dq) + ((long long)bh * n + w_row) * D, q_s + warp * 16 * kLd,
                dq, a.scale, min(16, n - w_row), vec);
}

// ---- dK/dV

// Shared memory: the block's K and V (later dK and dV), two Q and two dO
// tiles, two lse and two delta vectors, two bias tiles.
template <int D>
struct DkvSmem {
  static constexpr int kLd = D + kPad;
  static constexpr int kRowsT = kBlk * kLd;
  static constexpr int kBias = kBlk * kLdBias;
  static constexpr size_t kStatsAt = (size_t)6 * kRowsT * 2;   // lse [2][kBlk], delta [2][kBlk]
  static constexpr size_t kBiasAt = kStatsAt + 4 * kBlk * 4;
  static size_t bytes(bool bias) { return kBiasAt + (bias ? (size_t)2 * kBias * 2 : 0); }
};

// Column d of dO summed over the rows with no valid key, over m, into
// e_s[d] (d < D): what each dv row gets from them.  The block's threads
// split the rows into kThreads / D groups and add the groups' partial sums
// (in `part`, kThreads floats) in order.
template <int D>
__device__ __forceinline__ void empty_rows_share(float* e_s, float* part, const float* lg,
                                                 const bf16* dog, int n, int m) {
  constexpr int kGroups = kThreads / D;
  const int d = threadIdx.x % D;
  float e = 0.f;
  for (int i = threadIdx.x / D; i < n; i += kGroups)
    if (lg[i] <= kEmptyLse) e += to_float(dog[(long long)i * D + d]);
  part[threadIdx.x] = e;
  __syncthreads();
  if (threadIdx.x < D) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) sum += part[k * D + threadIdx.x];
    e_s[threadIdx.x] = sum / m;
  }
  __syncthreads();
}

// grid (batch * heads * ceil(m / kBlk)), batch item fastest, the first key
// tiles first (causal: the longest walks); block kThreads; dynamic shared
// memory DkvSmem<D>::bytes.
template <int D, bool kMasked>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_mma_kernel(const BwdArgs a) {
  using Smem = DkvSmem<D>;
  constexpr int kLd = Smem::kLd;
  const int n = a.n, m = a.m;
  int id = blockIdx.x;
  const int b = id % a.batch;
  id /= a.batch;
  const int hd = id % a.heads;
  const int col0 = id / a.heads * kBlk;
  const int bh = b * a.heads + hd;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  bf16* k_s = reinterpret_cast<bf16*>(smem_bwd);
  bf16* v_s = k_s + Smem::kRowsT;
  bf16* q_s = v_s + Smem::kRowsT;        // [2][kRowsT]
  bf16* do_s = q_s + 2 * Smem::kRowsT;   // [2][kRowsT]
  float* lse_s = reinterpret_cast<float*>(smem_bwd + Smem::kStatsAt);   // [2][kBlk]
  float* del_s = lse_s + 2 * kBlk;                                       // [2][kBlk]
  bf16* b_s = reinterpret_cast<bf16*>(smem_bwd + Smem::kBiasAt);        // [2][kBias]

  const bf16* qg = static_cast<const bf16*>(a.q) + (long long)bh * n * D;
  const bf16* dog = static_cast<const bf16*>(a.dout) + (long long)bh * n * D;
  const float* lg = a.lse + (long long)bh * n;
  const float* dg = a.delta + (long long)bh * n;
  const bf16* bg = a.bias == nullptr
                       ? nullptr
                       : static_cast<const bf16*>(a.bias) + (long long)b * a.bias_stride_b +
                             (long long)hd * a.bias_stride_h + col0;
  const unsigned char* kvg = kMasked ? key_row(a.kv_mask, b, m) : nullptr;
  const int qoff = kMasked ? query_offset(a.q_offset) : 0;
  const int k_rows = min(kBlk, m - col0);
  const bool vec = a.vec != 0;
  const long long krow = (long long)bh * m + col0;

  // the copies of query tile i into ring slot `slot`
  auto fetch = [&](int slot, int i) {
    const int rows = min(kBlk, n - i);
    stage_rows<D>(q_s + slot * Smem::kRowsT, qg + (long long)i * D, rows, vec);
    stage_rows<D>(do_s + slot * Smem::kRowsT, dog + (long long)i * D, rows, vec);
    stage_vector(lse_s + slot * kBlk, lg + i, rows, 0);
    stage_vector(del_s + slot * kBlk, dg + i, rows, kBlk);
    if (bg != nullptr)
      stage_bias(b_s + slot * Smem::kBias, bg + (long long)i * m, rows, k_rows, m,
                 a.vec_bias != 0);
  };

  stage_rows<D>(k_s, static_cast<const bf16*>(a.k) + krow * D, k_rows, vec);
  stage_rows<D>(v_s, static_cast<const bf16*>(a.v) + krow * D, k_rows, vec);
  // this lane's two keys: g and g + 8 of the warp's 16 (r = 0, 1)
  const int kj0 = col0 + warp * 16 + g;
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_ok[r] = kj0 + 8 * r < m && (!kMasked || kvg == nullptr || kvg[kj0 + 8 * r]);
  // a block whose keys are all masked out gets no p and no ds
  const bool any_key = !kMasked || kvg == nullptr ||
                       __syncthreads_or(threadIdx.x < kBlk && (int)threadIdx.x < k_rows &&
                                        kvg[col0 + threadIdx.x]);
  const int first = first_query_row(kMasked && a.causal, col0, qoff);
  int i0 = any_key ? first / kBlk * kBlk : n;
  if (i0 < n) fetch(0, i0);
  warp_mma::cp_async_commit();
  warp_mma::cp_async_wait<0>();
  __syncthreads();

  constexpr int kA = kHoldA<D> ? D / 16 : 1;
  uint32_t kf[kA][4], vf[kA][4];
  const bf16* k_w = k_s + warp * 16 * kLd;
  const bf16* v_w = v_s + warp * 16 * kLd;
  if constexpr (kHoldA<D>) {
    load_a<D>(kf, k_w);
    load_a<D>(vf, v_w);
  }
  const float scale2 = a.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  int slot = 0;
  while (i0 < n) {
    const int i1 = i0 + kBlk;
    if (i1 < n) fetch(slot ^ 1, i1);
    warp_mma::cp_async_commit();
    warp_mma::cp_async_wait<1>();   // query tile i0 is in
    __syncthreads();

    const bf16* qt = q_s + slot * Smem::kRowsT;
    const bf16* dt = do_s + slot * Smem::kRowsT;
    const float* lt = lse_s + slot * kBlk;
    const float* delt = del_s + slot * kBlk;
    const bf16* bt = b_s + slot * Smem::kBias + warp * 16 + g;
#pragma unroll
    for (int c = 0; c < kBlk / 16; ++c) {
      if (i0 + 16 * c >= n) break;
      // the transposed tile: rows are this warp's keys, columns 16 queries
      float st[2][4] = {}, dpt[2][4] = {};
      if constexpr (kHoldA<D>) {
        mma_abt<D>(st, kf, qt + 16 * c * kLd);
        mma_abt<D>(dpt, vf, dt + 16 * c * kLd);
      } else {
        mma_abt_rows<D>(st, k_w, qt + 16 * c * kLd);
        mma_abt_rows<D>(dpt, v_w, dt + 16 * c * kLd);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = 16 * c + 8 * j + 2 * t;   // tile row of the query of h = 0
        const float2 l2 = *reinterpret_cast<const float2*>(lt + qc);
        const float2 dl = *reinterpret_cast<const float2*>(delt + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, h = e & 1;
          const int qi = i0 + qc + h;
          bool ok = qi < n && key_ok[r];
          if (kMasked && a.causal) ok = ok && kj0 + 8 * r <= qi + qoff;
          float x = fmaf(st[j][e], scale2, -(h ? l2.y : l2.x) * kLog2e);
          // the bias of (query qc + h, key g + 8r): the (query, key) tile read transposed
          if (bg != nullptr) x = fmaf(to_float(bt[(qc + h) * kLdBias + 8 * r]), kLog2e, x);
          const float p = ok ? warp_mma::exp2_approx(x) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - (h ? dl.y : dl.x));
        }
      }
      uint32_t pf[1][4], dsf[2][4];
      to_a(pf[0], st);
      to_a_split(dsf, dpt);
      mma_ab<D, 1>(dv, pf, dt + 16 * c * kLd);    // dV += P^T dO
      mma_ab<D, 2>(dk, dsf, qt + 16 * c * kLd);   // dK += dS^T Q
    }
    __syncthreads();   // this slot is refilled by the next tile's copies
    slot ^= 1;
    i0 = i1;
  }

  // rows with no valid key spread their dO over all m keys (weights 1/m);
  // the ring's lse and delta vectors are free now
  if (kMasked && __syncthreads_or(some_empty_row(lg, n, threadIdx.x, kThreads))) {
    float* e_s = lse_s;
    empty_rows_share<D>(e_s, del_s, lg, dog, n, m);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float2 e = *reinterpret_cast<const float2*>(e_s + 8 * i + 2 * t);
      dv[i][0] += e.x;
      dv[i][1] += e.y;
      dv[i][2] += e.x;
      dv[i][3] += e.y;
    }
  }

  const int w_key = col0 + warp * 16;
  const int rows = min(16, m - w_key);
  const long long at = ((long long)bh * m + w_key) * D;
  store_rows<D>(static_cast<bf16*>(a.dk) + at, k_s + warp * 16 * kLd, dk, a.scale, rows, vec);
  store_rows<D>(static_cast<bf16*>(a.dv) + at, v_s + warp * 16 * kLd, dv, 1.f, rows, vec);
}

// ---- d(bias)

// Shared memory: two ring stages, each one item's Q and dO (64 query rows),
// K and V (64 keys), lse and delta, key flags; then the block's bias tile
// (at the end the d(bias) tile).
template <int D>
struct DbSmem {
  static constexpr int kLd = D + kPad;
  static constexpr int kRowsT = kBlk * kLd;
  static constexpr size_t kStatsAt = (size_t)4 * kRowsT * 2;   // within a stage
  static constexpr size_t kFlagsAt = kStatsAt + 2 * kBlk * 4;
  static constexpr size_t kStage = kFlagsAt + kBlk;
  static constexpr size_t kBiasAt = 2 * kStage;
  static constexpr size_t kBytes = kBiasAt + (size_t)kBlk * kLdBias * 2;
};

// grid (slabs * ceil(n / kBlk) * ceil(m / kBlk)), key tile fastest; block
// kThreads; dynamic shared memory DbSmem<D>::kBytes.  The block owns rows
// [row0, row0 + kBlk) x keys [col0, col0 + kBlk) of bias slab `slab` and
// walks the `items` batch items g = slab + t * item_stride in order.
template <int D, bool kMasked>
__global__ void __launch_bounds__(kThreads) flash_bwd_dbias_mma_kernel(const BwdArgs a) {
  using Smem = DbSmem<D>;
  constexpr int kLd = Smem::kLd;
  const int n = a.n, m = a.m;
  const int tiles_m = cdiv(m, kBlk), tiles_n = cdiv(n, kBlk);
  int id = blockIdx.x;
  const int col0 = id % tiles_m * kBlk;
  id /= tiles_m;
  const int row0 = id % tiles_n * kBlk;
  const int slab = id / tiles_n;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q_rows = min(kBlk, n - row0), k_rows = min(kBlk, m - col0);
  const int qoff = kMasked ? query_offset(a.q_offset) : 0;
  const bool kv_masked = kMasked && a.kv_mask != nullptr;
  const bool vec = a.vec != 0;
  bf16* b_s = reinterpret_cast<bf16*>(smem_bwd + Smem::kBiasAt);

  auto stage = [&](int slot) { return smem_bwd + slot * Smem::kStage; };
  // the copies of item it into ring slot `slot`
  auto fetch = [&](int slot, int it) {
    const long long gi = slab + (long long)it * a.item_stride;
    bf16* base = reinterpret_cast<bf16*>(stage(slot));
    const long long qrow = gi * n + row0, krow = gi * m + col0;
    stage_rows<D>(base, static_cast<const bf16*>(a.q) + qrow * D, q_rows, vec);
    stage_rows<D>(base + Smem::kRowsT, static_cast<const bf16*>(a.dout) + qrow * D, q_rows, vec);
    stage_rows<D>(base + 2 * Smem::kRowsT, static_cast<const bf16*>(a.k) + krow * D, k_rows, vec);
    stage_rows<D>(base + 3 * Smem::kRowsT, static_cast<const bf16*>(a.v) + krow * D, k_rows, vec);
    float* stats = reinterpret_cast<float*>(stage(slot) + Smem::kStatsAt);
    stage_vector(stats, a.lse + qrow, q_rows, 0);
    stage_vector(stats + kBlk, a.delta + qrow, q_rows, kBlk);
    if (kv_masked && threadIdx.x < kBlk)
      stage(slot)[Smem::kFlagsAt + threadIdx.x] =
          (int)threadIdx.x < k_rows ? a.kv_mask[gi / a.heads * m + col0 + threadIdx.x] : 0;
  };

  // this lane's two rows: g and g + 8 of the warp's 16 (r = 0, 1); cell
  // (r, col) is valid when col <= lim[r] (the tile's last key and, causal,
  // the row's last visible key; -1 for a row past n) and its key is real
  const int qi0 = row0 + warp * 16 + g;
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lim[r] = qi0 + 8 * r < n ? k_rows - 1 : -1;
    if (kMasked && a.causal) lim[r] = min(lim[r], qi0 + 8 * r + qoff - col0);
  }
  float acc[kBlk / 8][4];
#pragma unroll
  for (int j = 0; j < kBlk / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // causal: a tile wholly above the diagonal has ds = 0 everywhere
  const bool run = !kMasked || !a.causal || col0 <= row0 + kBlk - 1 + qoff;
  if (run) {
    stage_bias(b_s, static_cast<const bf16*>(a.bias) + (long long)slab * n * m +
                        (long long)row0 * m + col0,
               q_rows, k_rows, m, a.vec_bias != 0);
    fetch(0, 0);
    warp_mma::cp_async_commit();
    const float scale2 = a.scale * kLog2e;
    const bf16* bt = b_s + (warp * 16 + g) * kLdBias + 2 * t;
    for (int it = 0, slot = 0; it < a.items; ++it, slot ^= 1) {
      if (it + 1 < a.items) fetch(slot ^ 1, it + 1);
      warp_mma::cp_async_commit();
      warp_mma::cp_async_wait<1>();   // item it (and the bias tile) are in
      __syncthreads();

      const bf16* base = reinterpret_cast<const bf16*>(stage(slot));
      const float* stats = reinterpret_cast<const float*>(stage(slot) + Smem::kStatsAt);
      const unsigned char* kvt = stage(slot) + Smem::kFlagsAt + 2 * t;
      uint32_t qf[D / 16][4], dof[D / 16][4];
      load_a<D>(qf, base + warp * 16 * kLd);
      load_a<D>(dof, base + Smem::kRowsT + warp * 16 * kLd);
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = stats[warp * 16 + g + 8 * r] * kLog2e;
        dl[r] = stats[kBlk + warp * 16 + g + 8 * r];
      }
#pragma unroll
      for (int c = 0; c < kBlk / 16; ++c) {
        if (16 * c >= k_rows) break;
        float s[2][4] = {}, dp[2][4] = {};
        mma_abt<D>(s, qf, base + 2 * Smem::kRowsT + 16 * c * kLd);
        mma_abt<D>(dp, dof, base + 3 * Smem::kRowsT + 16 * c * kLd);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int col = 16 * c + 8 * j + 2 * t;
            const float2 bias = bf_pair(bt + r * 8 * kLdBias + 16 * c + 8 * j);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = 2 * r + h;
              bool ok = col + h <= lim[r];
              if (kv_masked) ok = ok && kvt[16 * c + 8 * j + h] != 0;
              const float x =
                  fmaf(s[j][e], scale2, fmaf(h ? bias.y : bias.x, kLog2e, -lse2[r]));
              const float p = ok ? warp_mma::exp2_approx(x) : 0.f;
              acc[2 * c + j][e] += p * (dp[j][e] - dl[r]);
            }
          }
        }
      }
      __syncthreads();   // this slot is refilled by item it + 2's copies
    }
  }

  // the sums as bf16 into the bias tile's place, then to the slab's rows
#pragma unroll
  for (int j = 0; j < kBlk / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(b_s + (warp * 16 + g + 8 * r) * kLdBias + 8 * j + 2 * t) =
          warp_mma::pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
  __syncthreads();
  bf16* out = static_cast<bf16*>(a.dbias) + (long long)slab * n * m + (long long)row0 * m + col0;
  if (a.vec_bias != 0) {
    constexpr int kChunks = kBlk / 8;
    for (int e = threadIdx.x; e < q_rows * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * 8;
      if (c < k_rows)
        *reinterpret_cast<uint4*>(out + (long long)r * m + c) =
            *reinterpret_cast<const uint4*>(b_s + r * kLdBias + c);
    }
  } else {
    for (int e = threadIdx.x; e < q_rows * kBlk; e += kThreads) {
      const int r = e / kBlk;
      const int c = e - r * kBlk;
      if (c < k_rows) out[(long long)r * m + c] = b_s[r * kLdBias + c];
    }
  }
}

// ---------------------------------------------------------------- launchers

inline bool masked(const BwdArgs& a) { return a.causal || a.kv_mask != nullptr; }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// a bf16 kernel with `smem` bytes of dynamic shared memory on `blocks` blocks
template <typename Kernel>
int launch_mma(Kernel kernel, unsigned blocks, size_t smem, const BwdArgs& a, cudaStream_t st) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();   // leave no stale error for the next launch's check
    return static_cast<int>(err);
  }
  kernel<<<blocks, kThreads, smem, st>>>(a);
  return 0;
}

struct DeltaLaunch {
  template <typename T, int D>
  static void run(const BwdArgs& a, cudaStream_t st) {
    const long long rows = (long long)a.batch * a.heads * a.n;
    const long long threads = rows * (D * (long long)sizeof(T) / 16);
    const unsigned blocks = (unsigned)((threads + 255) / 256);
    const T* out = static_cast<const T*>(a.out);
    const T* dout = static_cast<const T*>(a.dout);
    if (aligned16(out) && aligned16(dout)) {
      flash_bwd_delta_kernel<T, D, true><<<blocks, 256, 0, st>>>(out, dout, a.delta, rows);
    } else {
      flash_bwd_delta_kernel<T, D, false><<<blocks, 256, 0, st>>>(out, dout, a.delta, rows);
    }
  }
};

struct DqLaunch {
  template <int D>
  static int bf16(BwdArgs a, cudaStream_t st) {
    a.vec = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout) &&
            aligned16(a.dq);
    a.vec_bias = aligned16(a.bias) && a.m % 8 == 0 && a.bias_stride_b % 8 == 0 &&
                 a.bias_stride_h % 8 == 0;
    const unsigned blocks = (unsigned)(a.batch * a.heads) * cdiv(a.n, kBlk);
    const size_t smem = DqSmem<D>::bytes(a.bias != nullptr);
    return masked(a) ? launch_mma(flash_bwd_dq_mma_kernel<D, true>, blocks, smem, a, st)
                     : launch_mma(flash_bwd_dq_mma_kernel<D, false>, blocks, smem, a, st);
  }
  template <int D>
  static int fp32(const BwdArgs& a, cudaStream_t st) {
    auto kernel = masked(a) ? flash_bwd_dq_kernel<D, true>
                            : flash_bwd_dq_kernel<D, false>;
    kernel<<<dim3(a.batch * a.heads, cdiv(a.n, kRows)), kRows, 0, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.bias), a.kv_mask,
        a.q_offset, a.lse, a.delta, static_cast<const float*>(a.dout),
        static_cast<float*>(a.dq), a.heads, a.n, a.m, a.bias_stride_b, a.bias_stride_h,
        a.causal, a.scale);
    return 0;
  }
};

struct DkvLaunch {
  template <int D>
  static int bf16(BwdArgs a, cudaStream_t st) {
    a.vec = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout) &&
            aligned16(a.dk) && aligned16(a.dv);
    a.vec_bias = aligned16(a.bias) && a.m % 8 == 0 && a.bias_stride_b % 8 == 0 &&
                 a.bias_stride_h % 8 == 0;
    const unsigned blocks = (unsigned)(a.batch * a.heads) * cdiv(a.m, kBlk);
    const size_t smem = DkvSmem<D>::bytes(a.bias != nullptr);
    return masked(a) ? launch_mma(flash_bwd_dkv_mma_kernel<D, true>, blocks, smem, a, st)
                     : launch_mma(flash_bwd_dkv_mma_kernel<D, false>, blocks, smem, a, st);
  }
  template <int D>
  static int fp32(const BwdArgs& a, cudaStream_t st) {
    auto kernel = masked(a) ? flash_bwd_dkv_kernel<D, true>
                            : flash_bwd_dkv_kernel<D, false>;
    kernel<<<dim3(a.batch * a.heads, cdiv(a.m, kRows)), kRows, 0, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.bias), a.kv_mask,
        a.q_offset, a.lse, a.delta, static_cast<const float*>(a.dout),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.heads, a.n, a.m,
        a.bias_stride_b, a.bias_stride_h, a.causal, a.scale);
    return 0;
  }
};

struct DbiasLaunch {
  template <int D>
  static int bf16(BwdArgs a, cudaStream_t st) {
    a.vec = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && aligned16(a.dout);
    a.vec_bias = aligned16(a.bias) && aligned16(a.dbias) && a.m % 8 == 0;
    const unsigned blocks =
        (unsigned)(a.batch * a.heads / a.items) * cdiv(a.n, kBlk) * cdiv(a.m, kBlk);
    const size_t smem = DbSmem<D>::kBytes;
    return masked(a) ? launch_mma(flash_bwd_dbias_mma_kernel<D, true>, blocks, smem, a, st)
                     : launch_mma(flash_bwd_dbias_mma_kernel<D, false>, blocks, smem, a, st);
  }
  template <int D>
  static int fp32(const BwdArgs& a, cudaStream_t st) {
    // slabs: the leading extent of the bias, b*h items in all
    const int slabs = a.batch * a.heads / a.items;
    auto kernel = masked(a) ? flash_bwd_dbias_kernel<D, true>
                            : flash_bwd_dbias_kernel<D, false>;
    kernel<<<dim3(slabs, cdiv(a.n, kTile), cdiv(a.m, kRows)), kRows, 0, st>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.bias), a.kv_mask,
        a.q_offset, a.lse, a.delta, static_cast<const float*>(a.dout),
        static_cast<float*>(a.dbias), a.heads, a.n, a.m, a.items, a.item_stride, a.causal,
        a.scale);
    return 0;
  }
};

template <typename L>
int dispatch(const BwdArgs& a, int d, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (d) {
    case 16:
      rc = is_bf16 ? L::template bf16<16>(a, st) : L::template fp32<16>(a, st);
      break;
    case 32:
      rc = is_bf16 ? L::template bf16<32>(a, st) : L::template fp32<32>(a, st);
      break;
    case 64:
      rc = is_bf16 ? L::template bf16<64>(a, st) : L::template fp32<64>(a, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

BwdArgs pass_args(const void* q, const void* k, const void* v, const void* bias,
                  const void* kv_mask, const void* q_offset, const void* lse, void* delta,
                  const void* dout, int batch, int heads, int n, int m, int causal,
                  float scale) {
  BwdArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = bias;
  a.kv_mask = static_cast<const unsigned char*>(kv_mask);
  a.q_offset = static_cast<const int*>(q_offset);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dout = dout;
  a.batch = batch;
  a.heads = heads;
  a.n = n;
  a.m = m;
  a.causal = causal;
  a.scale = scale;
  return a;
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 when the launch
// was accepted).  The caller has checked: d in {16, 32, 64} (the delta
// pre-pass also 128; the _d128 launchers 128 only), one dtype for q, k, v, O, dO and the bias, contiguous
// buffers, bias strides in elements, fp32 lse and delta of (b, h, n).
// `bias`, `kv_mask` ((b, m) bytes) and `q_offset` (one int32) may be null.

// delta = rowsum(dO * O) into the fp32 (b, h, n) buffer `delta`.
extern "C" int flash_attention_bwd_delta_launch(const void* out, const void* dout, void* delta,
                                                int batch, int heads, int n, int d, int is_bf16,
                                                void* stream) {
  BwdArgs a{};
  a.out = out;
  a.dout = dout;
  a.delta = static_cast<float*>(delta);
  a.batch = batch;
  a.heads = heads;
  a.n = n;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      is_bf16 ? DeltaLaunch::run<__nv_bfloat16, 16>(a, st) : DeltaLaunch::run<float, 16>(a, st);
      break;
    case 32:
      is_bf16 ? DeltaLaunch::run<__nv_bfloat16, 32>(a, st) : DeltaLaunch::run<float, 32>(a, st);
      break;
    case 64:
      is_bf16 ? DeltaLaunch::run<__nv_bfloat16, 64>(a, st) : DeltaLaunch::run<float, 64>(a, st);
      break;
    case 128:
      is_bf16 ? DeltaLaunch::run<__nv_bfloat16, 128>(a, st) : DeltaLaunch::run<float, 128>(a, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dq.
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* bias, const void* kv_mask,
                                             const void* q_offset, const void* lse, void* delta,
                                             const void* dout, void* dq, int batch, int heads,
                                             int n, int m, int d, int bias_stride_b,
                                             int bias_stride_h, int causal, float scale,
                                             int is_bf16, void* stream) {
  BwdArgs a = pass_args(q, k, v, bias, kv_mask, q_offset, lse, delta, dout, batch, heads, n, m,
                        causal, scale);
  a.dq = dq;
  a.bias_stride_b = bias_stride_b;
  a.bias_stride_h = bias_stride_h;
  return dispatch<DqLaunch>(a, d, is_bf16, stream);
}

// dk and dv.
extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const void* bias, const void* kv_mask,
                                              const void* q_offset, const void* lse, void* delta,
                                              const void* dout, void* dk, void* dv, int batch,
                                              int heads, int n, int m, int d, int bias_stride_b,
                                              int bias_stride_h, int causal, float scale,
                                              int is_bf16, void* stream) {
  BwdArgs a = pass_args(q, k, v, bias, kv_mask, q_offset, lse, delta, dout, batch, heads, n, m,
                        causal, scale);
  a.dk = dk;
  a.dv = dv;
  a.bias_stride_b = bias_stride_b;
  a.bias_stride_h = bias_stride_h;
  return dispatch<DkvLaunch>(a, d, is_bf16, stream);
}

// dq and dk, dv at head dim 128: the bf16 mma.sync kernels at D = 128
// (the caller has checked bf16 and 16-byte aligned buffers); d(bias) and
// fp32 have no kernel at this head dim.
extern "C" int flash_attention_bwd_dq_d128_launch(const void* q, const void* k, const void* v,
                                                  const void* bias, const void* kv_mask,
                                                  const void* q_offset, const void* lse,
                                                  void* delta, const void* dout, void* dq,
                                                  int batch, int heads, int n, int m, int d,
                                                  int bias_stride_b, int bias_stride_h,
                                                  int causal, float scale, int is_bf16,
                                                  void* stream) {
  if (d != 128 || !is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = pass_args(q, k, v, bias, kv_mask, q_offset, lse, delta, dout, batch, heads, n, m,
                        causal, scale);
  a.dq = dq;
  a.bias_stride_b = bias_stride_b;
  a.bias_stride_h = bias_stride_h;
  const int rc = DqLaunch::bf16<128>(a, static_cast<cudaStream_t>(stream));
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_bwd_dkv_d128_launch(const void* q, const void* k, const void* v,
                                                   const void* bias, const void* kv_mask,
                                                   const void* q_offset, const void* lse,
                                                   void* delta, const void* dout, void* dk,
                                                   void* dv, int batch, int heads, int n, int m,
                                                   int d, int bias_stride_b, int bias_stride_h,
                                                   int causal, float scale, int is_bf16,
                                                   void* stream) {
  if (d != 128 || !is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = pass_args(q, k, v, bias, kv_mask, q_offset, lse, delta, dout, batch, heads, n, m,
                        causal, scale);
  a.dk = dk;
  a.dv = dv;
  a.bias_stride_b = bias_stride_b;
  a.bias_stride_h = bias_stride_h;
  const int rc = DkvLaunch::bf16<128>(a, static_cast<cudaStream_t>(stream));
  return rc != 0 ? rc : static_cast<int>(cudaGetLastError());
}

// d(bias) of a contiguous bias whose b*h / items slabs of (n, m) are each
// shared by `items` batch items g = slab + t * item_stride: (h, n, m) has
// items = b, item_stride = h; (1, n, m) items = b*h, item_stride = 1;
// (b, h, n, m) items = 1.
extern "C" int flash_attention_bwd_dbias_launch(const void* q, const void* k, const void* v,
                                                const void* bias, const void* kv_mask,
                                                const void* q_offset, const void* lse,
                                                void* delta, const void* dout, void* dbias,
                                                int batch, int heads, int n, int m, int d,
                                                int items, int item_stride, int causal,
                                                float scale, int is_bf16, void* stream) {
  BwdArgs a = pass_args(q, k, v, bias, kv_mask, q_offset, lse, delta, dout, batch, heads, n, m,
                        causal, scale);
  a.dbias = dbias;
  a.items = items;
  a.item_stride = item_stride;
  return dispatch<DbiasLaunch>(a, d, is_bf16, stream);
}
