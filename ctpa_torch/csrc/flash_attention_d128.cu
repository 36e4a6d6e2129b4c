// Flash attention at head dim 128 on the tensor cores: the forward (kernel
// K2, with or without the row logsumexp), dQ and dK/dV (kernel K3).
//
// Replaces, for the LLM's head dim, the TPU kernels of
// ctpa/ops/pallas/flash_attention.py: the forward `_attn_kernel` via
// `_flash_call` and the backward `_dq_kernel` and `_dkv_kernel` of
// `_flash_bwd`.  The functions are those of flash_attention.cu and
// flash_attention_bwd.cu (their headers give the formulas), with the masks
// of flash_masks.cuh; the delta pre-pass is the one in
// flash_attention_bwd.cu.  bf16 inputs only; d(bias) at this head dim has
// no kernel.
//
// Bound on the H100 at report training's shape (b 2, h 32, n = m = 512,
// d 128, bf16, causal with right padding, 896 of 1024 keys real): the
// forward moves q and out (2 x 8.4 MB), k and v over the real keys (2 x
// 7.3 MB) and the lse, 31.6 MB or 9.4 us at 3.35 TB/s; its two products
// over the tiles it visits (69 of 128 per head) are 4.6 GFLOP, 4.7 us at
// the bf16 tensor-core rate, so the bytes bound it.  dQ (three products,
// 40.1 MB) and dK/dV (four, 48.5 MB) read q, dO, k and v (the real keys),
// lse and delta and write their gradients: bound by the bytes too, 12.0
// and 14.5 us (chip_smoke.py computes these bounds from the run's mask).
//
// Design.  The fp32-FMA kernels hold a query row per thread, and a
// 128-float accumulator row spills.  Here each warp owns 16 rows and runs
// its products as 16x16x16 WMMA tiles (bf16 in, fp32 accumulated):
//   * forward: a block of 4 warps owns 64 query rows (each warp's Q as 8
//     bf16 fragments in registers) and walks the keys in tiles of 64 that
//     it stages in shared memory.  S = Q K^T goes to shared memory, where
//     two lanes per row apply the scale, the bias and the masks and run
//     the online softmax in fp32; P is rounded to bf16 (as ctpa does before
//     PV), and the running output, kept in shared memory in fp32, is
//     rescaled by the lanes and accumulated by P V on the tensor cores.
//   * dQ: a block owns 64 query rows (Q and dO staged once) and walks the
//     key tiles: S = Q K^T and dP = dO V^T to shared memory, the lanes form
//     ds = p (dp - delta) scale in bf16, and dQ += dS K stays in WMMA
//     accumulators.
//   * dK/dV: a block owns 64 keys (K and V staged once) and walks the
//     query tiles from the first row that sees its first key (causal):
//     S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and dK += dS^T Q in
//     WMMA accumulators.
// Key tiles past the causal diagonal and tiles with no real key are
// skipped whole.  wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "flash_masks.cuh"

using namespace nvcuda;

namespace {

using namespace flash;

using bf16 = __nv_bfloat16;

constexpr int D = 128;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block (fwd, dQ); keys per block (dK/dV)
constexpr int kBK = 64;           // keys (fwd, dQ) or query rows (dK/dV) per walked tile
constexpr int kLdT = D + 8;       // bf16 row stride of a staged (64, 128) tile
constexpr int kLdS = kBK + 4;     // fp32 row stride of a warp's 16 x 64 score tile
constexpr int kLdP = kBK + 8;     // bf16 row stride of a warp's 16 x 64 probability tile
constexpr int kLdO = D + 4;       // fp32 row stride of a warp's 16 x 128 accumulator

constexpr int kTileBytes = kBK * kLdT * 2;           // one staged (64, 128) bf16 tile
constexpr int kScoreBytes = kWarps * 16 * kLdS * 4;  // the warps' fp32 score tiles
constexpr int kProbBytes = kWarps * 16 * kLdP * 2;   // the warps' bf16 probability tiles
constexpr int kAccBytes = kWarps * 16 * kLdO * 4;    // the warps' fp32 (16, 128) rows

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

extern __shared__ __align__(128) unsigned char smem_d128[];

// Copy rows [0, rows) of a (., 128) bf16 matrix to a (64, kLdT) shared
// tile, 16 bytes per copy; rows past `rows` are zero.
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int rows) {
  for (int e = threadIdx.x; e < kBK * (D / 8); e += kThreads) {
    const int r = e / (D / 8);
    const int c = (e - r * (D / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + (long long)r * D + c);
    *reinterpret_cast<uint4*>(dst + r * kLdT + c) = val;
  }
}

// out (16 x 64, ldm kLdS) = A (16 rows of a staged tile) . B^T, where B is
// 64 rows of another staged tile: the contraction runs over the 128 columns.
__device__ __forceinline__ void rows_times_rows_t(float* out, const bf16* a, const bf16* b) {
#pragma unroll
  for (int c = 0; c < kBK / 16; ++c) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, kLdT);
      wmma::load_matrix_sync(fb, b + (c * 16) * kLdT + kk * 16, kLdT);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + c * 16, acc, kLdS, wmma::mem_row_major);
  }
}

// acc[c] += P (16 x 64 bf16, ldm kLdP) . B (64 x 128 staged tile), c over
// the 8 column blocks of 16.
__device__ __forceinline__ void probs_times_tile(FragC* acc, const bf16* p, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + kk * 16, kLdP);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + (kk * 16) * kLdT + c * 16, kLdT);
      wmma::mma_sync(acc[c], fa, fb, acc[c]);
    }
  }
}

// Write a warp's (16, 128) fp32 accumulators as bf16 rows of `dst` (row
// stride D), rows >= `rows` dropped, with `add` (128 floats in shared
// memory, or null) added to every row; `stage_w` is the warp's (16, kLdO)
// fp32 scratch.
__device__ __forceinline__ void write_rows(bf16* dst, FragC* acc, float* stage_w, int rows,
                                           const float* add) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < D / 16; ++c)
    wmma::store_matrix_sync(stage_w + c * 16, acc[c], kLdO, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int r = e / D;
    const int c = e - r * D;
    if (r < rows) {
      float x = stage_w[r * kLdO + c];
      if (add != nullptr) x += add[c];
      dst[(long long)r * D + c] = __float2bfloat16(x);
    }
  }
}

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* bias;
  const float* bound;
  const unsigned char* kv_mask;
  const int* q_offset;
  const float* lse_in;
  const float* delta;
  const bf16* dout;
  bf16* out;
  float* lse;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int heads, n, m, bias_stride_b, bias_stride_h, causal;
  float scale;
};

// grid (b * h, ceil(n / kBQ)); block kThreads; dynamic shared memory
// kFwdSmem.
constexpr int kFwdSmem = 2 * kTileBytes + kScoreBytes + kProbBytes + kAccBytes + kBK;

__global__ void __launch_bounds__(kThreads) fwd_d128_kernel(Args a) {
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int hd = bh - b * a.heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = a.n, m = a.m;
  const int row0 = blockIdx.y * kBQ;

  bf16* k_s = reinterpret_cast<bf16*>(smem_d128);
  bf16* v_s = k_s + kBK * kLdT;
  float* s_w = reinterpret_cast<float*>(v_s + kBK * kLdT) + warp * 16 * kLdS;
  bf16* p_w = reinterpret_cast<bf16*>(smem_d128 + 2 * kTileBytes + kScoreBytes) +
              warp * 16 * kLdP;
  float* o_w = reinterpret_cast<float*>(smem_d128 + 2 * kTileBytes + kScoreBytes + kProbBytes) +
               warp * 16 * kLdO;
  unsigned char* kv_s = smem_d128 + 2 * kTileBytes + kScoreBytes + kProbBytes + kAccBytes;

  const bf16* kg = a.k + (long long)bh * m * D;
  const bf16* vg = a.v + (long long)bh * m * D;
  const bf16* bg = a.bias == nullptr ? nullptr
                                     : a.bias + (long long)b * a.bias_stride_b +
                                           (long long)hd * a.bias_stride_h;
  const unsigned char* kvg = key_row(a.kv_mask, b, m);
  const int qoff = query_offset(a.q_offset);
  const int m_end = causal_key_end(a.causal, row0, kBQ, qoff, m);

  // the block's Q through the K buffer into each warp's fragments
  stage(k_s, a.q + ((long long)bh * n + row0) * D, min(kBQ, n - row0));
  __syncthreads();
  FragA qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], k_s + (warp * 16) * kLdT + kk * 16, kLdT);
  for (int e = lane; e < 16 * D; e += 32) o_w[(e / D) * kLdO + e % D] = 0.f;
  __syncthreads();

  // two lanes per row: row r, columns half * 32.. of each tile
  const int r = lane >> 1;
  const int half = lane & 1;
  const int qi = row0 + warp * 16 + r;
  const int qpos = qi + qoff;
  const bool flat = a.bound != nullptr;
  const float shift_flat = flat ? *a.bound : 0.f;
  float m_run = -INFINITY;
  float l = 0.f;
  bool seen = false;

  for (int j0 = 0; j0 < m_end; j0 += kBK) {
    const int jn = min(kBK, m - j0);
    if (kvg != nullptr) {
      if (threadIdx.x < kBK) kv_s[threadIdx.x] = threadIdx.x < jn ? kvg[j0 + threadIdx.x] : 0;
      if (!__syncthreads_or(threadIdx.x < kBK && kv_s[threadIdx.x])) continue;
    }
    stage(k_s, kg + (long long)j0 * D, jn);
    stage(v_s, vg + (long long)j0 * D, jn);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows
#pragma unroll
    for (int c = 0; c < kBK / 16; ++c) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBCol fb;
        wmma::load_matrix_sync(fb, k_s + (c * 16) * kLdT + kk * 16, kLdT);
        wmma::mma_sync(acc, qf[kk], fb, acc);
      }
      wmma::store_matrix_sync(s_w + c * 16, acc, kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // scale, bias, masks and the online softmax; -inf marks a masked cell
    float sv[32];
    float tile_max = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + c;
      const int key = j0 + j;
      const bool ok = qi < n && j < jn && cell_ok(a.causal, key, qpos, kvg == nullptr || kv_s[j]);
      float s = s_w[r * kLdS + j] * a.scale;
      if (bg != nullptr && ok) s += __bfloat162float(bg[(long long)qi * m + key]);
      sv[c] = ok ? s : -INFINITY;
      tile_max = fmaxf(tile_max, sv[c]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    seen = seen || tile_max != -INFINITY;
    float shift = shift_flat;
    float alpha = 1.f;
    if (!flat) {
      const float m_new = fmaxf(m_run, tile_max);
      if (m_new != -INFINITY) {
        alpha = m_run == -INFINITY ? 0.f : expf(m_run - m_new);
        m_run = m_new;
      }
      shift = m_run;
    }
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = sv[c] == -INFINITY ? 0.f : expf(sv[c] - shift);
      psum += p;
      p_w[r * kLdP + half * 32 + c] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    if (alpha != 1.f) {
#pragma unroll 8
      for (int c = 0; c < D / 2; ++c) o_w[r * kLdO + half * (D / 2) + c] *= alpha;
    }
    __syncwarp();

    // O += P V, the running output through fp32 shared memory
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      FragC acc;
      wmma::load_matrix_sync(acc, o_w + c * 16, kLdO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        FragA fa;
        FragBRow fb;
        wmma::load_matrix_sync(fa, p_w + kk * 16, kLdP);
        wmma::load_matrix_sync(fb, v_s + (kk * 16) * kLdT + c * 16, kLdT);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(o_w + c * 16, acc, kLdO, wmma::mem_row_major);
    }
    __syncthreads();   // k_s, v_s and kv_s are refilled by the next tile
  }
  __syncwarp();

  if (qi < n) {
    bf16* o = a.out + ((long long)bh * n + qi) * D + half * (D / 2);
    if (seen) {
      const float lc = fmaxf(l, 1e-30f);
      const float inv = 1.f / lc;
      for (int c = 0; c < D / 2; ++c)
        o[c] = __float2bfloat16(o_w[r * kLdO + half * (D / 2) + c] * inv);
      if (a.lse != nullptr && half == 0)
        a.lse[(long long)bh * n + qi] = (flat ? shift_flat : m_run) + logf(lc);
    } else {
      for (int c = 0; c < D / 2; ++c)
        o[c] = __float2bfloat16(mean_over_keys(vg, m, D, half * (D / 2) + c));
      if (a.lse != nullptr && half == 0) a.lse[(long long)bh * n + qi] = kNegInf;
    }
  }
}

// grid (b * h, ceil(n / kBQ)); block kThreads; dynamic shared memory
// kDqSmem.
constexpr int kDqSmem = 4 * kTileBytes + 2 * kScoreBytes + kProbBytes + kBK;
static_assert(2 * kScoreBytes >= kAccBytes, "dQ stages its output in the score tiles");

__global__ void __launch_bounds__(kThreads) dq_d128_kernel(Args a) {
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int hd = bh - b * a.heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = a.n, m = a.m;
  const int row0 = blockIdx.y * kBQ;

  bf16* k_s = reinterpret_cast<bf16*>(smem_d128);
  bf16* v_s = k_s + kBK * kLdT;
  bf16* q_s = v_s + kBK * kLdT;
  bf16* do_s = q_s + kBK * kLdT;
  float* scores = reinterpret_cast<float*>(smem_d128 + 4 * kTileBytes);
  float* s_w = scores + warp * 16 * kLdS;
  float* dp_w = scores + kWarps * 16 * kLdS + warp * 16 * kLdS;
  bf16* ds_w = reinterpret_cast<bf16*>(smem_d128 + 4 * kTileBytes + 2 * kScoreBytes) +
               warp * 16 * kLdP;
  unsigned char* kv_s = smem_d128 + 4 * kTileBytes + 2 * kScoreBytes + kProbBytes;

  const bf16* kg = a.k + (long long)bh * m * D;
  const bf16* vg = a.v + (long long)bh * m * D;
  const bf16* bg = a.bias == nullptr ? nullptr
                                     : a.bias + (long long)b * a.bias_stride_b +
                                           (long long)hd * a.bias_stride_h;
  const unsigned char* kvg = key_row(a.kv_mask, b, m);
  const int qoff = query_offset(a.q_offset);
  const int m_end = causal_key_end(a.causal, row0, kBQ, qoff, m);
  const int rows = min(kBQ, n - row0);

  stage(q_s, a.q + ((long long)bh * n + row0) * D, rows);
  stage(do_s, a.dout + ((long long)bh * n + row0) * D, rows);
  const int r = lane >> 1;
  const int half = lane & 1;
  const int qi = row0 + warp * 16 + r;
  const int qpos = qi + qoff;
  const float lse_r = qi < n ? a.lse_in[(long long)bh * n + qi] : 0.f;
  const float delta_r = qi < n ? a.delta[(long long)bh * n + qi] : 0.f;
  FragC acc[D / 16];
#pragma unroll
  for (int c = 0; c < D / 16; ++c) wmma::fill_fragment(acc[c], 0.f);
  __syncthreads();

  for (int j0 = 0; j0 < m_end; j0 += kBK) {
    const int jn = min(kBK, m - j0);
    if (kvg != nullptr) {
      if (threadIdx.x < kBK) kv_s[threadIdx.x] = threadIdx.x < jn ? kvg[j0 + threadIdx.x] : 0;
      if (!__syncthreads_or(threadIdx.x < kBK && kv_s[threadIdx.x])) continue;
    }
    stage(k_s, kg + (long long)j0 * D, jn);
    stage(v_s, vg + (long long)j0 * D, jn);
    __syncthreads();

    rows_times_rows_t(s_w, q_s + (warp * 16) * kLdT, k_s);
    rows_times_rows_t(dp_w, do_s + (warp * 16) * kLdT, v_s);
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + c;
      const int key = j0 + j;
      const bool ok = qi < n && j < jn && cell_ok(a.causal, key, qpos, kvg == nullptr || kv_s[j]);
      float ds = 0.f;
      if (ok) {
        float s = s_w[r * kLdS + j] * a.scale;
        if (bg != nullptr) s += __bfloat162float(bg[(long long)qi * m + key]);
        ds = expf(s - lse_r) * (dp_w[r * kLdS + j] - delta_r) * a.scale;
      }
      ds_w[r * kLdP + j] = __float2bfloat16(ds);
    }
    __syncwarp();
    probs_times_tile(acc, ds_w, k_s);    // dQ += dS K
    __syncthreads();
  }

  __syncthreads();   // the score tiles become each warp's output staging
  const int w_rows = min(16, n - (row0 + warp * 16));
  write_rows(a.dq + ((long long)bh * n + row0 + warp * 16) * D, acc,
             scores + warp * 16 * kLdO, w_rows, nullptr);
}

// grid (b * h, ceil(m / kBQ)); block kThreads; dynamic shared memory
// kDkvSmem.  Warp w owns keys col0 + 16 w ..
constexpr int kDkvSmem = 4 * kTileBytes + 2 * kScoreBytes + 2 * kProbBytes + 2 * kBK * 4 + D * 4;

__global__ void __launch_bounds__(kThreads) dkv_d128_kernel(Args a) {
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int hd = bh - b * a.heads;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = a.n, m = a.m;
  const int col0 = blockIdx.y * kBQ;

  bf16* k_s = reinterpret_cast<bf16*>(smem_d128);
  bf16* v_s = k_s + kBK * kLdT;
  bf16* q_s = v_s + kBK * kLdT;
  bf16* do_s = q_s + kBK * kLdT;
  float* scores = reinterpret_cast<float*>(smem_d128 + 4 * kTileBytes);
  float* st_w = scores + warp * 16 * kLdS;
  float* dpt_w = scores + kWarps * 16 * kLdS + warp * 16 * kLdS;
  bf16* probs = reinterpret_cast<bf16*>(smem_d128 + 4 * kTileBytes + 2 * kScoreBytes);
  bf16* pt_w = probs + warp * 16 * kLdP;
  bf16* dst_w = probs + kWarps * 16 * kLdP + warp * 16 * kLdP;
  float* lse_s = reinterpret_cast<float*>(smem_d128 + 4 * kTileBytes + 2 * kScoreBytes +
                                          2 * kProbBytes);
  float* delta_s = lse_s + kBK;
  float* e_s = delta_s + kBK;

  const bf16* qg = a.q + (long long)bh * n * D;
  const bf16* dog = a.dout + (long long)bh * n * D;
  const float* lg = a.lse_in + (long long)bh * n;
  const float* dg = a.delta + (long long)bh * n;
  const bf16* bg = a.bias == nullptr ? nullptr
                                     : a.bias + (long long)b * a.bias_stride_b +
                                           (long long)hd * a.bias_stride_h;
  const unsigned char* kvg = key_row(a.kv_mask, b, m);
  const int qoff = query_offset(a.q_offset);
  const int cols = min(kBQ, m - col0);

  stage(k_s, a.k + ((long long)bh * m + col0) * D, cols);
  stage(v_s, a.v + ((long long)bh * m + col0) * D, cols);
  const int r = lane >> 1;
  const int half = lane & 1;
  const int key = col0 + warp * 16 + r;
  const bool key_ok = key < m && (kvg == nullptr || kvg[key]);
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    wmma::fill_fragment(dk_acc[c], 0.f);
    wmma::fill_fragment(dv_acc[c], 0.f);
  }
  // a block whose keys are all masked out gets no p and no ds
  const bool any_key =
      __syncthreads_or(threadIdx.x < kBQ && col0 + (int)threadIdx.x < m &&
                       (kvg == nullptr || kvg[col0 + threadIdx.x]));
  const int first = first_query_row(a.causal, col0, qoff);
  const int i_begin = any_key ? first / kBK * kBK : n;

  for (int i0 = i_begin; i0 < n; i0 += kBK) {
    const int in_rows = min(kBK, n - i0);
    stage(q_s, qg + (long long)i0 * D, in_rows);
    stage(do_s, dog + (long long)i0 * D, in_rows);
    if (threadIdx.x < kBK) {
      lse_s[threadIdx.x] = (int)threadIdx.x < in_rows ? lg[i0 + threadIdx.x] : 0.f;
      delta_s[threadIdx.x] = (int)threadIdx.x < in_rows ? dg[i0 + threadIdx.x] : 0.f;
    }
    __syncthreads();

    rows_times_rows_t(st_w, k_s + (warp * 16) * kLdT, q_s);     // S^T = K Q^T
    rows_times_rows_t(dpt_w, v_s + (warp * 16) * kLdT, do_s);   // dP^T = V dO^T
    __syncwarp();
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int i = half * 32 + c;
      const int qi = i0 + i;
      const bool ok = i < in_rows && cell_ok(a.causal, key, qi + qoff, key_ok);
      float p = 0.f, ds = 0.f;
      if (ok) {
        float s = st_w[r * kLdS + i] * a.scale;
        if (bg != nullptr) s += __bfloat162float(bg[(long long)qi * m + key]);
        p = expf(s - lse_s[i]);
        ds = p * (dpt_w[r * kLdS + i] - delta_s[i]) * a.scale;
      }
      pt_w[r * kLdP + i] = __float2bfloat16(p);
      dst_w[r * kLdP + i] = __float2bfloat16(ds);
    }
    __syncwarp();
    probs_times_tile(dv_acc, pt_w, do_s);    // dV += P^T dO
    probs_times_tile(dk_acc, dst_w, q_s);    // dK += dS^T Q
    __syncthreads();
  }

  // rows with no valid key spread their dO over all m keys (weights 1/m)
  const bool any_empty = __syncthreads_or((a.causal || kvg != nullptr) &&
                                          some_empty_row(lg, n, threadIdx.x, kThreads));
  if (any_empty) e_s[threadIdx.x] = empty_rows_dout_share(lg, dog, n, m, D, threadIdx.x);
  __syncthreads();   // e_s, and the score tiles become each warp's output staging

  const int w_rows = min(16, m - (col0 + warp * 16));
  const long long dst = ((long long)bh * m + col0 + warp * 16) * D;
  float* stage_w = scores + warp * 16 * kLdO;
  write_rows(a.dk + dst, dk_acc, stage_w, w_rows, nullptr);
  __syncwarp();
  write_rows(a.dv + dst, dv_acc, stage_w, w_rows, any_empty ? e_s : nullptr);
}

static_assert(kThreads == D, "the empty-row sum gives one column to each thread");

template <typename K>
int launch(K kernel, int smem, dim3 grid, const Args& a, void* stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k, const void* v, const void* bias,
               const void* kv_mask, const void* q_offset, int heads, int n, int m,
               int bias_stride_b, int bias_stride_h, int causal, float scale) {
  Args a{};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.bias = static_cast<const bf16*>(bias);
  a.kv_mask = static_cast<const unsigned char*>(kv_mask);
  a.q_offset = static_cast<const int*>(q_offset);
  a.heads = heads;
  a.n = n;
  a.m = m;
  a.bias_stride_b = bias_stride_b;
  a.bias_stride_h = bias_stride_h;
  a.causal = causal;
  a.scale = scale;
  return a;
}

inline int cdiv(int x, int y) { return (x + y - 1) / y; }

int fwd(const void* q, const void* k, const void* v, const void* bias, const void* bound,
        const void* kv_mask, const void* q_offset, void* out, void* lse, int batch, int heads,
        int n, int m, int d, int bias_stride_b, int bias_stride_h, int causal, float scale,
        int is_bf16, void* stream) {
  if (d != D || !is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, bias, kv_mask, q_offset, heads, n, m, bias_stride_b,
                     bias_stride_h, causal, scale);
  a.bound = static_cast<const float*>(bound);
  a.out = static_cast<bf16*>(out);
  a.lse = static_cast<float*>(lse);
  return launch(fwd_d128_kernel, kFwdSmem, dim3(batch * heads, cdiv(n, kBQ)), a, stream);
}

}  // namespace

// Each launches on `stream` and returns a cudaError_t (0 when the launch was
// accepted).  The caller has checked: d = 128, bf16 q, k, v, dO and bias,
// contiguous 16-byte aligned buffers, bias strides in elements, fp32 lse
// and delta of (b, h, n).  `bias`, `bound`, `kv_mask` ((b, m) bytes,
// nonzero = real key) and `q_offset` (one int32) may be null.  The
// signatures are those of the head-dim-16..64 launchers.
extern "C" int flash_attention_fwd_d128_launch(const void* q, const void* k, const void* v,
                                               const void* bias, const void* bound,
                                               const void* kv_mask, const void* q_offset,
                                               void* out, int batch, int heads, int n, int m,
                                               int d, int bias_stride_b, int bias_stride_h,
                                               int causal, float scale, int is_bf16,
                                               void* stream) {
  return fwd(q, k, v, bias, bound, kv_mask, q_offset, out, nullptr, batch, heads, n, m, d,
             bias_stride_b, bias_stride_h, causal, scale, is_bf16, stream);
}

extern "C" int flash_attention_fwd_lse_d128_launch(const void* q, const void* k, const void* v,
                                                   const void* bias, const void* bound,
                                                   const void* kv_mask, const void* q_offset,
                                                   void* out, void* lse, int batch, int heads,
                                                   int n, int m, int d, int bias_stride_b,
                                                   int bias_stride_h, int causal, float scale,
                                                   int is_bf16, void* stream) {
  return fwd(q, k, v, bias, bound, kv_mask, q_offset, out, lse, batch, heads, n, m, d,
             bias_stride_b, bias_stride_h, causal, scale, is_bf16, stream);
}

extern "C" int flash_attention_bwd_dq_d128_launch(const void* q, const void* k, const void* v,
                                                  const void* bias, const void* kv_mask,
                                                  const void* q_offset, const void* lse,
                                                  void* delta, const void* dout, void* dq,
                                                  int batch, int heads, int n, int m, int d,
                                                  int bias_stride_b, int bias_stride_h,
                                                  int causal, float scale, int is_bf16,
                                                  void* stream) {
  if (d != D || !is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, bias, kv_mask, q_offset, heads, n, m, bias_stride_b,
                     bias_stride_h, causal, scale);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dout = static_cast<const bf16*>(dout);
  a.dq = static_cast<bf16*>(dq);
  return launch(dq_d128_kernel, kDqSmem, dim3(batch * heads, cdiv(n, kBQ)), a, stream);
}

extern "C" int flash_attention_bwd_dkv_d128_launch(const void* q, const void* k, const void* v,
                                                   const void* bias, const void* kv_mask,
                                                   const void* q_offset, const void* lse,
                                                   void* delta, const void* dout, void* dk,
                                                   void* dv, int batch, int heads, int n, int m,
                                                   int d, int bias_stride_b, int bias_stride_h,
                                                   int causal, float scale, int is_bf16,
                                                   void* stream) {
  if (d != D || !is_bf16) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, bias, kv_mask, q_offset, heads, n, m, bias_stride_b,
                     bias_stride_h, causal, scale);
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dout = static_cast<const bf16*>(dout);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  return launch(dkv_d128_kernel, kDkvSmem, dim3(batch * heads, cdiv(m, kBQ)), a, stream);
}
