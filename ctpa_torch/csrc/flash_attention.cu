// Flash-attention forward for the CTViT spatial fold.
//
// Replaces the TPU kernel ctpa/ops/pallas/flash_attention.py:flash_attention
// (forward, `_attn_kernel` via `_flash_call`).  On (b, h, n, d) q and
// (b, h, m, d) k, v it computes
//
//   out = softmax(scale * q k^T + bias) v
//
// and, for the backward (flash_attention_bwd.cu), optionally the fp32 row
// logsumexp of the post-scale, post-bias logits s:
//
//   lse_i = log sum_j exp(s_ij) = shift_i + log sum_j exp(s_ij - shift_i)
//
// with shift_i the bound (flat softmax) or the row max (online softmax).  It
// costs one store per row; the serving launch passes no lse buffer.  ctpa's
// bound-relative lse and spare-lane denominator are TPU lane tricks and are
// not carried over.
//
// with an optional additive bias shaped (h, n, m), (1, n, m) or (b, h, n, m)
// (given to the kernel as two strides), fp32 accumulation and bf16 or fp32
// inputs, and ctpa's masks, `causal` with `q_offset` and `kv_mask`, with
// their treatment of a row with no valid key (flash_masks.cuh).  Key tiles
// past the block's last query position (causal) or with no real key
// (kv_mask) are skipped whole, as ctpa skips them.  With a logit bound B
// (a device scalar that bounds every logit from above, as cosine attention
// guarantees) the kernel skips the running max and accumulates exp(s - B)
// directly ("flat softmax"); without it, it keeps the usual online-softmax
// running max.  The TPU's layout tricks (spare-lane denominator and bound,
// d padded to 128, power-of-two scale folding) are not carried over: they
// exist for the TPU's (8, 128) tiling.
//
// Bound on the H100 at the shipped shape ((24, 8, 576, 32) bf16, bias
// (8, 576, 576)): q, k, v and out are 7.1 MB each and the bias 5.3 MB, 33.6
// MB in all, 10.0 us at 3.35 TB/s; the 4 * 24 * 8 * 576^2 * 32 = 8.15 GFLOP
// take 8.2 us at the bf16 tensor-core rate.  The two are close; the bytes
// set the floor, and a kernel near it must also run its products on the
// tensor cores (on the fp32 FMA units alone they take at least 0.12 ms).
// At the training shape (48 slabs at batch 2, with the lse) it is 62.8 MB
// and 16.3 GFLOP, 18.8 us, again set by the bytes.  At head dim 128, report
// training's shape (b 2, h 32, n = m = 512, causal with right padding, 896
// of 1024 keys real): q and out (2 x 8.4 MB), k and v over the real keys
// (2 x 7.3 MB) and the lse, 31.6 MB or 9.4 us; its two products over the
// tiles it visits (69 of 128 per head) are 4.6 GFLOP, 4.7 us, so the bytes
// bound it (chip_smoke.py computes the bound from the run's mask).
//
// bf16 design (flash_fwd_mma_kernel, head dims 16, 32, 64 and 128),
// FlashAttention-2's shape on mma.sync m16n8k16 (warp_mma.cuh): a block of
// 4 warps owns 64 query rows, 16 a warp, and walks the keys in tiles of 64.
// Up to D = 64 each warp keeps its Q as A fragments in registers for the
// whole walk; at D = 128, where O alone takes 64 fp32 registers a lane, it
// reads them from the Q tile in shared memory at every k-step, as K3's
// D = 128 kernels read theirs.  S = Q K^T for a tile stays
// in registers (32 floats a lane), where the scale, the bias, the masks
// and the row max and sum are applied, a row's 64 values spread over the
// four lanes of a quad (two shuffles reduce them).  The S accumulators,
// rounded to bf16, are P's A fragments as they lie (no trip through
// shared memory), and O = P V accumulates in fp32 registers (D / 2 floats
// a lane).  K, V and the 64 x 64 bias tile arrive as bf16 by cp.async into
// a two-stage ring (flash_tiles.cuh, shared with the backward), so the next
// tile's copies overlap this tile's products; ldmatrix (.trans for V) reads
// the fragments, from rows padded by 8 elements so its eight row addresses
// fall on distinct banks.  The exponentials run in log2 units on ex2.approx; with the bound and no mask
// the shift folds into the scale's multiply-add and no row max is taken.
// kv_mask flags are read a tile ahead, so skipping a dead tile costs no
// wait on device memory; causal blocks run the last query tiles (the
// longest key walks) first.  Edge
// tiles zero-fill; inputs that are not 16-byte aligned (a bias whose rows
// are not a multiple of 8 keys, a tensor at an odd offset) take element
// copies into the same ring.  Blocks are ordered batch item fastest, so
// the blocks that read one (h, n, m) bias tile run side by side and find it
// in L2.  P is rounded to bf16 before P V, as ctpa's kernel rounds it to
// the value dtype; the running sum l adds the fp32 p (as ctpa's online path
// does; its flat path sums the rounded p).  The output goes out through the
// warp's own rows of the Q tile, 16 bytes a copy.
//
// fp32 design (flash_attention_fwd_kernel): one thread owns one query row
// (q, the accumulator and the softmax statistics stay in registers); a
// block of 64 rows walks the keys in tiles of 32 that it stages in shared
// memory, together with the matching 64 x 32 bias tile, so every global
// read is coalesced and the (n, m) score matrix never reaches device
// memory.  No main path runs fp32 on the card; it keeps the 1e-4 gate,
// which the tensor cores' TF32 would not meet.  Head dim 128 runs bf16
// only (a 128-float accumulator row a thread would spill).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_masks.cuh"
#include "flash_tiles.cuh"
#include "warp_mma.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;  // query rows per block, one per thread
constexpr int kBK = 32;  // keys per tile

// grid (b * h, ceil(n / kBQ)); block kBQ.  The masks are compiled in only
// where a launch has one (kMasked): the unmasked paths keep their registers.
template <int D, bool kMasked>
__global__ void __launch_bounds__(kBQ)
flash_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ bias,
                           const float* __restrict__ bound,
                           const unsigned char* __restrict__ kv_mask,
                           const int* __restrict__ q_offset, float* __restrict__ out,
                           float* __restrict__ lse, int heads, int n, int m, int bias_stride_b,
                           int bias_stride_h, int causal, float scale) {
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int hd = bh - b * heads;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kBQ;
  const int row = row0 + tid;
  const bool live = row < n;

  const float* qg = q + (long long)bh * n * D;
  const float* kg = k + (long long)bh * m * D;
  const float* vg = v + (long long)bh * m * D;
  const float* bg = bias == nullptr
                    ? nullptr
                    : bias + (long long)b * bias_stride_b + (long long)hd * bias_stride_h;
  const unsigned char* kvg = kMasked ? key_row(kv_mask, b, m) : nullptr;
  const int qoff = kMasked ? query_offset(q_offset) : 0;
  const int qpos = row + qoff;
  const int m_end = causal_key_end(kMasked && causal, row0, kBQ, qoff, m);

  __shared__ __align__(16) float k_s[kBK][D];
  __shared__ __align__(16) float v_s[kBK][D];
  __shared__ float b_s[kBQ][kBK + 1];
  __shared__ unsigned char kv_s[kBK];

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? qg[(long long)row * D + d] : 0.f;
    acc[d] = 0.f;
  }
  const bool flat = bound != nullptr;
  const float shift_flat = flat ? *bound : 0.f;
  float m_run = -INFINITY;
  float l = 0.f;
  bool seen = false;   // some valid key so far

  for (int j0 = 0; j0 < m_end; j0 += kBK) {
    const int jn = min(kBK, m - j0);
    if (kMasked && kvg != nullptr) {
      if (tid < kBK) kv_s[tid] = tid < jn ? kvg[j0 + tid] : 0;
      // a tile with no real key adds nothing to any row
      if (!__syncthreads_or(tid < kBK && kv_s[tid])) continue;
    }
    for (int e = tid; e < kBK * D; e += kBQ) {
      const int j = e / D;
      const int d = e - j * D;
      float kv = 0.f, vv = 0.f;
      if (j < jn) {
        kv = kg[(long long)(j0 + j) * D + d];
        vv = vg[(long long)(j0 + j) * D + d];
      }
      k_s[j][d] = kv;
      v_s[j][d] = vv;
    }
    if (bg != nullptr) {
      for (int e = tid; e < kBQ * kBK; e += kBQ) {
        const int r = e / kBK;
        const int j = e - r * kBK;
        b_s[r][j] = (row0 + r < n && j < jn)
                        ? bg[(long long)(row0 + r) * m + j0 + j]
                        : 0.f;
      }
    }
    __syncthreads();

    // -inf marks a masked cell
    float s[kBK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[j][d]);
        dot += qr[d] * kk.x + qr[d + 1] * kk.y + qr[d + 2] * kk.z + qr[d + 3] * kk.w;
      }
      float sj = dot * scale;
      if (bg != nullptr) sj += b_s[tid][j];
      const bool ok = j < jn && (!kMasked || cell_ok(causal, j0 + j, qpos,
                                                     kvg == nullptr || kv_s[j]));
      sj = ok ? sj : -INFINITY;
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
    seen = seen || tile_max != -INFINITY;

    float shift = shift_flat;
    if (!flat) {
      const float m_new = fmaxf(m_run, tile_max);
      // unmasked, every tile holds a valid key: m_new is finite and the
      // first alpha is exp(-inf) = 0
      if (!kMasked || m_new != -INFINITY) {
        const float alpha = kMasked && m_run == -INFINITY ? 0.f : expf(m_run - m_new);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] *= alpha;
        m_run = m_new;
      }
      shift = m_run;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      // masked keys give exp(-inf) = 0, but a row with no valid key yet has
      // shift -inf too
      const float p = kMasked && s[j] == -INFINITY ? 0.f : expf(s[j] - shift);
      l += p;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&v_s[j][d]);
        acc[d] += p * vv.x;
        acc[d + 1] += p * vv.y;
        acc[d + 2] += p * vv.z;
        acc[d + 3] += p * vv.w;
      }
    }
    __syncthreads();
  }

  if (live) {
    float* o = out + (long long)(bh * (long long)n + row) * D;
    if (!kMasked || seen) {
      const float lc = fmaxf(l, 1e-30f);
      const float inv = 1.f / lc;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = acc[d] * inv;
      if (lse != nullptr) lse[(long long)bh * n + row] = (flat ? shift_flat : m_run) + logf(lc);
    } else {
      for (int d = 0; d < D; ++d) o[d] = mean_over_keys(vg, m, D, d);
      if (lse != nullptr) lse[(long long)bh * n + row] = kNegInf;
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

constexpr int kMmaBQ = flash_tiles::kTile;   // query rows per block, 16 a warp
constexpr int kMmaBK = flash_tiles::kTile;   // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct MmaArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* bias;
  const float* bound;
  const unsigned char* kv_mask;
  const int* q_offset;
  bf16* out;
  float* lse;
  int batch, heads, n, m, bias_stride_b, bias_stride_h, causal;
  float scale;
  int vec;        // q, k, v and out 16-byte aligned: cp.async rows
  int vec_bias;   // the bias too, with rows a multiple of 8 keys
};

// Shared memory: the Q tile (later the output), two K, two V and two bias
// tiles, two tiles' key flags.
template <int D>
struct MmaSmem {
  static constexpr int kLd = D + kPad;
  static constexpr int kQ = kMmaBQ * kLd;   // elements
  static constexpr int kKV = kMmaBK * kLd;
  static constexpr int kBias = kMmaBQ * kLdBias;
  static constexpr size_t kFlags = (size_t)(kQ + 4 * kKV) * 2;   // byte offset
  static constexpr size_t kBiasAt = kFlags + 2 * kMmaBK;
  static size_t bytes(bool bias) { return kBiasAt + (bias ? (size_t)2 * kBias * 2 : 0); }
};

extern __shared__ __align__(16) unsigned char smem_mma[];

// The mean of v over all m keys, columns 2 lane + 64 p and 2 lane + 64 p + 1
// in mine[p] (lanes whose columns lie past D get 0): what a query row with
// no valid key gets.  The warp reads v row after row, keys in order.
template <int D>
__device__ __forceinline__ void mean_v_pairs(float2 (&mine)[(D + 63) / 64], const bf16* vg,
                                             int m) {
#pragma unroll
  for (int p = 0; p < (D + 63) / 64; ++p) {
    const int c = 64 * p + 2 * (threadIdx.x & 31);
    float x = 0.f, y = 0.f;
    if (c < D) {
      for (int j = 0; j < m; ++j) {
        x += __bfloat162float(vg[(long long)j * D + c]);
        y += __bfloat162float(vg[(long long)j * D + c + 1]);
      }
    }
    mine[p] = make_float2(x / m, y / m);
  }
}

// grid (batch * heads * ceil(n / kMmaBQ)), batch item fastest, the last
// query tiles first (causal: they walk the most keys); block kThreads;
// dynamic shared memory MmaSmem<D>::bytes(bias != null).
template <int D, bool kMasked>
__global__ void __launch_bounds__(kThreads) flash_fwd_mma_kernel(const MmaArgs a) {
  using Smem = MmaSmem<D>;
  constexpr int kLd = Smem::kLd;
  constexpr int kKSteps = D / 16;   // k-steps of S = Q K^T
  constexpr int kOTiles = D / 8;    // n-tiles of O = P V
  constexpr int kSTiles = kMmaBK / 8;
  // Q's A fragments stay in registers for the whole walk up to D = 64; at
  // D = 128 (32 more registers beside O's 64) they are read from the Q tile
  // at every k-step
  constexpr bool kHoldQ = D <= 64;

  const int n = a.n, m = a.m;
  int id = blockIdx.x;
  const int b = id % a.batch;
  id /= a.batch;
  const int hd = id % a.heads;
  const int row0 = ((n + kMmaBQ - 1) / kMmaBQ - 1 - id / a.heads) * kMmaBQ;
  const int bh = b * a.heads + hd;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  bf16* q_s = reinterpret_cast<bf16*>(smem_mma);
  bf16* k_s = q_s + Smem::kQ;               // [2][kKV]
  bf16* v_s = k_s + 2 * Smem::kKV;          // [2][kKV]
  unsigned char* kv_s = smem_mma + Smem::kFlags;                     // [2][kMmaBK]
  bf16* b_s = reinterpret_cast<bf16*>(smem_mma + Smem::kBiasAt);     // [2][kBias]

  const bf16* kg = a.k + (long long)bh * m * D;
  const bf16* vg = a.v + (long long)bh * m * D;
  const bf16* bg = a.bias == nullptr
                       ? nullptr
                       : a.bias + (long long)b * a.bias_stride_b +
                             (long long)hd * a.bias_stride_h + (long long)row0 * m;
  const unsigned char* kvg = kMasked ? key_row(a.kv_mask, b, m) : nullptr;
  const int qoff = kMasked ? query_offset(a.q_offset) : 0;
  const int m_end = causal_key_end(kMasked && a.causal, row0, kMmaBQ, qoff, m);
  const int q_rows = min(kMmaBQ, n - row0);
  const bool vec = a.vec != 0;

  // the copies of key tile j0 into ring slot `slot`
  auto fetch = [&](int slot, int j0) {
    const int jn = min(kMmaBK, m - j0);
    stage_rows<D>(k_s + slot * Smem::kKV, kg + (long long)j0 * D, jn, vec);
    stage_rows<D>(v_s + slot * Smem::kKV, vg + (long long)j0 * D, jn, vec);
    if (bg != nullptr)
      stage_bias(b_s + slot * Smem::kBias, bg + j0, q_rows, jn, m, a.vec_bias != 0);
  };
  // kv_mask: thread t < kMmaBK holds the flag of key j + t (0 past m).  The
  // flags of the tile after the one just fetched are loaded one tile ahead,
  // so neither the next tile's liveness nor its flags wait on device memory
  const bool kv_masked = kMasked && kvg != nullptr;
  auto kv_flag = [&](int j) -> unsigned char {
    return threadIdx.x < kMmaBK && j + (int)threadIdx.x < m ? kvg[j + threadIdx.x] : 0;
  };
  unsigned char kv_ahead = 0;

  stage_rows<D>(q_s, a.q + ((long long)bh * n + row0) * D, q_rows, vec);
  int j0 = kv_masked ? next_live_tile(0, m_end, m, kvg) : 0;
  if (j0 < m_end) {
    fetch(0, j0);
    if (kv_masked) {
      if (threadIdx.x < kMmaBK) kv_s[threadIdx.x] = kv_flag(j0);
      kv_ahead = kv_flag(j0 + kMmaBK);
    }
  }
  warp_mma::cp_async_commit();
  warp_mma::cp_async_wait<0>();
  __syncthreads();

  // the warp's 16 rows of Q as A fragments: ldmatrix's matrices 0-3 are
  // (rows 0-7, 8-15) x (columns 16kk + 0-7, + 8-15)
  const bf16* q_frag = q_s + (warp * 16 + (lane & 15)) * kLd + 8 * (lane >> 4);
  uint32_t qf[kHoldQ ? kKSteps : 1][4];
  if constexpr (kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) warp_mma::ldsm_x4(qf[kk], q_frag + 16 * kk);
  }
  // the lane's rows in ldmatrix's addressing of a K tile (matrices: tiles j,
  // j + 1 times the two column halves) and of a V tile (transposed: keys
  // 16kk + 0-7, + 8-15 times the column blocks i, i + 1)
  const int k_row = 8 * (lane >> 4) + (lane & 7);
  const int k_col = 8 * ((lane >> 3) & 1);
  const int v_row = (lane & 15);
  const int v_col = 8 * (lane >> 4);

  // this lane's two rows: g and g + 8 of the warp's 16 (r = 0, 1)
  const int qi0 = row0 + warp * 16 + g;
  const bool flat = a.bound != nullptr;
  const float shift_flat = flat ? *a.bound * kLog2e : 0.f;   // log2 domain
  const float scale2 = a.scale * kLog2e;
  float o[kOTiles][4];
#pragma unroll
  for (int i = 0; i < kOTiles; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // log2 domain
  float l[2] = {0.f, 0.f};                   // this lane's share of the row sums
  bool seen[2] = {false, false};             // some valid key so far

  int slot = 0;
  while (j0 < m_end) {
    const int jn = min(kMmaBK, m - j0);
    int j1 = j0 + kMmaBK;
    if (kv_masked && j1 < m_end && !__syncthreads_or(kv_ahead != 0))
      j1 = next_live_tile(j1 + kMmaBK, m_end, m, kvg);
    if (j1 < m_end) {
      fetch(slot ^ 1, j1);
      if (kv_masked) {
        if (threadIdx.x < kMmaBK)
          kv_s[(slot ^ 1) * kMmaBK + threadIdx.x] = j1 == j0 + kMmaBK ? kv_ahead : kv_flag(j1);
        kv_ahead = kv_flag(j1 + kMmaBK);
      }
    }
    warp_mma::cp_async_commit();
    warp_mma::cp_async_wait<1>();   // all but the copies just started: tile j0 is in
    __syncthreads();

    const bf16* kt = k_s + slot * Smem::kKV;
    const bf16* vt = v_s + slot * Smem::kKV;

    // S = Q K^T in log2 units: tile j holds keys 8j .. 8j + 7
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kHoldQ) {
#pragma unroll
      for (int j = 0; j < kSTiles; j += 2) {
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
          uint32_t kf[4];
          warp_mma::ldsm_x4(kf, kt + (8 * j + k_row) * kLd + 16 * kk + k_col);
          warp_mma::mma_bf16_16816(s[j], qf[kk], kf[0], kf[1]);
          warp_mma::mma_bf16_16816(s[j + 1], qf[kk], kf[2], kf[3]);
        }
      }
    } else {
      // each S tile still sums its k-steps in order
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        warp_mma::ldsm_x4(qf[0], q_frag + 16 * kk);
#pragma unroll
        for (int j = 0; j < kSTiles; j += 2) {
          uint32_t kf[4];
          warp_mma::ldsm_x4(kf, kt + (8 * j + k_row) * kLd + 16 * kk + k_col);
          warp_mma::mma_bf16_16816(s[j], qf[0], kf[0], kf[1]);
          warp_mma::mma_bf16_16816(s[j + 1], qf[0], kf[2], kf[3]);
        }
      }
    }
    // with the bound the shift is known before the scores: it goes into the
    // same fused multiply-add
    const float add = flat && !kMasked ? -shift_flat : 0.f;
    if (bg != nullptr) {
      const bf16* bt = b_s + slot * Smem::kBias + (warp * 16 + g) * kLdBias + 2 * t;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(bt + r * 8 * kLdBias + 8 * j);
          s[j][2 * r] = fmaf(s[j][2 * r], scale2, fmaf(__uint_as_float(w << 16), kLog2e, add));
          s[j][2 * r + 1] = fmaf(s[j][2 * r + 1], scale2,
                                 fmaf(__uint_as_float(w & 0xffff0000u), kLog2e, add));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = fmaf(s[j][e], scale2, add);
    }
    // masks: -inf marks a masked cell (a ragged tile's missing keys too).
    // Cell (r, col) is valid when col <= lim[r] (the tile's last key and,
    // causal, the row's last visible key) and its key is real (bit 2j + h of
    // kv, for col = 8j + 2t + h)
    if (kMasked || jn < kMmaBK) {
      int lim[2] = {jn - 1, jn - 1};
      uint32_t kv = 0xffffu;
      if (kMasked) {
        if (a.causal) {
          lim[0] = min(lim[0], qi0 + qoff - j0);
          lim[1] = min(lim[1], qi0 + 8 + qoff - j0);
        }
        if (kvg != nullptr) {
          const unsigned char* kvt = kv_s + slot * kMmaBK + 2 * t;
          kv = 0;
#pragma unroll
          for (int j = 0; j < kSTiles; ++j)
            kv |= (uint32_t)(kvt[8 * j] != 0) << (2 * j) |
                  (uint32_t)(kvt[8 * j + 1] != 0) << (2 * j + 1);
        }
      }
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          if (col > lim[e >> 1] || !((kv >> (2 * j + (e & 1))) & 1u)) s[j][e] = -INFINITY;
        }
      }
    }

    // the row max over the tile and the quad (not needed with the bound
    // and no mask); the shift each row subtracts
    float shift[2] = {0.f, 0.f}, alpha[2] = {1.f, 1.f};
    if (kMasked || !flat) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kSTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (kMasked) seen[r] = seen[r] || mx != -INFINITY;
        if (flat) {
          shift[r] = shift_flat;
        } else {
          const float m_new = fmaxf(m_run[r], mx);
          // a row with no valid key yet keeps m_run = -inf and alpha 1
          if (m_new != -INFINITY) {
            alpha[r] = warp_mma::exp2_approx(m_run[r] - m_new);   // 0 for the first
            m_run[r] = m_new;
          }
          // -inf - -inf would be NaN: such a row's p are all exp2(-inf) = 0
          shift[r] = m_run[r] == -INFINITY ? 0.f : m_run[r];
          l[r] *= alpha[r];
        }
      }
    }
    if (!flat) {
#pragma unroll
      for (int i = 0; i < kOTiles; ++i) {
        o[i][0] *= alpha[0];
        o[i][1] *= alpha[0];
        o[i][2] *= alpha[1];
        o[i][3] *= alpha[1];
      }
    }

    // p = exp2(s - shift), summed in fp32; rounded to bf16 it is P's A
    // fragments: k-step kk covers keys 16kk .. 16kk + 15, S tiles 2kk, 2kk+1
    uint32_t pf[kMmaBK / 16][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = warp_mma::exp2_approx(s[j][e] - shift[e >> 1]);
        l[e >> 1] += p[e];
      }
      pf[j >> 1][(j & 1) * 2] = warp_mma::pack_bf16(p[0], p[1]);
      pf[j >> 1][(j & 1) * 2 + 1] = warp_mma::pack_bf16(p[2], p[3]);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < kOTiles; i += 2) {
        uint32_t vf[4];
        warp_mma::ldsm_x4_trans(vf, vt + (16 * kk + v_row) * kLd + 8 * i + v_col);
        warp_mma::mma_bf16_16816(o[i], pf[kk], vf[0], vf[1]);
        warp_mma::mma_bf16_16816(o[i + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();   // this slot is refilled by the next tile's copies
    slot ^= 1;
    j0 = j1;
  }

  // a row with no valid key: the mean of v, which the warp computes once;
  // O tile i's columns 8i + 2t, + 1 are lane 4 (i % 8) + t's pair i / 8
  float2 mean[kOTiles];
  if (kMasked && __any_sync(0xffffffffu, (!seen[0] && qi0 < n) || (!seen[1] && qi0 + 8 < n))) {
    float2 mine[(D + 63) / 64];
    mean_v_pairs<D>(mine, vg, m);
#pragma unroll
    for (int i = 0; i < kOTiles; ++i) {
      mean[i].x = __shfl_sync(0xffffffffu, mine[i / 8].x, 4 * (i % 8) + t);
      mean[i].y = __shfl_sync(0xffffffffu, mine[i / 8].y, 4 * (i % 8) + t);
    }
  }

  // the row sums over the quad; the rows into the warp's own rows of q_s
  bf16* o_s = q_s + (warp * 16) * kLd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = g + 8 * r;
    const int qi = qi0 + 8 * r;
    if (!kMasked || seen[r]) {
      const float lc = fmaxf(l[r], 1e-30f);
      const float inv = 1.f / lc;
#pragma unroll
      for (int i = 0; i < kOTiles; ++i)
        *reinterpret_cast<uint32_t*>(o_s + row * kLd + 8 * i + 2 * t) =
            warp_mma::pack_bf16(o[i][2 * r] * inv, o[i][2 * r + 1] * inv);
      if (a.lse != nullptr && t == 0 && qi < n)
        a.lse[(long long)bh * n + qi] = ((flat ? shift_flat : m_run[r]) + log2f(lc)) * kLn2;
    } else {
#pragma unroll
      for (int i = 0; i < kOTiles; ++i)
        *reinterpret_cast<uint32_t*>(o_s + row * kLd + 8 * i + 2 * t) =
            warp_mma::pack_bf16(mean[i].x, mean[i].y);
      if (a.lse != nullptr && t == 0 && qi < n) a.lse[(long long)bh * n + qi] = kNegInf;
    }
  }
  __syncwarp();
  const int w_rows = min(16, n - (row0 + warp * 16));
  bf16* og = a.out + ((long long)bh * n + row0 + warp * 16) * D;
  if (vec) {
    constexpr int kChunks = D / 8;
    for (int e = lane; e < w_rows * kChunks; e += 32) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * 8;
      *reinterpret_cast<uint4*>(og + (long long)r * D + c) =
          *reinterpret_cast<const uint4*>(o_s + r * kLd + c);
    }
  } else {
    for (int e = lane; e < w_rows * D; e += 32) {
      const int r = e / D;
      og[(long long)r * D + e - r * D] = o_s[r * kLd + e - r * D];
    }
  }
}

// ---------------------------------------------------------------- launchers

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;
  const void* bound;
  const void* kv_mask;
  const void* q_offset;
  void* out;
  void* lse;
  int batch, heads, n, m, bias_stride_b, bias_stride_h, causal;
  float scale;
};

template <int D, bool kMasked>
int launch_mma(const FwdArgs& a, cudaStream_t st) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const MmaArgs args{static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                     static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.bias),
                     static_cast<const float*>(a.bound),
                     static_cast<const unsigned char*>(a.kv_mask),
                     static_cast<const int*>(a.q_offset), static_cast<bf16*>(a.out),
                     static_cast<float*>(a.lse), a.batch, a.heads, a.n, a.m, a.bias_stride_b,
                     a.bias_stride_h, a.causal, a.scale,
                     aligned(a.q) && aligned(a.k) && aligned(a.v) && aligned(a.out),
                     aligned(a.bias) && a.m % 8 == 0 && a.bias_stride_b % 8 == 0 &&
                         a.bias_stride_h % 8 == 0};
  const size_t smem = MmaSmem<D>::bytes(a.bias != nullptr);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D, kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // leave no stale error for the next launch's check
    return static_cast<int>(err);
  }
  const unsigned blocks =
      static_cast<unsigned>(a.batch * a.heads) * ((a.n + kMmaBQ - 1) / kMmaBQ);
  flash_fwd_mma_kernel<D, kMasked><<<blocks, kThreads, smem, st>>>(args);
  return 0;
}

template <int D>
int launch_bf16(const FwdArgs& a, cudaStream_t st) {
  return a.causal || a.kv_mask != nullptr ? launch_mma<D, true>(a, st)
                                          : launch_mma<D, false>(a, st);
}

template <int D, bool kMasked>
void launch_fp32_masked(const FwdArgs& a, cudaStream_t st) {
  const dim3 grid(a.batch * a.heads, (a.n + kBQ - 1) / kBQ);
  flash_attention_fwd_kernel<D, kMasked><<<grid, kBQ, 0, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const float*>(a.bound), static_cast<const unsigned char*>(a.kv_mask),
      static_cast<const int*>(a.q_offset), static_cast<float*>(a.out),
      static_cast<float*>(a.lse), a.heads, a.n, a.m, a.bias_stride_b, a.bias_stride_h,
      a.causal, a.scale);
}

template <int D>
int launch_fp32(const FwdArgs& a, cudaStream_t st) {
  if (a.causal || a.kv_mask != nullptr) {
    launch_fp32_masked<D, true>(a, st);
  } else {
    launch_fp32_masked<D, false>(a, st);
  }
  return 0;
}

// d128: the head-dim-128 launchers (bf16 only); else head dims 16-64
int launch_any(const void* q, const void* k, const void* v, const void* bias, const void* bound,
               const void* kv_mask, const void* q_offset, void* out, void* lse, int batch,
               int heads, int n, int m, int d, int bias_stride_b, int bias_stride_h, int causal,
               float scale, int is_bf16, void* stream, bool d128) {
  const FwdArgs a{q, k, v, bias, bound, kv_mask, q_offset, out, lse, batch, heads, n, m,
                  bias_stride_b, bias_stride_h, causal, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d128 != (d == 128)) return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  switch (d) {
    case 16:
      rc = is_bf16 ? launch_bf16<16>(a, st) : launch_fp32<16>(a, st);
      break;
    case 32:
      rc = is_bf16 ? launch_bf16<32>(a, st) : launch_fp32<32>(a, st);
      break;
    case 64:
      rc = is_bf16 ? launch_bf16<64>(a, st) : launch_fp32<64>(a, st);
      break;
    case 128:
      if (!is_bf16) return static_cast<int>(cudaErrorInvalidValue);
      rc = launch_bf16<128>(a, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).  `bias`, `bound`, `kv_mask` ((b, m) bytes, nonzero =
// real key) and `q_offset` (one int32) may be null.  The caller has checked:
// contiguous buffers, bias strides in elements; d in {16, 32, 64} for the
// first two, d = 128 and bf16 for the `_d128` pair.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          const void* bias, const void* bound,
                                          const void* kv_mask, const void* q_offset, void* out,
                                          int batch, int heads, int n, int m, int d,
                                          int bias_stride_b, int bias_stride_h, int causal,
                                          float scale, int is_bf16, void* stream) {
  return launch_any(q, k, v, bias, bound, kv_mask, q_offset, out, nullptr, batch, heads, n, m,
                    d, bias_stride_b, bias_stride_h, causal, scale, is_bf16, stream, false);
}

// The same with the fp32 (b, h, n) row logsumexp written to `lse`.
extern "C" int flash_attention_fwd_lse_launch(const void* q, const void* k, const void* v,
                                              const void* bias, const void* bound,
                                              const void* kv_mask, const void* q_offset,
                                              void* out, void* lse, int batch, int heads, int n,
                                              int m, int d, int bias_stride_b,
                                              int bias_stride_h, int causal, float scale,
                                              int is_bf16, void* stream) {
  return launch_any(q, k, v, bias, bound, kv_mask, q_offset, out, lse, batch, heads, n, m, d,
                    bias_stride_b, bias_stride_h, causal, scale, is_bf16, stream, false);
}

extern "C" int flash_attention_fwd_d128_launch(const void* q, const void* k, const void* v,
                                               const void* bias, const void* bound,
                                               const void* kv_mask, const void* q_offset,
                                               void* out, int batch, int heads, int n, int m,
                                               int d, int bias_stride_b, int bias_stride_h,
                                               int causal, float scale, int is_bf16,
                                               void* stream) {
  return launch_any(q, k, v, bias, bound, kv_mask, q_offset, out, nullptr, batch, heads, n, m,
                    d, bias_stride_b, bias_stride_h, causal, scale, is_bf16, stream, true);
}

extern "C" int flash_attention_fwd_lse_d128_launch(const void* q, const void* k, const void* v,
                                                   const void* bias, const void* bound,
                                                   const void* kv_mask, const void* q_offset,
                                                   void* out, void* lse, int batch, int heads,
                                                   int n, int m, int d, int bias_stride_b,
                                                   int bias_stride_h, int causal, float scale,
                                                   int is_bf16, void* stream) {
  return launch_any(q, k, v, bias, bound, kv_mask, q_offset, out, lse, batch, heads, n, m, d,
                    bias_stride_b, bias_stride_h, causal, scale, is_bf16, stream, true);
}
