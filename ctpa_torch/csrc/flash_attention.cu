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
// tensor cores.  At the training shape (48 slabs at batch 2, with the lse)
// it is 62.8 MB and 16.3 GFLOP, 18.8 us, again set by the bytes.  This
// first version runs the products on the fp32 FMA units and stays well
// above the floor; mma/wgmma tiles are later work.
//
// Design: one thread owns one query row (q, the accumulator and the softmax
// statistics stay in registers); a block of 64 rows walks the keys in tiles
// of 32 that it stages in shared memory as fp32, together with the matching
// 64 x 32 bias tile, so every global read is coalesced and the
// (n, m) score matrix never reaches device memory.  n = 576 = 9 * 64, and a
// ragged edge on either axis is masked.  Head dim 128 has its own kernel on
// the tensor cores (flash_attention_d128.cu): a 128-float row per thread
// would spill here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_masks.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;  // query rows per block, one per thread
constexpr int kBK = 32;  // keys per tile

// grid (b * h, ceil(n / kBQ)); block kBQ.  The masks are compiled in only
// where a launch has one (kMasked): the unmasked paths keep their registers.
template <typename T, int D, bool kMasked>
__global__ void __launch_bounds__(kBQ)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ bias,
                           const float* __restrict__ bound,
                           const unsigned char* __restrict__ kv_mask,
                           const int* __restrict__ q_offset, T* __restrict__ out,
                           float* __restrict__ lse, int heads, int n, int m, int bias_stride_b,
                           int bias_stride_h, int causal, float scale) {
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int hd = bh - b * heads;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kBQ;
  const int row = row0 + tid;
  const bool live = row < n;

  const T* qg = q + (long long)bh * n * D;
  const T* kg = k + (long long)bh * m * D;
  const T* vg = v + (long long)bh * m * D;
  const T* bg = bias == nullptr
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
    qr[d] = live ? to_float(qg[(long long)row * D + d]) : 0.f;
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
        kv = to_float(kg[(long long)(j0 + j) * D + d]);
        vv = to_float(vg[(long long)(j0 + j) * D + d]);
      }
      k_s[j][d] = kv;
      v_s[j][d] = vv;
    }
    if (bg != nullptr) {
      for (int e = tid; e < kBQ * kBK; e += kBQ) {
        const int r = e / kBK;
        const int j = e - r * kBK;
        b_s[r][j] = (row0 + r < n && j < jn)
                        ? to_float(bg[(long long)(row0 + r) * m + j0 + j])
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
    T* o = out + (long long)(bh * (long long)n + row) * D;
    if (!kMasked || seen) {
      const float lc = fmaxf(l, 1e-30f);
      const float inv = 1.f / lc;
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = from_float<T>(acc[d] * inv);
      if (lse != nullptr) lse[(long long)bh * n + row] = (flat ? shift_flat : m_run) + logf(lc);
    } else {
      for (int d = 0; d < D; ++d) o[d] = from_float<T>(mean_over_keys(vg, m, D, d));
      if (lse != nullptr) lse[(long long)bh * n + row] = kNegInf;
    }
  }
}

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

template <typename T, int D, bool kMasked>
void launch_masked(const FwdArgs& a, cudaStream_t st) {
  const dim3 grid(a.batch * a.heads, (a.n + kBQ - 1) / kBQ);
  flash_attention_fwd_kernel<T, D, kMasked><<<grid, kBQ, 0, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.bias), static_cast<const float*>(a.bound),
      static_cast<const unsigned char*>(a.kv_mask), static_cast<const int*>(a.q_offset),
      static_cast<T*>(a.out), static_cast<float*>(a.lse), a.heads, a.n, a.m, a.bias_stride_b,
      a.bias_stride_h, a.causal, a.scale);
}

template <typename T, int D>
void launch(const FwdArgs& a, cudaStream_t st) {
  if (a.causal || a.kv_mask != nullptr) {
    launch_masked<T, D, true>(a, st);
  } else {
    launch_masked<T, D, false>(a, st);
  }
}

template <typename T>
int launch_d(const FwdArgs& a, int d, cudaStream_t st) {
  switch (d) {
    case 16:
      launch<T, 16>(a, st);
      return 0;
    case 32:
      launch<T, 32>(a, st);
      return 0;
    case 64:
      launch<T, 64>(a, st);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_any(const void* q, const void* k, const void* v, const void* bias, const void* bound,
               const void* kv_mask, const void* q_offset, void* out, void* lse, int batch,
               int heads, int n, int m, int d, int bias_stride_b, int bias_stride_h, int causal,
               float scale, int is_bf16, void* stream) {
  const FwdArgs a{q, k, v, bias, bound, kv_mask, q_offset, out, lse, batch, heads, n, m,
                  bias_stride_b, bias_stride_h, causal, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = is_bf16 ? launch_d<__nv_bfloat16>(a, d, st) : launch_d<float>(a, d, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 when the launch
// was accepted).  `bias`, `bound`, `kv_mask` ((b, m) bytes, nonzero = real
// key) and `q_offset` (one int32) may be null.  The caller has checked: d in
// {16, 32, 64}, contiguous buffers, bias strides in elements.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          const void* bias, const void* bound,
                                          const void* kv_mask, const void* q_offset, void* out,
                                          int batch, int heads, int n, int m, int d,
                                          int bias_stride_b, int bias_stride_h, int causal,
                                          float scale, int is_bf16, void* stream) {
  return launch_any(q, k, v, bias, bound, kv_mask, q_offset, out, nullptr, batch, heads, n, m,
                    d, bias_stride_b, bias_stride_h, causal, scale, is_bf16, stream);
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
                    bias_stride_b, bias_stride_h, causal, scale, is_bf16, stream);
}
