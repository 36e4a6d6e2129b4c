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
// (given to the kernel as two strides), non-causal, fp32 accumulation and
// bf16 or fp32 inputs.  With a logit bound B (a device scalar that bounds
// every logit from above, as cosine attention guarantees) the kernel skips
// the running max and accumulates exp(s - B) directly ("flat softmax");
// without it, it keeps the usual online-softmax running max.  The TPU's
// layout tricks (spare-lane denominator and bound, d padded to 128,
// power-of-two scale folding) are not carried over: they exist for the
// TPU's (8, 128) tiling.
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
// ragged edge on either axis is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;  // query rows per block, one per thread
constexpr int kBK = 32;  // keys per tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// grid (b * h, ceil(n / kBQ)); block kBQ.
template <typename T, int D>
__global__ void __launch_bounds__(kBQ)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ bias,
                           const float* __restrict__ bound, T* __restrict__ out,
                           float* __restrict__ lse, int heads, int n, int m, int bias_stride_b,
                           int bias_stride_h, float scale) {
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

  __shared__ __align__(16) float k_s[kBK][D];
  __shared__ __align__(16) float v_s[kBK][D];
  __shared__ float b_s[kBQ][kBK + 1];

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

  for (int j0 = 0; j0 < m; j0 += kBK) {
    const int jn = min(kBK, m - j0);
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
      sj = j < jn ? sj : -INFINITY;
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }

    float shift = shift_flat;
    if (!flat) {
      const float m_new = fmaxf(m_run, tile_max);
      const float alpha = expf(m_run - m_new);   // 0 on the first tile
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
      m_run = m_new;
      shift = m_new;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - shift);   // masked keys give exp(-inf) = 0
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
    const float lc = fmaxf(l, 1e-30f);
    const float inv = 1.f / lc;
    T* o = out + (long long)(bh * (long long)n + row) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = from_float<T>(acc[d] * inv);
    if (lse != nullptr) lse[(long long)bh * n + row] = (flat ? shift_flat : m_run) + logf(lc);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, const void* bias, const void* bound,
            void* out, void* lse, int batch, int heads, int n, int m, int bias_stride_b,
            int bias_stride_h, float scale, cudaStream_t st) {
  const dim3 grid(batch * heads, (n + kBQ - 1) / kBQ);
  flash_attention_fwd_kernel<T, D><<<grid, kBQ, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(bias), static_cast<const float*>(bound), static_cast<T*>(out),
      static_cast<float*>(lse), heads, n, m, bias_stride_b, bias_stride_h, scale);
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* bias, const void* bound,
             void* out, void* lse, int batch, int heads, int n, int m, int d,
             int bias_stride_b, int bias_stride_h, float scale, cudaStream_t st) {
  switch (d) {
    case 16:
      launch<T, 16>(q, k, v, bias, bound, out, lse, batch, heads, n, m, bias_stride_b, bias_stride_h, scale, st);
      return 0;
    case 32:
      launch<T, 32>(q, k, v, bias, bound, out, lse, batch, heads, n, m, bias_stride_b, bias_stride_h, scale, st);
      return 0;
    case 64:
      launch<T, 64>(q, k, v, bias, bound, out, lse, batch, heads, n, m, bias_stride_b, bias_stride_h, scale, st);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_any(const void* q, const void* k, const void* v, const void* bias, const void* bound,
               void* out, void* lse, int batch, int heads, int n, int m, int d,
               int bias_stride_b, int bias_stride_h, float scale, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = is_bf16
                     ? launch_d<__nv_bfloat16>(q, k, v, bias, bound, out, lse, batch, heads, n, m,
                                               d, bias_stride_b, bias_stride_h, scale, st)
                     : launch_d<float>(q, k, v, bias, bound, out, lse, batch, heads, n, m, d,
                                       bias_stride_b, bias_stride_h, scale, st);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 when the launch
// was accepted).  `bias` and `bound` may be null.  The caller has checked:
// d in {16, 32, 64}, contiguous buffers, bias strides in elements.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          const void* bias, const void* bound, void* out,
                                          int batch, int heads, int n, int m, int d,
                                          int bias_stride_b, int bias_stride_h, float scale,
                                          int is_bf16, void* stream) {
  return launch_any(q, k, v, bias, bound, out, nullptr, batch, heads, n, m, d, bias_stride_b,
                    bias_stride_h, scale, is_bf16, stream);
}

// The same with the fp32 (b, h, n) row logsumexp written to `lse`.
extern "C" int flash_attention_fwd_lse_launch(const void* q, const void* k, const void* v,
                                              const void* bias, const void* bound, void* out,
                                              void* lse, int batch, int heads, int n, int m,
                                              int d, int bias_stride_b, int bias_stride_h,
                                              float scale, int is_bf16, void* stream) {
  return launch_any(q, k, v, bias, bound, out, lse, batch, heads, n, m, d, bias_stride_b,
                    bias_stride_h, scale, is_bf16, stream);
}
