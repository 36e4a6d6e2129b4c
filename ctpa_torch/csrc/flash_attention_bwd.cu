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
// Bound on the H100 at the shipped training shape (b*h = 48*8 at batch 2,
// n = m = 576, d = 32, bf16, bias (8, 576, 576)): the whole backward reads q,
// k, v, O, dO (5 x 14.2 MB), lse (0.9 MB) and the bias (5.3 MB) and writes dq,
// dk, dv (3 x 14.2 MB) and dbias (5.3 MB), 125 MB or 37 us at 3.35 TB/s; its
// five products (s, dp, dV, dK, dQ; 5 * 2 * 384 * 576^2 * 32 = 40.8 GFLOP)
// take 41 us at the bf16 tensor-core rate.  Bytes and operations are close,
// so a kernel near the floor needs both the tensor cores and few passes over
// the inputs.  This first version runs every product on the fp32 FMA units
// and recomputes s and dp in each of its three main passes (about 73 GFLOP
// in all); mma/wgmma tiles and a fused dq+dbias pass with fp32 atomics are
// later work.
//
// Design.  Blocks run in no order on the card, so nothing is carried from one
// block to another: each sum is a loop inside one block.
//   * delta: one thread per row, a pre-pass the three passes below read.
//   * dK/dV: a block of 64 threads owns 64 key rows (k_j, v_j, dk_j, dv_j in
//     registers) and walks the queries in tiles of 32, staging q, dO, lse,
//     delta and the 32 x 64 bias tile in shared memory; every shared read in
//     the inner loop is a broadcast.
//   * dQ: a block of 64 threads owns 64 query rows (q_i, dO_i, dq_i in
//     registers) and walks the keys in tiles of 32, as the forward does.
//   * d(bias): a block owns a 32 x 64 tile of one bias slab, one key column
//     per thread with its 32 cells in registers, and loops over the batch
//     items that broadcast the slab (all b for (h, n, m), all b*h for
//     (1, n, m), one for (b, h, n, m)), so the sum over items is
//     deterministic.
// At d = 64 the dK/dV pass holds 256 values per thread and spills; the
// shipped geometry has d = 32.  Head dim 128 (the LLM's) has its own
// kernels on the tensor cores (flash_attention_d128.cu); the delta pre-pass
// here serves it too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_masks.cuh"

namespace {

using namespace flash;

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
};

// delta_r = dO_r . O_r, one thread per row of the (b*h*n, D) layout.
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* o = out + r * D;
  const T* g = dout + r * D;
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc += to_float(o[d]) * to_float(g[d]);
  delta[r] = acc;
}

// grid (b*h, ceil(n / kRows)); block kRows.  Thread i owns query row i.  The
// masks are compiled in only where a launch has one (kMasked), here and in
// the passes below: the unmasked paths keep their registers.
template <typename T, int D, bool kMasked>
__global__ void __launch_bounds__(kRows)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ bias, const unsigned char* __restrict__ kv_mask,
                    const int* __restrict__ q_offset, const float* __restrict__ lse,
                    const float* __restrict__ delta, const T* __restrict__ dout,
                    T* __restrict__ dq, int heads, int n, int m, int bias_stride_b,
                    int bias_stride_h, int causal, float scale) {
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int hd = bh - b * heads;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int row = row0 + tid;
  const bool live = row < n;

  const T* kg = k + (long long)bh * m * D;
  const T* vg = v + (long long)bh * m * D;
  const T* bg = bias == nullptr
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
    qr[d] = live ? to_float(q[base + d]) : 0.f;
    dor[d] = live ? to_float(dout[base + d]) : 0.f;
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
      k_s[j][d] = in ? to_float(kg[(long long)(j0 + j) * D + d]) : 0.f;
      v_s[j][d] = in ? to_float(vg[(long long)(j0 + j) * D + d]) : 0.f;
    }
    if (bg != nullptr) {
      for (int e = tid; e < kRows * kTile; e += kRows) {
        const int r = e / kTile;
        const int j = e - r * kTile;
        b_s[r][j] = (row0 + r < n && j < jn) ? to_float(bg[(long long)(row0 + r) * m + j0 + j])
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
    for (int d = 0; d < D; ++d) dq[base + d] = from_float<T>(acc[d] * scale);
  }
}

// grid (b*h, ceil(m / kRows)); block kRows.  Thread j owns key row j.
template <typename T, int D, bool kMasked>
__global__ void __launch_bounds__(kRows)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ bias, const unsigned char* __restrict__ kv_mask,
                     const int* __restrict__ q_offset, const float* __restrict__ lse,
                     const float* __restrict__ delta, const T* __restrict__ dout,
                     T* __restrict__ dk, T* __restrict__ dv, int heads, int n, int m,
                     int bias_stride_b, int bias_stride_h, int causal, float scale) {
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int hd = bh - b * heads;
  const int tid = threadIdx.x;
  const int col0 = blockIdx.y * kRows;
  const int col = col0 + tid;
  const bool live = col < m;

  const T* qg = q + (long long)bh * n * D;
  const T* dog = dout + (long long)bh * n * D;
  const float* lg = lse + (long long)bh * n;
  const float* dg = delta + (long long)bh * n;
  const T* bg = bias == nullptr
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
    kr[d] = live ? to_float(k[base + d]) : 0.f;
    vr[d] = live ? to_float(v[base + d]) : 0.f;
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
      q_s[i][d] = in ? to_float(qg[(long long)(i0 + i) * D + d]) : 0.f;
      do_s[i][d] = in ? to_float(dog[(long long)(i0 + i) * D + d]) : 0.f;
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
                        ? to_float(bg[(long long)(i0 + i) * m + col0 + j])
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
      dk[base + d] = from_float<T>(dk_acc[d] * scale);
      dv[base + d] = from_float<T>(dv_acc[d]);
    }
  }
}

// grid (bias slabs, ceil(n / kTile), ceil(m / kRows)); block kRows.  Thread j
// owns key column j of a kTile x kRows tile of one slab; the block loops over
// the `items` batch items g = slab + t * item_stride that share the slab.
template <typename T, int D, bool kMasked>
__global__ void __launch_bounds__(kRows)
flash_bwd_dbias_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ bias,
                       const unsigned char* __restrict__ kv_mask,
                       const int* __restrict__ q_offset, const float* __restrict__ lse,
                       const float* __restrict__ delta, const T* __restrict__ dout,
                       T* __restrict__ dbias, int heads, int n, int m, int items,
                       int item_stride, int causal, float scale) {
  const int slab = blockIdx.x;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.z * kRows;
  const int tid = threadIdx.x;
  const int col = col0 + tid;
  const bool live = col < m;
  const int in_rows = min(kTile, n - row0);
  const T* bg = bias + (long long)slab * n * m;
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
                      ? to_float(bg[(long long)(row0 + i) * m + col0 + j])
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
      kr[d] = live ? to_float(k[kbase + d]) : 0.f;
      vr[d] = live ? to_float(v[kbase + d]) : 0.f;
    }
    const long long qbase = (g * n + row0) * D;
    for (int e = tid; e < kTile * D; e += kRows) {
      const int i = e / D;
      const bool in = i < in_rows;
      q_s[i][e - i * D] = in ? to_float(q[qbase + e]) : 0.f;
      do_s[i][e - i * D] = in ? to_float(dout[qbase + e]) : 0.f;
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
    T* out = dbias + (long long)slab * n * m;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (i < in_rows) out[(long long)(row0 + i) * m + col] = from_float<T>(acc[i]);
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

inline bool masked(const BwdArgs& a) { return a.causal || a.kv_mask != nullptr; }

struct DeltaLaunch {
  template <typename T, int D>
  static void run(const BwdArgs& a, cudaStream_t st) {
    const long long rows = (long long)a.batch * a.heads * a.n;
    flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
        static_cast<const T*>(a.out), static_cast<const T*>(a.dout), a.delta, rows);
  }
};

struct DqLaunch {
  template <typename T, int D>
  static void run(const BwdArgs& a, cudaStream_t st) {
    auto kernel = masked(a) ? flash_bwd_dq_kernel<T, D, true> : flash_bwd_dq_kernel<T, D, false>;
    kernel<<<dim3(a.batch * a.heads, cdiv(a.n, kRows)), kRows, 0, st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.bias), a.kv_mask, a.q_offset, a.lse, a.delta,
        static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.heads, a.n, a.m,
        a.bias_stride_b, a.bias_stride_h, a.causal, a.scale);
  }
};

struct DkvLaunch {
  template <typename T, int D>
  static void run(const BwdArgs& a, cudaStream_t st) {
    auto kernel = masked(a) ? flash_bwd_dkv_kernel<T, D, true> : flash_bwd_dkv_kernel<T, D, false>;
    kernel<<<dim3(a.batch * a.heads, cdiv(a.m, kRows)), kRows, 0, st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.bias), a.kv_mask, a.q_offset, a.lse, a.delta,
        static_cast<const T*>(a.dout), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.heads,
        a.n, a.m, a.bias_stride_b, a.bias_stride_h, a.causal, a.scale);
  }
};

struct DbiasLaunch {
  template <typename T, int D>
  static void run(const BwdArgs& a, cudaStream_t st) {
    // slabs: the leading extent of the bias, b*h items in all
    const int slabs = a.batch * a.heads / a.items;
    auto kernel = masked(a) ? flash_bwd_dbias_kernel<T, D, true>
                            : flash_bwd_dbias_kernel<T, D, false>;
    kernel<<<dim3(slabs, cdiv(a.n, kTile), cdiv(a.m, kRows)), kRows, 0, st>>>(
            static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
            static_cast<const T*>(a.bias), a.kv_mask, a.q_offset, a.lse, a.delta,
            static_cast<const T*>(a.dout), static_cast<T*>(a.dbias), a.heads, a.n, a.m,
            a.items, a.item_stride, a.causal, a.scale);
  }
};

template <typename L>
int dispatch(const BwdArgs& a, int d, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      is_bf16 ? L::template run<__nv_bfloat16, 16>(a, st) : L::template run<float, 16>(a, st);
      break;
    case 32:
      is_bf16 ? L::template run<__nv_bfloat16, 32>(a, st) : L::template run<float, 32>(a, st);
      break;
    case 64:
      is_bf16 ? L::template run<__nv_bfloat16, 64>(a, st) : L::template run<float, 64>(a, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
// pre-pass also 128), one dtype for q, k, v, O, dO and the bias, contiguous
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
  if (d == 128) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    is_bf16 ? DeltaLaunch::run<__nv_bfloat16, 128>(a, st) : DeltaLaunch::run<float, 128>(a, st);
    return static_cast<int>(cudaGetLastError());
  }
  return dispatch<DeltaLaunch>(a, d, is_bf16, stream);
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
