// Flash attention's forward at head dim 128 on the tensor cores (kernel K2,
// with or without the row logsumexp).  The backward at this head dim (K3)
// runs the mma.sync kernels of flash_attention_bwd.cu instantiated at
// D = 128; this file holds the forward only.
//
// Replaces, for the LLM's head dim, the TPU kernel
// ctpa/ops/pallas/flash_attention.py:_attn_kernel via `_flash_call`.  The
// function is that of flash_attention.cu (its header gives the formula),
// with the masks of flash_masks.cuh.  bf16 inputs only.
//
// Bound on the H100 at report training's shape (b 2, h 32, n = m = 512,
// d 128, bf16, causal with right padding, 896 of 1024 keys real): the
// forward moves q and out (2 x 8.4 MB), k and v over the real keys (2 x
// 7.3 MB) and the lse, 31.6 MB or 9.4 us at 3.35 TB/s; its two products
// over the tiles it visits (69 of 128 per head) are 4.6 GFLOP, 4.7 us at
// the bf16 tensor-core rate, so the bytes bound it (chip_smoke.py computes
// the bound from the run's mask).
//
// Design.  The fp32-FMA kernels hold a query row per thread, and a
// 128-float accumulator row spills.  Here each warp owns 16 rows and runs
// its products as 16x16x16 WMMA tiles (bf16 in, fp32 accumulated): a block
// of 4 warps owns 64 query rows (each warp's Q as 8 bf16 fragments in
// registers) and walks the keys in tiles of 64 that it stages in shared
// memory.  S = Q K^T goes to shared memory, where two lanes per row apply
// the scale, the bias and the masks and run the online softmax in fp32; P
// is rounded to bf16 (as ctpa does before PV), and the running output,
// kept in shared memory in fp32, is rescaled by the lanes and accumulated
// by P V on the tensor cores.  Key tiles past the causal diagonal and
// tiles with no real key are skipped whole.  Moving it to flash_attention.cu's
// register-resident mma.sync design is the next step.

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

struct Args {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* bias;
  const float* bound;
  const unsigned char* kv_mask;
  const int* q_offset;
  bf16* out;
  float* lse;
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
// accepted).  The caller has checked: d = 128, bf16 q, k, v and bias,
// contiguous 16-byte aligned buffers, bias strides in elements, an fp32 lse
// of (b, h, n).  `bias`, `bound`, `kv_mask` ((b, m) bytes,
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
