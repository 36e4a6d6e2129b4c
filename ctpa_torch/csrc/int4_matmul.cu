// int4 projection: y = x @ W with W stored as packed int4 and fp32 scales per
// (input group, output column).
//
// Replaces the TPU kernels ctpa/ops/quant.py:int4_matmul, `_q4_kernel`
// (weight-only, "w4") and `_q4_kernel_a8` (int8 activations, "w4a8").  x is
// (m, k), the weight (k/2, n) bytes in ctpa's quantize_int4 layout (see
// int4_common.cuh) with scale (k/G, n) fp32, G the scale group (32, 64 or
// 128).
//
//   w4:   w = bf16(q * scale[g, col]) in fp32 then rounded to bf16 (ctpa
//         rounds the dequantized tile to the activation dtype), y = x . w
//         with fp32 sums, out in bf16; no scale at the flush.
//   w4a8: x8, sx per row from ctpa's quantize_act_int8 (computed by the
//         caller in plain PyTorch, outside the kernel, as ctpa computes it
//         outside its Pallas kernel); per scale group one exact
//         int8 x int8 -> int32 dot, times the group's fp32 scale row, summed
//         over the groups in fp32; the sum times sx[row] at the flush.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOPS int8) at
// Meditron-7B (k 4096; n 12288 for the fused qkv_proj, 4096 for o_proj,
// 32000 for lm_head): a decode step (m = 4 to 32 rows) is bound by the
// bytes of the weights: qkv_proj reads 25.2 MB of packed weights and 1.6 MB
// of scales, 8.0 us; o_proj 2.7 us; lm_head 20.8 us.  Prefill (m = 2,048
// rows for 4 x 512 tokens) is bound by the operations: qkv_proj is 206 GFLOP,
// 0.21 ms in bf16 and 0.10 ms in int8.
//
// Design (simple and right first): a block owns BM x 64 outputs (BM = 16 for
// m <= 16, else 64) and walks its scale groups one at a time: it stages the
// x tile, unpacks the group's packed rows (16 bytes a load, each byte giving
// rows j and j + G/2) into shared memory, and runs the products on the
// tensor cores: WMMA bf16 16x16x16 with fp32 accumulators for w4, WMMA
// s8 x s8 -> s32 16x16x16 for w4a8, whose int32 tile goes through shared
// memory to be scaled per column into fp32 sums each thread owns.  The int8
// tiles sit in shared memory as 16x16 slabs of 256 bytes, so every fragment
// address is 32-byte aligned.  At decode the output tiles alone are too few
// for 132 SMs (64 for o_proj), so the contraction is split across blocks
// (blockIdx.z) until there are two blocks per SM; the splits write fp32
// partial sums that a second kernel adds in a fixed order, so the result is
// deterministic.  Loads are not overlapped with the products (no cp.async,
// TMA or wgmma yet): that is the next step for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "int4_common.cuh"

namespace {

using namespace nvcuda;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = kWarps * 16;     // output columns per block, 16 per warp
constexpr int kSeg = kBN / 16;       // 16-byte segments per packed row of a tile
constexpr int kMaxG = 128;           // the largest scale group: one group per step
constexpr int kLdA = kMaxG + 8;      // bf16 row strides of the w4 tiles
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;        // fp32 / int32 staging row stride

// grid (ceil(n / kBN), ceil(m / BM), splits); block kThreads.  Split z takes
// scale groups [z * per, min(k / group, (z + 1) * per)); with splits > 1 it
// writes fp32 sums to work (splits, m, n), else bf16 to out.
template <int BM>
__global__ void __launch_bounds__(kThreads)
int4_matmul_w4_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w4,
                      const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ work, int m, int k, int n, int group, int per) {
  constexpr int kFr = BM / 16;
  constexpr int kTileBytes = (BM * kLdA + kMaxG * kLdB) * 2;
  constexpr int kOutBytes = BM * kLdC * 4;
  __shared__ __align__(128) unsigned char smem[kTileBytes > kOutBytes ? kTileBytes : kOutBytes];
  __shared__ float s_s[kBN];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);   // [BM][kLdA]
  __nv_bfloat16* b_s = a_s + BM * kLdA;                          // [kMaxG][kLdB]
  float* c_s = reinterpret_cast<float*>(smem);                   // [BM][kLdC], after the loop

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int g_end = min(k / group, (static_cast<int>(blockIdx.z) + 1) * per);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int half = group / 2;
  const bool vec = n % 16 == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFr];
#pragma unroll
  for (int i = 0; i < kFr; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int g = blockIdx.z * per; g < g_end; ++g) {
    // x tile: BM rows x group columns, 8 bf16 a load; rows past m are 0
    const int cpr = group / 8;
    for (int e = tid; e < BM * cpr; e += kThreads) {
      const int r = e / cpr;
      const int c = (e - r * cpr) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m)
        v = *reinterpret_cast<const uint4*>(x + static_cast<long long>(m0 + r) * k + g * group + c);
      *reinterpret_cast<uint4*>(a_s + r * kLdA + c) = v;
    }
    for (int c = tid; c < kBN; c += kThreads)
      s_s[c] = n0 + c < n ? scale[static_cast<long long>(g) * n + n0 + c] : 0.f;
    __syncthreads();
    // weights: packed row j of the group gives rows j and j + half
    const int8_t* wg = w4 + static_cast<long long>(g) * half * n;
    for (int e = tid; e < half * kSeg; e += kThreads) {
      const int j = e / kSeg;
      const int c = (e - j * kSeg) * 16;
      const uint4 v = q4::load16(wg + static_cast<long long>(j) * n, n0 + c, n, vec);
      q4::store_dequant(b_s + j * kLdB + c, v, false, s_s + c);
      q4::store_dequant(b_s + (j + half) * kLdB + c, v, true, s_s + c);
    }
    __syncthreads();
    for (int k0 = 0; k0 < group; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, b_s + k0 * kLdB + warp * 16, kLdB);
#pragma unroll
      for (int i = 0; i < kFr; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, a_s + i * 16 * kLdA + k0, kLdA);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kFr; ++i)
    wmma::store_matrix_sync(c_s + i * 16 * kLdC + warp * 16, acc[i], kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * kBN; e += kThreads) {
    const int r = e / kBN;
    const int c = e - r * kBN;
    if (m0 + r >= m || n0 + c >= n) continue;
    const long long o = static_cast<long long>(m0 + r) * n + n0 + c;
    if (work != nullptr)
      work[static_cast<long long>(blockIdx.z) * m * n + o] = c_s[r * kLdC + c];
    else
      out[o] = __float2bfloat16_rn(c_s[r * kLdC + c]);
  }
}

// The w4a8 form, on the same grid.  Without splits the flush multiplies by
// sx[row]; with splits the reduction does, after the sum.
template <int BM>
__global__ void __launch_bounds__(kThreads)
int4_matmul_a8_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                      const int8_t* __restrict__ w4, const float* __restrict__ scale,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ work, int m, int k,
                      int n, int group, int per) {
  constexpr int kFr = BM / 16;
  constexpr int kPer = BM * kBN / kThreads;     // fp32 sums a thread owns
  // int8 tiles as 16x16 slabs of 256 bytes: x8 [group/16][BM][16] and the
  // weights [kBN/16][kMaxG][16], so every fragment starts 32-byte aligned
  __shared__ __align__(128) int8_t a_s[BM * kMaxG];
  __shared__ __align__(128) int8_t b_s[kMaxG * kBN];
  __shared__ __align__(128) int i_s[BM * kLdC];
  __shared__ float s_s[kBN];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int g_end = min(k / group, (static_cast<int>(blockIdx.z) + 1) * per);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int half = group / 2;
  const bool vec = n % 16 == 0;

  float acc[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) acc[t] = 0.f;

  for (int g = blockIdx.z * per; g < g_end; ++g) {
    const int spr = group / 16;
    for (int e = tid; e < BM * spr; e += kThreads) {
      const int r = e / spr;
      const int kb = e - r * spr;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m)
        v = *reinterpret_cast<const uint4*>(x8 + static_cast<long long>(m0 + r) * k +
                                            g * group + kb * 16);
      *reinterpret_cast<uint4*>(a_s + (kb * BM + r) * 16) = v;
    }
    for (int c = tid; c < kBN; c += kThreads)
      s_s[c] = n0 + c < n ? scale[static_cast<long long>(g) * n + n0 + c] : 0.f;
    const int8_t* wg = w4 + static_cast<long long>(g) * half * n;
    for (int e = tid; e < half * kSeg; e += kThreads) {
      const int j = e / kSeg;
      const int cb = e - j * kSeg;
      const uint4 v = q4::load16(wg + static_cast<long long>(j) * n, n0 + cb * 16, n, vec);
      *reinterpret_cast<uint4*>(b_s + (cb * kMaxG + j) * 16) = q4::unpack16(v, false);
      *reinterpret_cast<uint4*>(b_s + (cb * kMaxG + j + half) * 16) = q4::unpack16(v, true);
    }
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> ci[kFr];
#pragma unroll
    for (int i = 0; i < kFr; ++i) wmma::fill_fragment(ci[i], 0);
    for (int kk = 0; kk < group / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, reinterpret_cast<const signed char*>(
                                     b_s + (warp * kMaxG + kk * 16) * 16), 16);
#pragma unroll
      for (int i = 0; i < kFr; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af;
        wmma::load_matrix_sync(af, reinterpret_cast<const signed char*>(
                                       a_s + (kk * BM + i * 16) * 16), 16);
        wmma::mma_sync(ci[i], af, bf, ci[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kFr; ++i)
      wmma::store_matrix_sync(i_s + i * 16 * kLdC + warp * 16, ci[i], kLdC, wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int e = tid + t * kThreads;
      const int r = e / kBN;
      const int c = e - r * kBN;
      acc[t] = __fadd_rn(acc[t], __fmul_rn(static_cast<float>(i_s[r * kLdC + c]), s_s[c]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int e = tid + t * kThreads;
    const int r = e / kBN;
    const int c = e - r * kBN;
    if (m0 + r >= m || n0 + c >= n) continue;
    const long long o = static_cast<long long>(m0 + r) * n + n0 + c;
    if (work != nullptr)
      work[static_cast<long long>(blockIdx.z) * m * n + o] = acc[t];
    else
      out[o] = __float2bfloat16_rn(__fmul_rn(acc[t], sx[m0 + r]));
  }
}

template <int BM>
cudaError_t launch_rows(const void* x, const void* sx, const void* w4, const void* scale,
                        void* out, float* work, int m, int k, int n, int group, int per,
                        int splits, bool a8, cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + BM - 1) / BM, splits);
  if (a8)
    int4_matmul_a8_kernel<BM><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const float*>(sx),
        static_cast<const int8_t*>(w4), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), work, m, k, n, group, per);
  else
    int4_matmul_w4_kernel<BM><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w4),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), work, m, k, n,
        group, per);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the first CUDA error (0 when every launch was
// accepted).  x is bf16 (w4) or int8 with sx (w4a8), (m, k) row-major; w4
// (k/2, n) int8; scale (k/group, n) fp32; out (m, n) bf16; work (splits, m,
// n) fp32 when splits > 1.  The caller has checked the shapes and dtypes,
// and that x and w4 are contiguous and 16-byte aligned.
extern "C" int int4_matmul_launch(const void* x, const void* sx, const void* w4,
                                  const void* scale, void* out, void* work, int m, int k, int n,
                                  int group, int per, int splits, int act_quant, void* stream) {
  if (group != 32 && group != 64 && group != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || n <= 0 || k % group != 0 || per <= 0 || splits < 1 ||
      (splits - 1) * per >= k / group || (splits > 1 && work == nullptr) ||
      (act_quant && sx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(work) : nullptr;
  const bool a8 = act_quant != 0;
  cudaError_t err = m <= 16
      ? launch_rows<16>(x, sx, w4, scale, out, part, m, k, n, group, per, splits, a8, s)
      : launch_rows<64>(x, sx, w4, scale, out, part, m, k, n, group, per, splits, a8, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(q4::reduce_partials(part, splits, m,
                                                a8 ? static_cast<const float*>(sx) : nullptr,
                                                nullptr, static_cast<__nv_bfloat16*>(out), m, n,
                                                s));
}
