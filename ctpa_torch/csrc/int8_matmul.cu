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
//   w8a8: x8, sx per row from ctpa's quantize_act_int8 (computed by the
//         caller in plain PyTorch, outside the kernel, as ctpa computes it
//         outside its Pallas kernel); one exact int8 x int8 -> int32 dot
//         over the whole contraction (|sum| <= 11008 * 127^2 < 2^31), then
//         float(sum) * sx[row] * scale[col].
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOPS int8) at
// Meditron-7B (k 4096; n 12288 for the fused qkv_proj, 4096 for o_proj,
// 32000 for lm_head; k 4096, n 22016 for gateup_proj and k 11008, n 4096 for
// down_proj without the fused FFN): a decode step (m = 4 to 32 rows) is
// bound by the bytes of the weights: qkv_proj reads 50.3 MB, 15.0 us;
// o_proj 5.0 us; lm_head 39.2 us.  Prefill (m = 2,048 rows for 4 x 512
// tokens) is bound by the operations: qkv_proj is 206 GFLOP, 0.21 ms in
// bf16 (w8) and 0.10 ms in int8 (w8a8).
//
// Design (simple and right first): a block owns BM x 64 outputs (BM = 16 for
// m <= 16, else 64) and walks the contraction in chunks of 128: it stages the
// x tile and the chunk's 128 weight rows in shared memory and runs the
// products on the tensor cores: WMMA bf16 16x16x16 with fp32 accumulators
// for w8 (the int8 weights converted to bf16 on the way in), WMMA s8 x s8 ->
// s32 16x16x16 for w8a8, whose int32 accumulators stay in the fragments over
// the whole contraction.  The int8 tiles sit in shared memory as 16x16 slabs
// of 256 bytes, so every fragment address is 32-byte aligned.  At decode the
// output tiles alone are too few for 132 SMs (64 for o_proj), so the
// contraction is split across blocks (blockIdx.z) until there are two blocks
// per SM; the splits write fp32 (w8) or exact int32 (w8a8) partial sums that
// a second kernel adds in a fixed order and scales (int4_common.cuh), so the
// result is deterministic.  Loads are not overlapped with the products (no
// cp.async, TMA or wgmma yet): that is the next step for speed.

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
constexpr int kSeg = kBN / 16;       // 16-byte segments per weight row of a tile
constexpr int kKC = 128;             // contraction chunk
constexpr int kLdA = kKC + 8;        // bf16 row strides of the w8 tiles
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;        // fp32 / int32 staging row stride

// 16 bytes of x's row `row` at byte `col` of chunk `k0` (its `kc` real
// columns of `esize` bytes each); 0 past the chunk's end or past m
__device__ __forceinline__ uint4 x_segment(const void* x, int row, int m, int k, int k0, int kc,
                                           int col, int esize, bool vec) {
  if (row >= m) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* base = static_cast<const int8_t*>(x) +
                       (static_cast<long long>(row) * k + k0) * esize;
  return q4::load16(base, col, kc * esize, vec);
}

// grid (ceil(n / kBN), ceil(m / BM), splits); block kThreads.  Split z takes
// chunks [z * per, min(ceil(k / kKC), (z + 1) * per)); with splits > 1 it
// writes fp32 sums to work (splits, m, n), else bf16 to out.
template <int BM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_w8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w8,
                      const float* __restrict__ scale, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ work, int m, int k, int n, int per) {
  constexpr int kFr = BM / 16;
  constexpr int kTileBytes = (BM * kLdA + kKC * kLdB) * 2;
  constexpr int kOutBytes = BM * kLdC * 4;
  __shared__ __align__(128) unsigned char smem[kTileBytes > kOutBytes ? kTileBytes : kOutBytes];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);   // [BM][kLdA]
  __nv_bfloat16* b_s = a_s + BM * kLdA;                          // [kKC][kLdB]
  float* c_s = reinterpret_cast<float*>(smem);                   // [BM][kLdC], after the loop

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int c_end = min((k + kKC - 1) / kKC, (static_cast<int>(blockIdx.z) + 1) * per);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const bool xvec = k % 8 == 0;
  const bool wvec = n % 16 == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kFr];
#pragma unroll
  for (int i = 0; i < kFr; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int ch = blockIdx.z * per; ch < c_end; ++ch) {
    const int k0 = ch * kKC;
    const int kc = min(kKC, k - k0);
    const int kc16 = (kc + 15) / 16 * 16;     // rows and columns past kc are 0
    const int spr = kc16 / 8;                 // 16-byte segments of a bf16 x row
    for (int e = tid; e < BM * spr; e += kThreads) {
      const int r = e / spr;
      const int c = (e - r * spr) * 8;
      *reinterpret_cast<uint4*>(a_s + r * kLdA + c) =
          x_segment(x, m0 + r, m, k, k0, kc, c * 2, 2, xvec);
    }
    for (int e = tid; e < kc16 * kSeg; e += kThreads) {
      const int j = e / kSeg;
      const int c = (e - j * kSeg) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j < kc) v = q4::load16(w8 + static_cast<long long>(k0 + j) * n, n0 + c, n, wvec);
      q4::store_int8_as_bf16(b_s + j * kLdB + c, v);
    }
    __syncthreads();
    for (int kk = 0; kk < kc16; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, b_s + kk * kLdB + warp * 16, kLdB);
#pragma unroll
      for (int i = 0; i < kFr; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, a_s + i * 16 * kLdA + kk, kLdA);
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
      out[o] = __float2bfloat16_rn(__fmul_rn(c_s[r * kLdC + c], scale[n0 + c]));
  }
}

// The w8a8 form, on the same grid.  Without splits the flush scales by
// sx[row] and scale[col]; with splits the int32 partials go to work and the
// reduction scales their sum.
template <int BM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_a8_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                      const int8_t* __restrict__ w8, const float* __restrict__ scale,
                      __nv_bfloat16* __restrict__ out, int* __restrict__ work, int m, int k,
                      int n, int per) {
  constexpr int kFr = BM / 16;
  // int8 tiles as 16x16 slabs of 256 bytes: x8 [kKC/16][BM][16] and the
  // weights [kBN/16][kKC][16], so every fragment starts 32-byte aligned
  __shared__ __align__(128) int8_t a_s[BM * kKC];
  __shared__ __align__(128) int8_t b_s[kKC * kBN];
  __shared__ __align__(128) int i_s[BM * kLdC];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int c_end = min((k + kKC - 1) / kKC, (static_cast<int>(blockIdx.z) + 1) * per);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const bool xvec = k % 16 == 0;
  const bool wvec = n % 16 == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> ci[kFr];
#pragma unroll
  for (int i = 0; i < kFr; ++i) wmma::fill_fragment(ci[i], 0);

  for (int ch = blockIdx.z * per; ch < c_end; ++ch) {
    const int k0 = ch * kKC;
    const int kc = min(kKC, k - k0);
    const int spr = (kc + 15) / 16;           // 16-column slabs of this chunk
    for (int e = tid; e < BM * spr; e += kThreads) {
      const int r = e / spr;
      const int kb = e - r * spr;
      *reinterpret_cast<uint4*>(a_s + (kb * BM + r) * 16) =
          x_segment(x8, m0 + r, m, k, k0, kc, kb * 16, 1, xvec);
    }
    for (int e = tid; e < spr * 16 * kSeg; e += kThreads) {
      const int j = e / kSeg;
      const int cb = e - j * kSeg;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j < kc) v = q4::load16(w8 + static_cast<long long>(k0 + j) * n, n0 + cb * 16, n, wvec);
      *reinterpret_cast<uint4*>(b_s + (cb * kKC + j) * 16) = v;
    }
    __syncthreads();
    for (int kk = 0; kk < spr; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, reinterpret_cast<const signed char*>(
                                     b_s + (warp * kKC + kk * 16) * 16), 16);
#pragma unroll
      for (int i = 0; i < kFr; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> af;
        wmma::load_matrix_sync(af, reinterpret_cast<const signed char*>(
                                       a_s + (kk * BM + i * 16) * 16), 16);
        wmma::mma_sync(ci[i], af, bf, ci[i]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kFr; ++i)
    wmma::store_matrix_sync(i_s + i * 16 * kLdC + warp * 16, ci[i], kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * kBN; e += kThreads) {
    const int r = e / kBN;
    const int c = e - r * kBN;
    if (m0 + r >= m || n0 + c >= n) continue;
    const long long o = static_cast<long long>(m0 + r) * n + n0 + c;
    if (work != nullptr)
      work[static_cast<long long>(blockIdx.z) * m * n + o] = i_s[r * kLdC + c];
    else
      out[o] = __float2bfloat16_rn(__fmul_rn(
          __fmul_rn(static_cast<float>(i_s[r * kLdC + c]), sx[m0 + r]), scale[n0 + c]));
  }
}

template <int BM>
cudaError_t launch_rows(const void* x, const void* sx, const void* w8, const void* scale,
                        void* out, void* work, int m, int k, int n, int per, int splits, bool a8,
                        cudaStream_t stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + BM - 1) / BM, splits);
  if (a8)
    int8_matmul_a8_kernel<BM><<<grid, kThreads, 0, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const float*>(sx),
        static_cast<const int8_t*>(w8), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), static_cast<int*>(work), m, k, n, per);
  else
    int8_matmul_w8_kernel<BM><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w8),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
        static_cast<float*>(work), m, k, n, per);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the first CUDA error (0 when every launch was
// accepted).  x is bf16 (w8) or int8 with sx (w8a8), (m, k) row-major; w8
// (k, n) int8; scale (n,) fp32; out (m, n) bf16; work (splits, m, n), fp32
// (w8) or int32 (w8a8), when splits > 1.  The caller has checked the shapes
// and dtypes, and that x and w8 are contiguous and 16-byte aligned.
extern "C" int int8_matmul_launch(const void* x, const void* sx, const void* w8,
                                  const void* scale, void* out, void* work, int m, int k, int n,
                                  int per, int splits, int act_quant, void* stream) {
  const int chunks = (k + kKC - 1) / kKC;
  if (m <= 0 || n <= 0 || k <= 0 || per <= 0 || splits < 1 || (splits - 1) * per >= chunks ||
      (splits > 1 && work == nullptr) || (act_quant && sx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* part = splits > 1 ? work : nullptr;
  const bool a8 = act_quant != 0;
  cudaError_t err = m <= 16
      ? launch_rows<16>(x, sx, w8, scale, out, part, m, k, n, per, splits, a8, s)
      : launch_rows<64>(x, sx, w8, scale, out, part, m, k, n, per, splits, a8, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const float* cs = static_cast<const float*>(scale);
  if (a8)
    return static_cast<int>(q4::reduce_partials(static_cast<const int*>(part), splits, m,
                                                  static_cast<const float*>(sx), cs, o, m, n, s));
  return static_cast<int>(q4::reduce_partials(static_cast<const float*>(part), splits, m,
                                                nullptr, cs, o, m, n, s));
}
