// Helpers shared by the tiled (prefill) projection kernels: the nibble
// unpack of ctpa's quantize_int4 layout (int4_matmul.cu), and for the int8
// kernel too (int8_matmul.cu) 16-byte loads with a ragged edge and the
// fixed-order reduction of partial sums.
//
// Packed layout (ctpa/ops/quant.py:quantize_int4): the weight is (in/2, out)
// bytes; byte j of scale group g (group size G) holds row g*G + j in its low
// nibble and row g*G + G/2 + j in its high nibble, both signed in [-7, 7].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace q4 {
namespace {  // each kernel source gets its own copy

// Sign-extend a nibble held in the low 4 bits of an unsigned value: shift it
// to the top on the unsigned value, then arithmetic-shift back (a left shift
// of a negative int would be undefined).
__device__ __forceinline__ int nibble_lo(uint32_t byte) {
  return static_cast<int32_t>(byte << 28) >> 28;
}
__device__ __forceinline__ int nibble_hi(uint32_t byte) {
  return static_cast<int32_t>((byte >> 4) << 28) >> 28;
}

// 16 bytes of a packed row starting at column `col` (a multiple of 16); the
// bytes at columns >= n are 0.  `vec` promises n % 16 == 0 and a 16-byte
// aligned base, so a whole in-range segment is one load.
__device__ __forceinline__ uint4 load16(const int8_t* row, int col, int n, bool vec) {
  if (vec) {
    if (col < n) return *reinterpret_cast<const uint4*>(row + col);
    return make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (col + i < n) w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[col + i]))
                                 << (8 * (i % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ uint32_t byte_of(const uint4& v, int i) {
  const uint32_t w = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
  return (w >> (8 * (i % 4))) & 0xFFu;
}

// 16 bf16 values, each q * s rounded to bf16, stored at dst (16-byte aligned)
__device__ __forceinline__ void store_dequant(__nv_bfloat16* dst, const uint4& v, bool high,
                                              const float* s) {
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t b0 = byte_of(v, 2 * i), b1 = byte_of(v, 2 * i + 1);
    const int q0 = high ? nibble_hi(b0) : nibble_lo(b0);
    const int q1 = high ? nibble_hi(b1) : nibble_lo(b1);
    __nv_bfloat162 two = __halves2bfloat162(
        __float2bfloat16_rn(__fmul_rn(static_cast<float>(q0), s[2 * i])),
        __float2bfloat16_rn(__fmul_rn(static_cast<float>(q1), s[2 * i + 1])));
    p[i] = *reinterpret_cast<uint32_t*>(&two);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(p[0], p[1], p[2], p[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(p[4], p[5], p[6], p[7]);
}

// 16 int8 values of v (bytes in order) as bf16, exact, stored at dst
// (16-byte aligned)
__device__ __forceinline__ void store_int8_as_bf16(__nv_bfloat16* dst, const uint4& v) {
  uint32_t p[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q0 = static_cast<int8_t>(byte_of(v, 2 * i));
    const int q1 = static_cast<int8_t>(byte_of(v, 2 * i + 1));
    __nv_bfloat162 two = __halves2bfloat162(__float2bfloat16_rn(static_cast<float>(q0)),
                                            __float2bfloat16_rn(static_cast<float>(q1)));
    p[i] = *reinterpret_cast<uint32_t*>(&two);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(p[0], p[1], p[2], p[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(p[4], p[5], p[6], p[7]);
}

// 16 signed nibbles of v (low or high halves of its bytes) as 16 int8 values
__device__ __forceinline__ uint4 unpack16(const uint4& v, bool high) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t b = byte_of(v, i);
    const int q = high ? nibble_hi(b) : nibble_lo(b);
    w[i / 4] |= (static_cast<uint32_t>(q) & 0xFFu) << (8 * (i % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// out[r, c] = bf16((sum over s of part[s, r, c], in order s = 0, 1, ...)
//                 * rowscale[r] * colscale[c]) for r < m, c < n; part is
// (splits, ld_rows, n) of T: fp32 partial sums, or exact int32 ones (int8
// activations), whose sum stays exact; rowscale and colscale may be null.
template <typename T>
__global__ void reduce_partials_kernel(const T* __restrict__ part, int splits, int ld_rows,
                                       const float* __restrict__ rowscale,
                                       const float* __restrict__ colscale,
                                       __nv_bfloat16* __restrict__ out, int m, int n) {
  const long long total = static_cast<long long>(m) * n;
  const long long split_stride = static_cast<long long>(ld_rows) * n;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(e / n);
    const int c = static_cast<int>(e - static_cast<long long>(r) * n);
    T sum = 0;
    for (int s = 0; s < splits; ++s)
      sum += part[s * split_stride + static_cast<long long>(r) * n + c];
    float acc = static_cast<float>(sum);
    if (rowscale != nullptr) acc = __fmul_rn(acc, rowscale[r]);
    if (colscale != nullptr) acc = __fmul_rn(acc, colscale[c]);
    out[e] = __float2bfloat16_rn(acc);
  }
}

template <typename T>
cudaError_t reduce_partials(const T* part, int splits, int ld_rows, const float* rowscale,
                            const float* colscale, __nv_bfloat16* out, int m, int n,
                            cudaStream_t stream) {
  const long long total = static_cast<long long>(m) * n;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  reduce_partials_kernel<T><<<blocks, threads, 0, stream>>>(part, splits, ld_rows, rowscale,
                                                            colscale, out, m, n);
  return cudaGetLastError();
}

}  // namespace
}  // namespace q4
