// The shared-memory tiles of the bf16 flash kernels on mma.sync: the
// forward (flash_attention.cu) and the backward (flash_attention_bwd.cu).
//
// A block of 4 warps stages tiles of 64 rows of a (rows, D) bf16 matrix and
// 64 x 64 tiles of a bias into shared memory.  Every staged row is padded by
// 8 elements, so ldmatrix's eight row addresses fall on distinct banks.
// Where the source is 16-byte aligned the rows arrive by cp.async (the
// caller commits and waits); elsewhere (a bias whose rows are not a
// multiple of 8 keys, a tensor at an odd offset) by element copies into the
// same layout.  Rows or columns past the matrix's edge are zero.

#pragma once

#include <cuda_bf16.h>

#include "warp_mma.cuh"

namespace flash_tiles {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;   // rows of a tile, 16 a warp; keys of a key tile
constexpr int kPad = 8;              // bf16 padding of every staged row
constexpr int kLdBias = kTile + kPad;

// Rows [0, kTile) of a (., D) bf16 matrix at src into dst (row stride
// D + kPad); rows >= `rows` are zero.  With `vec` by 16-byte cp.async.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int rows, bool vec) {
  constexpr int kLd = D + kPad;
  if (vec) {
    constexpr int kChunks = D / 8;
    for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * 8;
      const bool ok = r < rows;
      warp_mma::cp_async16(dst + r * kLd + c, ok ? src + (long long)r * D + c : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int r = e / D;
      const int c = e - r * D;
      dst[r * kLd + c] = r < rows ? src[(long long)r * D + c] : __float2bfloat16(0.f);
    }
  }
}

// The (kTile, kTile) bias tile at src (row stride m) into dst (row stride
// kLdBias); cells past `rows` or `cols` are zero.  `vec` needs m % 8 == 0
// (so cols is a multiple of 8 too) and a 16-byte aligned src.
__device__ __forceinline__ void stage_bias(bf16* dst, const bf16* src, int rows, int cols, int m,
                                           bool vec) {
  if (vec) {
    constexpr int kChunks = kTile / 8;
    for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * 8;
      const bool ok = r < rows && c < cols;
      warp_mma::cp_async16(dst + r * kLdBias + c, ok ? src + (long long)r * m + c : src,
                           ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile;
      const int c = e - r * kTile;
      dst[r * kLdBias + c] =
          r < rows && c < cols ? src[(long long)r * m + c] : __float2bfloat16(0.f);
    }
  }
}

// kv_mask: the first key tile at or after j0 that holds a real key, or
// m_end; block-uniform (every thread must call it).
__device__ __forceinline__ int next_live_tile(int j0, int m_end, int m,
                                              const unsigned char* kvg) {
  for (; j0 < m_end; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (__syncthreads_or(threadIdx.x < kTile && j < m && kvg[j])) break;
  }
  return j0;
}

}  // namespace flash_tiles
