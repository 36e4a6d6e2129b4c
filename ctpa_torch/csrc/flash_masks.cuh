// ctpa's attention masks, shared by the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu).
//
// `causal`: query row i sits at position i + q_offset (q_offset a device
// int32 scalar, 0 when null) and sees the keys up to that position.
// `kv_mask`: (b, m) bytes, nonzero = a real key.  A masked cell takes no
// part in the softmax.  A query row with no valid key gets ctpa's dense
// reference: the softmax over m equal logits (out = the mean of v over all
// m keys, lse = NEG_INF), so in the backward its weights are 1/m, its dq
// and its share of dk are zero, and every dv row gets 1/m of its dO row.

#pragma once

#include <cuda_bf16.h>

namespace flash {

constexpr float kNegInf = -1e30f;     // ctpa's NEG_INF: the lse of a row with no valid key
constexpr float kEmptyLse = -0.5e30f;  // a row whose lse is at most this had no valid key

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int query_offset(const int* q_offset) {
  return q_offset == nullptr ? 0 : *q_offset;
}

// batch item b's row of the key mask; null without one
__device__ __forceinline__ const unsigned char* key_row(const unsigned char* kv_mask, int b,
                                                        int m) {
  return kv_mask == nullptr ? nullptr : kv_mask + (long long)b * m;
}

// whether the query at position qpos sees key `key`, which is real or not
__device__ __forceinline__ bool cell_ok(bool causal, int key, int qpos, bool real) {
  return (!causal || key <= qpos) && real;
}

// causal: the query rows [row0, row0 + rows) see no key at or past this
__device__ __forceinline__ int causal_key_end(bool causal, int row0, int rows, int qoff, int m) {
  return causal ? max(0, min(m, row0 + rows + qoff)) : m;
}

// causal: the query rows before this see no key at or past col0
__device__ __forceinline__ int first_query_row(bool causal, int col0, int qoff) {
  return causal ? max(0, col0 - qoff) : 0;
}

// column d of v (m rows of D) averaged over the rows: a row with no valid key
template <typename T>
__device__ __forceinline__ float mean_over_keys(const T* v, int m, int D, int d) {
  float acc = 0.f;
  for (int j = 0; j < m; ++j) acc += to_float(v[(long long)j * D + d]);
  return acc / m;
}

// whether any of the rows i = first, first + stride, ... < n had no valid key
__device__ __forceinline__ bool some_empty_row(const float* lse, int n, int first, int stride) {
  bool empty = false;
  for (int i = first; i < n; i += stride) empty = empty || lse[i] <= kEmptyLse;
  return empty;
}

// column d of dO (n rows of D) summed over the rows with no valid key, over m:
// what each dv row gets from them
template <typename T>
__device__ __forceinline__ float empty_rows_dout_share(const float* lse, const T* dout, int n,
                                                       int m, int D, int d) {
  float e = 0.f;
  for (int i = 0; i < n; ++i) {
    if (lse[i] <= kEmptyLse) e += to_float(dout[(long long)i * D + d]);
  }
  return e / m;
}

}  // namespace flash
