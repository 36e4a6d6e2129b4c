// int4 projection: y = x @ W with W stored as packed int4 and fp32 scales per
// (input group, output column).
//
// Replaces the TPU kernels ctpa/ops/quant.py:int4_matmul, `_q4_kernel`
// (weight-only, "w4") and `_q4_kernel_a8` (int8 activations, "w4a8").  x is
// (m, k), the weight (k/2, n) bytes in ctpa's quantize_int4 layout (byte j
// of scale group g holds row g G + j in its low nibble and row g G + G/2 + j
// in its high nibble, signed in [-7, 7]) with scale (k/G, n) fp32, G the
// scale group (32, 64 or 128).
//
//   w4:   w = bf16(q * scale[g, col]) in fp32 then rounded to bf16 (ctpa
//         rounds the dequantized tile to the activation dtype), y = x . w
//         with fp32 sums, out in bf16; no scale at the flush.
//   w4a8: x8, sx per row from ctpa's quantize_act_int8 (ctpa computes it
//         outside its Pallas kernel; here one launch of its own before the
//         projection); per scale group one exact
//         int8 x int8 -> int32 dot, times the group's fp32 scale row, summed
//         over the groups in fp32; the sum times sx[row] at the flush.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16, 1,979 TOPS int8) at
// Meditron-7B (k 4096; n 12288 for the fused qkv_proj, 4096 for o_proj,
// 32000 for lm_head): a decode step (m = 4 to 32 rows) is bound by the
// bytes of the weights: qkv_proj reads 25.2 MB of packed weights and 1.6 MB
// of scales, 8.0 us; o_proj 2.7 us; lm_head 20.8 us.  Prefill (m = 2,048
// rows for 4 x 512 tokens) is bound by the operations: qkv_proj is 206 GFLOP,
// 0.21 ms in bf16 and 0.10 ms in int8; o_proj 69 GFLOP, 0.069 ms and 0.035
// ms.
//
// Two kernels; ops/quant.py:int4_matmul_plan picks one by m.
//
// Decode (m <= 32), `int4_matmul_stream_kernel`: weight streaming on
// mma.sync.  A block owns 128 output columns (128 contiguous bytes of every
// packed row, 32 columns a warp) and walks its share of the scale groups;
// the contraction is split across blocks until they fill what the card
// holds at once (ops/quant.py asks the kernel's occupancy), at least four
// groups a split.  Each group's packed rows, its scale row and x's rows
// over the group arrive by 16-byte cp.async into a ring of four stages, so
// three groups (about 30 KB at m = 4) are in flight while one is
// multiplied, with one barrier a group.  w4 runs 8 warps, two sets of 4
// that take alternate k-steps of each group (their fp32 sums added in that
// order at the end): its dequantization is the longest part of a k-step.  The weights are the A operand (16 output columns x k,
// the tokens the 8-wide N side, so m = 4 wastes half an N tile), and a lane
// builds its A registers from 4-byte reads of the packed rows, never a
// dequantized tile in shared memory (stream_common.cuh, shared with K7):
//   w4:   m16n8k16 bf16.  A byte holds rows j and j + G/2 of one column, so
//         the kernel takes that pair as the two k of one bf16 register and
//         reads x in the same order (a permutation of k inside a group
//         leaves every group dot the same; it changes only w4's fp32 sum
//         order).  Each nibble becomes q exactly as (2^23 + q + 8) - (2^23 +
//         8), is multiplied by the column's scale in fp32 and rounded to
//         bf16, as ctpa rounds its dequantized tile.
//   w4a8: m16n8k32 s8.  Four int8 k of a register are (j, j + 1, j + G/2,
//         j + 1 + G/2) of one column, built from two packed rows by byte
//         permutes with each nibble as 16 q in its byte's high half; the
//         int32 group dot (16 times the exact one) times a sixteenth of the
//         group's scale, in registers, is the exact dot times the scale,
//         rounded once; the groups are summed in order.
// With a split contraction each block writes its fp32 sums to a work
// buffer; the last block of a column strip to finish (a per-strip counter,
// which that block resets) adds the splits in split order and writes out:
// one launch, no float atomics, the same bits on every call.  w4a8's x is
// quantized first by `quantize_act_int8_kernel`, one launch with
// quantize_act_int8's bits.
//
// Prefill (m > 32), `prefill_wgmma::proj_kernel` (prefill_wgmma.cuh, the
// design of K6's and K7's prefill kernels for one matrix): a block of three
// warpgroups owns 256 output columns and 128 tokens (w4) or 64 (w4a8, whose
// group dots and fp32 sums both live in registers); a producer warpgroup
// keeps a TMA ring of 128-row stages full (the packed rows, the scale rows,
// x's tile), and two consumer warpgroups build wgmma's A registers from the
// raw packed bytes: w4 bf16 m64nNk16 on each nibble times its scale rounded
// to bf16, the low nibbles against x's first G/2 columns of a group and the
// high ones against the next G/2, in natural order; w4a8 s8 m64nNk32 on the
// nibbles held as 16 q, each group's exact dot times a sixteenth of its
// scale in registers, summed in group order, times sx at the end.  Where
// the token tiles and strips are fewer than the card runs at once (m
// 33-128), the contraction splits across a thread-block cluster, added in
// split order through distributed shared memory: one launch, no reduction
// kernel.  Weight rows of n % 16 != 0 bytes (and then the scale rows) are
// copied by the producer's plain loads into the TMA layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "prefill_wgmma.cuh"
#include "stream_common.cuh"
#include "warp_mma.cuh"

namespace {

// ------------------------------------------------------------ decode: streaming

constexpr int kSWarps = 4;
constexpr int kSThreads = 32 * kSWarps;
constexpr int kSBN = 32 * kSWarps;   // output columns of a block: 128 bytes of each packed row
constexpr int kStages = 4;           // ring depth, one scale group a stage
// w4 splits each group's k-steps between two sets of 4 warps (8 warps a
// block): its dequantization is the longest part of a k-step, and the
// second set doubles the warps that hide its latency; w4a8 keeps 4 warps
// (its exact int32 group dot would need the halves' sums before scaling)
constexpr int kW4Halves = 2;

// One ring stage: the group's G/2 packed rows of the block's 128 columns,
// their 128 scales, and x's NT * 8 rows (rows >= m zero) over the group's G
// columns.  The row strides spread a warp's reads over the 32 banks: a w4
// k-step reads packed rows 8s + t (t = lane % 4), an a8 one rows 16s + 2t,
// 32 bytes each, and a token step reads 8 rows of x at 8 (w4) or 4 bytes a
// row apart.
template <int G, int NT, bool A8>
struct StreamSmem {
  static constexpr int kLdW = kSBN + (A8 ? 16 : 32);
  static constexpr int kXBytes = A8 ? 1 : 2;
  static constexpr int kLdX = G * kXBytes + 16;
  static constexpr int kW = G / 2 * kLdW;
  static constexpr int kS = kSBN * 4;
  static constexpr int kStage = kW + kS + NT * 8 * kLdX;
  static constexpr int kBytes = kStages * kStage;
  static_assert(kW % 16 == 0 && kStage % 16 == 0, "16-byte aligned copies");
};

extern __shared__ __align__(16) unsigned char smem_stream[];

// grid (ceil(n / kSBN), splits); block kSThreads; dynamic shared memory
// StreamSmem::kBytes.  Block (x, z) owns columns [128 x, 128 x + 128) and
// scale groups [z per, min(k / G, (z + 1) per)).  Warp w owns 32 columns;
// lane (g, t) = (lane / 4, lane % 4) reads 4 bytes of a packed row at
// columns 32 w + 4 g .. + 3, and the A rows of its two 16-column mma tiles
// i are those columns: row g of tile i is column 4g + 2i, row g + 8 column
// 4g + 2i + 1.  The k order inside a group is permuted, for W and x alike:
// w4 takes k-pair (j, j + G/2), one byte, as the two k of a bf16 register;
// a8 takes (j, j + 1, j + G/2, j + 1 + G/2) for even j.  With splits > 1
// each block writes its fp32 sums to work (splits, m, n) and the last block
// of a column strip (a per-strip counter, reset by that block) adds the
// splits in order and writes out.
template <int G, int NT, bool A8, int KH>
__global__ void __launch_bounds__(kSThreads * KH)
int4_matmul_stream_kernel(const void* __restrict__ xv, const float* __restrict__ sx,
                          const int8_t* __restrict__ w4, const float* __restrict__ scale,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ work,
                          unsigned int* __restrict__ counters, int m, int k, int n, int per) {
  using Smem = StreamSmem<G, NT, A8>;
  static_assert(KH == 1 || (KH == 2 && !A8), "w4 alone splits a group's k-steps");
  constexpr int kThreads = kSThreads * KH;
  const int tid = threadIdx.x;
  const int warp = (tid >> 5) & (kSWarps - 1);   // the warp's 32 columns
  const int kh = tid >> 7;                       // its half of each group's k-steps
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n0 = blockIdx.x * kSBN;
  const int splits = gridDim.y;
  const int g0 = blockIdx.y * per;
  const int cnt = min(k / G, g0 + per) - g0;
  const bool vec = n % 16 == 0;
  const unsigned char* xb = static_cast<const unsigned char*>(xv);

  // the copies of scale group grp into ring slot `slot`
  auto fetch = [&](int slot, int grp) {
    unsigned char* st = smem_stream + slot * Smem::kStage;
    const int8_t* wsrc = w4 + static_cast<long long>(grp) * (G / 2) * n + n0;
    const float* ssrc = scale + static_cast<long long>(grp) * n + n0;
    float* s_dst = reinterpret_cast<float*>(st + Smem::kW);
    if (vec) {
      for (int e = tid; e < G / 2 * (kSBN / 16); e += kThreads) {
        const int r = e / (kSBN / 16);
        const int c = (e - r * (kSBN / 16)) * 16;
        const bool ok = n0 + c < n;
        warp_mma::cp_async16(st + r * Smem::kLdW + c, ok ? wsrc + static_cast<long long>(r) * n + c
                                                         : wsrc, ok ? 16 : 0);
      }
      if (tid < kSBN / 4) {
        const bool ok = n0 + 4 * tid < n;
        warp_mma::cp_async16(s_dst + 4 * tid, ok ? ssrc + 4 * tid : ssrc, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < G / 2 * kSBN; e += kThreads) {
        const int r = e / kSBN;
        const int c = e - r * kSBN;
        st[r * Smem::kLdW + c] =
            n0 + c < n ? static_cast<unsigned char>(wsrc[static_cast<long long>(r) * n + c]) : 0;
      }
      for (int c = tid; c < kSBN; c += kThreads) s_dst[c] = n0 + c < n ? ssrc[c] : 0.f;
    }
    constexpr int kChunks = G * Smem::kXBytes / 16;
    const unsigned char* xsrc = xb + static_cast<long long>(grp) * G * Smem::kXBytes;
    for (int e = tid; e < NT * 8 * kChunks; e += kThreads) {
      const int r = e / kChunks;
      const int c = (e - r * kChunks) * 16;
      const bool ok = r < m;
      warp_mma::cp_async16(st + Smem::kW + Smem::kS + r * Smem::kLdX + c,
                           ok ? xsrc + static_cast<long long>(r) * k * Smem::kXBytes + c : xsrc,
                           ok ? 16 : 0);
    }
  };

  // acc[i][nt]: tile i (columns 4g + 2i, 4g + 2i + 1), tokens 8 nt + 2t, + 1
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < cnt) fetch(s, g0 + s);
    warp_mma::cp_async_commit();
  }
  for (int it = 0; it < cnt; ++it) {
    warp_mma::cp_async_wait<kStages - 2>();   // group g0 + it is in
    __syncthreads();                          // and every warp is done with slot it - 1
    if (it + kStages - 1 < cnt) fetch((it + kStages - 1) % kStages, g0 + it + kStages - 1);
    warp_mma::cp_async_commit();

    const unsigned char* st = smem_stream + (it % kStages) * Smem::kStage;
    const unsigned char* wl = st + 32 * warp + 4 * g;
    const float4 sc4 = *reinterpret_cast<const float4*>(st + Smem::kW + (32 * warp + 4 * g) * 4);
    const float sc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
    wstream::int4_group_products<G, NT, A8, KH, Smem::kLdW, Smem::kLdX>(
        acc, wl, sc, st + Smem::kW + Smem::kS + g * Smem::kLdX, t, kh);
  }

  // w4 with KH = 2: the second half's sums through shared memory, added to
  // the first half's in that order
  if constexpr (KH == 2) {
    __syncthreads();   // every warp is done with the ring
    float* other = reinterpret_cast<float*>(smem_stream) + (warp * 32 + lane) * (8 * NT);
    if (kh == 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) other[(i * NT + j) * 4 + e] = acc[i][j][e];
    }
    __syncthreads();
    if (kh == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += other[(i * NT + j) * 4 + e];
    }
  }

  // this lane's outputs: column 4g + c (c = 2i + e / 2) of the warp's 32,
  // token 8 nt + 2t + e % 2 (the first half's warps write them)
  const int col0 = n0 + 32 * warp + 4 * g;
  const bool vec4 = n % 4 == 0;
  if (splits == 1) {
    if (kh != 0) return;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tok = 8 * j + 2 * t + h;
        if (tok >= m || col0 >= n) continue;
        const float mul = A8 ? sx[tok] : 1.f;
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = acc[c >> 1][j][2 * (c & 1) + h];
        if (A8) {
#pragma unroll
          for (int c = 0; c < 4; ++c) v[c] = __fmul_rn(v[c], mul);
        }
        __nv_bfloat16* o = out + static_cast<long long>(tok) * n + col0;
        if (vec4) {
          *reinterpret_cast<uint2*>(o) =
              make_uint2(warp_mma::pack_bf16(v[0], v[1]), warp_mma::pack_bf16(v[2], v[3]));
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (col0 + c < n) o[c] = __float2bfloat16_rn(v[c]);
        }
      }
    return;
  }

  float* part = work + static_cast<long long>(blockIdx.y) * m * n;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = 8 * j + 2 * t + h;
      if (kh != 0 || tok >= m || col0 >= n) continue;
      float* p = part + static_cast<long long>(tok) * n + col0;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col0 + c < n) p[c] = acc[c >> 1][j][2 * (c & 1) + h];
    }
  // the last block of the strip to finish adds the splits in order
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + blockIdx.x, 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = tid; e < m * kSBN; e += kThreads) {
    const int tok = e / kSBN;
    const int col = n0 + e - tok * kSBN;
    if (col >= n) continue;
    float sum = 0.f;
    for (int z = 0; z < splits; ++z)
      sum += __ldcg(work + (static_cast<long long>(z) * m + tok) * n + col);
    if (A8) sum = __fmul_rn(sum, sx[tok]);
    out[static_cast<long long>(tok) * n + col] = __float2bfloat16_rn(sum);
  }
  if (tid == 0) counters[blockIdx.x] = 0u;
}

template <int G, int NT, bool A8, int KH>
cudaError_t launch_stream(const void* x, const float* sx, const int8_t* w4, const float* scale,
                          __nv_bfloat16* out, float* work, unsigned int* counters, int m, int k,
                          int n, int per, int splits, cudaStream_t stream) {
  auto kernel = int4_matmul_stream_kernel<G, NT, A8, KH>;
  constexpr int smem = StreamSmem<G, NT, A8>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kSBN - 1) / kSBN, splits);
  kernel<<<grid, kSThreads * KH, smem, stream>>>(x, sx, w4, scale, out, work, counters, m, k, n,
                                                 per);
  return cudaGetLastError();
}

template <int G, int NT, bool A8, int KH>
int stream_residency() {
  auto kernel = int4_matmul_stream_kernel<G, NT, A8, KH>;
  constexpr int smem = StreamSmem<G, NT, A8>::kBytes;
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kSThreads * KH, smem) !=
          cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return blocks;
}

template <int G, bool A8, int KH>
int rows_residency(int m) {
  return m <= 8 ? stream_residency<G, 1, A8, KH>()
       : m <= 16 ? stream_residency<G, 2, A8, KH>() : stream_residency<G, 4, A8, KH>();
}

template <int G, bool A8, int KH>
cudaError_t stream_rows(const void* x, const float* sx, const int8_t* w4, const float* scale,
                        __nv_bfloat16* out, float* work, unsigned int* counters, int m, int k,
                        int n, int per, int splits, cudaStream_t stream) {
  if (m <= 8)
    return launch_stream<G, 1, A8, KH>(x, sx, w4, scale, out, work, counters, m, k, n, per,
                                       splits, stream);
  if (m <= 16)
    return launch_stream<G, 2, A8, KH>(x, sx, w4, scale, out, work, counters, m, k, n, per,
                                       splits, stream);
  return launch_stream<G, 4, A8, KH>(x, sx, w4, scale, out, work, counters, m, k, n, per, splits,
                                     stream);
}

template <bool A8, int KH>
cudaError_t stream_groups(const void* x, const float* sx, const int8_t* w4, const float* scale,
                          __nv_bfloat16* out, float* work, unsigned int* counters, int m, int k,
                          int n, int group, int per, int splits, cudaStream_t stream) {
  switch (group) {
    case 32:
      return stream_rows<32, A8, KH>(x, sx, w4, scale, out, work, counters, m, k, n, per, splits,
                                     stream);
    case 64:
      return stream_rows<64, A8, KH>(x, sx, w4, scale, out, work, counters, m, k, n, per, splits,
                                     stream);
    default:
      return stream_rows<128, A8, KH>(x, sx, w4, scale, out, work, counters, m, k, n, per, splits,
                                      stream);
  }
}

// ------------------------------------------------------------ w4a8: x to int8

constexpr int kQThreads = 256;

// One block a row: amax of |x|, sx = max(amax * (1/127), 1e-12), x8 =
// clamp(rint(x / sx), -127, 127), as quantize_act_int8 computes them on the
// card (PyTorch divides by a Python scalar as a product with its fp32
// reciprocal, and by a tensor exactly).  With `vec` (k % 8 == 0, x 16-byte
// aligned) 16-byte loads, else one element a load.
__device__ __forceinline__ int8_t act_q8(float f, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(__fdiv_rn(f, s)), -127.f), 127.f));
}

__global__ void __launch_bounds__(kQThreads)
quantize_act_int8_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ x8,
                         float* __restrict__ sx, int k, int vec) {
  __shared__ float red[kQThreads / 32];
  const __nv_bfloat16* xr = x + static_cast<long long>(blockIdx.x) * k;
  float amax = 0.f;
  if (vec) {
    for (int c = threadIdx.x * 8; c < k; c += kQThreads * 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        amax = fmaxf(amax, fmaxf(fabsf(__uint_as_float(w[i] << 16)),
                                 fabsf(__uint_as_float(w[i] & 0xffff0000u))));
    }
  } else {
    for (int c = threadIdx.x; c < k; c += kQThreads) amax = fmaxf(amax, fabsf(__bfloat162float(xr[c])));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int i = 1; i < kQThreads / 32; ++i) amax = fmaxf(amax, red[i]);
  const float s = fmaxf(__fmul_rn(amax, 1.0f / 127.0f), 1e-12f);
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
  int8_t* qr = x8 + static_cast<long long>(blockIdx.x) * k;
  if (!vec) {
    for (int c = threadIdx.x; c < k; c += kQThreads) qr[c] = act_q8(__bfloat162float(xr[c]), s);
    return;
  }
  for (int c = threadIdx.x * 8; c < k; c += kQThreads * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t q[2] = {0u, 0u};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
      q[i / 4] |= (static_cast<uint32_t>(act_q8(f, s)) & 0xFFu) << (8 * (i % 4));
    }
    *reinterpret_cast<uint2*>(qr + c) = make_uint2(q[0], q[1]);
  }
}

// ------------------------------------------------------------ prefill

template <bool A8, int G>
cudaError_t prefill_group(const prefill_wgmma::ProjArgs& base, int splits, cudaStream_t s) {
  using F = prefill_wgmma::ProjForm<true, A8, G>;
  prefill_wgmma::ProjArgs a = base;
  a.tiles = (a.m + F::BN - 1) / F::BN;
  return prefill_wgmma::launch_proj<F>(a, splits, s);
}

template <bool A8>
int prefill_clusters(int group, int splits) {
  return group == 32   ? prefill_wgmma::proj_clusters<prefill_wgmma::ProjForm<true, A8, 32>>(splits)
       : group == 64   ? prefill_wgmma::proj_clusters<prefill_wgmma::ProjForm<true, A8, 64>>(splits)
                       : prefill_wgmma::proj_clusters<prefill_wgmma::ProjForm<true, A8, 128>>(splits);
}

}  // namespace

// The decode kernel (m <= 32): launches on `stream` and returns the CUDA
// error of the launch (0 when it was accepted).  x is bf16 (w4) or int8
// with sx (w4a8), (m, k) row-major, 16-byte aligned; w4 (k/2, n) int8 and
// scale (k/group, n) fp32, 16-byte aligned; out (m, n) bf16.  With splits >
// 1: work (splits, m, n) fp32 and counters, one unsigned int per column
// strip of 128 (ceil(n / 128)), zero on entry and left zero; the calls
// sharing a counter buffer run one after another (one stream).
extern "C" int int4_matmul_stream_launch(const void* x, const void* sx, const void* w4,
                                         const void* scale, void* out, void* work, void* counters,
                                         int m, int k, int n, int group, int per, int splits,
                                         int act_quant, void* stream) {
  if (group != 32 && group != 64 && group != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0 || m > 32 || n <= 0 || k % group != 0 || per <= 0 || splits < 1 ||
      (splits - 1) * per >= k / group || (splits > 1 && (work == nullptr || counters == nullptr)) ||
      (act_quant && sx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* w = static_cast<const int8_t*>(w4);
  const float* sc = static_cast<const float*>(scale);
  const float* rows = static_cast<const float*>(sx);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  float* part = splits > 1 ? static_cast<float*>(work) : nullptr;
  unsigned int* cnt = static_cast<unsigned int*>(counters);
  const cudaError_t err =
      act_quant ? stream_groups<true, 1>(x, rows, w, sc, o, part, cnt, m, k, n, group, per,
                                         splits, s)
                : stream_groups<false, kW4Halves>(x, rows, w, sc, o, part, cnt, m, k, n, group,
                                                  per, splits, s);
  return static_cast<int>(err);
}

// The decode kernel's resident blocks per SM for m rows, a scale group and
// w4 or w4a8 (the card's occupancy for its registers, threads and shared
// memory), or -1 on a CUDA error.
extern "C" int int4_matmul_stream_residency(int m, int group, int act_quant) {
  if (m <= 0 || m > 32) return -1;
  switch (group) {
    case 32:
      return act_quant ? rows_residency<32, true, 1>(m) : rows_residency<32, false, kW4Halves>(m);
    case 64:
      return act_quant ? rows_residency<64, true, 1>(m) : rows_residency<64, false, kW4Halves>(m);
    case 128:
      return act_quant ? rows_residency<128, true, 1>(m)
                       : rows_residency<128, false, kW4Halves>(m);
    default:
      return -1;
  }
}

// The int8 activations of w4a8 and w8a8 (K5, K7, K4, K6): x (m, k) bf16 ->
// x8 (m, k) int8 and sx (m,) fp32, one launch; rows contiguous.
extern "C" int int4_act_quant_launch(const void* x, void* x8, void* sx, int m, int k,
                                     void* stream) {
  if (m <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x8) % 8 == 0;
  quantize_act_int8_kernel<<<m, kQThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(x8), static_cast<float*>(sx), k,
      vec);
  return static_cast<int>(cudaGetLastError());
}

// The prefill kernel (prefill_wgmma.cuh): one launch on `stream` in
// clusters of its splits; returns the CUDA error of the launch (0 when it
// was accepted).  x is bf16 (w4) or int8 with sx (w4a8), (m, k); w4 (k/2,
// n) int8; scale (k/group, n) fp32; out (m, n) bf16.  The splits cut the
// ceil(k / 128) chunks of 128 contraction rows per at a time, at most 8.
// Every buffer contiguous and 16-byte aligned.
extern "C" int int4_matmul_prefill_launch(const void* x, const void* sx, const void* w4,
                                          const void* scale, void* out, int m, int k, int n,
                                          int group, int per, int splits, int act_quant,
                                          void* stream) {
  if (group != 32 && group != 64 && group != 128) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (k + prefill_wgmma::kProjKC - 1) / prefill_wgmma::kProjKC;
  if (m <= 0 || n <= 0 || k <= 0 || k % group != 0 || per <= 0 || splits < 1 ||
      splits > wstream::kMaxSplits || (splits - 1) * per >= chunks || splits * per < chunks ||
      (act_quant && sx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const prefill_wgmma::ProjArgs a{x, static_cast<const float*>(sx), static_cast<const int8_t*>(w4),
                                  static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
                                  m, k, n, 0, per, 0, n % 16 != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (act_quant)
    err = group == 32 ? prefill_group<true, 32>(a, splits, s)
        : group == 64 ? prefill_group<true, 64>(a, splits, s) : prefill_group<true, 128>(a, splits, s);
  else
    err = group == 32 ? prefill_group<false, 32>(a, splits, s)
        : group == 64 ? prefill_group<false, 64>(a, splits, s)
                      : prefill_group<false, 128>(a, splits, s);
  return static_cast<int>(err);
}

// How many clusters of `splits` blocks (1 to 8) of the prefill kernel for a
// scale group, w4 or w4a8, the card runs at once, or -1 on a CUDA error.
extern "C" int int4_matmul_prefill_clusters(int group, int act_quant, int splits) {
  if ((group != 32 && group != 64 && group != 128) || splits < 1 || splits > wstream::kMaxSplits)
    return -1;
  return act_quant ? prefill_clusters<true>(group, splits) : prefill_clusters<false>(group, splits);
}
