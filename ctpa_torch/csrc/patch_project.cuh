// The LayerNorm-folded patch projection that K1 (patchify.cu) and K9
// (resample_patchify.cu) share: a block's patches times the projection on
// the tensor cores, with per-patch LayerNorm statistics gathered while the
// patches are staged.  The two kernels differ only in how a chunk of patch
// features reaches shared memory (their `Stage`) and in the variance's clamp.
//
// A block owns up to kSlabs (pt, p1, W) row slabs (hi, hi+1) of one temporal
// row ti, i.e. up to kM = kSlabs * 24 patches (three 16-row tiles), and
// kBN = 128 output columns.  Features are ordered (pt, p1, p2): slab row
// r = i_pt * p1 + i_p1 holds features [r * p2, (r + 1) * p2) of each patch.
// Chunks of whole slab rows (kKC = 80 features at p2 = 20) are staged as
// bf16 (patch, feature) tiles next to the matching rows of the bf16
// projection kmat (served from L2: 4 MB does not fit in shared memory) and
// multiplied on WMMA 16x16x16 bf16 tiles with fp32 accumulators.  The
// epilogue writes
//
//   out[p, n] = rsig[p] * acc[p, n] - mu[p] * rsig[p] * v2[n]
//
// in bf16, pre-bias and pre-norm_out, with mu and rsig from the fp32 sums of
// x and x^2 over each patch's features.  The stage leaves one partial sum
// per (patch, slab row) of the chunk in shared memory, and one thread per
// patch adds them in row order, chunk after chunk: the sums, and so the
// output, are the same bits on every run (float atomics would add them in
// the order the threads arrive).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace patch_project {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlabs = 2;                 // slab rows (hi, hi+1) per block
constexpr int kM = 48;                    // patch rows per block: 3 tiles of 16
constexpr int kBN = kWarps * 16;          // output columns per block, 16 per warp
constexpr int kKC = 80;                   // features per chunk (a multiple of 16)
constexpr int kMaxP2 = 32;                // longest patch run a thread handles at once
constexpr int kChunkRows = 16;            // most slab rows in one chunk (p2 < 5 only)
constexpr int kLdA = kKC + 8;             // bf16 row strides of the smem tiles
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;             // fp32

// one shared buffer, used in turn for the A/B chunks and the fp32 output tile
constexpr int kTileBytes = (kM * kLdA + kKC * kLdB) * 2;
constexpr int kOutBytes = kM * kLdC * 4;
constexpr int kSmemBytes = kTileBytes > kOutBytes ? kTileBytes : kOutBytes;

// slab rows per chunk
__host__ __device__ inline int chunk_rows(int p2) {
  return kKC / p2 < kChunkRows ? kKC / p2 : kChunkRows;
}

// This block's place in the grid (dim / kBN, ceil(h / kSlabs), t).
struct Tile {
  int ti, h0, n0, slabs;   // temporal row, first slab, first output column, slabs owned
  int h, w, rows, p2;      // patch grid, slab rows (pt * p1) and patch run
};

__device__ __forceinline__ Tile tile_of(int h, int w, int rows, int p2) {
  const int h0 = blockIdx.y * kSlabs;
  return Tile{static_cast<int>(blockIdx.z), h0, static_cast<int>(blockIdx.x) * kBN,
              min(kSlabs, h - h0), h, w, rows, p2};
}

inline dim3 grid_of(int t, int h, int dim) {
  return dim3(dim / kBN, (h + kSlabs - 1) / kSlabs, t);
}

// Run the block.  `stage(r0, nr, a_s, part_s)` is called by every thread
// for each chunk of slab rows [r0, r0 + nr): it writes patch m's features
// (r0 + rr) * p2 + c at a_s[m * kLdA + rr * p2 + c] for m < slabs * w, and
// patch m's sums of x and x^2 over the row's p2 features at
// part_s[rr * kM + m]; it may call __syncthreads.  `smem` holds
// kSmemBytes, aligned to 128 bytes.  kClampVariance clamps m2 - mu^2 at 0
// before the rsqrt.
template <bool kClampVariance, class Stage>
__device__ __forceinline__ void project(const Tile& tile, Stage&& stage, unsigned char* smem,
                                        const __nv_bfloat16* __restrict__ kmat,
                                        const float* __restrict__ v2,
                                        __nv_bfloat16* __restrict__ out, int dim, float eps) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int w = tile.w, p2 = tile.p2, rows = tile.rows;
  const int pd = rows * p2;

  __shared__ float sum_s[kM];   // per-patch sums of x and x^2 over the features
  __shared__ float sq_s[kM];
  __shared__ float2 part_s[kChunkRows * kM];   // the chunk's per-(row, patch) sums
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kM][kLdA]
  __nv_bfloat16* b_s = a_s + kM * kLdA;                         // [kKC][kLdB]
  float* c_s = reinterpret_cast<float*>(smem);                  // [kM][kLdC]

  // patch rows past slabs * w stay zero for the whole loop
  for (int e = tid; e < kM * kLdA; e += kThreads) a_s[e] = __float2bfloat16(0.f);
  for (int e = tid; e < kM; e += kThreads) {
    sum_s[e] = 0.f;
    sq_s[e] = 0.f;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kM / 16];
#pragma unroll
  for (int i = 0; i < kM / 16; ++i) wmma::fill_fragment(acc[i], 0.f);

  const int rows_per_chunk = chunk_rows(p2);
  for (int r0 = 0; r0 < rows; r0 += rows_per_chunk) {
    const int nr = min(rows_per_chunk, rows - r0);
    const int kc = nr * p2;
    const int kc16 = (kc + 15) / 16 * 16;
    stage(r0, nr, a_s, part_s);
    // B chunk: kmat rows [r0 * p2, r0 * p2 + kc), columns [n0, n0 + kBN), 8 at a time
    for (int e = tid; e < kc * (kBN / 8); e += kThreads) {
      const int kk = e / (kBN / 8);
      const int nn = (e - kk * (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(&b_s[kk * kLdB + nn]) = *reinterpret_cast<const uint4*>(
          &kmat[(long long)(r0 * p2 + kk) * dim + tile.n0 + nn]);
    }
    // a ragged last chunk: zero the features up to the next multiple of 16
    for (int e = tid; e < (kc16 - kc) * kM; e += kThreads) {
      const int m = e / (kc16 - kc);
      a_s[m * kLdA + kc + (e - m * (kc16 - kc))] = __float2bfloat16(0.f);
    }
    for (int e = tid; e < (kc16 - kc) * kBN; e += kThreads) {
      b_s[(kc + e / kBN) * kLdB + e % kBN] = __float2bfloat16(0.f);
    }
    __syncthreads();
    // thread m < slabs * w adds patch m's partial sums in row order
    // (part_s is rewritten only after the barrier below)
    if (tid < tile.slabs * w) {
      float sum = 0.f, sq = 0.f;
      for (int rr = 0; rr < nr; ++rr) {
        const float2 part = part_s[rr * kM + tid];
        sum += part.x;
        sq += part.y;
      }
      sum_s[tid] += sum;
      sq_s[tid] += sq;
    }
    for (int k0 = 0; k0 < kc16; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, b_s + k0 * kLdB + warp * 16, kLdB);
#pragma unroll
      for (int i = 0; i < kM / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, a_s + i * 16 * kLdA + k0, kLdA);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
    __syncthreads();
  }

  // epilogue through shared memory: fold the LayerNorm and store bf16
#pragma unroll
  for (int i = 0; i < kM / 16; ++i)
    wmma::store_matrix_sync(c_s + i * 16 * kLdC + warp * 16, acc[i], kLdC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < tile.slabs * w * kBN; e += kThreads) {
    const int m = e / kBN;
    const int nn = e - m * kBN;
    const int s = m / w;
    const int wi = m - s * w;
    const float mu = sum_s[m] / pd;
    float var = sq_s[m] / pd - mu * mu;
    if (kClampVariance) var = fmaxf(var, 0.f);
    const float rs = rsqrtf(var + eps);
    const float val = rs * c_s[m * kLdC + nn] - mu * rs * v2[tile.n0 + nn];
    out[(((long long)tile.ti * tile.h + tile.h0 + s) * w + wi) * dim + tile.n0 + nn] =
        __float2bfloat16(val);
  }
}

}  // namespace patch_project
