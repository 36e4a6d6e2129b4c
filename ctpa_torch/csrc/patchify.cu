// Fused patchify + LayerNorm + projection for the CTViT patch embed.
//
// Replaces the TPU kernel ctpa/ops/pallas/patchify.py:patchify_project
// (`_kernel`, impl="chunked").  One bf16 (T, H, W) volume becomes bf16
// (t, h, w, dim) patch embeddings, pre-bias and pre-norm_out:
//
//   out[p, :] = rsig[p] * sum_f bf16(x[p, f] * g[f]) * K[f, :]  -  mu[p] * rsig[p] * v2
//
// with per-patch LayerNorm statistics mu, rsig over the pd = pt*p1*p2
// features taken in fp32, the LN scale g folded into the product, and
// v2 = g @ K (fp32, computed by the caller).  The scaled patch is rounded to
// bf16 before the product, as the reference rounds its scaled slab.
// Features are ordered (pt, p1, p2), so slab row r = i_pt * p1 + i_p1 holds
// features [r * p2, (r + 1) * p2) of every patch of that row.
//
// Bound on the H100 at the shipped shape ((240, 480, 480), pt=10, p=20,
// dim 512): 2 * 13,824 * 4,000 * 512 = 56.6 GFLOP against ~129 MB of
// traffic, so it is bound by operations: 57 us at the bf16 tensor-core rate.
//
// What the design does about it: the products run on the tensor cores
// (WMMA 16x16x16 bf16 tiles with fp32 accumulators, i.e. mma.sync; wgmma
// and TMA are later work).  The inner contiguous run of a patch is only
// p2 = 20 elements (40 bytes), so nothing gathers per patch: a block owns
// two (pt, p1, W) row slabs (hi, hi+1), 2 * 24 = 48 patches = three 16-row
// tiles, reads whole image rows, which are contiguous across W, and regroups
// them into the (patch, feature) layout in shared memory; the patch layout
// never reaches device memory.  K (4 MB) does not fit in shared memory: it
// is tiled over 128 output columns per block and over chunks of whole slab
// rows (80 features at p2 = 20), and is served from the 50 MB L2; taking two
// slabs per block halves how often K is read.  The LayerNorm statistics
// come from the same staging pass: each thread loads one patch's p2-run of
// an image row in one burst of independent loads, so a chunk costs one
// memory round trip, not p2.  The variance is m2 - mu^2 in fp32, clamped at
// 0 before rsqrt.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlabs = 2;                 // slab rows (hi, hi+1) per block
constexpr int kM = 48;                    // patch rows per block: 3 tiles of 16
constexpr int kBN = kWarps * 16;          // output columns per block, 16 per warp
constexpr int kKC = 80;                   // features per chunk (a multiple of 16)
constexpr int kMaxP2 = 32;                // longest patch run a thread loads at once
constexpr int kLdA = kKC + 8;             // bf16 row strides of the smem tiles
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;             // fp32

// one shared buffer, used in turn for the A/B chunks and the fp32 output tile
constexpr int kTileBytes = (kM * kLdA + kKC * kLdB) * 2;
constexpr int kOutBytes = kM * kLdC * 4;
constexpr int kSmemBytes = kTileBytes > kOutBytes ? kTileBytes : kOutBytes;

// grid (dim / kBN, ceil(h / kSlabs), t); block kThreads.
__global__ void __launch_bounds__(kThreads)
patchify_project_kernel(const __nv_bfloat16* __restrict__ vol, const float* __restrict__ g,
                        const __nv_bfloat16* __restrict__ kmat, const float* __restrict__ v2,
                        __nv_bfloat16* __restrict__ out, int H, int W, int pt, int p1, int p2,
                        int dim, float eps) {
  const int w = W / p2;
  const int h = H / p1;
  const int n0 = blockIdx.x * kBN;
  const int h0 = blockIdx.y * kSlabs;
  const int ti = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int rows = pt * p1;
  const int pd = rows * p2;
  const int slabs = min(kSlabs, h - h0);

  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  __shared__ float sum_s[kM];   // per-patch sums of x and x^2 over the features
  __shared__ float sq_s[kM];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kM][kLdA]
  __nv_bfloat16* b_s = a_s + kM * kLdA;                         // [kKC][kLdB]
  float* c_s = reinterpret_cast<float*>(smem);                  // [kM][kLdC]

  // slab s, row r is image row (ti * pt + r / p1, (h0 + s) * p1 + r % p1)
  auto row_ptr = [&](int s, int r) -> const __nv_bfloat16* {
    const long long frame = (long long)ti * pt + r / p1;
    const long long y = (long long)(h0 + s) * p1 + r % p1;
    return vol + (frame * H + y) * W;
  };

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

  const int rows_per_chunk = kKC / p2;
  for (int r0 = 0; r0 < rows; r0 += rows_per_chunk) {
    const int nr = min(rows_per_chunk, rows - r0);
    const int kc = nr * p2;
    const int kc16 = (kc + 15) / 16 * 16;
    // A chunk: nr whole image rows of each slab, scaled by g and rounded to
    // bf16; one task is one patch's p2-run of one row, and adds its sums of
    // x and x^2 to the patch's statistics
    for (int e = tid; e < slabs * w * nr; e += kThreads) {
      const int m = e % (slabs * w);          // patch row in the block: s * w + wi
      const int rr = e / (slabs * w);
      const int s = m / w;
      const __nv_bfloat16* src = row_ptr(s, r0 + rr) + (m - s * w) * p2;
      const float* gr = g + (r0 + rr) * p2;
      float x[kMaxP2];
#pragma unroll
      for (int c = 0; c < kMaxP2; ++c) x[c] = c < p2 ? __bfloat162float(src[c]) : 0.f;
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxP2; ++c) {
        if (c < p2) {
          sum += x[c];
          sq += x[c] * x[c];
          a_s[m * kLdA + rr * p2 + c] = __float2bfloat16(x[c] * gr[c]);
        }
      }
      atomicAdd(&sum_s[m], sum);
      atomicAdd(&sq_s[m], sq);
    }
    // B chunk: K rows [r0 * p2, r0 * p2 + kc), columns [n0, n0 + kBN), 8 at a time
    for (int e = tid; e < kc * (kBN / 8); e += kThreads) {
      const int kk = e / (kBN / 8);
      const int nn = (e - kk * (kBN / 8)) * 8;
      *reinterpret_cast<uint4*>(&b_s[kk * kLdB + nn]) =
          *reinterpret_cast<const uint4*>(&kmat[(long long)(r0 * p2 + kk) * dim + n0 + nn]);
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
  for (int e = tid; e < slabs * w * kBN; e += kThreads) {
    const int m = e / kBN;
    const int nn = e - m * kBN;
    const int s = m / w;
    const int wi = m - s * w;
    const float mu = sum_s[m] / pd;
    const float rs = rsqrtf(fmaxf(sq_s[m] / pd - mu * mu, 0.f) + eps);
    const float val = rs * c_s[m * kLdC + nn] - mu * rs * v2[n0 + nn];
    out[(((long long)ti * h + h0 + s) * w + wi) * dim + n0 + nn] = __float2bfloat16(val);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 when the launch was
// accepted).  The caller has checked: bf16 volume and K, fp32 g and v2,
// T % pt == 0, H % p1 == 0, W % p2 == 0, W / p2 <= 24, p2 <= 32,
// dim % 128 == 0, contiguous buffers.
extern "C" int patchify_project_launch(const void* vol, const void* g, const void* kmat,
                                       const void* v2, void* out, int T, int H, int W,
                                       int pt, int p1, int p2, int dim, float eps,
                                       void* stream) {
  const int h = H / p1;
  const dim3 grid(dim / kBN, (h + kSlabs - 1) / kSlabs, T / pt);
  patchify_project_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(vol), static_cast<const float*>(g),
      static_cast<const __nv_bfloat16*>(kmat), static_cast<const float*>(v2),
      static_cast<__nv_bfloat16*>(out), H, W, pt, p1, p2, dim, eps);
  return static_cast<int>(cudaGetLastError());
}
