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
// memory round trip, not p2, and leaves the run's sums as a (patch, row)
// partial that the projection adds in a fixed order.  The variance is m2 - mu^2 in fp32, clamped at
// 0 before rsqrt.  The block's projection and epilogue are patch_project.cuh,
// which K9 (resample_patchify.cu) shares; this file stages the patches.

#include "patch_project.cuh"

namespace {

using namespace patch_project;

// grid grid_of(t, h, dim); block kThreads.
__global__ void __launch_bounds__(kThreads)
patchify_project_kernel(const __nv_bfloat16* __restrict__ vol, const float* __restrict__ g,
                        const __nv_bfloat16* __restrict__ kmat, const float* __restrict__ v2,
                        __nv_bfloat16* __restrict__ out, int H, int W, int pt, int p1, int p2,
                        int dim, float eps) {
  const Tile tile = tile_of(H / p1, W / p2, pt * p1, p2);
  const int w = tile.w;
  const int tid = threadIdx.x;
  __shared__ __align__(128) unsigned char smem[kSmemBytes];

  // slab s, row r is image row (ti * pt + r / p1, (h0 + s) * p1 + r % p1)
  auto row_ptr = [&](int s, int r) -> const __nv_bfloat16* {
    const long long frame = (long long)tile.ti * pt + r / p1;
    const long long y = (long long)(tile.h0 + s) * p1 + r % p1;
    return vol + (frame * H + y) * W;
  };
  // A chunk: nr whole image rows of each slab, scaled by g and rounded to
  // bf16; one task is one patch's p2-run of one row, and leaves its sums of
  // x and x^2 as the (patch, row) partial
  auto stage = [&](int r0, int nr, __nv_bfloat16* a_s, float2* part_s) {
    for (int e = tid; e < tile.slabs * w * nr; e += kThreads) {
      const int m = e % (tile.slabs * w);     // patch row in the block: s * w + wi
      const int rr = e / (tile.slabs * w);
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
      part_s[rr * kM + m] = make_float2(sum, sq);
    }
  };
  project<true>(tile, stage, smem, kmat, v2, out, dim, eps);
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
  patchify_project_kernel<<<grid_of(T / pt, H / p1, dim), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(vol), static_cast<const float*>(g),
      static_cast<const __nv_bfloat16*>(kmat), static_cast<const float*>(v2),
      static_cast<__nv_bfloat16*>(out), H, W, pt, p1, p2, dim, eps);
  return static_cast<int>(cudaGetLastError());
}
