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
// What the design does about it: the projection is patch_wgmma.cuh's
// (wgmma on a TMA-fed ring, the window multicast across a cluster of two
// blocks, 96 patches x 256 columns a block), which K9 (resample_patchify.cu)
// shares.  This file forms the patch rows: the image rows a k-block touches
// are in the block's row slot (whole rows of W, contiguous across the
// patches of a slab row; the patch layout never reaches device memory), and
// staging task (wi, q) takes features 8q .. 8q + 7 of the k-block for patch
// column wi of every slab row: x from the slot, its sums of x and x^2 for
// the statistics, x * g rounded to bf16 into the patch tile.  The variance
// is m2 - mu^2 in fp32, clamped at 0 before rsqrt.

#include "patch_wgmma.cuh"

namespace patch_wgmma {
namespace {  // the kernel beside the header's types: nvcc's host stub names both

struct PatchifyStage {
  const float* g;   // (pd,) fp32

  __device__ __forceinline__ void setup(unsigned char*, const Geometry&, const Tile&) const {}

  __device__ __forceinline__ void form(unsigned char*, const Geometry& geo, const Tile& tile,
                                       int kb, int2 rc, const __nv_bfloat16* rows, int wi,
                                       int q, unsigned char* btile, float (&sum)[kSlabs],
                                       float (&sq)[kSlabs]) const {
    const int f0 = kb * kKB + 8 * q;
    int r = rc.x, c = rc.y;
    float x[kSlabs][8];
    float gv[8];
    if (geo.p2 % 4 == 0 && geo.L % 4 == 0 && f0 + 8 <= geo.pd) {
      // two runs of 4 features, each inside one slab row and 8-byte aligned
      // in the row ring: one 8-byte load a run and slab row
      int off[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        off[h] = unit_row(geo, r, 0) + wi * geo.p2 + c;
        if ((c += 4) == geo.p2) c = 0, ++r;
      }
      const float4 g0 = *reinterpret_cast<const float4*>(g + f0);
      const float4 g1 = *reinterpret_cast<const float4*>(g + f0 + 4);
      gv[0] = g0.x, gv[1] = g0.y, gv[2] = g0.z, gv[3] = g0.w;
      gv[4] = g1.x, gv[5] = g1.y, gv[6] = g1.z, gv[7] = g1.w;
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint2 v = make_uint2(0, 0);
          if (s < tile.slabs) v = *reinterpret_cast<const uint2*>(rows + off[h] + s * geo.L);
          x[s][4 * h] = __uint_as_float(v.x << 16);
          x[s][4 * h + 1] = __uint_as_float(v.x & 0xffff0000u);
          x[s][4 * h + 2] = __uint_as_float(v.y << 16);
          x[s][4 * h + 3] = __uint_as_float(v.y & 0xffff0000u);
        }
      }
    } else {
      // feature f0 + e at slab row r, column c of the patch (-1 past pd)
      int off[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bool in = f0 + e < geo.pd;
        off[e] = in ? unit_row(geo, r, 0) + wi * geo.p2 + c : -1;
        gv[e] = in ? g[f0 + e] : 0.f;
        if (++c == geo.p2) c = 0, ++r;
      }
#pragma unroll
      for (int s = 0; s < kSlabs; ++s)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          x[s][e] = s < tile.slabs && off[e] >= 0
                        ? __bfloat162float(rows[off[e] + s * geo.L]) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sum[s] += x[s][e];
        sq[s] += x[s][e] * x[s][e];
        y[e] = x[s][e] * gv[e];
      }
      *reinterpret_cast<uint4*>(btile + hopper::swizzle128(s * geo.w + wi, 16 * q)) =
          make_uint4(warp_mma::pack_bf16(y[0], y[1]), warp_mma::pack_bf16(y[2], y[3]),
                     warp_mma::pack_bf16(y[4], y[5]), warp_mma::pack_bf16(y[6], y[7]));
    }
  }
};

// grid and block from patch_wgmma::launch
__global__ void __launch_bounds__(kThreads, 1)
    patchify_project_kernel(const __grid_constant__ CUtensorMap tk, const Geometry geo,
                            const PatchifyStage stage) {
  run<true>(&tk, geo, stage);
}

}  // namespace
}  // namespace patch_wgmma

// Launches on `stream`; returns a cudaError_t (0 when the launch was
// accepted).  The caller has checked: bf16 volume and K, fp32 g and v2,
// T % pt == 0, H % p1 == 0, W % p2 == 0, W / p2 <= 24, dim % 128 == 0,
// contiguous buffers.
extern "C" int patchify_project_launch(const void* vol, const void* g, const void* kmat,
                                       const void* v2, void* out, int T, int H, int W,
                                       int pt, int p1, int p2, int dim, float eps,
                                       void* stream) {
  using namespace patch_wgmma;
  Geometry geo{};
  geo.src = static_cast<const __nv_bfloat16*>(vol);
  geo.v2 = static_cast<const float*>(v2);
  geo.out = static_cast<__nv_bfloat16*>(out);
  geo.L = W;
  geo.frame_rows = H;
  geo.pt = pt, geo.p1 = p1, geo.p2 = p2;
  geo.t = T / pt, geo.h = H / p1, geo.w = W / p2, geo.dim = dim;
  geo.eps = eps;
  const cudaError_t err =
      launch(patchify_project_kernel, geo, static_cast<const __nv_bfloat16*>(kmat),
             PatchifyStage{static_cast<const float*>(g)}, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();   // leave no stale error for the next launch
  return static_cast<int>(err);
}
