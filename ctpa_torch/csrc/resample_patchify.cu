// Fused stage-3 resample + HU window + pad mask + patchify + LayerNorm +
// projection for the CTViT patch embed of a raw volume.
//
// Replaces the TPU kernel
// ctpa/ops/pallas/resample_patchify.py:resample3_patchify_project (`_kernel`).
// It reads the stage-1/2 intermediate x2 = (D, H, ws) in bf16 (depth and
// height already resampled, the width still the raw's) and writes bf16
// (t, h, w, dim) patch embeddings, pre-bias and pre-norm_out; the resampled
// (D, H, W) volume never reaches device memory:
//
//   y[d, r, c] = w0[c] * x2[d, r, i0[c]] + w1[c] * x2[d, r, i1[c]]      (fp32)
//   y          = (clamp(y, lo, hi) + shift) * (1 / scale)   (when windowed)
//   y          = pad_value outside vd x vh x vw
//   out[p, :]  = rsig[p] * sum_f bf16(y[p, f]) * kg[f, :]  -  mu[p] * rsig[p] * v2
//
// with mu, rsig the fp32 LayerNorm statistics of y over the pd = pt*p1*p2
// features (no clamp of m2 - mu^2, as ctpa computes it), kg = bf16(g * K)
// and v2 = sum_f g * K in fp32 (both from the caller).  The taps (i0, i1,
// w0, w1) are the at most two non-zeros of each row of the stage-3 matrix
// (the caller derives them where the matrix is built, or from the matrix):
// two terms make the two-tap sum the dense fp32 dot ctpa takes.  The window
// multiplies by the reciprocal of the scale where ctpa and the plain version
// divide: the same value within one fp32 ulp, an IEEE division costing about
// a quarter of the parent WMMA kernel's time on the H100.
//
// Bound on the H100 at the shipped shape (x2 (240, 480, 512), W 480, pt 10,
// p 20, dim 512): the projection is 2 * 13,824 * 4,000 * 512 = 56.6 GFLOP,
// 57 us at the bf16 tensor-core rate, against ~137 MB of traffic (x2 118 MB,
// K 4 MB, the output 14 MB), 41 us at 3.35 TB/s: bound by operations.  The
// two-tap stage 3 adds 4 fp32 operations an output voxel (0.22 GFLOP, 3 us on
// the FMA units, beside the tensor cores); ctpa's dense stage-3 dot would
// count 113 GFLOP more.
//
// What the design does about it: the projection is patch_wgmma.cuh's
// (wgmma on a TMA-fed ring, kg's window multicast across a cluster of two
// blocks, 96 patches x 256 columns a block), K1's.  Only the forming of the
// patch rows differs: the x2 rows a k-block touches are in the block's row
// slot (bulk copies where ws is a multiple of 8, else the staging threads'
// loads), and staging task (wi, q) takes features 8q .. 8q + 7 of the
// k-block for patch column wi of every slab row: each feature's output
// column has one tap entry (i0, i1, w0, w1; 16 bytes in shared memory, read
// once and used for the kSlabs slab rows), its two x2 values from the
// slot, the window, the row and column masks, the sums of y and y^2, and y
// rounded to bf16 into the patch tile.  The rows' masks sit in shared
// memory as one byte per (slab row, row of the slab), the columns' beside
// the taps.  profile_resample_patchify.py times the kernel against the
// parent's on the card (PERF.md).

#include <cstdint>

#include "patch_wgmma.cuh"

namespace patch_wgmma {
namespace {  // the kernel beside the header's types: nvcc's host stub names both

// The Stage's tables in shared memory: the taps of each output column
// (int4: i0, i1, w0, w1 as bits), its mask vw, the row mask of each (slab
// row, row of the slab).
__host__ __device__ inline int taps_bytes(int W) { return 16 * W; }
__host__ __device__ inline int extra_bytes(int W, int rows) { return 16 * W + W + kSlabs * rows; }

struct ResampleStage {
  const int2* taps_i;          // (W, 2) source columns
  const float2* taps_w;        // (W, 2) weights
  const unsigned char* vd;     // (D,), (H,), (W,) masks
  const unsigned char* vh;
  const unsigned char* vw;
  int W, has_window;
  float lo, hi, shift, inv_scale, pad_value;

  __device__ __forceinline__ void setup(unsigned char* extra, const Geometry& geo,
                                        const Tile& tile) const {
    int4* tap_s = reinterpret_cast<int4*>(extra);
    unsigned char* vw_s = extra + taps_bytes(W);
    unsigned char* row_s = vw_s + W;
    for (int e = threadIdx.x; e < W; e += kThreads) {
      const int2 ii = taps_i[e];
      const float2 ww = taps_w[e];
      tap_s[e] = make_int4(ii.x, ii.y, __float_as_int(ww.x), __float_as_int(ww.y));
      vw_s[e] = vw[e];
    }
    for (int e = threadIdx.x; e < kSlabs * geo.rows; e += kThreads) {
      const int s = e / geo.rows, r = e - s * geo.rows;
      row_s[e] = s < tile.slabs && vd[tile.ti * geo.pt + r / geo.p1] &&
                 vh[(tile.h0 + s) * geo.p1 + r % geo.p1];
    }
  }

  __device__ __forceinline__ void form(unsigned char* extra, const Geometry& geo,
                                       const Tile& tile, int kb, int2 rc,
                                       const __nv_bfloat16* rows, int wi, int q,
                                       unsigned char* btile, float (&sum)[kSlabs],
                                       float (&sq)[kSlabs]) const {
    const int4* tap_s = reinterpret_cast<const int4*>(extra);
    const unsigned char* vw_s = extra + taps_bytes(W);
    const unsigned char* row_s = vw_s + W;
    // feature f0 + e: its slab row, offset in the row ring, the output
    // column's taps and mask; past pd, row 0 with zero taps (read, then
    // dropped), so no load waits on a branch
    const int f0 = kb * kKB + 8 * q;
    int r = rc.x, c = rc.y;
    int row[8], off[8];
    int4 tap[8];
    bool in[8], col_ok[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      in[e] = f0 + e < geo.pd;
      const int col = wi * geo.p2 + c;
      row[e] = in[e] ? r : 0;
      off[e] = in[e] ? unit_row(geo, r, 0) : 0;
      tap[e] = in[e] ? tap_s[col] : make_int4(0, 0, 0, 0);
      col_ok[e] = in[e] && vw_s[col];
      if (++c == geo.p2) c = 0, ++r;
    }
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (s < tile.slabs) {
        const __nv_bfloat16* src = rows + s * geo.L;
        float x0[8], x1[8];
        bool ok[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          x0[e] = __bfloat162float(src[off[e] + tap[e].x]);
          x1[e] = __bfloat162float(src[off[e] + tap[e].y]);
          ok[e] = col_ok[e] && row_s[s * geo.rows + row[e]];
        }
        float y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float t = __int_as_float(tap[e].z) * x0[e] + __int_as_float(tap[e].w) * x1[e];
          if (has_window) t = (fminf(fmaxf(t, lo), hi) + shift) * inv_scale;
          y[e] = in[e] ? (ok[e] ? t : pad_value) : 0.f;
          sum[s] += y[e];
          sq[s] += y[e] * y[e];
        }
        v = make_uint4(warp_mma::pack_bf16(y[0], y[1]), warp_mma::pack_bf16(y[2], y[3]),
                       warp_mma::pack_bf16(y[4], y[5]), warp_mma::pack_bf16(y[6], y[7]));
      }
      *reinterpret_cast<uint4*>(btile + hopper::swizzle128(s * geo.w + wi, 16 * q)) = v;
    }
  }
};

// grid and block from patch_wgmma::launch
__global__ void __launch_bounds__(kThreads, 1)
    resample3_patchify_project_kernel(const __grid_constant__ CUtensorMap tk, const Geometry geo,
                                      const ResampleStage stage) {
  run<false>(&tk, geo, stage);
}

}  // namespace
}  // namespace patch_wgmma

// Launches on `stream`; returns a cudaError_t (0 when the launch was
// accepted), also cudaErrorInvalidValue when no shared-memory layout for ws
// fits the card.  The caller has checked: bf16 x2 and kg, int32 taps_i and
// fp32 taps_w (W, 2) with every column below ws, uint8 masks, fp32 v2,
// D % pt == 0, H % p1 == 0, W % p2 == 0, W / p2 <= 24, dim % 128 == 0,
// contiguous buffers.
extern "C" int resample3_patchify_project_launch(
    const void* x2, const void* taps_i, const void* taps_w, const void* vd, const void* vh,
    const void* vw, const void* kmat, const void* v2, void* out, int D, int H, int ws, int W,
    int pt, int p1, int p2, int dim, int has_window, float lo, float hi, float shift,
    float scale, float pad_value, float eps, void* stream) {
  using namespace patch_wgmma;
  Geometry geo{};
  geo.src = static_cast<const __nv_bfloat16*>(x2);
  geo.v2 = static_cast<const float*>(v2);
  geo.out = static_cast<__nv_bfloat16*>(out);
  geo.L = ws;
  geo.frame_rows = H;
  geo.pt = pt, geo.p1 = p1, geo.p2 = p2;
  geo.t = D / pt, geo.h = H / p1, geo.w = W / p2, geo.dim = dim;
  geo.eps = eps;
  const ResampleStage stage{static_cast<const int2*>(taps_i),
                            static_cast<const float2*>(taps_w),
                            static_cast<const unsigned char*>(vd),
                            static_cast<const unsigned char*>(vh),
                            static_cast<const unsigned char*>(vw),
                            W,
                            has_window,
                            lo,
                            hi,
                            shift,
                            1.f / scale,
                            pad_value};
  const cudaError_t err =
      launch(resample3_patchify_project_kernel, geo, static_cast<const __nv_bfloat16*>(kmat),
             stage, extra_bytes(W, pt * p1), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();   // leave no stale error for the next launch
  return static_cast<int>(err);
}
