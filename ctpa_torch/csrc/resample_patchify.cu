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
// (the wrapper derives them and refuses any other matrix): two terms make
// the two-tap sum the dense fp32 dot ctpa takes.  The window multiplies by
// the reciprocal of the scale where ctpa and the plain version divide: the
// same value within one fp32 ulp, an IEEE division costing about a quarter
// of the kernel's time on the H100.
//
// Bound on the H100 at the shipped shape (x2 (240, 480, 512), W 480, pt 10,
// p 20, dim 512): the projection is 2 * 13,824 * 4,000 * 512 = 56.6 GFLOP,
// 57 us at the bf16 tensor-core rate, against ~137 MB of traffic (x2 118 MB,
// K 4 MB, the output 14 MB), 41 us at 3.35 TB/s: bound by operations.  The
// two-tap stage 3 adds 4 fp32 operations an output voxel (0.22 GFLOP, 3 us on
// the FMA units, beside the tensor cores); ctpa's dense stage-3 dot would
// count 113 GFLOP more.
//
// What the design does about it: the projection and its epilogue are K1's
// (patch_project.cuh: WMMA bf16 tiles, a block owns two slab rows of 24
// patches and 128 output columns, kg served from L2).  Only the staging
// differs: for each chunk of slab rows the block copies the matching x2 rows
// (contiguous over ws, 16 bytes a thread) into shared memory, then one
// thread per (patch, row) forms its p2 output columns two at a time from
// the two taps, windows and masks them, leaves their sums as the (patch,
// row) partial of the statistics (added in a fixed order by the projection)
// and stores them rounded to bf16 in the (patch, feature) tile.
// Stage 3 thus costs a few fp32 operations per voxel instead of a second
// product.  The staging is laid out for shared memory's 32 banks: a warp's
// lanes take the rows of a patch first (four rows of eight patches), the
// x rows are padded by 16 elements so the rows fall on other banks, and the
// taps are packed 16 bytes a column in (column within the patch, patch)
// order, so neighbouring lanes read neighbouring taps; 78 registers leave
// room for three blocks an SM.  The x2 rows are read from device memory
// once per 128 output columns (four times at dim 512; the repeats come from
// L2), and the staging is done once per 128 output columns too.
// profile_resample_patchify.py times the parts on the card (PERF.md).

#include <cstdint>

#include "patch_project.cuh"

namespace {

using namespace patch_project;

// Dynamic shared memory: the projection's tiles, the taps (i0, i1, w0, w1,
// 16 bytes a column), the chunk's x2 rows (kSlabs * chunk_rows(p2) rows of
// ws + kRowPad bf16), the column mask vw.
constexpr int kRowPad = 16;   // keeps rows 16-byte aligned, moves them 8 banks on
__host__ __device__ inline size_t rows_offset(int W) { return kSmemBytes + 16 * (size_t)W; }
__host__ __device__ inline size_t vw_offset(int W, int ws, int p2) {
  return rows_offset(W) + (size_t)kSlabs * chunk_rows(p2) * (ws + kRowPad) * 2;
}
inline size_t smem_bytes(int W, int ws, int p2) { return vw_offset(W, ws, p2) + W; }

// grid grid_of(t, h, dim); block kThreads; dynamic shared memory smem_bytes.
__global__ void __launch_bounds__(kThreads)
resample3_patchify_project_kernel(const __nv_bfloat16* __restrict__ x2,
                                  const int2* __restrict__ taps_i,
                                  const float2* __restrict__ taps_w,
                                  const unsigned char* __restrict__ vd,
                                  const unsigned char* __restrict__ vh,
                                  const unsigned char* __restrict__ vw,
                                  const __nv_bfloat16* __restrict__ kmat,
                                  const float* __restrict__ v2, __nv_bfloat16* __restrict__ out,
                                  int H, int ws, int W, int pt, int p1, int p2, int dim,
                                  int has_window, float lo, float hi, float shift, float scale,
                                  float pad_value, float eps, int vec) {
  const Tile tile = tile_of(H / p1, W / p2, pt * p1, p2);
  const int w = tile.w;
  const int tid = threadIdx.x;
  const int ld_x = ws + kRowPad;
  const float inv_scale = 1.f / scale;
  extern __shared__ __align__(128) unsigned char dsmem[];
  float4* tap_s = reinterpret_cast<float4*>(dsmem + kSmemBytes);
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(dsmem + rows_offset(W));
  unsigned char* vw_s = dsmem + vw_offset(W, ws, p2);
  // output column wi * p2 + c at (c, wi); published by project's first __syncthreads
  for (int e = tid; e < W; e += kThreads) {
    const int wi = e / p2;
    const int k = (e - wi * p2) * w + wi;
    const int2 ii = taps_i[e];
    const float2 ww = taps_w[e];
    tap_s[k] = make_float4(__int_as_float(ii.x), __int_as_float(ii.y), ww.x, ww.y);
    vw_s[k] = vw[e];
  }

  // slab s, row r is x2 row (ti * pt + r / p1, (h0 + s) * p1 + r % p1)
  auto x_row = [&](int s, int r) -> const __nv_bfloat16* {
    const long long frame = (long long)tile.ti * pt + r / p1;
    const long long y = (long long)(tile.h0 + s) * p1 + r % p1;
    return x2 + (frame * H + y) * ws;
  };
  // output column (c, wi) of an x row: the two taps, the window, the mask
  auto column = [&](const __nv_bfloat16* xr, int k, bool row_ok) -> float {
    const float4 t = tap_s[k];
    float y = t.z * __bfloat162float(xr[__float_as_int(t.x)]) +
              t.w * __bfloat162float(xr[__float_as_int(t.y)]);
    if (has_window) y = (fminf(fmaxf(y, lo), hi) + shift) * inv_scale;
    return row_ok && vw_s[k] ? y : pad_value;
  };
  auto stage = [&](int r0, int nr, __nv_bfloat16* a_s, float2* part_s) {
    // the chunk's x2 rows: slab s, chunk row rr at x_s[(s * nr + rr) * ld_x]
    const int n_rows = tile.slabs * nr;
    if (vec) {
      const int per_row = ws / 8;
      for (int e = tid; e < n_rows * per_row; e += kThreads) {
        const int q = e / per_row;
        const int j = e - q * per_row;
        const int s = q / nr;
        reinterpret_cast<uint4*>(x_s + (size_t)q * ld_x)[j] =
            reinterpret_cast<const uint4*>(x_row(s, r0 + q - s * nr))[j];
      }
    } else {
      for (int e = tid; e < n_rows * ws; e += kThreads) {
        const int q = e / ws;
        const int s = q / nr;
        const int c = e - q * ws;
        x_s[(size_t)q * ld_x + c] = x_row(s, r0 + q - s * nr)[c];
      }
    }
    __syncthreads();
    // one task is one patch's p2 output columns of one row; rows run fastest
    for (int e = tid; e < tile.slabs * w * nr; e += kThreads) {
      const int rr = e % nr;
      const int m = e / nr;                   // patch row in the block: s * w + wi
      const int s = m / w;
      const int wi = m - s * w;
      const int r = r0 + rr;
      const bool row_ok = vd[tile.ti * pt + r / p1] && vh[(tile.h0 + s) * p1 + r % p1];
      const __nv_bfloat16* xr = x_s + (size_t)(s * nr + rr) * ld_x;
      __nv_bfloat16* dst = a_s + m * kLdA + rr * p2;
      float sum = 0.f, sq = 0.f;
      if (p2 % 2 == 0) {
#pragma unroll
        for (int c = 0; c < kMaxP2; c += 2) {
          if (c < p2) {
            const float y0 = column(xr, c * w + wi, row_ok);
            const float y1 = column(xr, (c + 1) * w + wi, row_ok);
            sum += y0 + y1;
            sq += y0 * y0 + y1 * y1;
            *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(y0, y1);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < kMaxP2; ++c) {
          if (c < p2) {
            const float y = column(xr, c * w + wi, row_ok);
            sum += y;
            sq += y * y;
            dst[c] = __float2bfloat16(y);
          }
        }
      }
      part_s[rr * kM + m] = make_float2(sum, sq);
    }
  };
  project<false>(tile, stage, dsmem, kmat, v2, out, dim, eps);
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 when the launch was
// accepted), also when the shared memory that ws needs exceeds the card's.
// The caller has checked: bf16 x2 and kg, int32 taps_i and fp32 taps_w
// (W, 2) with every column below ws, uint8 masks, fp32 v2, D % pt == 0,
// H % p1 == 0, W % p2 == 0, W / p2 <= 24, p2 <= 32, dim % 128 == 0,
// contiguous buffers.
extern "C" int resample3_patchify_project_launch(
    const void* x2, const void* taps_i, const void* taps_w, const void* vd, const void* vh,
    const void* vw, const void* kmat, const void* v2, void* out, int D, int H, int ws, int W,
    int pt, int p1, int p2, int dim, int has_window, float lo, float hi, float shift,
    float scale, float pad_value, float eps, void* stream) {
  // the kernel's static shared memory counts against the 48 KB default too,
  // so the dynamic size is granted on every launch, whatever it is
  const size_t smem = smem_bytes(W, ws, p2);
  const cudaError_t err = cudaFuncSetAttribute(
      resample3_patchify_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();   // leave no stale error for the next launch's check
    return static_cast<int>(err);
  }
  const int vec = ws % 8 == 0 && reinterpret_cast<uintptr_t>(x2) % 16 == 0;
  resample3_patchify_project_kernel<<<grid_of(D / pt, H / p1, dim), kThreads, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x2), static_cast<const int2*>(taps_i),
      static_cast<const float2*>(taps_w), static_cast<const unsigned char*>(vd),
      static_cast<const unsigned char*>(vh), static_cast<const unsigned char*>(vw),
      static_cast<const __nv_bfloat16*>(kmat), static_cast<const float*>(v2),
      static_cast<__nv_bfloat16*>(out), H, ws, W, pt, p1, p2, dim, has_window, lo, hi, shift,
      scale, pad_value, eps, vec);
  return static_cast<int>(cudaGetLastError());
}
