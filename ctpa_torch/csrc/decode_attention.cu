// Single-token decode attention over the stacked head-major KV cache.
//
// Replaces the TPU kernel ctpa/ops/pallas/decode_attention.py:decode_attention
// (`_kernel`).  For one decode step of one layer, on q (b, h, hd) and the
// FULL stacked caches ck, cv (L, b, kvh, m, hd), with valid (b, m) and, for an
// int8 cache, k_scale, v_scale (L, b, kvh, m) fp32, query head g * rep + r
// (rep = h / kvh) computes
//
//   s_j = (q . k_j) * k_scale_j * scale          over the valid slots j
//   a_j = softmax_j(s) * v_scale_j               (fp32)
//   out = sum_j a_j v_j                          (in q's dtype)
//
// and a row with no valid slot gives zeros.  Cache values are converted to
// fp32 exactly (bf16 and int8 values are exact in fp32), so the products are
// those of ctpa's bf16 dots and the sums are fp32.  ctpa rounds a_j to the
// dot dtype before the second product; this kernel keeps it in fp32.  The
// TPU kernel's kv-head blocking against a VMEM budget, its (b, h, 1, hd)
// view, its 8-head groups and its stand-in scale blocks are not carried
// over: they exist for the TPU's VMEM and (8, 128) tiling.
//
// Bound on the H100: the work is two length-hd dots per slot per head, so
// what bounds it is the bytes.  The kernel loads the K and V rows (and, for
// an int8 cache, the scales) of the valid slots only, each once, in place;
// an invalid slot's row is never loaded.  At the shipped decode shape
// (Meditron-7B: b 4, kvh = h = 32, m 608, hd 128, bf16) with every slot
// valid, one layer's K and V planes are 2 * 4 * 32 * 608 * 128 * 2 B =
// 39.8 MB, 11.9 us at 3.35 TB/s; with the int8 cache 19.9 MB plus 0.6 MB
// of scales, 6.1 us.  Prompts of 512/448/384/320 tokens padded to 512 leave
// 2,048 of the 2,432 slots valid at the last decode step: 33.6 MB, 10.0 us
// (int8 17.4 MB, 5.2 us).  A decode step also reads the layer's 202 M
// weights (405 MB), so attention is under 9% of a step's bytes; the step's
// floor is 13.2 GB of weights plus at most 1.27 GB of cache, about 4.3 ms.
//
// Design (simple and right first): one block per (kv head, batch row),
// 4 * 32 = 128 blocks at the shipped shape for 132 SMs.  The block computes
// the rep query heads that share its kv head, so the cache is never
// repeated, and reads the layer's planes in place at the layer's offset (no
// copy of a slice).  A group of hd / VEC lanes holds one slot's row, VEC
// elements a lane (one 16-byte load for bf16 and fp32, 8 bytes for int8):
// a warp reads whole rows, coalesced.  Each group walks its slots U at a
// time (all U rows of K and V are loaded before any is used, to keep
// several loads in flight) with an online softmax (running max and sum) in
// fp32 per query head; the dot is reduced across the group's lanes by warp
// shuffles.  At the end the groups of a warp merge their (max, sum,
// accumulator) states by shuffles and the warps of the block through shared
// memory.  Invalid slots and the ragged tail add nothing.  Splitting the
// slots of one head across blocks, which a batch this small needs to reach
// the bandwidth, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // slots a group loads before using them
constexpr float kNegBig = -1e30f;   // "no slot yet"; exp(kNegBig - s) == 0

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One lane's chunk of a cache row: VEC elements read by one vector load.
template <typename KT> struct Chunk;
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int VEC = 8;
  using Raw = uint4;
  __device__ static void to_float(const Raw& r, float* f) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(p[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};
template <> struct Chunk<float> {
  static constexpr int VEC = 4;
  using Raw = float4;
  __device__ static void to_float(const Raw& r, float* f) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  }
};
template <> struct Chunk<int8_t> {
  static constexpr int VEC = 8;
  using Raw = uint2;
  __device__ static void to_float(const Raw& r, float* f) {
    const int8_t* p = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(p[i]);
  }
};

// grid (kvh, b); block kThreads; dynamic shared memory
// (REP * hd + kWarps * REP * (hd + 2)) floats.
template <typename QT, typename KT, int REP>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ ck,
                        const KT* __restrict__ cv, const unsigned char* __restrict__ valid,
                        const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                        QT* __restrict__ out, int b, int kvh, int m, int hd, int layer,
                        float scale) {
  using C = Chunk<KT>;
  constexpr int VEC = C::VEC;
  const int g = blockIdx.x;
  const int bi = blockIdx.y;
  const int lpr = hd / VEC;              // lanes per row: 2 .. 32, a power of two
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int li = lane & (lpr - 1);       // the lane's chunk of the row
  const int group = threadIdx.x / lpr;
  const int groups = kThreads / lpr;

  extern __shared__ float smem[];
  float* qs = smem;                      // (REP, hd) fp32
  float* part = qs + REP * hd;           // (kWarps, REP, hd + 2): acc, max, sum

  const long long plane = (long long)(layer * b + bi) * kvh + g;   // (layer, bi, g)
  const KT* kp = ck + plane * m * hd + li * VEC;
  const KT* vp = cv + plane * m * hd + li * VEC;
  const float* ksp = k_scale ? k_scale + plane * m : nullptr;
  const float* vsp = v_scale ? v_scale + plane * m : nullptr;
  const unsigned char* vm = valid + (long long)bi * m;
  const QT* qg = q + ((long long)bi * kvh + g) * REP * hd;

  for (int t = threadIdx.x; t < REP * hd; t += kThreads) qs[t] = to_float(qg[t]);
  __syncthreads();
  float qr[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) qr[r][e] = qs[r * hd + li * VEC + e];

  float mx[REP], sum[REP], acc[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    mx[r] = kNegBig;
    sum[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }

  // every lane runs the same number of iterations (the shuffles need the
  // whole warp); slots past m count as invalid
  for (int base = 0; base < m; base += groups * kUnroll) {
    const int j0 = base + group * kUnroll;
    typename C::Raw kr[kUnroll], vr[kUnroll];
    bool ok[kUnroll];
    float ks[kUnroll], vs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
      ok[u] = j < m && vm[j];
      ks[u] = 1.f;
      vs[u] = 1.f;
      if (ok[u]) {
        kr[u] = *reinterpret_cast<const typename C::Raw*>(kp + (long long)j * hd);
        vr[u] = *reinterpret_cast<const typename C::Raw*>(vp + (long long)j * hd);
        if (ksp) {
          ks[u] = ksp[j];
          vs[u] = vsp[j];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[VEC], vf[VEC], dot[REP];
      if (ok[u]) {
        C::to_float(kr[u], kf);
        C::to_float(vr[u], vf);
      }
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float d = 0.f;
        if (ok[u]) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qr[r][e], kf[e], d);
        }
        for (int off = lpr >> 1; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        dot[r] = d;
      }
      if (ok[u]) {
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float s = dot[r] * ks[u] * scale;
          const float mn = fmaxf(mx[r], s);
          const float c = expf(mx[r] - mn);
          const float p = expf(s - mn);
          sum[r] = sum[r] * c + p;
          const float pv = p * vs[u];
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(pv, vf[e], acc[r][e] * c);
          mx[r] = mn;
        }
      }
    }
  }

  // merge the groups of each warp: lane li of every group holds the same
  // chunk of the row
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[r], off);
      const float os = __shfl_xor_sync(0xffffffffu, sum[r], off);
      const float mn = fmaxf(mx[r], om);
      const float c1 = expf(mx[r] - mn), c2 = expf(om - mn);
      sum[r] = sum[r] * c1 + os * c2;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float oa = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * c1 + oa * c2;
      }
      mx[r] = mn;
    }
  }
  if (lane < lpr) {
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float* pw = part + (warp * REP + r) * (hd + 2);
#pragma unroll
      for (int e = 0; e < VEC; ++e) pw[li * VEC + e] = acc[r][e];
      if (lane == 0) {
        pw[hd] = mx[r];
        pw[hd + 1] = sum[r];
      }
    }
  }
  __syncthreads();

  // merge the warps; a head with no valid slot has sum 0 and gives 0
  QT* og = out + ((long long)bi * kvh + g) * REP * hd;
  for (int t = threadIdx.x; t < REP * hd; t += kThreads) {
    const int r = t / hd, d = t - r * hd;
    float mn = kNegBig;
    for (int w = 0; w < kWarps; ++w) mn = fmaxf(mn, part[(w * REP + r) * (hd + 2) + hd]);
    float a = 0.f, s = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = part + (w * REP + r) * (hd + 2);
      const float c = expf(pw[hd] - mn);
      a += pw[d] * c;
      s += pw[hd + 1] * c;
    }
    og[t] = from_float<QT>(a / fmaxf(s, 1e-30f));
  }
}

template <typename QT, typename KT>
cudaError_t launch_typed(const void* q, const void* ck, const void* cv, const void* valid,
                         const void* ks, const void* vs, void* out, int b, int h, int kvh,
                         int m, int hd, int layer, float scale, cudaStream_t stream) {
  const int rep = h / kvh;
  const dim3 grid(kvh, b);
  const size_t smem = sizeof(float) * (size_t)(rep * hd + kWarps * rep * (hd + 2));
#define CTPA_DECODE_LAUNCH(R)                                                              \
  decode_attention_kernel<QT, KT, R><<<grid, kThreads, smem, stream>>>(                    \
      static_cast<const QT*>(q), static_cast<const KT*>(ck), static_cast<const KT*>(cv),   \
      static_cast<const unsigned char*>(valid), static_cast<const float*>(ks),             \
      static_cast<const float*>(vs), static_cast<QT*>(out), b, kvh, m, hd, layer, scale)
  switch (rep) {
    case 1: CTPA_DECODE_LAUNCH(1); break;
    case 2: CTPA_DECODE_LAUNCH(2); break;
    case 4: CTPA_DECODE_LAUNCH(4); break;
    case 8: CTPA_DECODE_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef CTPA_DECODE_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 bf16 q + bf16 cache, 1 fp32 + fp32, 2 bf16 q + int8 cache,
// 3 fp32 q + int8 cache.  k_scale and v_scale are read for the int8 cache only.
extern "C" int decode_attention_launch(const void* q, const void* ck, const void* cv,
                                       const void* valid, const void* k_scale,
                                       const void* v_scale, void* out, int b, int h, int kvh,
                                       int m, int hd, int layer, float scale, int dtype,
                                       void* stream) {
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128) return (int)cudaErrorInvalidValue;
  if (kvh <= 0 || h % kvh != 0 || m <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_typed<__nv_bfloat16, __nv_bfloat16>(q, ck, cv, valid, nullptr, nullptr,
                                                             out, b, h, kvh, m, hd, layer,
                                                             scale, s);
    case 1:
      return (int)launch_typed<float, float>(q, ck, cv, valid, nullptr, nullptr, out, b, h, kvh,
                                             m, hd, layer, scale, s);
    case 2:
      return (int)launch_typed<__nv_bfloat16, int8_t>(q, ck, cv, valid, k_scale, v_scale, out,
                                                      b, h, kvh, m, hd, layer, scale, s);
    case 3:
      return (int)launch_typed<float, int8_t>(q, ck, cv, valid, k_scale, v_scale, out, b, h,
                                              kvh, m, hd, layer, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
