// Single-token decode attention over the stacked head-major KV cache (K8).
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
// Bound on the H100: the work is two length-hd dots per slot and query
// head, so what bounds it is the bytes.  The kernel loads the K and V rows
// (and, for an int8 cache, the scales) of the valid slots' tiles only, each
// once, in place.  At the shipped decode shape (Meditron-7B: b 4, kvh = h =
// 32, m 608, hd 128) prompts of 512/448/384/320 tokens padded to 512 leave
// 2,048 of the 2,432 slots valid at the last decode step: 33.6 MB, 10.0 us at
// 3.35 TB/s (int8 17.3 MB, 5.2 us); the README's batch-32 int8 headline
// 138 MB, 41 us.  Tensor cores buy nothing here: at rep 1 (Meditron-7B is
// MHA) each cache element meets one query value, one multiply-add, so an
// M = 1 product would waste 63 of wgmma's 64 rows and still wait for the
// same bytes; the FMA units in fp32 keep up with 3.35 TB/s at 4 bytes of
// bf16 K and V a multiply-add pair.
//
// Design, for a card of 132 SMs and a batch of 4:
//  * The slots of one (batch row, kv head) are split over a thread-block
//    cluster of `ranks` blocks: grid (ranks, kvh, b), cluster (ranks, 1,
//    1).  The wrapper picks ranks in {1, 2, 4, 8} from b * kvh and the SM
//    count so that the grid runs in one wave of at most 2 blocks an SM (2
//    at b 4, 1 at b 32, 8 at b 4 with 8 kv heads; clusters of 4 or 8 at b 4
//    took two waves; ops/decode_attention.py:split_count).  The head plane
//    is cut into tiles of T slots (32 at head dim 128, else 64); rank r owns
//    tiles [r * n / ranks, (r + 1) * n / ranks) of the n = ceil(m / T).
//  * Each block first reads its range's `valid` bytes once, into one bit
//    per slot (16 slots a thread, every load issued before any is used: one
//    round trip); a tile with no valid slot is never loaded.  At the
//    shipped prompts every invalid run starts and ends on a 64-slot
//    boundary, so no invalid row is loaded.
//  * One producer thread (warp 4) brings each loaded tile's K rows and V
//    rows, each one contiguous run in the head-major plane, with one
//    cp.async.bulk each into a ring of 2-4 stages (full and empty
//    mbarriers); an int8 tile brings its k and v scales too when the scale
//    runs are 16-byte aligned (m % 4 == 0), else the consumers read them
//    with plain loads.  No load waits behind a `valid` byte.
//  * Four consumer warps compute from shared memory in fp32.  A group of
//    G = hd / VEC lanes holds one slot's row, VEC elements a lane (16 at
//    rep 1-2 and head dim >= 32, else 8; fp32 8 or 4: fewer lanes a row
//    mean fewer shuffles and less of the softmax repeated across them);
//    each dot is reduced by one butterfly over the group; int8 becomes fp32
//    by a byte permute and an add, not I2F.  q is pre-scaled by scale *
//    log2(e), so the softmax uses exp2f: a group scores up to kBatch slots,
//    rescales its running state once, then takes one exp2f a slot and head.
//    At rep >= 2 the query heads of a kv head are spread over the warps
//    (rep / 4 or 1 heads a warp, the warps of a head set splitting the
//    slots), so no instantiation holds more than 2 heads in registers.
//  * Merge: each group's (max, sum, acc) goes to shared memory; the block
//    merges its groups in a fixed order; after a cluster barrier rank 0
//    loads the states of ranks 0 .. ranks-1 through distributed shared
//    memory (all at once), merges them in rank order and writes `out`; a
//    second cluster barrier keeps every block's shared memory alive until
//    it has been read (a cluster of one block takes neither barrier).  A
//    rank with no valid slot carries max -1e30 and sum 0 and adds exactly
//    nothing; a row with none anywhere gives 0 / max(0, 1e-30) = 0.  No
//    partial leaves the chip, there is one launch, and every sum runs in a
//    fixed order, so the bits repeat.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kThreads = (kConsumerWarps + 1) * 32;   // + the producer warp
constexpr int kBatch = 4;             // slots a group scores before one rescale
constexpr int kMaxSplits = 8;         // blocks of a cluster
constexpr int kRingBytes = 64 * 1024;
constexpr float kNegBig = -1e30f;     // "no slot yet"; exp2f(kNegBig - s) == 0
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One lane's chunk of a cache row in shared memory, VEC elements (a
// multiple of 16 bytes for bf16 and fp32, of 8 for int8), to fp32.
template <typename KT, int VEC> struct Chunk;
template <int VEC> struct Chunk<__nv_bfloat16, VEC> {
  __device__ static void load(const __nv_bfloat16* p, float* f) {
#pragma unroll
    for (int c = 0; c < VEC / 8; ++c) {
      const uint4 r = reinterpret_cast<const uint4*>(p)[c];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(h[i]);
        f[8 * c + 2 * i] = t.x;
        f[8 * c + 2 * i + 1] = t.y;
      }
    }
  }
};
template <int VEC> struct Chunk<float, VEC> {
  __device__ static void load(const float* p, float* f) {
#pragma unroll
    for (int c = 0; c < VEC / 4; ++c) {
      const float4 r = reinterpret_cast<const float4*>(p)[c];
      f[4 * c] = r.x;
      f[4 * c + 1] = r.y;
      f[4 * c + 2] = r.z;
      f[4 * c + 3] = r.w;
    }
  }
};
// int8 to fp32 without I2F (a quarter-rate instruction, which paced the
// batch-32 int8 cache): byte c ^ 0x80 = c + 128 under the exponent of 2^23
// (one byte permute), minus 2^23 + 128, is c exactly.
template <int VEC> struct Chunk<int8_t, VEC> {
  __device__ static void load(const int8_t* p, float* f) {
#pragma unroll
    for (int c = 0; c < VEC / 8; ++c) {
      const uint2 r = reinterpret_cast<const uint2*>(p)[c];
      const uint32_t w[2] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u};
#pragma unroll
      for (int i = 0; i < 8; ++i)
        f[8 * c + i] =
            __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7540u | (i % 4))) - 8388736.f;
    }
  }
};

constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// The block's shape for a cache type, head dim and GQA ratio.
template <typename KT, int HD, int REP>
struct Geo {
  static constexpr int T = HD == 128 ? 32 : 64;          // slots a tile
  // elements a lane: 16 (8 for fp32) where a lane's registers allow it and
  // a tile still gives every group a slot
  static constexpr int VEC = sizeof(KT) == 4 ? (REP >= 4 ? 4 : 8)
                                             : (REP >= 4 || HD == 16 ? 8 : 16);
  static constexpr int G = HD / VEC;                     // lanes a row
  static constexpr int GPW = 32 / G;                     // groups a warp
  static constexpr int HW = REP < kConsumerWarps ? REP : kConsumerWarps;   // head sets
  static constexpr int R = REP / HW;                     // query heads a warp
  static constexpr int SW = kConsumerWarps / HW;         // warps a head set
  static constexpr int NG = SW * GPW;                    // groups a head set
  static constexpr int ROW = HD * static_cast<int>(sizeof(KT));
  static constexpr int TILE = T * ROW;                   // bytes of K (or V) a tile
  static constexpr int STAGE = 2 * TILE + 2 * T * 4;     // K, V, k scales, v scales
  static constexpr int STAGES =
      kRingBytes / STAGE < 2 ? 2 : (kRingBytes / STAGE > 4 ? 4 : kRingBytes / STAGE);
  static constexpr int PART = kConsumerWarps * GPW * R * (HD + 2);   // floats
  static constexpr int RES = REP * (HD + 2);                        // floats
  // dynamic shared memory: ring, group partials, block result, barriers,
  // then one 16-bit mask a 16 slots of the range
  static constexpr int OFF_PART = STAGES * STAGE;
  static constexpr int OFF_RES = round16(OFF_PART + PART * 4);
  static constexpr int OFF_BARS = round16(OFF_RES + RES * 4);
  static constexpr int OFF_MASKS = OFF_BARS + 2 * STAGES * 8;
  static_assert(T % NG == 0 && HD % VEC == 0 && 32 % G == 0, "a tile splits evenly");
  static_assert(STAGE % 16 == 0 && TILE % 16 == 0, "bulk copies move 16-byte multiples");
};

struct Args {
  const void* q;
  const void* ck;
  const void* cv;
  const unsigned char* valid;
  const float* ks;
  const float* vs;
  void* out;
  int b, kvh, m, layer, ranks;
  int bulk_scales;   // the scale runs are 16-byte aligned: copy them with the tile
  float scale;
};

// the valid-slot bits of tile t of the block's range
template <int T>
__device__ __forceinline__ uint64_t tile_bits(const uint16_t* masks, int t) {
  uint64_t bits = 0;
#pragma unroll
  for (int u = 0; u < T / 16; ++u) bits |= static_cast<uint64_t>(masks[t * (T / 16) + u]) << (16 * u);
  return bits;
}

// grid (ranks, kvh, b), cluster (ranks, 1, 1), kThreads threads
template <typename QT, typename KT, int HD, int REP>
__global__ void __launch_bounds__(kThreads, 4) decode_attention_kernel(const Args a) {
  using Gm = Geo<KT, HD, REP>;
  constexpr int T = Gm::T, VEC = Gm::VEC, G = Gm::G, GPW = Gm::GPW, R = Gm::R, SW = Gm::SW,
                NG = Gm::NG, STAGES = Gm::STAGES;
  constexpr bool kQuant = sizeof(KT) == 1;
  extern __shared__ __align__(128) unsigned char da_smem[];
  unsigned char* ring = da_smem;
  float* part = reinterpret_cast<float*>(da_smem + Gm::OFF_PART);
  float* res = reinterpret_cast<float*>(da_smem + Gm::OFF_RES);
  uint64_t* full = reinterpret_cast<uint64_t*>(da_smem + Gm::OFF_BARS);
  uint64_t* empty = full + STAGES;
  uint16_t* masks = reinterpret_cast<uint16_t*>(da_smem + Gm::OFF_MASKS);

  const int rank = blockIdx.x, g = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (a.m + T - 1) / T;
  const int t_begin = rank * n_tiles / a.ranks;
  const int t_end = (rank + 1) * n_tiles / a.ranks;
  const long long plane = (static_cast<long long>(a.layer) * a.b + bi) * a.kvh + g;

  // the range's valid bits, 16 slots a thread: all its loads issued at once
  // (one round trip for ranges of up to 16 * kThreads slots)
  const unsigned char* vrow = a.valid + static_cast<long long>(bi) * a.m;
  const int units = (t_end - t_begin) * (T / 16);
  for (int u = tid; u < units; u += kThreads) {
    const int j0 = t_begin * T + u * 16;
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) bits |= (j0 + k < a.m && vrow[j0 + k] != 0 ? 1u : 0u) << k;
    masks[u] = static_cast<uint16_t>(bits);
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumerWarps);
    }
    hopper::mbar_init_fence();
  }

  // this warp's query heads and this lane's place in its slot group
  const int hs = warp / SW, gi = (warp % SW) * GPW + lane / G, li = lane % G;
  float qr[R][VEC];
  if (warp < kConsumerWarps) {
    const QT* qg = static_cast<const QT*>(a.q) +
                   ((static_cast<long long>(bi) * a.kvh + g) * REP + hs * R) * HD + li * VEC;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[r][e] = to_float(qg[r * HD + e]) * (a.scale * kLog2e);
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // the producer: one thread issues every copy
    if (lane == 0) {
      int i = 0;
      for (int t = t_begin; t < t_end; ++t) {
        if (tile_bits<T>(masks, t - t_begin) == 0) continue;
        const int s = i % STAGES;
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        const int n = min(T, a.m - t * T);
        const uint32_t rows = n * Gm::ROW;
        const uint32_t scales = kQuant && a.bulk_scales ? n * 4 : 0;
        const long long slot = plane * a.m + static_cast<long long>(t) * T;
        unsigned char* st = ring + s * Gm::STAGE;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * rows + 2 * scales);
        hopper::bulk_load(st, static_cast<const KT*>(a.ck) + slot * HD, rows, &full[s]);
        hopper::bulk_load(st + Gm::TILE, static_cast<const KT*>(a.cv) + slot * HD, rows,
                          &full[s]);
        if (scales) {
          hopper::bulk_load(st + 2 * Gm::TILE, a.ks + slot, scales, &full[s]);
          hopper::bulk_load(st + 2 * Gm::TILE + T * 4, a.vs + slot, scales, &full[s]);
        }
        ++i;
      }
    }
    __syncwarp();
  } else {
    float mx[R], sum[R], acc[R][VEC];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mx[r] = kNegBig;
      sum[r] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
    }
    int i = 0;
    for (int t = t_begin; t < t_end; ++t) {
      const uint64_t bits = tile_bits<T>(masks, t - t_begin);
      if (bits == 0) continue;
      const int s = i % STAGES;
      hopper::mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* st = ring + s * Gm::STAGE;
      const KT* kt = reinterpret_cast<const KT*>(st) + li * VEC;
      const KT* vt = reinterpret_cast<const KT*>(st + Gm::TILE) + li * VEC;
      // an int8 tile's scales: copied with it, or read in place
      const float* kst = reinterpret_cast<const float*>(st + 2 * Gm::TILE);
      const float* vst = kst + T;
      if (kQuant && !a.bulk_scales) {
        const long long slot = plane * a.m + static_cast<long long>(t) * T;
        kst = a.ks + slot;
        vst = a.vs + slot;
      }
#pragma unroll 1
      for (int jb = gi; jb < T; jb += kBatch * NG) {
        // score up to kBatch slots (j < T is the same for every group)
        float sc[kBatch][R];
        bool ok[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int j = jb + u * NG;
          ok[u] = false;
#pragma unroll
          for (int r = 0; r < R; ++r) sc[u][r] = kNegBig;
          if (j < T) {
            float kf[VEC];
            Chunk<KT, VEC>::load(kt + j * HD, kf);
            ok[u] = (bits >> j) & 1;
            const float ksc = kQuant && ok[u] ? kst[j] : 1.f;
#pragma unroll
            for (int r = 0; r < R; ++r) {
              float d = 0.f;
#pragma unroll
              for (int e = 0; e < VEC; ++e) d = fmaf(qr[r][e], kf[e], d);
#pragma unroll
              for (int off = G / 2; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
              sc[u][r] = ok[u] ? d * ksc : kNegBig;
            }
          }
        }
        // one rescale for the batch, then one exp2f a valid slot and head
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float mn = mx[r];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) mn = fmaxf(mn, sc[u][r]);
          const float c = exp2f(mx[r] - mn);
          sum[r] *= c;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] *= c;
          mx[r] = mn;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (!ok[u]) continue;
          const int j = jb + u * NG;
          float vf[VEC];
          Chunk<KT, VEC>::load(vt + j * HD, vf);
          const float vsc = kQuant ? vst[j] : 1.f;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float p = exp2f(sc[u][r] - mx[r]);
            sum[r] += p;
            const float pv = p * vsc;
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(pv, vf[e], acc[r][e]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
      ++i;
    }
    // this group's state: (acc, max, sum) a query head
    float* pg = part + (hs * NG + gi) * R * (HD + 2);
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) pg[r * (HD + 2) + li * VEC + e] = acc[r][e];
      if (li == 0) {
        pg[r * (HD + 2) + HD] = mx[r];
        pg[r * (HD + 2) + HD + 1] = sum[r];
      }
    }
  }
  __syncthreads();

  // the block's state: its groups merged in group order
  for (int x = tid; x < REP * HD; x += kThreads) {
    const int head = x / HD, d = x - head * HD;
    const float* p0 = part + ((head / R) * NG * R + head % R) * (HD + 2);
    float mn = kNegBig;
    for (int k = 0; k < NG; ++k) mn = fmaxf(mn, p0[k * R * (HD + 2) + HD]);
    float av = 0.f, sv = 0.f;
    for (int k = 0; k < NG; ++k) {
      const float* pk = p0 + k * R * (HD + 2);
      const float c = exp2f(pk[HD] - mn);
      av += pk[d] * c;
      sv += pk[HD + 1] * c;
    }
    res[head * (HD + 2) + d] = av;
    if (d == 0) {
      res[head * (HD + 2) + HD] = mn;
      res[head * (HD + 2) + HD + 1] = sv;
    }
  }
  if (a.ranks > 1) {
    hopper::cluster_sync();
  } else {
    __syncthreads();
  }

  // rank 0 merges the cluster's blocks in rank order and writes out
  if (rank == 0) {
    QT* og = static_cast<QT*>(a.out) + (static_cast<long long>(bi) * a.kvh + g) * REP * HD;
    for (int x = tid; x < REP * HD; x += kThreads) {
      const int head = x / HD, d = x - head * HD;
      const float* rh = res + head * (HD + 2);
      // every rank's state, loaded at once (one round trip)
      float mk[kMaxSplits], ak[kMaxSplits], sk[kMaxSplits];
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k) {
        mk[k] = kNegBig;
        ak[k] = sk[k] = 0.f;
        if (k < a.ranks) {
          mk[k] = hopper::ld_cluster_f32(rh + HD, k);
          ak[k] = hopper::ld_cluster_f32(rh + d, k);
          sk[k] = hopper::ld_cluster_f32(rh + HD + 1, k);
        }
      }
      float mn = kNegBig;
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k) mn = fmaxf(mn, mk[k]);
      float av = 0.f, sv = 0.f;
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k) {
        if (k == a.ranks) break;   // the cluster merge, rank by rank
        const float c = exp2f(mk[k] - mn);
        av += ak[k] * c;
        sv += sk[k] * c;
      }
      og[x] = from_float<QT>(av / fmaxf(sv, 1e-30f));
    }
  }
  if (a.ranks > 1) hopper::cluster_sync();   // no block leaves while rank 0 reads it
}

template <typename QT, typename KT, int HD, int REP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using Gm = Geo<KT, HD, REP>;
  auto kernel = decode_attention_kernel<QT, KT, HD, REP>;
  // the card's whole opt-in shared memory, set once (occupancy follows the
  // launch's own size)
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (opt_in != cudaSuccess) return opt_in;
  const int n_tiles = (a.m + Gm::T - 1) / Gm::T;
  const int most = (n_tiles + a.ranks - 1) / a.ranks;     // tiles of the largest range
  const size_t smem = Gm::OFF_MASKS + static_cast<size_t>(most) * (Gm::T / 16) * 2;
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = a.ranks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.ranks, a.kvh, a.b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename QT, typename KT, int HD>
cudaError_t by_rep(const Args& a, int rep, cudaStream_t s) {
  switch (rep) {
    case 1: return launch<QT, KT, HD, 1>(a, s);
    case 2: return launch<QT, KT, HD, 2>(a, s);
    case 4: return launch<QT, KT, HD, 4>(a, s);
    case 8: return launch<QT, KT, HD, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, typename KT>
cudaError_t by_head_dim(const Args& a, int hd, int rep, cudaStream_t s) {
  switch (hd) {
    case 16: return by_rep<QT, KT, 16>(a, rep, s);
    case 32: return by_rep<QT, KT, 32>(a, rep, s);
    case 64: return by_rep<QT, KT, 64>(a, rep, s);
    case 128: return by_rep<QT, KT, 128>(a, rep, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 bf16 q + bf16 cache, 1 fp32 + fp32, 2 bf16 q + int8 cache,
// 3 fp32 q + int8 cache.  k_scale and v_scale are read for the int8 cache
// only.  splits: the blocks that share one (batch row, kv head), 1, 2, 4 or
// 8 (ops/decode_attention.py:split_count).  The caches must be 16-byte
// aligned.
extern "C" int decode_attention_launch(const void* q, const void* ck, const void* cv,
                                       const void* valid, const void* k_scale,
                                       const void* v_scale, void* out, int b, int h, int kvh,
                                       int m, int hd, int layer, float scale, int dtype,
                                       int splits, void* stream) {
  if (b <= 0 || kvh <= 0 || h % kvh != 0 || m <= 0 || layer < 0) return (int)cudaErrorInvalidValue;
  if (splits != 1 && splits != 2 && splits != 4 && splits != 8) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(ck) % 16 || reinterpret_cast<uintptr_t>(cv) % 16)
    return (int)cudaErrorInvalidValue;
  const bool quant = dtype == 2 || dtype == 3;
  const bool bulk_scales = quant && m % 4 == 0 && reinterpret_cast<uintptr_t>(k_scale) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(v_scale) % 16 == 0;
  const Args a{q, ck, cv, static_cast<const unsigned char*>(valid),
               static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), out, b, kvh,
               m, layer, splits, bulk_scales ? 1 : 0, scale};
  const int rep = h / kvh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)by_head_dim<__nv_bfloat16, __nv_bfloat16>(a, hd, rep, s);
    case 1: return (int)by_head_dim<float, float>(a, hd, rep, s);
    case 2: return (int)by_head_dim<__nv_bfloat16, int8_t>(a, hd, rep, s);
    case 3: return (int)by_head_dim<float, int8_t>(a, hd, rep, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
