// The LayerNorm-folded patch projection that K1 (patchify.cu) and K9
// (resample_patchify.cu) share, on Hopper: warpgroup MMA (wgmma) fed by a
// ring of shared-memory stages, the projection's window brought by TMA and
// multicast to the two blocks of a thread-block cluster, the patch rows
// built by staging warps in the layout wgmma reads.  The two kernels differ
// only in how a patch's features are formed (their `Stage`) and in the
// variance's clamp.
//
// What a block computes: for its tile of patches (kSlabs slab rows of one
// temporal row, w patches each: up to kN = 96) and its strip of kCols = 256
// output columns,
//
//   out[p, n] = rsig[p] * sum_f b[p, f] * kmat[f, n]  -  mu[p] * rsig[p] * v2[n]
//
// in bf16 (pre-bias, pre-norm_out), where b is the bf16 patch row the Stage
// forms (K1: x * g, K9: the resampled, windowed, masked y), mu and rsig the
// fp32 LayerNorm statistics of the values the Stage sums (K1: x, K9: y) over
// the pd = pt * p1 * p2 features, ordered (pt, p1, p2).
//
// Operands.  The contraction runs over 64-feature k-blocks, one 128-byte
// bf16 row.  A is the projection's window, kmat rows [64 kb, 64 kb + 64) x
// the strip's 256 columns, four TMA boxes of 64 rows x 64 columns in the
// 128-byte swizzle: kmat is (pd, dim) with the output column contiguous, so
// the box is M-major for out^T = kmat^T . b^T, and wgmma reads it through a
// descriptor with the transpose bit (the SS form, hopper_ptx.cuh:
// desc_mn_sw128).  SS rather than the RS form of prefill_wgmma.cuh: the
// window is bf16 already, so there is nothing to convert in registers, and
// with no A fragments in registers the consumers keep a stage of products
// in flight (wgmma_wait<1>) at 96 accumulators a thread.  B is the patch
// tile: kN rows of 128 bytes, patch m's features [64 kb, 64 kb + 64) in row
// m in the 128-byte swizzle (16-byte chunk q at chunk q ^ (m % 8)), K-major
// for desc_sw128.  The staging threads write it (fence.proxy.async before
// they arrive, since wgmma reads through the async proxy); rows past the
// tile's patches are zero.  D is (64 columns x 96 patches) per wgmma.
//
// Block (kThreads = 480): warps 0-3 and 12-13 stage (kStageThreads = 192,
// one task each: patch column wi < w and 16-byte chunk q < 8, for every
// slab row of the tile), warps 4-7 and 8-11 are the two consumer
// warpgroups, 128 columns each (two m64 tiles; 2 x 48 fp32 accumulators a
// thread), warp 14 issues the copies: the window and the source rows.  A
// ring stage holds one k-block: the window (32 KB) and the patch
// tile (12 KB); `full[s]` takes the 6 staging warps' arrivals, the window
// copier's and the window's bytes; `empty[s]` the releases of the 8
// consumer warps of both blocks of the cluster (16), since each block's
// window copy lands in both.  The source rows (K1: image rows of the
// volume, K9: rows of x2) sit in a ring of `units`: unit r % units holds
// slab row r of every slab of the tile, copied once each by bulk copies
// (cp.async.bulk, one a source row; `ufull`) as soon as the staging warps
// have released the unit (`uempty`, after the last k-block that reads it),
// so the copies run up to units - nr slab rows ahead of the staging.  Where
// a row is not a multiple of 16 bytes the staging threads copy a k-block's
// rows themselves between two barriers of theirs.  The launcher sizes the
// ring (2-4 stages) and the units (up to 32) for the shape: K9's units grow
// with ws.

// Statistics.  A staging task sums its 8 features of each k-block, for each
// slab row, in feature order and k-block after k-block, in registers; at
// the end each patch adds its 8 tasks' sums in chunk order.  No atomics:
// the same bits on every call.
//
// Grid.  A tile is kSlabs slab rows of one temporal row (the last tile of a
// temporal row may hold fewer); tiles pair up in clusters of 2 (blocks 2k,
// 2k + 1, the second with no patches where the tile count is odd), and each
// pair runs once per 256-column strip, the strips of a pair next to each
// other in launch order, so the second staging of a tile's source rows reads
// them from L2.  Each block of a cluster copies half the window's boxes,
// multicast to both.  At the shipped shape (a (240, 480, 480) volume, pt 10,
// p 20, dim 512): 144 tiles of 96 patches, 72 clusters x 2 strips = 288
// blocks, one a streaming multiprocessor (480 threads, about 220 KB of
// shared memory), 2.2 waves on 132.  The window is read from L2 once a
// cluster and k-block: 144 / 2 x 2 strips x 4,000 x 256 x 2 bytes = 0.30 GB
// a call (1.18 GB with WMMA's 48-patch, 128-column tiles and no multicast);
// the source rows twice, once a strip (the second mostly from L2).
//
// The epilogue waits for the statistics (one barrier of the block), writes
// rsig * acc - mu * rsig * v2 as bf16 into the ring, whose stages are idle
// by then, as (patch, column) rows, and stores them 16 bytes at a time into
// the (t, h, w, dim) output.  A cluster barrier at the end keeps each block
// alive until its partner's last remote arrivals.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"
#include "warp_mma.cuh"

namespace patch_wgmma {
namespace {  // each kernel source gets its own copy

constexpr int kSlabs = 4;                          // slab rows (patch rows) a tile
constexpr int kMaxW = 24;                          // patches a slab row at most
constexpr int kN = kSlabs * kMaxW;                 // wgmma's N: 96 patch rows
constexpr int kKB = 64;                            // features a k-block (128 bytes of bf16)
constexpr int kCols = 256;                         // output columns a block
constexpr int kBox = kKB * 64 * 2;                 // a window box: 64 rows x 64 columns
constexpr int kABytes = 4 * kBox;                  // the window: 32 KB
constexpr int kBBytes = kN * 128;                  // the patch tile: 12 KB
constexpr int kStageBytes = kABytes + kBBytes;     // a multiple of 1024
constexpr int kStageThreads = 8 * kMaxW;           // 192 staging tasks (wi, q)
constexpr int kStageWarps = kStageThreads / 32;
constexpr int kConsumer0 = 128;                    // threads [128, 384) consume
constexpr int kProducer0 = kConsumer0 + 256 + 64;  // warp 14 copies
constexpr int kThreads = kProducer0 + 32;          // 480
constexpr int kMaxStages = 4;
constexpr int kMaxUnits = 32;
constexpr int kOutPitch = kCols + 8;               // bf16 a row of the output tile
constexpr int kBarBytes = (2 * kMaxStages + 2 * kMaxUnits) * 8;
constexpr int kPartBytes = kN * 8 * 8;             // (sum, sq) of each task and slab
constexpr int kMiscBytes = kBarBytes + kPartBytes + kN * 8;
static_assert(kStageBytes % 1024 == 0, "ring stages stay 1024-aligned");
static_assert(kN * kOutPitch * 2 <= 2 * kStageBytes, "the output tile fits the ring");

// The launch's shape, filled by launch().
struct Geometry {
  const __nv_bfloat16* src;   // the rows the staging reads: the volume (K1) or x2 (K9)
  const float* v2;            // (dim,) fp32
  __nv_bfloat16* out;         // (t, h, w, dim)
  int L;                      // elements a source row: W (K1) or ws (K9)
  int frame_rows;             // source rows a frame: H
  int pt, p1, p2, rows, pd;   // rows = pt * p1 slab rows of p2 features
  int t, h, w, dim;
  int tiles_h, tiles, strips; // tiles a temporal row, tiles, 256-column strips
  int stages, units, nr;      // ring stages, row units (a power of 2), slab rows a k-block
                              // touches at most
  int unit_shift;             // log2(units)
  int rows_off, misc_off, table_off, extra_off;   // byte offsets in the aligned dynamic buffer
  int bulk;                   // rows by bulk copies (16-byte rows and base)
  float eps;
};

// This block's tile.
struct Tile {
  int ti, h0;    // temporal row, first slab row
  int slabs;     // slab rows inside the volume: 0 for the partner of an odd last tile
  int n0;        // first output column
  int rank;      // in the cluster
};

extern __shared__ __align__(16) unsigned char patch_smem[];

__device__ __forceinline__ unsigned char* smem_base() {
  const uint32_t a = hopper::smem_u32(patch_smem);
  return patch_smem + ((1024u - (a & 1023u)) & 1023u);
}

// blocks 2k, 2k + 1 form a cluster; block x holds tile 2 (x / 2 / strips) +
// x % 2 and strip x / 2 % strips
__device__ __forceinline__ Tile tile_of(const Geometry& g) {
  const int x = static_cast<int>(blockIdx.x);
  const int rank = x & 1;
  const int strip = (x >> 1) % g.strips;
  const int tile = ((x >> 1) / g.strips) * 2 + rank;
  Tile t{0, 0, 0, strip * kCols, rank};
  if (tile < g.tiles) {
    t.ti = tile / g.tiles_h;
    t.h0 = (tile - t.ti * g.tiles_h) * kSlabs;
    t.slabs = min(kSlabs, g.h - t.h0);
  }
  return t;
}

// the slab rows [r_a, r_b] that k-block kb touches
__device__ __forceinline__ int first_row(const Geometry& g, int kb) { return kb * kKB / g.p2; }
__device__ __forceinline__ int last_row(const Geometry& g, int kb) {
  return min(g.rows - 1, (kb * kKB + kKB - 1) / g.p2);
}

// The table of divisions by p2, filled once a block: (r_a, r_b) of each
// k-block, then (slab row, column) of each feature 8i; the staging's loop
// divides nothing.
__host__ __device__ inline int table_bytes(int n_kb) { return n_kb * 9 * 8; }

// source row of slab s, slab row r
__device__ __forceinline__ long long source_row(const Geometry& g, const Tile& t, int s, int r) {
  return static_cast<long long>(t.ti * g.pt + r / g.p1) * g.frame_rows + (t.h0 + s) * g.p1 +
         r % g.p1;
}

// The row ring: unit r % units holds slab row r of every slab of the tile,
// slab s's source row at rows[((r % units) kSlabs + s) L]; units is a
// power of 2, so r % units is a mask.
__device__ __forceinline__ int unit_row(const Geometry& g, int r, int s) {
  return ((r & (g.units - 1)) * kSlabs + s) * g.L;
}

// slab rows [r_a, r_b] into their units by the staging threads' plain loads
// (rows of any length)
__device__ __forceinline__ void copy_rows(const Geometry& g, const Tile& t, int r_a, int r_b,
                                          __nv_bfloat16* rows, int st) {
  const int nr = r_b - r_a + 1;
  for (int e = st; e < t.slabs * nr * g.L; e += kStageThreads) {
    const int q = e / g.L;                      // rr * slabs + s
    const int col = e - q * g.L;
    const int rr = q / t.slabs, s = q - rr * t.slabs;
    rows[unit_row(g, r_a + rr, s) + col] = g.src[source_row(g, t, s, r_a + rr) * g.L + col];
  }
}

// The ring's stage and the parity of its current pass, stepped once a
// k-block (no division in the loops).
struct Cursor {
  int s = 0, phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++s == stages) s = 0, phase ^= 1;
  }
};

// a consumer warp is done with stage s: its arrival on the stage's empty
// barrier in both blocks of the cluster
__device__ __forceinline__ void release(uint64_t* empty, int rank) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    hopper::mbar_arrive(empty);
    hopper::mbar_arrive_remote(empty, rank ^ 1);
  }
}

// Run the block.  `stage.setup(extra, g, tile)` is called by every thread
// before the ring starts (K9 fills its tables in `extra`);
// `stage.form(extra, g, tile, kb, rc, rows, wi, q, btile, sum, sq)` by
// staging task (wi, q) for each k-block kb, rc the (slab row, column) of
// its first feature 64 kb + 8 q, the k-block's slab rows in the row ring
// `rows` (unit_row): it writes the 16-byte chunk q of patch
// s * w + wi's row of btile for every slab row s < kSlabs (zeros for s >=
// tile.slabs and for features past pd) and adds to sum[s], sq[s] the sums of
// the values the statistics see.  tk: kmat (pd, dim) bf16 in boxes of 64
// columns x 64 rows, 128-byte swizzle.
template <bool kClampVariance, class Stage>
__device__ __forceinline__ void run(const CUtensorMap* tk, const Geometry& g, const Stage& stage) {
  unsigned char* base = smem_base();
  const int n_kb = (g.pd + kKB - 1) / kKB;
  unsigned char* ring = base;
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(base + g.rows_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + g.misc_off);
  uint64_t* empty = full + kMaxStages;
  uint64_t* ufull = empty + kMaxStages;   // a unit's rows are in
  uint64_t* uempty = ufull + kMaxUnits;   // every task is done with a unit
  float2* part = reinterpret_cast<float2*>(base + g.misc_off + kBarBytes);   // [patch][q]
  float2* stat = part + kN * 8;                                              // (rsig, mu rsig)
  int2* kb_rows = reinterpret_cast<int2*>(base + g.table_off);               // [kb] (r_a, r_b)
  int2* feat_rc = kb_rows + (g.pd + kKB - 1) / kKB;                          // [f / 8] (r, c)
  unsigned char* extra = base + g.extra_off;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // the warp's index through a shuffle, so the compiler knows every role
  // branch below is warp-uniform (wgmma in code it takes for divergent is
  // serialized)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const Tile tile = tile_of(g);

  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      hopper::mbar_init(&full[s], kStageWarps + 1);
      hopper::mbar_init(&empty[s], 16);
    }
    for (int u = 0; u < g.units; ++u) {
      hopper::mbar_init(&ufull[u], 1);
      hopper::mbar_init(&uempty[u], kStageWarps);
    }
    hopper::mbar_init_fence();
  }
  stage.setup(extra, g, tile);
  for (int i = tid; i < n_kb * 9; i += kThreads) {
    if (i < n_kb) {
      kb_rows[i] = make_int2(first_row(g, i), last_row(g, i));
    } else {
      const int f = 8 * (i - n_kb), r = f / g.p2;
      feat_rc[i - n_kb] = make_int2(r, f - r * g.p2);
    }
  }
  // patch rows past the tile's stay zero in every stage
  for (int e = tid; e < g.stages * (kN - kSlabs * g.w) * 8; e += kThreads) {
    const int s = e / ((kN - kSlabs * g.w) * 8);
    const int rem = e - s * (kN - kSlabs * g.w) * 8;
    *reinterpret_cast<uint4*>(ring + s * kStageBytes + kABytes + (kSlabs * g.w) * 128 +
                              rem * 16) = make_uint4(0, 0, 0, 0);
  }
  hopper::fence_proxy_async();
  hopper::cluster_sync();   // both blocks' barriers exist before any copy or arrival

  if (warp >= kProducer0 / 32) {
    // ---------------------------------------------------------------- copies
    // The producer warp polls both duties in step (lane 0 tests the
    // barriers, the warp follows): the window's boxes of each k-block, this
    // block's half (2 at dim 128, else 4) multicast to both blocks once both
    // blocks' consumers freed the stage; and the slab rows in order, each as
    // soon as the staging released its unit, lane s copying slab s's source
    // row (its pointer stepped a row at a time: the rows of a frame are
    // contiguous, the next frame H - p1 rows on).
    const int boxes = min(4, (g.dim - tile.n0) / 64);
    const int n_rows = g.bulk ? g.rows : 0;
    const uint32_t row_bytes = static_cast<uint32_t>(g.L) * 2;
    const __nv_bfloat16* src =
        lane < tile.slabs ? g.src + source_row(g, tile, lane, 0) * g.L : g.src;
    Cursor at;
    for (int kb = 0, r = 0, r_in = 0; kb < n_kb || r < n_rows;) {
      if (kb < n_kb &&
          __shfl_sync(0xffffffffu, hopper::mbar_test_wait(&empty[at.s], at.phase ^ 1), 0)) {
        if (lane == 0) {
          unsigned char* stg = ring + at.s * kStageBytes;
          hopper::mbar_arrive_expect_tx(&full[at.s], boxes * kBox);
          for (int b = tile.rank * boxes / 2; b < (tile.rank + 1) * boxes / 2; ++b)
            hopper::tma_load_2d_multicast(stg + b * kBox, tk, tile.n0 + 64 * b, kb * kKB,
                                          &full[at.s], 0x3);
        }
        ++kb;
        at.next(g.stages);
      }
      if (r < n_rows) {
        const int u = r & (g.units - 1);
        if (__shfl_sync(0xffffffffu,
                        hopper::mbar_test_wait(&uempty[u], ((r >> g.unit_shift) & 1) ^ 1), 0)) {
          if (lane == 0) hopper::mbar_arrive_expect_tx(&ufull[u], tile.slabs * row_bytes);
          if (lane < tile.slabs)
            hopper::bulk_load(rows + unit_row(g, r, lane), src, row_bytes, &ufull[u]);
          src += (++r_in == g.p1 ? (r_in = 0, g.frame_rows - g.p1 + 1) : 1) * g.L;
          ++r;
        }
      }
    }
    __syncthreads();   // the statistics are written, the ring is idle
    __syncthreads();   // the output tile is written
  } else if (warp < kConsumer0 / 32 || warp >= (kConsumer0 + 256) / 32) {
    // ---------------------------------------------------------------- staging
    const int st = tid < kConsumer0 ? tid : tid - 256;
    const int wi = st >> 3, q = st & 7;
    const bool task = wi < g.w;
    float sum[kSlabs], sq[kSlabs];
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) sum[s] = sq[s] = 0.f;
    Cursor at;
    for (int kb = 0; kb < n_kb; ++kb, at.next(g.stages)) {
      const int s = at.s;
      const int r_a = kb_rows[kb].x, r_b = kb_rows[kb].y;
      unsigned char* stg = ring + s * kStageBytes;
      hopper::mbar_wait(&empty[s], at.phase ^ 1);
      if (g.bulk) {
        for (int r = r_a; r <= r_b; ++r)
          hopper::mbar_wait(&ufull[r & (g.units - 1)], (r >> g.unit_shift) & 1);
      } else {
        copy_rows(g, tile, r_a, r_b, rows, st);
        hopper::named_barrier(1, kStageThreads);
      }
      if (task)
        stage.form(extra, g, tile, kb, feat_rc[8 * kb + q], rows, wi, q, stg + kABytes, sum, sq);
      hopper::fence_proxy_async();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&full[s]);
      if (g.bulk) {
        // the units the next k-block does not read
        const int r_next = kb + 1 < n_kb ? kb_rows[kb + 1].x : g.rows;
        if (lane == 0)
          for (int r = r_a; r < r_next; ++r) hopper::mbar_arrive(&uempty[r & (g.units - 1)]);
      } else {
        hopper::named_barrier(1, kStageThreads);   // every task is done with the rows
      }
    }
    if (task)
#pragma unroll
      for (int s = 0; s < kSlabs; ++s) part[(s * g.w + wi) * 8 + q] = make_float2(sum[s], sq[s]);
    hopper::named_barrier(1, kStageThreads);
    for (int m = st; m < kSlabs * g.w; m += kStageThreads) {
      float su = 0.f, sqq = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        su += part[m * 8 + c].x;
        sqq += part[m * 8 + c].y;
      }
      const float mu = su / g.pd;
      float var = sqq / g.pd - mu * mu;
      if (kClampVariance) var = fmaxf(var, 0.f);
      const float rs = rsqrtf(var + g.eps);
      stat[m] = make_float2(rs, mu * rs);
    }
    __syncthreads();   // the statistics are written, the ring is idle
    __syncthreads();   // the output tile is written
  } else {
    // ---------------------------------------------------------------- consumers
    const int c = (warp - kConsumer0 / 32) >> 2;   // columns [128 c, 128 c + 128) of the strip
    const bool live = tile.n0 + 128 * c < g.dim;
    float acc[2][48];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 48; ++r) acc[i][r] = 0.f;
    Cursor at;
    if (!live) {   // past dim: the stages are only released
      for (int kb = 0; kb < n_kb; ++kb, at.next(g.stages)) {
        hopper::mbar_wait(&full[at.s], at.phase);
        release(&empty[at.s], tile.rank);
      }
    }
    int prev = 0;   // the stage whose products are still in flight
    for (int kb = 0; live && kb < n_kb; ++kb, at.next(g.stages)) {
      const int s = at.s;
      hopper::mbar_wait(&full[s], at.phase);
      const unsigned char* stg = ring + s * kStageBytes;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKB / 16; ++kk) {
        const uint64_t db = hopper::desc_sw128(stg + kABytes + 32 * kk);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          hopper::wgmma_bf16_ss_n96_ta(acc[i], hopper::desc_mn_sw128(stg + (2 * c + i) * kBox +
                                                                     2048 * kk),
                                       db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();   // the previous stage's products are done
      if (kb > 0) release(&empty[prev], tile.rank);
      prev = s;
    }
    if (live) {
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 2; ++i) hopper::fence_regs(acc[i]);
      release(&empty[prev], tile.rank);
    }
    __syncthreads();   // the statistics are written, the ring is idle
    if (live) {
      // register r of tile i: column 128 c + 64 i + 16 w + g + 8 ((r / 2) % 2)
      // of the strip, patch 8 (r / 4) + 2 t + r % 2
      const int w = warp & 3;
      const int gq = lane >> 2, t4 = lane & 3;
      __nv_bfloat16* ot = reinterpret_cast<__nv_bfloat16*>(ring);   // [kN][kOutPitch]
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col0 = 128 * c + 64 * i + 16 * w + gq;
        const float v2a = g.v2[tile.n0 + col0], v2b = g.v2[tile.n0 + col0 + 8];
#pragma unroll
        for (int r = 0; r < 48; ++r) {
          const int p = 8 * (r >> 2) + 2 * t4 + (r & 1);
          const int col = col0 + 8 * ((r >> 1) & 1);
          const float2 sr = stat[p];
          ot[p * kOutPitch + col] =
              __float2bfloat16(sr.x * acc[i][r] - sr.y * ((r >> 1) & 1 ? v2b : v2a));
        }
      }
    }
    __syncthreads();   // the output tile is written
  }

  // the output tile's rows of the tile's patches, 16 bytes at a time
  const int chunks = min(kCols, g.dim - tile.n0) / 8;
  const __nv_bfloat16* ot = reinterpret_cast<const __nv_bfloat16*>(ring);
  for (int e = tid; e < tile.slabs * g.w * chunks; e += kThreads) {
    const int m = e / chunks, ch = e - m * chunks;
    const int s = m / g.w, wi = m - s * g.w;
    const long long row = (static_cast<long long>(tile.ti) * g.h + tile.h0 + s) * g.w + wi;
    *reinterpret_cast<uint4*>(g.out + row * g.dim + tile.n0 + 8 * ch) =
        *reinterpret_cast<const uint4*>(ot + m * kOutPitch + 8 * ch);
  }
  hopper::cluster_sync();   // the partner's last arrivals on this block's barriers are done
}

// ------------------------------------------------------------------ host

// Fill g's tiling and shared-memory layout for `extra` bytes of the Stage's
// tables; false where no layout fits the card's shared memory.  The ring
// takes 4, 3 or 2 stages, the first that leaves room for the units of a
// k-block's slab rows and 8 more (about 2.5 k-blocks of lookahead at p2 20),
// else the first with room for one k-block's; units is a power of 2.
inline bool plan(Geometry& g, int extra, int smem_max) {
  g.rows = g.pt * g.p1;
  g.pd = g.rows * g.p2;
  g.tiles_h = (g.h + kSlabs - 1) / kSlabs;
  g.tiles = g.t * g.tiles_h;
  g.strips = (g.dim + kCols - 1) / kCols;
  g.nr = 0;
  for (int kb = 0; kb * kKB < g.pd; ++kb)
    g.nr = max(g.nr, min(g.rows - 1, (kb * kKB + kKB - 1) / g.p2) - kb * kKB / g.p2 + 1);
  const int unit_bytes = kSlabs * g.L * 2;
  const int want = g.nr + 8;
  const int table = table_bytes((g.pd + kKB - 1) / kKB);
  for (int need : {want, g.nr}) {
    for (int stages = kMaxStages; stages >= 2; --stages) {
      const int room = smem_max - 1024 - 256 - stages * kStageBytes - kMiscBytes - table - extra;
      int units = kMaxUnits;   // the largest power of 2 that fits
      while (units > 1 && units * unit_bytes > room) units /= 2;
      if (units >= need) {
        g.stages = stages;
        g.units = units;
        for (g.unit_shift = 0; 1 << g.unit_shift < units; ++g.unit_shift) {
        }
        g.rows_off = stages * kStageBytes;
        g.misc_off = (g.rows_off + units * unit_bytes + 127) / 128 * 128;
        g.table_off = g.misc_off + kMiscBytes;
        g.extra_off = (g.table_off + table + 127) / 128 * 128;   // K9's 16-byte taps
        return 1024 + g.extra_off + extra <= smem_max;
      }
    }
  }
  return false;
}

inline int smem_bytes(const Geometry& g, int extra) { return 1024 + g.extra_off + extra; }

// The launch on `st`: the tensor map of kmat, the layout, and the grid in
// clusters of 2.  cudaSuccess, the launch's error, or cudaErrorInvalidValue
// where kmat's map cannot be made or no layout fits.
template <class Kernel, class Stage>
cudaError_t launch(Kernel kernel, Geometry g, const __nv_bfloat16* kmat, const Stage& stage,
                   int extra, cudaStream_t st) {
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (!plan(g, extra, smem_max)) return cudaErrorInvalidValue;
  g.bulk = g.L * 2 % 16 == 0 && reinterpret_cast<uintptr_t>(g.src) % 16 == 0;
  CUtensorMap tk;
  if (hopper::encode_2d(&tk, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, kmat, static_cast<uint64_t>(g.dim),
                        static_cast<uint64_t>(g.pd), static_cast<uint64_t>(g.dim) * 2, 64, kKB,
                        CU_TENSOR_MAP_SWIZZLE_128B) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int smem = smem_bytes(g, extra);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * ((g.tiles + 1) / 2) * g.strips);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, tk, g, stage);
}

}  // namespace
}  // namespace patch_wgmma
