// Hopper (sm_90a) primitives in inline PTX for the kernels that load their
// tiles with the Tensor Memory Accelerator (TMA) and multiply them with
// warpgroup MMA (wgmma): the prefill kernels of the quantized projections
// and FFNs (prefill_wgmma.cuh, for int8_matmul.cu, int4_matmul.cu,
// int8_ffn.cu and int4_ffn.cu), the patch-embed projection of K1 and K9
// (patch_wgmma.cuh, for patchify.cu and resample_patchify.cu) and the
// split-KV decode attention of K8 (decode_attention.cu: bulk copies,
// mbarriers, cluster barriers and distributed shared memory).
//
// mbarrier: a barrier in shared memory that counts arrivals and the bytes of
// the TMA copies bound to it (`expect_tx`, `complete_tx`); a phase
// completes when both reach zero, and `try_wait.parity` with parity P
// returns true once the phase of parity P has completed (so on a fresh
// barrier a wait with parity 1 passes at once).
//
// TMA: `cp.async.bulk.tensor.2d` copies one box of a 2-D tensor, described
// by a CUtensorMap made on the host (encode_2d), into shared memory, filling
// the elements outside the tensor with zeros, and adds the box's bytes to
// the mbarrier.  With CU_TENSOR_MAP_SWIZZLE_128B a box whose rows are 128
// bytes lands as rows of 128 bytes whose 16-byte chunks are permuted: chunk
// c of row r sits at chunk c ^ (r % 8) (`swizzle128`), the destination
// 1024-byte aligned.
//
// wgmma, register-A ("RS") form: a warpgroup (four warps, 128 threads)
// computes D (64 x N) += A (64 x K) . B (K x N), A from registers, B from
// shared memory through a matrix descriptor, D in registers.  Warp w of the
// warpgroup holds rows 16w .. 16w + 15 of A and D.  With g = lane / 4 and t
// = lane % 4, a warp's share of A has the layout of mma.sync's A fragment
// (PTX ISA, "Register fragments: matrix A" of wgmma .m64nNk16 / .m64nNk32;
// CUTLASS's SM90 ALayout_64x16 / ALayout_64x32 say the same):
//
//   bf16, K 16:  a[0] = A[g][2t, 2t+1]      a[1] = A[g+8][2t, 2t+1]
//                a[2] = A[g][2t+8, 2t+9]    a[3] = A[g+8][2t+8, 2t+9]
//   s8, K 32:    a[0] = A[g][4t .. 4t+3]    a[1] = A[g+8][4t .. 4t+3]
//                a[2] = A[g][4t+16 .. +19]  a[3] = A[g+8][4t+16 .. +19]
//
// (rows relative to the warp's 16, the lower k in the lower bits), and D's
// register r holds D[g + 8 ((r / 2) % 2)][8 (r / 4) + 2t + r % 2].  B is
// K-major (each of its N rows holds its K values contiguously: a token's
// row of x) in the 128-byte swizzle: N rows of 128 bytes, eight-row groups
// 1024 bytes apart; the descriptor (desc_sw128) points at the first k of
// the step, 32 bytes (16 bf16, 32 s8) on for each k-step inside the row.
// Shared-memory ("SS") form with a transposed A (wgmma_bf16_ss_n96_ta): A
// is read through a descriptor too, M-major (each k row holds 64 values of
// M in 128 bytes, 128-byte swizzle, eight-row groups 1024 bytes apart:
// desc_mn_sw128), as a TMA box of a row-major (K, M) matrix lands.
//
// Thread-block clusters: a TMA copy with `.multicast::cluster` lands at the
// same shared-memory offset in every block of its mask and completes bytes
// on the mbarrier at the same offset in each; `mbar_arrive_remote` arrives
// on the mbarrier at this block's offset in another block of the cluster
// (mapa); `ld_cluster_f32` reads a float at this block's offset in another
// block's shared memory; `cluster_sync` is a barrier over every thread of
// the cluster (release and acquire: shared-memory writes before it are seen
// by reads after it anywhere in the cluster).
//
// The accumulators are used as "+f"/"+r" operands, so successive wgmma on
// one accumulator need no wait; `wgmma_fence` orders register writes
// (A fragments, zeroed accumulators) before the next wgmma, and
// `fence_regs` after `wgmma_wait` keeps the compiler from reading an
// accumulator before the wait.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {
namespace {  // each kernel source gets its own copy

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// this thread's arrival, after adding `bytes` to the copies the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// as mbar_try_wait, but never suspends the thread
__device__ __forceinline__ bool mbar_test_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ------------------------------------------------------------------ TMA

// box (c0, c1) of the tensor `map` (c0 the inner coordinate, in elements)
// into shared memory at dst, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// as tma_load_2d, the box landing in every block of the cluster whose bit is
// set in `mask`, each block's barrier at the same offset taking its bytes
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map, int c0,
                                                      int c1, uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// `bytes` contiguous bytes of device memory into shared memory (both
// addresses and the size multiples of 16), completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// an arrival on the barrier at bar's offset in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// the float at p's offset in the shared memory of block `rank` of the
// cluster (distributed shared memory)
__device__ __forceinline__ float ld_cluster_f32(const float* p, uint32_t rank) {
  float v;
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %1, %2;\n"
      "ld.shared::cluster.f32 %0, [remote];\n}\n"
      : "=f"(v)
      : "r"(smem_u32(p)), "r"(rank)
      : "memory");
  return v;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// the byte offset of byte c (0-127) of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int swizzle128(int r, int c) {
  return r * 128 + ((((c >> 4) ^ r) & 7) << 4) + (c & 15);
}

// orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of them (wgmma's B operand), as TMA's own writes are
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ wgmma

// a K-major B tile in the 128-byte swizzle starting at p (the step's first
// k): start address >> 4, leading offset 1 (unused in this layout), stride
// 1024 bytes between eight-row groups, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return ((static_cast<uint64_t>(smem_u32(p)) & 0x3FFFFu) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// an M-major A tile in the 128-byte swizzle starting at p (the step's first
// k row): start address >> 4, leading offset 8192 bytes (the next 64 values
// of M, unused at M 64), stride 1024 bytes between eight-row groups of k,
// layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc_mn_sw128(const void* p) {
  return ((static_cast<uint64_t>(smem_u32(p)) & 0x3FFFFu) >> 4) | (512ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_bf16_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 96) += A . B, both from shared memory through descriptors, A
// M-major (desc_mn_sw128, the transpose bit set), B K-major (desc_sw128);
// bf16 in, fp32 sums
__device__ __forceinline__ void wgmma_bf16_ss_n96_ta(float (&d)[48], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

// D (64 x N) += A . B: bf16 in, fp32 sums (K 16), or s8 in, exact s32 sums
// (K 32); N 32, 64 or 128
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (N == 128) {
    wgmma_bf16_n128(d, a, b);
  } else if constexpr (N == 64) {
    wgmma_bf16_n64(d, a, b);
  } else {
    static_assert(N == 32, "N is 32, 64 or 128");
    wgmma_bf16_n32(d, a, b);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 128) {
    wgmma_s8_n128(d, a, b);
  } else if constexpr (N == 64) {
    wgmma_s8_n64(d, a, b);
  } else {
    static_assert(N == 32, "N is 32, 64 or 128");
    wgmma_s8_n32(d, a, b);
  }
}

// ------------------------------------------------------------------ warpgroups

// a warpgroup gives up registers (the producer) or takes them (the consumers)
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// a barrier of `count` threads (a multiple of 32) under id 1-15; id 0 is
// __syncthreads'
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled is a driver-API call: it is reached through the
// runtime's cudaGetDriverEntryPoint[ByVersion], so the library needs no
// -lcuda.  A 2-D tensor of `outer` rows of `inner` elements, `stride` bytes
// apart, cut into boxes of box_outer rows of box_inner elements; elements
// outside the tensor read as zero.  CUDA_SUCCESS or the driver's error.
inline CUresult encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                          uint64_t inner, uint64_t outer, uint64_t stride, uint32_t box_inner,
                          uint32_t box_outer, CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || fn == nullptr)
      return CUDA_ERROR_NOT_FOUND;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace
}  // namespace hopper
