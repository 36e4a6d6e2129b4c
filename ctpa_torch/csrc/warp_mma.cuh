// Warp-level tensor-core, shared-memory and asynchronous-copy primitives
// (inline PTX, sm_80 and later), for the kernels that hold their matrix
// tiles in registers (the bf16 forward and backward of flash attention,
// flash_attention.cu and flash_attention_bwd.cu; the int4 projection at
// decode, int4_matmul.cu).
//
// mma_bf16_16816 is `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`:
// D (16 x 8, fp32) = A (16 x 16, bf16) . B (16 x 8, bf16) + C, the operands
// spread over the 32 lanes of a warp.  With g = lane / 4 and t = lane % 4,
// each 32-bit register holding two bf16 values, the lower column (or row of
// B) in its low half:
//
//   A: a[0] = A[g][2t, 2t+1]      a[1] = A[g+8][2t, 2t+1]
//      a[2] = A[g][2t+8, 2t+9]    a[3] = A[g+8][2t+8, 2t+9]
//   B: b[0] = B[2t, 2t+1][g]      b[1] = B[2t+8, 2t+9][g]
//   C, D: c[0], c[1] = C[g][2t, 2t+1]    c[2], c[3] = C[g+8][2t, 2t+1]
//
// so a row of C is held by the four lanes of a quad (lanes 4g .. 4g+3), and
// two C tiles side by side are, rounded to bf16, the A operand of the next
// product over their 16 columns.
//
// ldsm_x4 is `ldmatrix.sync.aligned.m8n8.x4.shared.b16`: four 8 x 8 bf16
// matrices from shared memory, the rows of matrix i at the addresses that
// lanes 8i .. 8i+7 give (16 bytes each, 16-byte aligned); lane l receives in
// r[i] row l / 4, columns 2(l % 4) and 2(l % 4) + 1 of matrix i: a B
// fragment register when the matrix rows are B's columns (a K tile for
// S = Q K^T).  ldsm_x4_trans (`.trans`) gives the transposed matrices: row
// 2(l % 4) and 2(l % 4) + 1 of column l / 4, the B fragment of a row-major
// B (a V tile for O = P V).
//
// cp_async16 copies 16 bytes from device to shared memory without holding a
// register (`cp.async.cg`, through L2 only); with src_bytes 0 it reads
// nothing and writes 16 zero bytes.  Copies started since the last
// cp_async_commit form one group; cp_async_wait<N> returns once at most N
// of this thread's groups are still in flight.  A __syncthreads after the
// wait publishes the copies to the other threads.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace warp_mma {

// two floats as a bf16 pair, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += A . B
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A . B on int8: `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`,
// D (16 x 8, int32) = A (16 x 32, s8) . B (32 x 8, s8) + C, four int8 values
// to a register, the lowest k in the low byte:
//
//   A: a[0] = A[g][4t .. 4t+3]        a[1] = A[g+8][4t .. 4t+3]
//      a[2] = A[g][4t+16 .. 4t+19]    a[3] = A[g+8][4t+16 .. 4t+19]
//   B: b[0] = B[4t .. 4t+3][g]        b[1] = B[4t+16 .. 4t+19][g]
//   C, D as for mma_bf16_16816.
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem_row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 2^x by the special-function unit (`ex2.approx.ftz`: relative error about
// 2^-22, 0 for -inf, subnormal results flushed to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(gmem), "r"(src_bytes)
               : "memory");
}

// 4 bytes (`cp.async.ca`: the 4- and 8-byte forms go through L1), zero
// filled with src_bytes 0: one fp32 value of a row vector
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(dst), "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace warp_mma
