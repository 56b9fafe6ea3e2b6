// The PTX that the tensor-core attention body (attention_tc.cuh) issues,
// each instruction in a small device function of its own: the m16n8k16
// bf16 product with f32 accumulation (mma.sync), the 8x8 shared-memory
// matrix loads that feed it (ldmatrix, plain and transposed), the 16- and
// 4-byte asynchronous copies from global to shared memory with their
// commit and wait (cp.async), the bf16 pair that turns two f32
// accumulators back into an operand, and the SFU's 2^x.  Keeping them
// here, and nothing else, lets the CPU build of the kernels
// (tests/test_torch_kernel_emulation.py) stand in for exactly these
// functions with warp-collective emulations of the same register layouts.
//
// Operand layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// lane = 4 g + c:
//   A (16 x 16, row-major), four b32 registers of two bf16 each:
//     a0 row g, cols 2c, 2c+1      a1 row g+8, cols 2c, 2c+1
//     a2 row g, cols 2c+8, 2c+9    a3 row g+8, cols 2c+8, 2c+9
//   B (16 x 8, k x n), two registers: b0 rows 2c, 2c+1 of column g,
//     b1 rows 2c+8, 2c+9 of column g
//   C, D (16 x 8, f32): d0, d1 row g, cols 2c, 2c+1; d2, d3 row g+8
// The lower-indexed element of a pair sits in the lower 16 bits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a b: one m16n8k16 product, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: lane 8 i + j gives the
// address of row j of matrix i; register i of lane 4 g + c holds row g,
// cols 2c, 2c+1 of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

// The same, transposed: register i of lane 4 g + c holds rows 2c, 2c+1 of
// column g of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

// 16 bytes global -> shared, bypassing L1; zeros when !valid (the source
// is then not read).  Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Closes the group of copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 2^x on the special function unit (ex2.approx: relative error ~2^-22,
// results below 2^-126 flushed to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to bf16 and packed, lo in the lower 16 bits.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace tc
