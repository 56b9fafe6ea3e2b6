// Device helpers shared by the port's attention kernels (the paged pair in
// paged_attention.cuh, decode_attention.cu and flash_attention.cu) and the
// selective scan (selective_scan.cu): the finite NEG_INF of the TPU
// kernels, the dtype codes of the C interface, loads upcast to f32, stores
// rounded to the output's type, and a launch that raises the block's
// dynamic shared memory limit where it needs more than the default 48 KB.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// REPRO_TRIP(name) heads the body of every loop that the instruction
// census scales by its trip count (core/sass_counters.py, count_looped;
// the trip models beside the wrappers name the loops).  It expands to
// nothing here; the CPU emulation of these sources defines it to count
// each thread's iterations.
#ifndef REPRO_TRIP
#define REPRO_TRIP(name)
#endif

namespace attn {

// The TPU kernels' finite NEG_INF: a row whose first tile is fully masked
// for it takes p = 1 there, and the next live tile cancels that through
// corr = 0; with -inf that case would be NaN.
constexpr float kNegInf = -1e30f;

// dtype codes shared with the Python wrappers (kernels/build.py)
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store_f32(float* p, size_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i,
                                          float x) {
  p[i] = __float2bfloat16_rn(x);
}

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// Runs kernel<<<grid, threads, smem, stream>>>(p) after raising the
// block's dynamic shared memory limit where it needs more than 48 KB, and
// returns the launch's cudaGetLastError().
template <typename Kernel, typename P>
cudaError_t launch_smem(Kernel kernel, dim3 grid, int threads, size_t smem,
                        cudaStream_t stream, const P& p) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace attn
