// BabelStream's five kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of src/repro/kernels/stream/stream.py:
//   copy  (_copy_kernel)   c = a
//   mul   (_mul_kernel)    b = s * c
//   add   (_add_kernel)    c = a + b
//   triad (_triad_kernel)  a = b + s * c
//   dot   (_dot_kernel)    sum(a * b), accumulated in f32
// over contiguous f32 or bf16 arrays of n elements (the wrappers flatten
// the JAX kernels' (rows, cols) arrays).  Their use is to measure the
// card: copy's rate is the memory ceiling of the instruction roofline
// (paper section 6.2), and every kernel is a point on it.
//
// What bounds them on this card: bytes.  Copy moves 8 bytes per f32
// element and does no arithmetic; triad, the busiest, does 2 flops for
// 12 bytes — far below the ~20 flops per byte at which the H100's f32
// CUDA cores (67 TFLOP/s) rather than its 3.35 TB/s of HBM would be the
// limit.  The layout is BabelStream-CUDA's, not the Pallas blocks carried
// over: one element per thread over the flattened array, 1024-thread
// blocks, a bounds guard so any n works, and enough blocks (32768 at
// BabelStream's 2^25 elements) to fill every SM.
//
// What holds copy, mul, add and triad back: one 4-byte (f32) or 2-byte
// (bf16) load per thread.  An SM holds at most 2048 threads, so it keeps
// at most 8 KB of f32 loads in flight, about half of what HBM's latency
// asks for at full rate; f32 copy measures ~56% of the data sheet's 3.35
// TB/s (PERF.md), where BabelStream's f64 default moves twice the bytes
// per thread.  Their vector form is the next step.
//
// dot has it already: each thread takes kPer = 32 elements of each array
// in 16-byte loads (eight of f32, four of bf16, per array), a warp's load
// reading 512 neighbouring bytes, in blocks of kDotThreads = 256, so a
// block sums 8192 products and 2^25 elements take 4096 blocks; the f32
// partials are summed by stream_sum_f32 the same way, so 2^25 takes two
// launches (2^25 -> 4096 -> 1).  Small blocks with many bytes per thread
// keep several blocks loading on each SM while another one reduces.  The
// arrays' base must be 16-byte aligned (the wrapper refuses others).
// Each 16-byte vector is read only when it lies wholly in range; the
// elements past the last whole vector (n % 8 of bf16, n % 4 of f32) are
// the ragged tail, which global thread j adds through a guarded scalar
// load.  So the code has no loop and only forward branches.
//
// Two rules keep the results reproducible and the instruction census
// (repro_torch/core/sass_counters.py) exact:
//   * Round where the JAX kernels round.  Each operation is done in f32
//     with an explicit rounding intrinsic and rounded to the array's type
//     on its own: triad rounds s * c before adding b (two roundings, as
//     _triad_kernel and the plain version do), and nvcc may not contract
//     the pair into one FMA.  copy, mul, add and triad are then
//     bit-identical to their plain versions.  The scalar arrives already
//     rounded to the array's type (the wrapper does it, as JAX does).
//   * No loop, no atomic, and one straight-line path for every warp.  dot
//     sums each thread's 32 products (and its tail product) in a fixed
//     tree, the block's 256 thread sums with warp shuffles, the 8 warp
//     partials through shared memory, and a last 32-way shuffle (zeros
//     past the 8) that every warp runs.  Lane 0 of every warp then stores the block's sum — the
//     same value, bit for bit, from each warp.  Were thread 0 alone to
//     store, nvcc would end the other warps with an early EXIT before it
//     (52 instructions against warp 0's 58, in the first build's SASS),
//     and the census's one path per kernel would no longer be every warp's.
//     The block partials are summed by relaunching the f32 sum kernel until
//     one value is left (2^25 -> 4096 -> 1), so the order of every
//     addition is fixed and the sum is the same on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;               // BabelStream-CUDA's TBSIZE
constexpr int kWarp = 32;
constexpr int kDotThreads = 256;             // dot and sum: their blocks
constexpr int kDotWarps = kDotThreads / kWarp;
constexpr int kPer = 32;                     // ... and elements a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// f32 result of one operation, rounded to the array's type
template <typename T>
__device__ __forceinline__ T round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ long long element() {
  return (long long)blockIdx.x * kThreads + threadIdx.x;
}

template <typename T>
__device__ __forceinline__ void copy_at(const T* a, T* c, long long n) {
  const long long i = element();
  if (i < n) c[i] = a[i];
}

template <typename T>
__device__ __forceinline__ void mul_at(const T* c, T* b, float s,
                                       long long n) {
  const long long i = element();
  if (i < n) b[i] = round_to<T>(__fmul_rn(s, to_f32(c[i])));
}

template <typename T>
__device__ __forceinline__ void add_at(const T* a, const T* b, T* c,
                                       long long n) {
  const long long i = element();
  if (i < n) c[i] = round_to<T>(__fadd_rn(to_f32(a[i]), to_f32(b[i])));
}

template <typename T>
__device__ __forceinline__ void triad_at(const T* b, const T* c, T* a,
                                         float s, long long n) {
  const long long i = element();
  if (i < n) {
    const float sc = to_f32(round_to<T>(__fmul_rn(s, to_f32(c[i]))));
    a[i] = round_to<T>(__fadd_rn(to_f32(b[i]), sc));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// The block's kDotThreads terms summed into out[blockIdx.x].  Every warp
// runs every instruction (see the note at the top).
__device__ __forceinline__ void block_sum(float v, float* out) {
  extern __shared__ float smem[];            // kDotWarps warp partials
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  v = warp_sum(v);
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = warp_sum(lane < kDotWarps ? smem[lane] : 0.f);  // in every warp
  if (lane == 0) out[blockIdx.x] = v;
}

// 16 bytes of an array: 8 bf16 or 4 f32 values
template <typename T>
struct alignas(16) Pack {
  T e[16 / sizeof(T)];
};

// One element's term: the f32 product a[j] * b[j] for dot, the value
// a[j] for sum (kDot false: b is not read).
template <bool kDot, typename T>
__device__ __forceinline__ float term(T a, T b) {
  return kDot ? __fmul_rn(to_f32(a), to_f32(b)) : to_f32(a);
}

// x[j] += x[j + W] for j < W, then W / 2, ... down to 1: a fixed tree
// over 2 W terms, unrolled by the template (no loop is left to the SASS).
template <int W>
__device__ __forceinline__ void fold(float* x) {
#pragma unroll
  for (int j = 0; j < W; ++j) x[j] = __fadd_rn(x[j], x[j + W]);
  if constexpr (W > 1) fold<W / 2>(x);
}

// This thread's sum of kPer terms in a fixed tree.  Its c-th 16-byte
// vector starts at element blockIdx.x * kPer * kDotThreads + (c *
// kDotThreads + threadIdx.x) * E, so that each load of a warp reads 512
// neighbouring bytes; a vector is read only when all its E elements are
// in range, else its terms are 0.  Then (global threads j < n % E) the
// ragged tail's element n - n % E + j, which no whole vector holds, by a
// guarded scalar load.
template <bool kDot, typename T>
__device__ __forceinline__ float thread_sum(const T* a, const T* b,
                                            long long n) {
  constexpr int E = 16 / sizeof(T), kVecs = kPer / E;
  static_assert((kPer & (kPer - 1)) == 0, "the tree halves kPer terms");
  const long long first = (long long)blockIdx.x * kPer * kDotThreads
                          + (long long)threadIdx.x * E;
  float x[kPer];
#pragma unroll
  for (int c = 0; c < kVecs; ++c) {
    const long long i = first + (long long)c * kDotThreads * E;
#pragma unroll
    for (int j = 0; j < E; ++j) x[c * E + j] = 0.f;
    if (i + E <= n) {
      const Pack<T> va = *reinterpret_cast<const Pack<T>*>(a + i);
      const Pack<T> vb = kDot ? *reinterpret_cast<const Pack<T>*>(b + i)
                              : va;
#pragma unroll
      for (int j = 0; j < E; ++j) x[c * E + j] = term<kDot>(va.e[j], vb.e[j]);
    }
  }
  fold<kPer / 2>(x);
  const long long t = n - n % E
                      + (long long)blockIdx.x * kDotThreads + threadIdx.x;
  if (t < n) x[0] = __fadd_rn(x[0], term<kDot>(a[t], kDot ? b[t] : a[t]));
  return x[0];
}

template <typename T>
__device__ __forceinline__ void dot_at(const T* a, const T* b, float* out,
                                       long long n) {
  block_sum(thread_sum<true>(a, b, n), out);
}

__device__ __forceinline__ void sum_at(const float* x, float* out,
                                       long long n) {
  block_sum(thread_sum<false>(x, x, n), out);
}

}  // namespace

// The compiled kernels, one per operation and type, under C names so that
// the SASS census finds them as stream_<op>_<f32|bf16>.
#define STREAM_KERNELS(T, SFX)                                              \
  extern "C" __global__ void __launch_bounds__(kThreads)                    \
      stream_copy_##SFX(const T* a, T* c, long long n) {                    \
    copy_at(a, c, n);                                                       \
  }                                                                         \
  extern "C" __global__ void __launch_bounds__(kThreads)                    \
      stream_mul_##SFX(const T* c, T* b, float s, long long n) {            \
    mul_at(c, b, s, n);                                                     \
  }                                                                         \
  extern "C" __global__ void __launch_bounds__(kThreads)                    \
      stream_add_##SFX(const T* a, const T* b, T* c, long long n) {         \
    add_at(a, b, c, n);                                                     \
  }                                                                         \
  extern "C" __global__ void __launch_bounds__(kThreads)                    \
      stream_triad_##SFX(const T* b, const T* c, T* a, float s,             \
                         long long n) {                                     \
    triad_at(b, c, a, s, n);                                                \
  }                                                                         \
  extern "C" __global__ void __launch_bounds__(kDotThreads)                 \
      stream_dot_##SFX(const T* a, const T* b, float* out, long long n) {   \
    dot_at(a, b, out, n);                                                   \
  }

STREAM_KERNELS(float, f32)
STREAM_KERNELS(__nv_bfloat16, bf16)
#undef STREAM_KERNELS

extern "C" __global__ void __launch_bounds__(kDotThreads)
    stream_sum_f32(const float* x, float* out, long long n) {
  sum_at(x, out, n);
}

namespace {

// One launch of ceil(n / per) threads in blocks of `threads`: per = 1
// element a thread in blocks of kThreads, or kPer in blocks of
// kDotThreads for dot and sum.
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), long long n, int threads, int per,
                   size_t smem, void* stream, A... args) {
  const long long block = (long long)threads * per;
  const dim3 grid((unsigned)((n + block - 1) / block));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<grid, threads, smem, s>>>(args...);
  return cudaGetLastError();
}

// dtype codes of the C interface (kernels/build.py DTYPE_CODES)
constexpr int kF32 = 0, kBF16 = 1;

typedef __nv_bfloat16 bf16;

}  // namespace

// All pointers are device pointers to n contiguous elements of the dtype
// (0 = f32, 1 = bf16); out may alias an input.  Each returns the launch's
// cudaError_t (0 = launched).
extern "C" int stream_copy(const void* a, void* c, long long n, int dtype,
                           void* stream) {
  if (dtype == kF32)
    return launch(stream_copy_f32, n, kThreads, 1, 0, stream, (const float*)a,
                  (float*)c, n);
  if (dtype == kBF16)
    return launch(stream_copy_bf16, n, kThreads, 1, 0, stream, (const bf16*)a, (bf16*)c,
                  n);
  return cudaErrorInvalidValue;
}

extern "C" int stream_mul(const void* c, void* b, float s, long long n,
                          int dtype, void* stream) {
  if (dtype == kF32)
    return launch(stream_mul_f32, n, kThreads, 1, 0, stream, (const float*)c, (float*)b,
                  s, n);
  if (dtype == kBF16)
    return launch(stream_mul_bf16, n, kThreads, 1, 0, stream, (const bf16*)c, (bf16*)b,
                  s, n);
  return cudaErrorInvalidValue;
}

extern "C" int stream_add(const void* a, const void* b, void* c,
                          long long n, int dtype, void* stream) {
  if (dtype == kF32)
    return launch(stream_add_f32, n, kThreads, 1, 0, stream, (const float*)a,
                  (const float*)b, (float*)c, n);
  if (dtype == kBF16)
    return launch(stream_add_bf16, n, kThreads, 1, 0, stream, (const bf16*)a,
                  (const bf16*)b, (bf16*)c, n);
  return cudaErrorInvalidValue;
}

extern "C" int stream_triad(const void* b, const void* c, void* a, float s,
                            long long n, int dtype, void* stream) {
  if (dtype == kF32)
    return launch(stream_triad_f32, n, kThreads, 1, 0, stream, (const float*)b,
                  (const float*)c, (float*)a, s, n);
  if (dtype == kBF16)
    return launch(stream_triad_bf16, n, kThreads, 1, 0, stream, (const bf16*)b,
                  (const bf16*)c, (bf16*)a, s, n);
  return cudaErrorInvalidValue;
}

// The first pass of dot: out[j] = the sum of block j's products
// a[i] * b[i] in f32 (8192 a block; block 0 adds the ragged tail's).  a
// and b 16-byte aligned; out holds ceil(n / 8192) floats.
extern "C" int stream_dot(const void* a, const void* b, float* out,
                          long long n, int dtype, void* stream) {
  const size_t smem = kDotWarps * sizeof(float);
  if (dtype == kF32)
    return launch(stream_dot_f32, n, kDotThreads, kPer, smem, stream, (const float*)a,
                  (const float*)b, out, n);
  if (dtype == kBF16)
    return launch(stream_dot_bf16, n, kDotThreads, kPer, smem, stream, (const bf16*)a,
                  (const bf16*)b, out, n);
  return cudaErrorInvalidValue;
}

// The later passes of dot: out[j] = the sum of block j's elements of the
// f32 partials x (8192 a block).  x 16-byte aligned; out holds
// ceil(n / 8192) floats.
extern "C" int stream_sum(const float* x, float* out, long long n,
                          void* stream) {
  return launch(stream_sum_f32, n, kDotThreads, kPer,
                kDotWarps * sizeof(float), stream, x, out, n);
}
