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
// limit.  What the design must give HBM is bytes in flight: at ~0.6-0.8
// us of latency, 3.35 TB/s over 132 SMs needs ~15-20 KB of loads in
// flight on every SM.
//
// copy, mul, add and triad share one layout, map_vec's 16-byte vectors:
// each thread moves kVecPer 16-byte vectors (4 f32 or 8 bf16 elements
// each) of every input in blocks of kVecThreads.  Vector c of thread t in
// block b starts at element b * kVecPer * kVecThreads * E + (c *
// kVecThreads + t) * E, so each warp-wide load or store touches 512
// neighbouring bytes, and a thread issues all its loads (one per input
// per vector) before any store.  A sweep on the card
// (scripts/torch_stream_sweep.py, PERF.md) over 128-1024 threads and 1,
// 2, 4 or 8 vectors a thread found every layout of copy and mul within
// 2% of copy_, and every layout of add and triad (V <= 4) within 1% of
// torch.add; for all four the fewest vectors in the largest blocks were
// the fastest: kVecThreads = 1024 and kVecPer = 1, so a block covers 4096
// f32 or 8192 bf16 elements, 2^25 f32 elements take 8192 blocks, and a
// full SM keeps 2048 x 16 bytes of each input in flight (32 KB for copy
// and mul, 64 KB for add and triad: more than HBM needs).  Streaming
// cache hints (__ldcs/__stcs) gained under 1% for copy and are not used.
// The arrays' base must be 16-byte aligned (the wrappers refuse others).
// A vector is read and written only when it lies wholly in range; the
// elements past the last whole vector (n % E) are the ragged tail, which
// global thread j < n % E moves by a scalar access between the loads and
// the stores.  Only loads and stores sit under a guard, each one
// predicated instruction, so the kernel has no branch (chip_smoke.py
// checks its SASS): a guarded tail at the kernel's end would compile to
// an early EXIT that every warp takes at n = 2^25, and the census below
// would count instructions no warp runs.  At n a multiple of a block's
// elements every vector guard holds and every warp runs the whole
// listing.  Each thread reads its elements before it writes them, and no
// two threads touch one element, so out may alias any input exactly
// (BabelStream's in-place chain); for that the pointers are not
// __restrict__.
//
// dot has the same vector layout with kPer = 32 elements a thread in
// blocks of kDotThreads = 256, so a block sums 8192 products and 2^25
// elements take 4096 blocks; the f32 partials are summed by
// stream_sum_f32 the same way, so 2^25 takes two launches (2^25 -> 4096
// -> 1).  Small blocks with many bytes per thread keep several blocks
// loading on each SM while another one reduces.  Its ragged tail is
// added by global thread j through a guarded scalar load.
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
//     past the 8) that every warp runs.  Lane 0 of every warp then stores
//     the block's sum — the same value, bit for bit, from each warp.  Were
//     thread 0 alone to store, nvcc would end the other warps with an
//     early EXIT before it (52 instructions against warp 0's 58, in the
//     first build's SASS), and the census's one path per kernel would no
//     longer be every warp's.  The block partials are summed by
//     relaunching the f32 sum kernel until one value is left (2^25 ->
//     4096 -> 1), so the order of every addition is fixed and the sum is
//     the same on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kVecThreads = 1024;            // copy, mul, add, triad: blocks
constexpr int kVecPer = 1;                   // ... 16-byte vectors a thread
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

// How map_vec reads and writes a 16-byte vector: plain loads and stores.
// (scripts/torch_stream_sweep.py passes another policy, with cache hints,
// to measure them.)
struct PlainAccess {
  template <typename T>
  static __device__ __forceinline__ Pack<T> load(const T* p) {
    return *reinterpret_cast<const Pack<T>*>(p);
  }
  template <typename T>
  static __device__ __forceinline__ void store(T* p, const Pack<T>& v) {
    *reinterpret_cast<Pack<T>*>(p) = v;
  }
};

// The elementwise operations of map_vec, one element at a time: kInputs
// arrays in (a, then b), the result rounded to the array's type.
struct CopyOp {
  static constexpr int kInputs = 1;
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T) const { return a; }
};

struct MulOp {
  static constexpr int kInputs = 1;
  float s;                                   // rounded to T by the wrapper
  template <typename T>
  __device__ __forceinline__ T operator()(T c, T) const {
    return round_to<T>(__fmul_rn(s, to_f32(c)));
  }
};

struct AddOp {
  static constexpr int kInputs = 2;
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return round_to<T>(__fadd_rn(to_f32(a), to_f32(b)));
  }
};

// s * c rounded to T before b is added: two roundings, never one FMA
struct TriadOp {
  static constexpr int kInputs = 2;
  float s;                                   // rounded to T by the wrapper
  template <typename T>
  __device__ __forceinline__ T operator()(T b, T c) const {
    const float sc = to_f32(round_to<T>(__fmul_rn(s, to_f32(c))));
    return round_to<T>(__fadd_rn(to_f32(b), sc));
  }
};

// v stays computed on every path: an empty asm takes its four words, so
// nvcc cannot sink the work that made v under the guard of v's store
// (for bf16 mul it did, and branched around each vector's conversions).
template <typename T>
__device__ __forceinline__ void keep(const Pack<T>& v) {
  uint4 u;
  memcpy(&u, &v, 16);
  asm volatile("" : : "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w));
}

// y = op(a[, b]) over n elements in the 16-byte vector layout (see the
// note at the top): kT threads a block, kV vectors a thread.  Every
// vector load is issued before any store.  The ragged tail's element
// comes between the loads and the stores, read through an index clamped
// into range.  The operation runs on every vector (zeros where one lies
// out of range), so that only loads and stores sit under a guard, each a
// single predicated instruction: the kernel has no branch, and the one
// guard left at its end (the last vector's store) holds whenever n is a
// multiple of a block's elements.
template <int kT, int kV, typename Access = PlainAccess, typename T,
          typename Op>
__device__ __forceinline__ void map_vec(const T* a, const T* b, T* y,
                                        long long n, Op op) {
  constexpr int E = 16 / sizeof(T);
  constexpr bool kTwo = Op::kInputs == 2;
  const long long first = (long long)blockIdx.x * kV * kT * E
                          + (long long)threadIdx.x * E;
  Pack<T> va[kV] = {}, vb[kV] = {};
#pragma unroll
  for (int c = 0; c < kV; ++c) {
    const long long i = first + (long long)c * kT * E;
    if (i + E <= n) {
      va[c] = Access::load(a + i);
      if constexpr (kTwo) vb[c] = Access::load(b + i);
    }
  }
  const long long t = n - n % E + (long long)blockIdx.x * kT + threadIdx.x;
  const long long k = t < n ? t : n - 1;
  const T r = op(a[k], kTwo ? b[k] : a[k]);
  if (t < n) y[t] = r;
#pragma unroll
  for (int c = 0; c < kV; ++c) {
#pragma unroll
    for (int j = 0; j < E; ++j)
      va[c].e[j] = op(va[c].e[j], kTwo ? vb[c].e[j] : va[c].e[j]);
    keep(va[c]);
  }
#pragma unroll
  for (int c = 0; c < kV; ++c) {
    const long long i = first + (long long)c * kT * E;
    if (i + E <= n) Access::store(y + i, va[c]);
  }
}

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
  extern "C" __global__ void __launch_bounds__(kVecThreads)                 \
      stream_copy_##SFX(const T* a, T* c, long long n) {                    \
    map_vec<kVecThreads, kVecPer>(a, a, c, n, CopyOp{});                    \
  }                                                                         \
  extern "C" __global__ void __launch_bounds__(kVecThreads)                 \
      stream_mul_##SFX(const T* c, T* b, float s, long long n) {            \
    map_vec<kVecThreads, kVecPer>(c, c, b, n, MulOp{s});                    \
  }                                                                         \
  extern "C" __global__ void __launch_bounds__(kVecThreads)                 \
      stream_add_##SFX(const T* a, const T* b, T* c, long long n) {         \
    map_vec<kVecThreads, kVecPer>(a, b, c, n, AddOp{});                     \
  }                                                                         \
  extern "C" __global__ void __launch_bounds__(kVecThreads)                 \
      stream_triad_##SFX(const T* b, const T* c, T* a, float s,             \
                         long long n) {                                     \
    map_vec<kVecThreads, kVecPer>(b, c, a, n, TriadOp{s});                  \
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

// One launch of ceil(n / per) threads in blocks of `threads`: kVecPer
// 16-byte vectors in blocks of kVecThreads (copy, mul, add, triad), or
// kPer elements in blocks of kDotThreads (dot, sum).
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

// elements a thread of copy, mul, add and triad moves: kVecPer vectors
// of 16 bytes (of each input)
template <typename T>
constexpr int kVecElems = kVecPer * 16 / sizeof(T);

}  // namespace

// All pointers are device pointers to n contiguous elements of the dtype
// (0 = f32, 1 = bf16); out may alias an input.  Each returns the launch's
// cudaError_t (0 = launched).
// copy, mul, add and triad: every array 16-byte aligned.
extern "C" int stream_copy(const void* a, void* c, long long n, int dtype,
                           void* stream) {
  if (dtype == kF32)
    return launch(stream_copy_f32, n, kVecThreads, kVecElems<float>, 0,
                  stream, (const float*)a, (float*)c, n);
  if (dtype == kBF16)
    return launch(stream_copy_bf16, n, kVecThreads, kVecElems<bf16>, 0,
                  stream, (const bf16*)a, (bf16*)c, n);
  return cudaErrorInvalidValue;
}

extern "C" int stream_mul(const void* c, void* b, float s, long long n,
                          int dtype, void* stream) {
  if (dtype == kF32)
    return launch(stream_mul_f32, n, kVecThreads, kVecElems<float>, 0,
                  stream, (const float*)c, (float*)b, s, n);
  if (dtype == kBF16)
    return launch(stream_mul_bf16, n, kVecThreads, kVecElems<bf16>, 0,
                  stream, (const bf16*)c, (bf16*)b, s, n);
  return cudaErrorInvalidValue;
}

extern "C" int stream_add(const void* a, const void* b, void* c,
                          long long n, int dtype, void* stream) {
  if (dtype == kF32)
    return launch(stream_add_f32, n, kVecThreads, kVecElems<float>, 0,
                  stream, (const float*)a, (const float*)b, (float*)c, n);
  if (dtype == kBF16)
    return launch(stream_add_bf16, n, kVecThreads, kVecElems<bf16>, 0,
                  stream, (const bf16*)a, (const bf16*)b, (bf16*)c, n);
  return cudaErrorInvalidValue;
}

extern "C" int stream_triad(const void* b, const void* c, void* a, float s,
                            long long n, int dtype, void* stream) {
  if (dtype == kF32)
    return launch(stream_triad_f32, n, kVecThreads, kVecElems<float>, 0,
                  stream, (const float*)b, (const float*)c, (float*)a, s, n);
  if (dtype == kBF16)
    return launch(stream_triad_bf16, n, kVecThreads, kVecElems<bf16>, 0,
                  stream, (const bf16*)b, (const bf16*)c, (bf16*)a, s, n);
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
