// Dense single-token decode attention for Hopper (sm_90a), split-KV.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode.py::decode_attention_fwd
// (Pallas body `_kernel`): each slot's one new query attends over its rows
// of the whole-batch (B, T, KV, D) cache, per KV head with its G grouped
// query heads; a scalar kv_len masks positions >= kv_len and a per-slot
// kv_start masks positions < kv_start[b]; f32 online softmax, finished as
// acc / max(l, 1e-30).
//
// What bounds it on this card: the bytes of the live cache rows.  A slot
// of n live positions reads 2 * n * KV * D elements and does 4 * n * H * D
// flops: G flops per byte in bf16 (4 at granite-8b), far below the ~295 at
// which the tensor cores and not the 3.35 TB/s of memory would bound it,
// and below the ~20 of f32 math on the CUDA cores.  So the math stays in
// f32 on the CUDA cores, and the design is about bytes in flight: at the
// whole-batch serving shape (B = 4, KV = 8, ~500 live rows, bf16) the
// whole call moves ~8 MB, 2.4 us at full rate, so every SM has to have
// its share of the rows requested at once.
//
// The Pallas grid (B, KV, kv_blocks) ran the kv blocks as its sequential
// minor axis, carrying m, l and acc in VMEM scratch.  Here the window is
// split across blocks instead (flash-decoding):
//   * decode_attention_kernel, grid (splits, KV, B): block (s, h, b)
//     takes the s-th of `splits` contiguous pieces of slot b's window
//     [lo, hi) = [max(kv_start[b], 0), min(kv_len, T)), found on the
//     device (the host never reads kv_len or kv_start).  Pieces are whole
//     tiles of kTile positions, so when the window is short the last
//     pieces are empty.  `splits` is the host's choice from the static
//     T, B and KV: about two blocks per SM (8 at the serving shape, 256
//     blocks).  The block writes its unnormalised partial (m, l, acc[G,
//     D]) in f32 to scratch the wrapper allocates.
//   * decode_attention_combine_kernel, grid (KV, B), launched right after
//     on the same stream: out = sum_s e^(m_s - M) acc_s / max(sum_s
//     e^(m_s - M) l_s, 1e-30) over the pieces with l_s > 0, M their
//     largest m_s, with the weights computed once per row in shared
//     memory.
// Inside a block, K and V tiles arrive by 16-byte cp.async copies
// (neighbouring threads on neighbouring 16 bytes of a row) into a ring of
// kStages tiles, so the next tiles' loads are in flight while this one is
// used; the rows are padded by 16 bytes in shared memory, which keeps
// every lane's 16-byte read of its own row free of bank conflicts.
// Scores and softmax run on all four warps: warp w takes query rows w,
// w + 4, ... (the row tile is the G heads of the kv head, at most
// kMaxRows, so granite's G = 4 is one row per warp and no padding rows),
// lane t scores position t of the tile (kTile = 32, one per lane), and
// the row's max and sum are warp shuffles; m and l stay in the warp's
// registers.  p @ v gives each thread 4 neighbouring columns of a row.
// Tiles are read only inside the window, so blocks outside it read
// nothing (the Pallas kernel's dead-block skip).  G > kMaxRows (no ported
// config) walks the row tiles in turn, each reading the piece again.
//
// Empty windows (kv_start[b] >= kv_len): every piece is empty, keeps m =
// -inf and l = 0, and the combine skips pieces with l = 0, so it never
// forms exp(-inf - -inf) and the output is exact zeros.  The plain
// version, like the JAX oracle, softmaxes a fully masked row uniformly
// instead (the mean of all T value rows).  The Pallas kernel gives zeros
// when kv_len falls on one of its block boundaries; otherwise the block
// that straddles kv_len passes its dead-block test and gives that block's
// mean.  The whole-batch path never builds an empty window (its kv_start
// is 0).  The tests pin the zeros.
#include "attention_common.cuh"
#include "tc_ptx.cuh"

namespace {

using namespace attn;
using namespace tc;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                    // cache positions per tile
constexpr int kStages = 3;                   // tiles in the cp.async ring
constexpr int kMaxRows = 16;                 // query rows per row tile
constexpr int kCombineThreads = 512;         // one output each at G D = 512
constexpr int kRowsPerWarp = kMaxRows / kWarps;

// 16 bytes of a row: 8 bf16 or 4 f32 values
template <typename T>
struct alignas(16) Pack {
  T e[16 / sizeof(T)];
};

// 4 neighbouring values of a row, read as one access
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T e[4];
};

struct Params {
  const void* q;                             // (B, 1, H, D)
  const void* k;                             // (B, T, KV, D), q's dtype
  const void* v;
  const int* kv_len;                         // (1,): positions >= masked
  const int* kv_start;                       // (B,): positions < masked
  float* acc;                                // (B, KV, splits, G, D)
  float* m;                                  // (B, KV, splits, G)
  float* l;                                  // (B, KV, splits, G)
  int T, H, KV, G, splits;
  float scale;                               // 1 / sqrt(D)
};

struct CombineParams {
  void* out;                                 // (B, 1, H, D), q's dtype
  const float* acc;
  const float* m;
  const float* l;
  int H, KV, G, D, splits;
};

// Elements of a padded K or V row in shared memory.
template <typename T>
__host__ __device__ constexpr int row_stride(int D) {
  return D + 16 / (int)sizeof(T);
}

// Dynamic shared memory of one block, in bytes, for rows query rows.
template <typename T>
size_t smem_bytes(int D, int rows) {
  return sizeof(T) * (size_t)kStages * 2 * kTile * row_stride<T>(D)
         + sizeof(float) * ((size_t)rows * D        // query rows
                            + (size_t)rows * kTile  // probabilities
                            + rows);                // corrections
}

// q . k over D: q in f32 from shared memory (the same row for the whole
// warp: a broadcast), both read 16 bytes at a time; four independent FMA
// chains.
template <typename T, int D>
__device__ __forceinline__ float dot_row(const float* qr, const T* kr) {
  constexpr int E = 16 / sizeof(T);
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < D / E; ++c) {
    const Pack<T> kk = *reinterpret_cast<const Pack<T>*>(kr + c * E);
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const Quad<float> qq =
          *reinterpret_cast<const Quad<float>*>(qr + c * E + i);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dot[j] = fmaf(qq.e[j], to_f32(kk.e[i + j]), dot[j]);
    }
  }
  return (dot[0] + dot[1]) + (dot[2] + dot[3]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(Params p) {
  constexpr int E = 16 / sizeof(T);          // elements per 16-byte copy
  constexpr int kChunks = D / E;             // copies per cache row
  constexpr int kStride = row_stride<T>(D);
  constexpr int kCols = D / 4;               // 4-column units of a row
  constexpr int kUnits = (kMaxRows * kCols + kThreads - 1) / kThreads;
  extern __shared__ float smem[];
  T* ring = reinterpret_cast<T*>(smem);      // kStages x (K tile, V tile)
  float* qs = reinterpret_cast<float*>(ring + kStages * 2 * kTile * kStride);

  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);

  // this block's piece [s0, s1) of the slot's window [lo, hi)
  const int lo = imax(p.kv_start[b], 0);
  const int hi = imin(*p.kv_len, p.T);
  const int n = imax(hi - lo, 0);
  const int per = ((n + p.splits - 1) / p.splits + kTile - 1) / kTile * kTile;
  const int s0 = lo + sp * per;
  const int s1 = imin(s0 + per, hi);
  const int n_tiles = s1 > s0 ? (s1 - s0 + kTile - 1) / kTile : 0;
  const size_t base = ((size_t)b * p.T * p.KV + h) * D;   // (b, 0, h, 0)
  const size_t pos_stride = (size_t)p.KV * D;

  auto load_tile = [&](int i, int s) {
    T* kt = ring + (size_t)s * 2 * kTile * kStride;
    T* vt = kt + kTile * kStride;
    const int t0 = s0 + i * kTile;
    for (int e = tid; e < kTile * kChunks; e += kThreads) {
      const int t = e / kChunks, ch = e % kChunks;
      const bool live = t0 + t < s1;         // past the piece: zeros
      const size_t off = live ? base + (size_t)(t0 + t) * pos_stride
                                    + (size_t)ch * E
                              : 0;
      cp_async16(kt + t * kStride + ch * E, k + off, live);
      cp_async16(vt + t * kStride + ch * E, v + off, live);
    }
  };

  for (int r0 = 0; r0 < p.G; r0 += kMaxRows) {
    const int R = imin(kMaxRows, p.G - r0);  // query rows of this tile
    float* ps = qs + R * D;                  // R x kTile probabilities
    float* cs = ps + R * kTile;              // R corrections

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_tiles) load_tile(s, s);
      cp_async_commit();                     // empty groups keep the count
    }
    // the query rows, while the first tiles are in flight
    const T* qb = q + ((size_t)b * p.H + (size_t)h * p.G + r0) * D;
    for (int e = tid; e < R * D; e += kThreads) qs[e] = to_f32(qb[e]);

    float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      m[j] = -INFINITY;
      l[j] = 0.f;
    }
    float acc[kUnits][4];
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][c] = 0.f;

    for (int i = 0; i < n_tiles; ++i) {
      cp_async_wait<kStages - 2>();          // tile i has landed
      __syncthreads();                       // ... for every thread, q is
                                             // in; tile i - 1's stage free
      if (i + kStages - 1 < n_tiles)
        load_tile(i + kStages - 1, (i + kStages - 1) % kStages);
      cp_async_commit();
      const T* kt = ring + (size_t)(i % kStages) * 2 * kTile * kStride;
      const T* vt = kt + kTile * kStride;
      const int live = imin(kTile, s1 - (s0 + i * kTile));

      // scores and the online softmax: lane = position, warp = row
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int g = warp + j * kWarps;
        if (g < R) {                         // uniform across the warp
          const float s = lane < live
              ? dot_row<T, D>(qs + g * D, kt + lane * kStride) * p.scale
              : -INFINITY;
          const float m_new = fmaxf(m[j], warp_max(s));  // lane 0 is live
          const float pt = lane < live ? expf(s - m_new) : 0.f;
          const float corr = expf(m[j] - m_new);         // 0 on tile 0
          l[j] = l[j] * corr + warp_sum(pt);
          m[j] = m_new;
          ps[g * kTile + lane] = pt;
          if (lane == 0) cs[g] = corr;
        }
      }
      __syncthreads();

      // acc = acc * corr + p @ v; rows past the piece are zeros with p = 0
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const int e = tid + u * kThreads;
        if (e < R * kCols) {
          const int g = e / kCols, d = 4 * (e % kCols);
          const float corr = cs[g];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[u][c] *= corr;
#pragma unroll 2
          for (int t0 = 0; t0 < kTile; t0 += 4) {
            const Quad<float> pq =
                *reinterpret_cast<const Quad<float>*>(ps + g * kTile + t0);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const Quad<T> vq = *reinterpret_cast<const Quad<T>*>(
                  vt + (t0 + t) * kStride + d);
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[u][c] = fmaf(pq.e[t], to_f32(vq.e[c]), acc[u][c]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();                      // only empty groups remain

    const size_t row0 = (((size_t)b * p.KV + h) * p.splits + sp) * p.G + r0;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int e = tid + u * kThreads;
      if (e < R * kCols)
#pragma unroll
        for (int c = 0; c < 4; ++c) p.acc[row0 * D + 4 * e + c] = acc[u][c];
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int g = warp + j * kWarps;
      if (g < R && lane == 0) {
        p.m[row0 + g] = m[j];
        p.l[row0 + g] = l[j];
      }
    }
    __syncthreads();                         // before the next row tile
  }
}

// One block per (kv head, slot): the G x D outputs from the pieces'
// partials.  The pieces' m and l are read once, all at the same time, into
// shared memory; then each row's weights w_s = e^(m_s - M) / max(L, 1e-30),
// with M the largest m_s and L = sum_s e^(m_s - M) l_s over the pieces
// with l_s > 0 (empty pieces get w_s = 0), so an empty window gives exact
// zeros and no exp(-inf - -inf) is formed; then every output is sum_s w_s
// acc_s, the pieces' loads independent of each other (one output a thread
// at granite's G D = 512, so all of a block's loads are in flight at once).
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    decode_attention_combine_kernel(CombineParams c) {
  extern __shared__ float smem[];            // splits x G: m, l, then w
  float* ms = smem;
  float* ls = ms + c.splits * c.G;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  T* out = static_cast<T*>(c.out);
  const size_t row0 = ((size_t)b * c.KV + h) * c.splits * c.G;
  for (int e = tid; e < c.splits * c.G; e += kCombineThreads) {
    ms[e] = c.m[row0 + e];                   // e = s * G + g
    ls[e] = c.l[row0 + e];
  }
  __syncthreads();
  for (int g = tid; g < c.G; g += kCombineThreads) {
    float M = -INFINITY;
    for (int s = 0; s < c.splits; ++s)
      if (ls[s * c.G + g] > 0.f) M = fmaxf(M, ms[s * c.G + g]);
    float L = 0.f;
    for (int s = 0; s < c.splits; ++s) {
      const int r = s * c.G + g;
      const float w = ls[r] > 0.f ? expf(ms[r] - M) : 0.f;
      L = fmaf(w, ls[r], L);
      ms[r] = w;                             // m_s is read no more
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int s = 0; s < c.splits; ++s) ms[s * c.G + g] *= inv;
  }
  __syncthreads();
  for (int e = tid; e < c.G * c.D; e += kCombineThreads) {
    const int g = e / c.D, d = e % c.D;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < c.splits; ++s)
      o = fmaf(ms[s * c.G + g], c.acc[(row0 + s * c.G + g) * c.D + d], o);
    store_f32(out, ((size_t)b * c.H + (size_t)h * c.G + g) * c.D + d, o);
  }
}

template <typename T>
cudaError_t run_typed(const Params& p, const CombineParams& c, int B, int D,
                      cudaStream_t stream) {
  const dim3 grid(p.splits, p.KV, B);
  const size_t smem = smem_bytes<T>(D, imin(p.G, kMaxRows));
  cudaError_t err;
  switch (D) {
    case 16:
      err = launch_smem(decode_attention_kernel<T, 16>, grid, kThreads, smem,
                        stream, p);
      break;
    case 32:
      err = launch_smem(decode_attention_kernel<T, 32>, grid, kThreads, smem,
                        stream, p);
      break;
    case 64:
      err = launch_smem(decode_attention_kernel<T, 64>, grid, kThreads, smem,
                        stream, p);
      break;
    case 128:
      err = launch_smem(decode_attention_kernel<T, 128>, grid, kThreads,
                        smem, stream, p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_smem(decode_attention_combine_kernel<T>, dim3(p.KV, B),
                     kCombineThreads,
                     2 * sizeof(float) * (size_t)p.splits * p.G, stream, c);
}

}  // namespace

// out, q: (B, 1, H, D); k, v: (B, T, KV, D), all of dtype code `dtype`
// (0 f32, 1 bf16) and 16-byte aligned; kv_len: one int32; kv_start: (B,)
// int32; part: B * KV * splits * H / KV * (D + 2) f32 of scratch (the
// pieces' acc, then m, then l).  All device pointers, all contiguous.
// Launches the split kernel and the combine on `stream` and returns the
// first launch error (0 = both launched); cudaErrorInvalidValue for a
// head dim, dtype or split count no kernel takes (the Python wrapper
// refuses those before calling).
extern "C" int decode_attention(void* out, const void* q, const void* k,
                                const void* v, const void* kv_len,
                                const void* kv_start, void* part, int B,
                                int T, int H, int KV, int D, int splits,
                                int dtype, void* stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const size_t pieces = (size_t)B * KV * splits * G;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_start = static_cast<const int*>(kv_start);
  p.acc = static_cast<float*>(part);
  p.m = p.acc + pieces * D;
  p.l = p.m + pieces;
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.G = G;
  p.splits = splits;
  p.scale = (float)(1.0 / sqrt((double)D));  // as math.sqrt in Python
  CombineParams c;
  c.out = out;
  c.acc = p.acc;
  c.m = p.m;
  c.l = p.l;
  c.H = H;
  c.KV = KV;
  c.G = G;
  c.D = D;
  c.splits = splits;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)run_typed<float>(p, c, B, D, s);
  if (dtype == kBF16) return (int)run_typed<__nv_bfloat16>(p, c, B, D, s);
  return (int)cudaErrorInvalidValue;
}
