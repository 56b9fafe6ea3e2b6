// Split-KV single-token decode attention (flash-decoding) for Hopper: the
// body that the dense decode kernel (decode_attention.cu) and the paged
// decode kernel (paged_decode.cu) share, and the combine kernel that
// merges their pieces.  The two kernels differ only in where a position's
// K/V row lives (the whole-batch cache, or a page found through the block
// table), in how a slot's window is cut into pieces (tiles of the window,
// or whole pages), and in the paged pools' int8 rows with f32 scales.
//
// Each block takes one piece [s0, s1) of positions of one (slot, kv
// head), found on the device from the lengths, and writes the piece's
// unnormalised partial (m, l, acc[G, D]) in f32 to scratch that the
// wrapper allocates; the combine, launched right after on the same stream,
// merges the pieces.  Inside a block:
//   * K and V tiles of kTile positions arrive by 16-byte cp.async copies
//     (neighbouring threads on neighbouring 16 bytes of a row) into a ring
//     of kStages tiles, so the next tiles' loads are in flight while this
//     one is used; row_of(pos) gives the index of a position's D-element
//     row in the cache or pool (and of its scale, for int8 rows, copied 4
//     bytes at a time beside it).  Rows are padded by 16 bytes in shared
//     memory, which keeps every lane's 16-byte read of its own row free of
//     bank conflicts.  Positions past the piece land as zeros and are
//     never read from memory.
//   * Scores and softmax run on all four warps: warp w takes query rows w,
//     w + 4, ... (the row tile is the G heads of the kv head, at most
//     kMaxRows), lane t scores position t of the tile (kTile = 32, one per
//     lane), and the row's max and sum are warp shuffles; m and l stay in
//     the warp's registers.  p @ v gives each thread 4 neighbouring
//     columns of a row.  G > kMaxRows (granite-20b: 48 heads over one kv
//     head) walks the row tiles in turn, each reading the piece again.
//   * int8 rows are scaled in f32: the score as (q . k) * k_scale, and
//     p @ v as (p * v_scale) @ v, with l summing the unscaled p.
// An empty piece keeps m = -inf and l = 0, and the combine skips pieces
// with l = 0, so a slot with nothing to attend gives exact zeros.
//
// Everything here has internal linkage: nvcc compiles and registers the
// device code of each source alone, so each including source gets its own
// copy of the kernels.
#pragma once

#include "attention_common.cuh"
#include "tc_ptx.cuh"

namespace {

namespace splitkv {

using namespace attn;
using namespace tc;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                    // positions per tile
constexpr int kStages = 3;                   // tiles in the cp.async ring
constexpr int kMaxRows = 16;                 // query rows per row tile
constexpr int kCombineThreads = 512;         // one output each at G D = 512
constexpr int kRowsPerWarp = kMaxRows / kWarps;

// 16 bytes of a row: 16 int8, 8 bf16 or 4 f32 values
template <typename T>
struct alignas(16) Pack {
  T e[16 / sizeof(T)];
};

// 4 neighbouring values of a row, read as one access
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T e[4];
};

// The pieces' partials: acc (B, KV, splits, G, D), then m and l (B, KV,
// splits, G), all f32.
struct Partials {
  float* acc;
  float* m;
  float* l;
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

template <typename T>
__host__ __device__ constexpr bool is_int8() {
  return sizeof(T) == 1;
}

// Dynamic shared memory of one block, in bytes, for rows query rows.
template <typename KVT>
size_t smem_bytes(int D, int rows) {
  return sizeof(KVT) * (size_t)kStages * 2 * kTile * row_stride<KVT>(D)
         + (is_int8<KVT>() ? sizeof(float) * kStages * 2 * kTile : 0)
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

// One block's piece [s0, s1) of one (slot, kv head): the G query rows at q
// (G x D, contiguous), the K/V row of position pos at row_of(pos) * D in
// k and v (and its scales at row_of(pos) in k_scale and v_scale, for int8
// rows), the partials written at rows row0 .. row0 + G - 1 of out.
template <typename QT, typename KVT, int D, typename RowOf>
__device__ __forceinline__ void attend(const QT* q, const KVT* k,
                                       const KVT* v, const float* k_scale,
                                       const float* v_scale, RowOf row_of,
                                       int s0, int s1, int G, float scale,
                                       const Partials& out, size_t row0,
                                       float* smem) {
  constexpr bool kInt8 = is_int8<KVT>();
  constexpr int E = 16 / sizeof(KVT);        // elements per 16-byte copy
  constexpr int kChunks = D / E;             // copies per row
  constexpr int kStride = row_stride<KVT>(D);
  constexpr int kCols = D / 4;               // 4-column units of a row
  constexpr int kUnits = (kMaxRows * kCols + kThreads - 1) / kThreads;
  KVT* ring = reinterpret_cast<KVT*>(smem);  // kStages x (K tile, V tile)
  float* scales = reinterpret_cast<float*>(ring + kStages * 2 * kTile
                                                  * kStride);
  float* qs = scales + (kInt8 ? kStages * 2 * kTile : 0);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = s1 > s0 ? (s1 - s0 + kTile - 1) / kTile : 0;

  auto load_tile = [&](int i, int s) {
    KVT* kt = ring + (size_t)s * 2 * kTile * kStride;
    KVT* vt = kt + kTile * kStride;
    const int t0 = s0 + i * kTile;
    for (int e = tid; e < kTile * kChunks; e += kThreads) {
      REPRO_TRIP(split_kv_copy);
      const int t = e / kChunks, ch = e % kChunks;
      const bool live = t0 + t < s1;         // past the piece: zeros
      const size_t off = live ? (size_t)row_of(t0 + t) * D + (size_t)ch * E
                              : 0;
      cp_async16(kt + t * kStride + ch * E, k + off, live);
      cp_async16(vt + t * kStride + ch * E, v + off, live);
    }
    if (kInt8) {
      float* st = scales + s * 2 * kTile;
      for (int t = tid; t < kTile; t += kThreads) {
        REPRO_TRIP(split_scale_copy);
        const bool live = t0 + t < s1;
        const size_t r = live ? (size_t)row_of(t0 + t) : 0;
        cp_async4(st + t, k_scale + r, live);
        cp_async4(st + kTile + t, v_scale + r, live);
      }
    }
  };

  for (int r0 = 0; r0 < G; r0 += kMaxRows) {
    REPRO_TRIP(split_row_tiles);
    const int R = imin(kMaxRows, G - r0);    // query rows of this tile
    float* ps = qs + R * D;                  // R x kTile probabilities
    float* cs = ps + R * kTile;              // R corrections

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_tiles) load_tile(s, s);
      cp_async_commit();                     // empty groups keep the count
    }
    // the query rows, while the first tiles are in flight
    const QT* qb = q + (size_t)r0 * D;
    for (int e = tid; e < R * D; e += kThreads) {
      REPRO_TRIP(split_q_load);
      qs[e] = to_f32(qb[e]);
    }

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
      REPRO_TRIP(split_kv_tiles);
      cp_async_wait<kStages - 2>();          // tile i has landed
      __syncthreads();                       // ... for every thread, q is
                                             // in; tile i - 1's stage free
      if (i + kStages - 1 < n_tiles)
        load_tile(i + kStages - 1, (i + kStages - 1) % kStages);
      cp_async_commit();
      const int s = i % kStages;
      const KVT* kt = ring + (size_t)s * 2 * kTile * kStride;
      const KVT* vt = kt + kTile * kStride;
      const float* st = scales + s * 2 * kTile;
      const int live = imin(kTile, s1 - (s0 + i * kTile));

      // scores and the online softmax: lane = position, warp = row
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int g = warp + j * kWarps;
        if (g < R) {                         // uniform across the warp
          float s = -INFINITY;
          if (lane < live) {
            s = dot_row<KVT, D>(qs + g * D, kt + lane * kStride);
            if (kInt8) s *= st[lane];
            s *= scale;
          }
          const float m_new = fmaxf(m[j], warp_max(s));  // lane 0 is live
          const float pt = lane < live ? expf(s - m_new) : 0.f;
          const float corr = expf(m[j] - m_new);         // 0 on tile 0
          l[j] = l[j] * corr + warp_sum(pt);
          m[j] = m_new;
          ps[g * kTile + lane] = kInt8 ? pt * st[kTile + lane] : pt;
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
            REPRO_TRIP(split_pv);
            const Quad<float> pq =
                *reinterpret_cast<const Quad<float>*>(ps + g * kTile + t0);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const Quad<KVT> vq = *reinterpret_cast<const Quad<KVT>*>(
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

    const size_t rows = row0 + r0;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      const int e = tid + u * kThreads;
      if (e < R * kCols)
#pragma unroll
        for (int c = 0; c < 4; ++c) out.acc[rows * D + 4 * e + c] = acc[u][c];
    }
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int g = warp + j * kWarps;
      if (g < R && lane == 0) {
        out.m[rows + g] = m[j];
        out.l[rows + g] = l[j];
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
    REPRO_TRIP(combine_ml_load);
    ms[e] = c.m[row0 + e];                   // e = s * G + g
    ls[e] = c.l[row0 + e];
  }
  __syncthreads();
  for (int g = tid; g < c.G; g += kCombineThreads) {
    REPRO_TRIP(combine_rows);
    float M = -INFINITY;
    for (int s = 0; s < c.splits; ++s) {
      REPRO_TRIP(combine_max);
      if (ls[s * c.G + g] > 0.f) M = fmaxf(M, ms[s * c.G + g]);
    }
    float L = 0.f;
    for (int s = 0; s < c.splits; ++s) {
      REPRO_TRIP(combine_weights);
      const int r = s * c.G + g;
      const float w = ls[r] > 0.f ? expf(ms[r] - M) : 0.f;
      L = fmaf(w, ls[r], L);
      ms[r] = w;                             // m_s is read no more
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int s = 0; s < c.splits; ++s) {
      REPRO_TRIP(combine_norm);
      ms[s * c.G + g] *= inv;
    }
  }
  __syncthreads();
  for (int e = tid; e < c.G * c.D; e += kCombineThreads) {
    REPRO_TRIP(combine_out);
    const int g = e / c.D, d = e % c.D;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < c.splits; ++s) {
      REPRO_TRIP(combine_sum);
      o = fmaf(ms[s * c.G + g], c.acc[(row0 + s * c.G + g) * c.D + d], o);
    }
    store_f32(out, ((size_t)b * c.H + (size_t)h * c.G + g) * c.D + d, o);
  }
}

// The partials' layout in the wrapper's scratch (acc, then m, then l) for
// B slots of H heads over KV kv heads, and the combine's parameters.
inline Partials partials(void* part, int B, int H, int D, int splits) {
  const size_t pieces = (size_t)B * H * splits;
  Partials p;
  p.acc = static_cast<float*>(part);
  p.m = p.acc + pieces * D;
  p.l = p.m + pieces;
  return p;
}

// Launches the combine for out (B, 1, H, D) of type T on stream.
template <typename T>
cudaError_t launch_combine(void* out, const Partials& part, int B, int H,
                           int KV, int D, int splits, cudaStream_t stream) {
  CombineParams c;
  c.out = out;
  c.acc = part.acc;
  c.m = part.m;
  c.l = part.l;
  c.H = H;
  c.KV = KV;
  c.G = H / KV;
  c.D = D;
  c.splits = splits;
  return launch_smem(decode_attention_combine_kernel<T>, dim3(KV, B),
                     kCombineThreads,
                     2 * sizeof(float) * (size_t)splits * c.G, stream, c);
}

}  // namespace splitkv

}  // namespace
