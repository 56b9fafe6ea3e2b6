// Dense single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/decode.py::decode_attention_fwd
// (Pallas body `_kernel`): each slot's one new query attends over its rows
// of the whole-batch (B, T, KV, D) cache, per KV head with its G grouped
// query heads; a scalar kv_len masks positions >= kv_len and a per-slot
// kv_start masks positions < kv_start[b]; f32 online softmax, finished as
// acc / max(l, 1e-30).
//
// The Pallas grid (B, KV, kv_blocks) ran the kv blocks as its sequential
// minor axis, carrying m, l and acc in VMEM scratch between grid steps.
// Blocks on Hopper run in no order, so here one thread block takes one
// (kv-head, slot) and a loop inside it walks the slot's window
// [kv_start[b], min(kv_len, T)) in tiles of kTile positions, with m, l and
// acc in shared memory and registers throughout.  The tiles start at the
// window's first position, so every position a tile holds is live and no
// score is masked; blocks outside the window are never read (the Pallas
// kernel's dead-block skip).  Query rows — the G heads of the kv head —
// go in tiles of kRows, so each cache row is read once per (slot, kv-head)
// for every G <= 8 (all ported configs).
//
// Empty windows (kv_start[b] >= kv_len): no tile is visited, l stays 0 and
// the output is exact zeros.  The plain version, like the JAX oracle,
// softmaxes a fully masked row uniformly instead (the mean of all T value
// rows).  The Pallas kernel gives zeros when kv_len falls on one of its
// block boundaries; otherwise the block that straddles kv_len passes its
// dead-block test and gives that block's mean.  The whole-batch path never
// builds an empty window (its kv_start is 0).  The tests pin the zeros.
//
// What bounds it on this card: the bytes of the live cache rows.  A slot
// of n live positions reads 2 * n * KV * D elements and does 4 * n * H * D
// flops: G flops per byte in bf16 (4 at granite-8b), far below the ~295 at
// which the tensor cores and not the 3.35 TB/s of memory would bound it,
// and below the ~20 of f32 math on the CUDA cores.  So the design reads
// each live row once and nothing else, and keeps the softmax state on
// chip.
//
// What holds it back (left for later work): one block per (slot, kv-head)
// is B * KV blocks — 32 at the serving shape (B = 4, KV = 8) on 132 SMs —
// and each block loads its tiles with plain loads, one tile at a time,
// with no cp.async or TMA to overlap the next tile's load with this
// tile's math.  Split-KV across blocks is the next step.
#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kThreads = 128;
constexpr int kRows = 8;                     // query rows per row tile
constexpr int kTile = 64;                    // cache positions per tile

struct Params {
  void* out;                                 // (B, 1, H, D), q's dtype
  const void* q;                             // (B, 1, H, D)
  const void* k;                             // (B, T, KV, D), q's dtype
  const void* v;
  const int* kv_len;                         // (1,): positions >= masked
  const int* kv_start;                       // (B,): positions < masked
  int T, H, KV, G;
  float scale;                               // 1 / sqrt(D)
};

// Dynamic shared memory of one block, in bytes.
inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kRows * D        // query tile
                          + (size_t)kTile * (D + 1)  // K tile (padded rows)
                          + (size_t)kTile * D        // V tile
                          + (size_t)kRows * kTile    // scores / probabilities
                          + 3 * (size_t)kRows);      // m, l, corr
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(Params p) {
  static_assert((kRows * D) % kThreads == 0, "tile must split evenly");
  constexpr int E = kRows * D / kThreads;    // accumulator slots per thread
  extern __shared__ float smem[];
  float* qs = smem;                          // kRows x D
  float* ks = qs + kRows * D;                // kTile x (D + 1)
  float* vs = ks + kTile * (D + 1);          // kTile x D
  float* ss = vs + kTile * D;                // kRows x kTile
  float* ms = ss + kRows * kTile;            // kRows
  float* ls = ms + kRows;                    // kRows
  float* cs = ls + kRows;                    // kRows

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* out = static_cast<T*>(p.out);
  const int lo = imax(p.kv_start[b], 0);     // the slot's window [lo, hi)
  const int hi = imin(*p.kv_len, p.T);

  for (int r0 = 0; r0 < p.G; r0 += kRows) {
    for (int e = tid; e < kRows * D; e += kThreads) {
      const int g = r0 + e / D;
      qs[e] = g < p.G ? to_f32(q[((size_t)b * p.H + (size_t)h * p.G + g) * D
                                 + e % D])
                      : 0.f;                 // pad rows: never stored
    }
    for (int r = tid; r < kRows; r += kThreads) {
      ms[r] = kNegInf;
      ls[r] = 0.f;
    }
    float acc[E];
#pragma unroll
    for (int i = 0; i < E; ++i) acc[i] = 0.f;
    __syncthreads();

    for (int t0 = lo; t0 < hi; t0 += kTile) {
      const int n = imin(kTile, hi - t0);    // live positions in this tile
      for (int e = tid; e < n * D; e += kThreads) {
        const int t = e / D, d = e % D;
        const size_t idx = (((size_t)b * p.T + t0 + t) * p.KV + h) * D + d;
        ks[t * (D + 1) + d] = to_f32(k[idx]);
        vs[t * D + d] = to_f32(v[idx]);
      }
      __syncthreads();

      for (int e = tid; e < kRows * n; e += kThreads) {
        const int r = e / n, t = e % n;
        const float* qr = qs + r * D;
        const float* kr = ks + t * (D + 1);
        float dot[4] = {0.f, 0.f, 0.f, 0.f};  // 4 independent FMA chains
#pragma unroll
        for (int d = 0; d < D; d += 4) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dot[i] = fmaf(qr[d + i], kr[d + i], dot[i]);
        }
        ss[r * kTile + t] = ((dot[0] + dot[1]) + (dot[2] + dot[3])) * p.scale;
      }
      __syncthreads();

      for (int r = tid; r < kRows; r += kThreads) {
        float* sr = ss + r * kTile;
        float mx = kNegInf;
        for (int t = 0; t < n; ++t) mx = fmaxf(mx, sr[t]);
        const float m_prev = ms[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = 0; t < n; ++t) {
          const float pt = expf(sr[t] - m_new);
          sr[t] = pt;
          sum += pt;
        }
        const float corr = expf(m_prev - m_new);
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
        cs[r] = corr;
      }
      __syncthreads();

      // acc = acc * corr + p @ v, t outermost: a thread's E accumulators
      // are E independent FMA chains
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] *= cs[(tid + i * kThreads) / D];
      for (int t = 0; t < n; ++t) {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int e = tid + i * kThreads;
          acc[i] = fmaf(ss[(e / D) * kTile + t], vs[t * D + e % D], acc[i]);
        }
      }
      __syncthreads();                       // before the next tile lands
    }

#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int e = tid + i * kThreads;
      const int g = r0 + e / D;
      if (g < p.G)
        store_f32(out, ((size_t)b * p.H + (size_t)h * p.G + g) * D + e % D,
                  acc[i] / fmaxf(ls[e / D], 1e-30f));
    }
    __syncthreads();                         // before the next row tile
  }
}

template <typename T>
cudaError_t run_typed(const Params& p, int B, int D, cudaStream_t stream) {
  const dim3 grid(p.KV, B);
  const size_t smem = smem_bytes(D);
  switch (D) {
    case 16:
      return launch_smem(decode_attention_kernel<T, 16>, grid, kThreads,
                         smem, stream, p);
    case 32:
      return launch_smem(decode_attention_kernel<T, 32>, grid, kThreads,
                         smem, stream, p);
    case 64:
      return launch_smem(decode_attention_kernel<T, 64>, grid, kThreads,
                         smem, stream, p);
    case 128:
      return launch_smem(decode_attention_kernel<T, 128>, grid, kThreads,
                         smem, stream, p);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out, q: (B, 1, H, D); k, v: (B, T, KV, D), all of dtype code `dtype`
// (0 f32, 1 bf16); kv_len: one int32; kv_start: (B,) int32.  All device
// pointers, all contiguous.  Returns the launch's cudaError_t (0 =
// launched); cudaErrorInvalidValue for a head dim or dtype no kernel was
// built for (the Python wrapper refuses those before calling).
extern "C" int decode_attention(void* out, const void* q, const void* k,
                                const void* v, const void* kv_len,
                                const void* kv_start, int B, int T, int H,
                                int KV, int D, int dtype, void* stream) {
  Params p;
  p.out = out;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_start = static_cast<const int*>(kv_start);
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.scale = (float)(1.0 / sqrt((double)D));  // as math.sqrt in Python
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)run_typed<float>(p, B, D, s);
  if (dtype == kBF16) return (int)run_typed<__nv_bfloat16>(p, B, D, s);
  return (int)cudaErrorInvalidValue;
}
