// CUDA-core body of the f32 paged prefill kernel (paged_prefill.cu, q in
// f32: the parity path); the bf16 prefill runs on the tensor cores
// (attention_tc.cuh) and decode splits its pages across blocks
// (paged_decode.cu, split_decode.cuh).  One thread block attends one
// (slot b, kv-head h) over that slot's pages of a stacked
// (L, num_pages, page, KV, D) pool, all in f32.
//
// The TPU kernels ran the logical blocks as the sequential minor axis of
// the Pallas grid, carrying the online-softmax state in VMEM scratch
// between grid steps.  Blocks on Hopper run in no order, so here the page
// sweep is a loop inside the block and the state (row max m, row sum l,
// accumulator acc) stays in shared memory and registers across it.
//
// Query rows are flattened t-major, as in prefill_paged.py: row r of a
// (slot, kv-head) is query token r / G, head h*G + r % G, at absolute
// position base + r / G.  Rows are processed in tiles of
// ROWS; each tile sweeps the pages in logical order j = 0, 1, ... with
//
//   s      = (q . k) * scale, masked to NEG_INF unless
//            tpos <= qpos and tpos < new_len
//   m_new  = max(m_prev, rowmax(s));  p = exp(s - m_new)
//   corr   = exp(m_prev - m_new);     l = l * corr + rowsum(p)
//   acc    = acc * corr + p @ v
//
// and finishes with out = acc / max(l, 1e-30), so a row that saw no live
// position (an empty prefill slot, new_len == 0) comes out as exact
// zeros, as the Pallas kernels' guarded finalize gives.  NEG_INF is the
// finite -1e30 of the TPU kernels: a row whose first page is fully masked
// for it takes p = 1 there, and the next live page cancels that through
// corr = 0; with -inf that case would be NaN.
//
// Only logical blocks with j * page < new_len are visited (dead blocks'
// table entries point at the null page 0 and are never read), and in a
// tile whose last row sits at qpos_max only blocks with
// j * page <= qpos_max: a later block is fully masked for every row of
// the tile, and block 0 always holds position 0, which is live for every
// row, so skipping it leaves m, l and acc exactly as visiting it would.
#pragma once

#include "attention_common.cuh"

namespace paged {

using namespace attn;  // kNegInf, DType, to_f32, store_f32, imin, launch_smem

constexpr int kThreads = 128;

struct Params {
  void* out;               // same layout and dtype as q
  const void* q;           // (B, T, H, D), contiguous
  const void* k_pool;      // (L, num_pages, page, KV, D), contiguous
  const void* v_pool;
  const float* k_scale;    // (L, num_pages, page, KV) f32, int8 pools only
  const float* v_scale;
  const int* table;        // (B, NB) physical page ids
  const int* lens_a;       // base_len (B,)
  const int* lens_b;       // new_len (B,)
  int T, H, KV, G;
  int num_pages, page, NB, layer;
  float scale;             // 1 / sqrt(D)
};

// Dynamic shared memory of one block, in bytes.
inline size_t smem_bytes(int D, int rows, int page) {
  size_t floats = (size_t)rows * D           // query tile
                  + (size_t)page * (D + 1)   // K page (padded rows)
                  + (size_t)page * D         // V page
                  + (size_t)rows * page      // scores / probabilities
                  + 3 * (size_t)rows;        // m, l, corr
  return floats * sizeof(float);
}

template <typename QT, typename KVT, int D, int ROWS>
__device__ void attend(const Params& p, int b, int h, int base, int new_len,
                       float* smem) {
  static_assert((ROWS * D) % kThreads == 0, "tile must split evenly");
  constexpr int E = ROWS * D / kThreads;     // accumulator slots per thread
  const int tid = threadIdx.x;
  const int page = p.page;
  float* qs = smem;                          // ROWS x D
  float* ks = qs + ROWS * D;                 // page x (D + 1)
  float* vs = ks + page * (D + 1);           // page x D
  float* ss = vs + page * D;                 // ROWS x page
  float* ms = ss + ROWS * page;              // ROWS
  float* ls = ms + ROWS;                     // ROWS
  float* cs = ls + ROWS;                     // ROWS

  const QT* q = static_cast<const QT*>(p.q);
  QT* out = static_cast<QT*>(p.out);
  const KVT* kp = static_cast<const KVT*>(p.k_pool);
  const KVT* vp = static_cast<const KVT*>(p.v_pool);
  const int TG = p.T * p.G;
  const int live_blocks =
      new_len > 0 ? imin(p.NB, (new_len + page - 1) / page) : 0;

  for (int r0 = 0; r0 < TG; r0 += ROWS) {
    REPRO_TRIP(paged_row_tiles);
    for (int e = tid; e < ROWS * D; e += kThreads) {
      REPRO_TRIP(paged_q_load);
      const int row = r0 + e / D;
      float x = 0.f;                         // pad rows: zeros, never stored
      if (row < TG) {
        const int t = row / p.G, g = row % p.G;
        x = to_f32(q[(((size_t)b * p.T + t) * p.H + (size_t)h * p.G + g)
                         * D + e % D]);
      }
      qs[e] = x;
    }
    for (int r = tid; r < ROWS; r += kThreads) {
      REPRO_TRIP(paged_ml_init);
      ms[r] = kNegInf;
      ls[r] = 0.f;
    }
    float acc[E];
#pragma unroll
    for (int k = 0; k < E; ++k) acc[k] = 0.f;
    const int qpos_max = base + (imin(r0 + ROWS, TG) - 1) / p.G;
    const int n_blocks =
        qpos_max < 0 ? 0 : imin(live_blocks, qpos_max / page + 1);
    __syncthreads();

    for (int j = 0; j < n_blocks; ++j) {
      REPRO_TRIP(paged_pages);
      const size_t row0 =
          ((size_t)p.layer * p.num_pages + p.table[(size_t)b * p.NB + j])
          * page;                            // pool row of (layer, phys, 0)
      for (int e = tid; e < page * D; e += kThreads) {
        REPRO_TRIP(paged_kv_load);
        const int t = e / D, d = e % D;
        const size_t idx = ((row0 + t) * p.KV + h) * D + d;
        float kx = to_f32(kp[idx]);
        float vx = to_f32(vp[idx]);
        if (p.k_scale != nullptr) {          // int8: dequantize in f32
          const size_t si = (row0 + t) * p.KV + h;
          kx *= p.k_scale[si];
          vx *= p.v_scale[si];
        }
        ks[t * (D + 1) + d] = kx;
        vs[t * D + d] = vx;
      }
      __syncthreads();

      for (int e = tid; e < ROWS * page; e += kThreads) {
        REPRO_TRIP(paged_scores);
        const int r = e / page, t = e % page;
        const float* qr = qs + r * D;
        const float* kr = ks + t * (D + 1);
        float dot[4] = {0.f, 0.f, 0.f, 0.f};  // 4 independent FMA chains
#pragma unroll
        for (int d = 0; d < D; d += 4) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            dot[i] = fmaf(qr[d + i], kr[d + i], dot[i]);
        }
        const float s = (dot[0] + dot[1]) + (dot[2] + dot[3]);
        const int tpos = j * page + t;
        const int qpos = base + (r0 + r) / p.G;
        ss[e] = (tpos <= qpos && tpos < new_len) ? s * p.scale : kNegInf;
      }
      __syncthreads();

      for (int r = tid; r < ROWS; r += kThreads) {
        REPRO_TRIP(paged_rows);
        float* sr = ss + r * page;
        float mx = kNegInf;
        for (int t = 0; t < page; ++t) {
          REPRO_TRIP(paged_row_max);
          mx = fmaxf(mx, sr[t]);
        }
        const float m_prev = ms[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = 0; t < page; ++t) {
          REPRO_TRIP(paged_row_exp);
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

      // acc = acc * corr + p @ v, with t outermost so that a thread's E
      // accumulators are E independent FMA chains
#pragma unroll
      for (int k = 0; k < E; ++k) acc[k] *= cs[(tid + k * kThreads) / D];
      for (int t = 0; t < page; ++t) {
        REPRO_TRIP(paged_pv);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const int e = tid + k * kThreads;
          acc[k] = fmaf(ss[(e / D) * page + t], vs[t * D + e % D], acc[k]);
        }
      }
      __syncthreads();                       // before the next page lands
    }

#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int e = tid + k * kThreads;
      const int r = e / D, d = e % D;
      const int row = r0 + r;
      if (row < TG) {
        const int t = row / p.G, g = row % p.G;
        store_f32(out,
                  (((size_t)b * p.T + t) * p.H + (size_t)h * p.G + g) * D + d,
                  acc[k] / fmaxf(ls[r], 1e-30f));
      }
    }
    __syncthreads();                         // before the next tile's loads
  }
}

// Launches LAUNCH(QT, KVT, D) for the head dim given; returns
// cudaErrorInvalidValue for a head dim no kernel was built for (the Python
// wrapper refuses those before calling).
#define PAGED_DISPATCH_D(QT, KVT)                                           \
  switch (D) {                                                              \
    case 16: return LAUNCH(QT, KVT, 16);                                    \
    case 32: return LAUNCH(QT, KVT, 32);                                    \
    case 64: return LAUNCH(QT, KVT, 64);                                    \
    case 128: return LAUNCH(QT, KVT, 128);                                  \
    default: return cudaErrorInvalidValue;                                  \
  }

}  // namespace paged
