// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/flash.py::flash_attention_fwd
// (Pallas body `_kernel`): q (B, S, H, D) attends over k, v (B, T, KV, D),
// causal (top-left aligned: query row s sees key positions <= s) or not,
// with an f32 online softmax finished as acc / max(l, 1e-30), and written
// out in q's dtype.  The JAX kernel takes k and v already repeated to H
// heads; here query head h reads kv head h / (H / KV), so the caller
// passes them unrepeated (KV == H is the JAX signature).
//
// The Pallas grid (B * H, S / bq, T / bkv) ran the kv blocks as its
// sequential minor axis with m, l and acc in VMEM scratch.  Here a loop
// inside each thread block streams the k/v tiles, and under causal
// masking stops at the tile's last row: later tiles are fully masked for
// every row (the Pallas kernel's skip of blocks past the diagonal,
// flash.py:47-52).  The tiles are the kernel's own, not the Pallas
// blocks: the ragged last q tile and the ragged last k/v tile are masked
// here, so any S and T work (the JAX kernel takes any S <= 512 as one
// block; the Python wrapper still refuses the shapes its asserts
// refuse).  The first k/v tile always holds a live position for every
// row (position 0), so no row is ever fully masked.  Heavier causal q
// tiles are launched first.
//
// What bounds it on this card: at the whole-batch serving shape (B = 4,
// S = 512, H = 32, KV = 8, D = 128, causal, bf16) it must read q, k and v
// once and write o once, ~42 MB, 0.0125 ms at 3.35 TB/s, against 8.6
// GFLOP of causal scores and p @ v, 0.0087 ms on the tensor cores at 989
// TFLOP/s — so the card's bound is the bytes, barely, and the math has to
// run on the tensor cores to come near it: on the CUDA cores (67 TFLOP/s
// in f32) the same flops take at least 0.13 ms.
//
// bf16 (the serving path): flash_attention_tc_kernel, the tensor-core
// body of attention_tc.cuh.  One block of 4 warps takes 128 query rows of
// one (sequence, kv head), flattened t-major (row r: token r / G, head
// hk G + r % G), so the G heads of a kv head read each k/v tile once (the
// GQA reuse); scores and p @ v run as bf16 mma.sync with f32
// accumulators, k/v tiles of 64 positions arrive by cp.async while the
// previous tile is in use, and the softmax stays in registers.  Each warp
// takes 32 rows, two m16 tiles that share every k and v fragment it
// loads, which halves the ldmatrix traffic and the L2 reads of k and v
// per product against 16 rows a warp; q is re-read from shared memory
// each tile to leave the registers to the two tiles' accumulators.  At
// the serving shape that is 2048 rows per (b, kv head) and 512 blocks.  p
// is rounded to bf16 before p @ v (the plain version keeps it in f32).
//
// Head dims: 16, 32, 64, 128, and 112 for the zamba2 hybrid's shared
// attention (3584 / 32 heads).  At 112 the tensor-core body takes 7 k16
// blocks of Q K^T and 7 pairs of n8 tiles of P V (each ldmatrix_x4 loads
// 16 columns, so no two blocks are paired), and a padded row of 120 bf16
// (240 bytes, 60 words) puts ldmatrix's 8 row addresses at bank offsets
// 0, 28, 24, ... 4: distinct 16-byte groups.  The f32 body takes 7 output
// columns a thread.
//
// What still holds it back (left for later work): mma.sync runs at about
// two thirds of the wgmma rate, and the tiles are copied by every thread
// rather than by TMA; at these shapes the bytes, not the math, bound the
// card, so wgmma/TMA come only if the measured time stays well above the
// library call's.
//
// f32 (the parity path): flash_attention_kernel, the CUDA-core body of
// the first port, unchanged: one block per (64-row q tile, batch x head),
// k/v tiles of 32 positions through shared memory, 4 x 2 scores and
// 4 x D/16 outputs per thread, all in f32 (TF32 tensor cores would miss
// the f32 tolerance).
//
// Training (the forward under autograd): flash_attention_tc_lse_kernel
// and flash_attention_lse_kernel are the same two bodies instantiated
// with kLse, which also write each row's softmax normalizer
// L = m + log(max(l, 1e-30)) (natural log, f32) to a (B, S, H) output for
// the backward (models/flash.py), which recomputes the probabilities as
// exp(s - L) instead of saving them.  The serving instantiations are
// built with kLse off and compile as they did without it.
#include "attention_common.cuh"
#include "attention_tc.cuh"

namespace {

using namespace attn;

constexpr int kThreads = 256;                // a 16 x 16 thread grid
constexpr int kBQ = 64;                      // query rows per block
constexpr int kBK = 32;                      // key positions per tile

struct Params {
  void* out;                                 // (B, S, H, D), q's dtype
  const void* q;                             // (B, S, H, D)
  const void* k;                             // (B, T, KV, D), q's dtype
  const void* v;
  int S, T, H, KV;
  int causal;
  float scale;                               // 1 / sqrt(D)
  float* lse;                                // (B, S, H) f32: L, or null
};

// Dynamic shared memory of one block, in bytes.
inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * (D + 1)    // q tile (padded rows)
                          + (size_t)kBK * (D + 1)  // k tile (padded rows)
                          + (size_t)kBK * D        // v tile
                          + (size_t)kBQ * (kBK + 1)  // scores / p
                          + 3 * (size_t)kBQ);      // m, l, corr
}

template <typename T, int D, bool kLse>
__device__ __forceinline__ void flash_cuda_core_body(const Params& p) {
  static_assert(D % 16 == 0, "head dim must split over 16 columns");
  constexpr int DP = D + 1;
  constexpr int NJ = D / 16;                 // output columns per thread
  constexpr int SP = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                          // kBQ x DP
  float* ks = qs + kBQ * DP;                 // kBK x DP
  float* vs = ks + kBK * DP;                 // kBK x D
  float* ps = vs + kBK * D;                  // kBQ x SP
  float* ms = ps + kBQ * SP;                 // kBQ
  float* ls = ms + kBQ;                      // kBQ
  float* cs = ls + kBQ;                      // kBQ

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int hk = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* out = static_cast<T*>(p.out);

  for (int e = tid; e < kBQ * D; e += kThreads) {
    REPRO_TRIP(flash_q_load);
    const int r = e / D, d = e % D, s = q0 + r;
    qs[r * DP + d] =
        s < p.S ? to_f32(q[(((size_t)b * p.S + s) * p.H + h) * D + d])
                : 0.f;                       // pad rows: never stored
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    REPRO_TRIP(flash_ml_init);
    ms[r] = kNegInf;
    ls[r] = 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  const int t_end =
      p.causal ? imin(p.T, imin(q0 + kBQ, p.S)) : p.T;  // past: all masked
  __syncthreads();

  for (int k0 = 0; k0 < t_end; k0 += kBK) {
    REPRO_TRIP(flash_tiles);
    for (int e = tid; e < kBK * D; e += kThreads) {
      REPRO_TRIP(flash_kv_load);
      const int t = e / D, d = e % D, pos = k0 + t;
      float kx = 0.f, vx = 0.f;
      if (pos < p.T) {
        const size_t idx = (((size_t)b * p.T + pos) * p.KV + hk) * D + d;
        kx = to_f32(k[idx]);
        vx = to_f32(v[idx]);
      }
      ks[t * DP + d] = kx;
      vs[t * D + d] = vx;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      REPRO_TRIP(flash_qk);
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, t = tx + 16 * j;
        const int kpos = k0 + t;
        const bool live = kpos < p.T && (!p.causal || kpos <= q0 + r);
        ps[r * SP + t] = live ? s[i][j] * p.scale : kNegInf;
      }
    __syncthreads();

    for (int r = tid; r < kBQ; r += kThreads) {
      REPRO_TRIP(flash_rows);
      float* pr = ps + r * SP;
      float mx = kNegInf;
      for (int t = 0; t < kBK; ++t) {
        REPRO_TRIP(flash_row_max);
        mx = fmaxf(mx, pr[t]);
      }
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < kBK; ++t) {
        REPRO_TRIP(flash_row_exp);
        const float pt = expf(pr[t] - m_new);
        pr[t] = pt;
        sum += pt;
      }
      const float corr = expf(m_prev - m_new);
      ls[r] = ls[r] * corr + sum;
      ms[r] = m_new;
      cs[r] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = cs[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= c;
    }
    for (int t = 0; t < kBK; ++t) {
      REPRO_TRIP(flash_pv);
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * SP + t];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = vs[t * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();                         // before the next tile lands
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s < p.S) {
      const float l = fmaxf(ls[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        store_f32(out, (((size_t)b * p.S + s) * p.H + h) * D + tx + 16 * j,
                  acc[i][j] / l);
      if constexpr (kLse) {
        if (tx == 0)
          p.lse[((size_t)b * p.S + s) * p.H + h] = ms[r] + logf(l);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(Params p) {
  flash_cuda_core_body<T, D, false>(p);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_lse_kernel(Params p) {
  flash_cuda_core_body<T, D, true>(p);
}

template <typename T>
cudaError_t run_typed(const Params& p, int B, int D, cudaStream_t stream) {
  const dim3 grid(B * p.H, (p.S + kBQ - 1) / kBQ);
  const size_t smem = smem_bytes(D);
  if (p.lse != nullptr) {                    // training: the kLse bodies
    switch (D) {
      case 16:
        return launch_smem(flash_attention_lse_kernel<T, 16>, grid,
                           kThreads, smem, stream, p);
      case 32:
        return launch_smem(flash_attention_lse_kernel<T, 32>, grid,
                           kThreads, smem, stream, p);
      case 64:
        return launch_smem(flash_attention_lse_kernel<T, 64>, grid,
                           kThreads, smem, stream, p);
      case 112:
        return launch_smem(flash_attention_lse_kernel<T, 112>, grid,
                           kThreads, smem, stream, p);
      case 128:
        return launch_smem(flash_attention_lse_kernel<T, 128>, grid,
                           kThreads, smem, stream, p);
      default:
        return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16:
      return launch_smem(flash_attention_kernel<T, 16>, grid, kThreads, smem,
                         stream, p);
    case 32:
      return launch_smem(flash_attention_kernel<T, 32>, grid, kThreads, smem,
                         stream, p);
    case 64:
      return launch_smem(flash_attention_kernel<T, 64>, grid, kThreads, smem,
                         stream, p);
    case 112:                                // zamba2: 3584 / 32 heads
      return launch_smem(flash_attention_kernel<T, 112>, grid, kThreads,
                         smem, stream, p);
    case 128:
      return launch_smem(flash_attention_kernel<T, 128>, grid, kThreads,
                         smem, stream, p);
    default:
      return cudaErrorInvalidValue;
  }
}

constexpr int kTcWarps = 4, kTcMT = 2;       // bf16: 32 query rows a warp
constexpr int kTcRows = 16 * kTcMT * kTcWarps;

template <int D, bool kLse>
__device__ __forceinline__ void flash_tc_body(const Params& p) {
  extern __shared__ float smem[];
  const int b = blockIdx.x / p.KV, hk = blockIdx.x % p.KV;
  const int G = p.H / p.KV;
  const size_t q0 = ((size_t)b * p.S * p.H + (size_t)hk * G) * D;
  tc::Tile<__nv_bfloat16> a;
  a.q = static_cast<const __nv_bfloat16*>(p.q) + q0;
  a.out = static_cast<__nv_bfloat16*>(p.out) + q0;
  a.k = static_cast<const __nv_bfloat16*>(p.k);
  a.v = static_cast<const __nv_bfloat16*>(p.v);
  a.k_scale = a.v_scale = nullptr;
  a.tok_stride = (size_t)p.H * D;
  a.G = G;
  a.nrows = p.S * G;
  a.r0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heaviest first
  a.base = 0;
  a.kv_end = p.T;
  a.causal = p.causal;
  a.scale_log2 = p.scale * tc::kLog2e;
  const size_t kv0 = (size_t)b * p.T * p.KV + hk;  // row of position 0
  const int KV = p.KV;
  // L of row r (token r / G, head hk G + r % G): (b S + r / G) H + hk G
  float* lse = kLse ? p.lse + (size_t)b * p.S * p.H + (size_t)hk * G
                    : nullptr;
  tc::attend<__nv_bfloat16, D, kTcWarps, kTcMT, kLse>(
      a, [=](int pos) { return (kv0 + (size_t)pos * KV) * D; },
      reinterpret_cast<unsigned char*>(smem), lse);
}

template <int D>
__global__ void __launch_bounds__(32 * kTcWarps)
    flash_attention_tc_kernel(Params p) {
  flash_tc_body<D, false>(p);
}

template <int D>
__global__ void __launch_bounds__(32 * kTcWarps)
    flash_attention_tc_lse_kernel(Params p) {
  flash_tc_body<D, true>(p);
}

cudaError_t run_tc(const Params& p, int B, int D, cudaStream_t stream) {
  if (!tc::aligned16(p.out) || !tc::aligned16(p.q) || !tc::aligned16(p.k)
      || !tc::aligned16(p.v))                    // cp.async rows
    return cudaErrorInvalidValue;
  const int G = p.H / p.KV;
  const dim3 grid(B * p.KV, (p.S * G + kTcRows - 1) / kTcRows);
  const size_t smem = tc::smem_bytes(D, kTcRows, false);
  if (p.lse != nullptr) {                    // training: the kLse body
    switch (D) {
      case 16:
        return launch_smem(flash_attention_tc_lse_kernel<16>, grid,
                           32 * kTcWarps, smem, stream, p);
      case 32:
        return launch_smem(flash_attention_tc_lse_kernel<32>, grid,
                           32 * kTcWarps, smem, stream, p);
      case 64:
        return launch_smem(flash_attention_tc_lse_kernel<64>, grid,
                           32 * kTcWarps, smem, stream, p);
      case 112:
        return launch_smem(flash_attention_tc_lse_kernel<112>, grid,
                           32 * kTcWarps, smem, stream, p);
      case 128:
        return launch_smem(flash_attention_tc_lse_kernel<128>, grid,
                           32 * kTcWarps, smem, stream, p);
      default:
        return cudaErrorInvalidValue;
    }
  }
  switch (D) {
    case 16:
      return launch_smem(flash_attention_tc_kernel<16>, grid, 32 * kTcWarps,
                         smem, stream, p);
    case 32:
      return launch_smem(flash_attention_tc_kernel<32>, grid, 32 * kTcWarps,
                         smem, stream, p);
    case 64:
      return launch_smem(flash_attention_tc_kernel<64>, grid, 32 * kTcWarps,
                         smem, stream, p);
    case 112:          // D / 16 = 7 column blocks: nothing pairs them
      return launch_smem(flash_attention_tc_kernel<112>, grid,
                         32 * kTcWarps, smem, stream, p);
    case 128:
      return launch_smem(flash_attention_tc_kernel<128>, grid,
                         32 * kTcWarps, smem, stream, p);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// out, q: (B, S, H, D); k, v: (B, T, KV, D), all of dtype code `dtype`
// (0 f32, 1 bf16), H a multiple of KV; causal 0 or 1; lse null, or a
// (B, S, H) f32 output for each row's L (the training forward).  All
// device pointers, all contiguous.  Returns the launch's cudaError_t (0 =
// launched); cudaErrorInvalidValue for a head dim or dtype no kernel was
// built for (the Python wrapper refuses those before calling) and, in
// bf16, for a pointer that is not 16-byte aligned.  f32 runs the
// CUDA-core kernel, bf16 the tensor-core one.
extern "C" int flash_attention(void* out, const void* q, const void* k,
                               const void* v, int B, int S, int T, int H,
                               int KV, int D, int causal, int dtype,
                               void* stream, float* lse) {
  Params p;
  p.out = out;
  p.q = q;
  p.k = k;
  p.v = v;
  p.S = S;
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.causal = causal;
  p.scale = (float)(1.0 / sqrt((double)D));  // as math.sqrt in Python
  p.lse = lse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)run_typed<float>(p, B, D, s);
  if (dtype == kBF16) return (int)run_tc(p, B, D, s);
  return (int)cudaErrorInvalidValue;
}
