// Ragged multi-token paged PREFILL attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/prefill_paged.py
//     ::paged_prefill_attention_fwd
// (Pallas body `_kernel`): a chunk of T query tokens per slot, whose K/V
// rows the caller has already scattered into the pool, attends causally
// over the slot's pages.  Row t sits at base_len[b] + t and sees the
// positions <= that and < new_len[b]; rows past a slot's grant still
// attend (their output is garbage the engine ignores, computed with the
// same masks as the plain version, row for row); optional int8 pages.
//
// Empty slots: a slot with new_len == 0 visits nothing, so l stays 0 and
// the guarded finalize acc / max(l, 1e-30) writes exact zeros — what the
// Pallas kernel gives.  The plain version (ref.py), like the JAX oracle,
// softmaxes such a fully masked row uniformly instead.  The port follows
// the kernel; the tests pin the zeros.
//
// What bounds it on this card: at the paged serving shape (B = 4, T = 32
// tokens, G = 4, D = 128, page 16, a few hundred live positions per slot)
// one (slot, kv head) 64-position tile of K/V, 32 KB in bf16, feeds
// 128 rows x 64 x 128 x 4 flops, 128 flops per byte, under the H100's
// ~295 for the tensor cores: the card's bound is the live K/V bytes,
// ~1.6 us, far below the cost of a launch.  What a kernel can lose is
// parallelism and latency: a few hundred positions per slot leave little
// work per (slot, kv head), so it has to be spread over many blocks and
// its loads overlapped with its math.
//
// bf16 q (the serving path): paged_prefill_tc_kernel, the tensor-core
// body of attention_tc.cuh.  The grid is (row tiles, KV, B): a block of
// 2 warps takes 32 query rows (16 a warp) of one (slot, kv head),
// flattened t-major, so the serving shape's 128 rows per (slot, kv head)
// launch 4 x 8 x 4 = 128 blocks on the 132 SMs (the CUDA-core body
// launched B x KV = 32).  Position p of a 64-position tile is fetched
// through the block table (page table[b, p / page], row p % page), so a
// tile may straddle pages and every page size works, with shared memory
// independent of the page.  Tiles arrive by 16-byte cp.async while the
// previous tile is in use; scores and p @ v run as bf16 mma.sync with f32
// accumulators; int8 pages arrive as raw rows and f32 scales and are
// multiplied in f32 and rounded once to bf16 in shared memory, as the
// plain version rounds for bf16 q.  Only positions below new_len, and
// below each tile's causal limit, are read.
//
// What still holds it back (left for later work): each block sweeps its
// slot's whole prefix alone (a split over positions would add blocks at
// long contexts), and the tiles are copied by every thread rather than by
// TMA, whose 2-D boxes do not fit pages scattered through a table.
//
// f32 q (the parity path): paged_prefill_kernel, the CUDA-core body of
// paged_attention.cuh, unchanged: one block per (kv head, slot), rows in
// tiles of 64, one page at a time, all in f32.
//
// pages_per_step: accepted by the Python wrapper and ignored, as in
// paged_decode.cu.  It changes no result.
#include "attention_tc.cuh"
#include "paged_attention.cuh"

namespace {

constexpr int kRows = 64;                    // f32: query rows per tile
constexpr int kTcWarps = 2;                  // bf16: 16 query rows a warp
constexpr int kTcRows = 16 * kTcWarps;

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(paged::kThreads)
    paged_prefill_kernel(paged::Params p) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  paged::attend<QT, KVT, D, kRows>(p, b, h, p.lens_a[b], p.lens_b[b], smem);
}

template <typename KVT, int D>
__global__ void __launch_bounds__(32 * kTcWarps)
    paged_prefill_tc_kernel(paged::Params p) {
  extern __shared__ float smem[];
  const int hk = blockIdx.y, b = blockIdx.z;
  const size_t q0 = ((size_t)b * p.T * p.H + (size_t)hk * p.G) * D;
  tc::Tile<KVT> a;
  a.q = static_cast<const __nv_bfloat16*>(p.q) + q0;
  a.out = static_cast<__nv_bfloat16*>(p.out) + q0;
  a.k = static_cast<const KVT*>(p.k_pool);
  a.v = static_cast<const KVT*>(p.v_pool);
  a.k_scale = p.k_scale;
  a.v_scale = p.v_scale;
  a.tok_stride = (size_t)p.H * D;
  a.G = p.G;
  a.nrows = p.T * p.G;
  a.r0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // heaviest first
  a.base = p.lens_a[b];
  a.kv_end = paged::imin(p.lens_b[b], p.NB * p.page);
  a.causal = 1;
  a.scale_log2 = p.scale * tc::kLog2e;
  const int* table = p.table + (size_t)b * p.NB;
  const size_t page0 = (size_t)p.layer * p.num_pages;
  const int page = p.page, KV = p.KV;
  tc::attend<KVT, D, kTcWarps, 1>(
      a,
      [=](int pos) {                         // pool row of position pos
        return (((page0 + table[pos / page]) * page + pos % page) * KV + hk)
               * D;
      },
      reinterpret_cast<unsigned char*>(smem));
}

cudaError_t run(const paged::Params& p, int B, int D, int q_dtype,
                int kv_dtype, cudaStream_t stream) {
  if (q_dtype == paged::kF32) {
    const dim3 grid(p.KV, B);
    const size_t smem = paged::smem_bytes(D, kRows, p.page);
#define LAUNCH(QT, KVT, DD) \
  paged::launch_smem(paged_prefill_kernel<QT, KVT, DD>, grid, \
                    paged::kThreads, smem, stream, p)
    if (kv_dtype == paged::kF32) {
      PAGED_DISPATCH_D(float, float)
    }
    if (kv_dtype == paged::kI8) {
      PAGED_DISPATCH_D(float, int8_t)
    }
#undef LAUNCH
    return cudaErrorInvalidValue;
  }
  if (q_dtype != paged::kBF16 || (kv_dtype != paged::kBF16
                                  && kv_dtype != paged::kI8))
    return cudaErrorInvalidValue;
  if (!tc::aligned16(p.out) || !tc::aligned16(p.q)
      || !tc::aligned16(p.k_pool) || !tc::aligned16(p.v_pool))
    return cudaErrorInvalidValue;            // cp.async rows
  const dim3 grid((p.T * p.G + kTcRows - 1) / kTcRows, p.KV, B);
  const bool int8 = kv_dtype == paged::kI8;
  const size_t smem = tc::smem_bytes(D, kTcRows, int8);
#define LAUNCH(QT, KVT, DD) \
  paged::launch_smem(paged_prefill_tc_kernel<KVT, DD>, grid, \
                    32 * kTcWarps, smem, stream, p)
  if (int8) {
    PAGED_DISPATCH_D(__nv_bfloat16, int8_t)
  }
  PAGED_DISPATCH_D(__nv_bfloat16, __nv_bfloat16)
#undef LAUNCH
}

}  // namespace

// out, q: (B, T, H, D); pools (L, num_pages, page, KV, D); scales
// (L, num_pages, page, KV) f32 or null; table (B, NB) int32; base_len,
// new_len (B,) int32.  All device pointers, all contiguous.  Returns the
// launch's cudaError_t (0 = launched).
extern "C" int paged_prefill_attention(
    void* out, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* base_len, const void* new_len, int B, int T, int H, int KV,
    int D, int num_pages, int page, int NB, int layer, int q_dtype,
    int kv_dtype, void* stream) {
  paged::Params p;
  p.out = out;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.table = static_cast<const int*>(table);
  p.lens_a = static_cast<const int*>(base_len);
  p.lens_b = static_cast<const int*>(new_len);
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.num_pages = num_pages;
  p.page = page;
  p.NB = NB;
  p.layer = layer;
  p.scale = (float)(1.0 / sqrt((double)D));   // as math.sqrt in Python
  return (int)run(p, B, D, q_dtype, kv_dtype,
                  static_cast<cudaStream_t>(stream));
}
