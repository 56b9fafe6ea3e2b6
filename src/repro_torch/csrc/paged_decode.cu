// Paged single-token decode attention for Hopper (sm_90a), split-KV over
// pages.
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/paged.py::paged_decode_attention_fwd
// (Pallas body `_kernel`): one new query per slot attends, per KV head
// with its G grouped query heads, over the slot's pages of the stacked
// (L, num_pages, page, KV, D) pool, found through the block table; f32
// online softmax; blocks with j * page >= kv_len skipped; optional int8
// pages with per-row f32 scales, dequantized in f32 before the dot.
//
// What bounds it on this card: the bytes of the live K/V pages.  A slot
// of n tokens reads 2 * n * KV * D elements and does 4 * n * H * D flops,
// G flops per byte in bf16 (4 at granite-8b's G = 4) — far below the ~295
// flops per byte at which the H100's tensor cores, not its 3.35 TB/s of
// memory, would be the limit, and below the ~20 at which even f32 math
// on the CUDA cores (67 TFLOP/s) would be.  So the math stays in f32 on
// the CUDA cores, and the design is about bytes in flight: at the paged
// serving shape (B = 4, KV = 8, 80-316 live tokens a slot, bf16) the call
// moves ~3 MB, ~1 us at full rate, so the live pages have to be spread
// over the whole card and requested at once.
//
// The Pallas grid (B, KV, blocks) ran the logical blocks as its
// sequential minor axis, carrying m, l and acc in VMEM scratch.  Here the
// pages are split across blocks instead (flash-decoding, as the dense
// decode kernel splits its window; split_decode.cuh):
//   * paged_decode_kernel, grid (splits, KV, B): block (s, h, b) takes the
//     s-th of `splits` contiguous runs of whole logical pages below
//     kv_len[b] (capped at the table's NB pages), found on the device (the
//     host never reads kv_len).  When a slot has fewer live pages than
//     blocks, the last pieces are empty.  `splits` is the host's choice
//     from the static NB, B and KV: about two blocks per SM (8 at the
//     serving shape, 256 blocks).  Position pos of a piece is row pos %
//     page of page table[b, pos / page]; a block reads the table entries
//     of its own live pages only, so pages past kv_len (entries pointing
//     at the null page 0) are never read.  The block runs splitkv::attend
//     over its piece: K and V rows of its kv head (D contiguous elements,
//     KV * D apart within a page) by 16-byte cp.async into a 3-stage ring
//     of 32-position tiles, which may straddle pages, so every page size
//     works with shared memory independent of the page; int8 rows bring
//     their f32 scales by 4-byte cp.async; the softmax on all four warps;
//     its unnormalised partial (m, l, acc[G, D]) in f32 to scratch the
//     wrapper allocates.
//   * decode_attention_combine_kernel (split_decode.cuh), grid (KV, B),
//     launched right after on the same stream, merges the pieces.
//
// A slot with kv_len == 0 has only empty pieces and comes out as exact
// zeros, as the one-block kernel's guarded finalize gave.
//
// What holds it back (left for later work): the combine is a second
// launch, and the Python wrapper's host time per call (its checks and
// the scratch allocation) is larger than the kernels' device time at the
// serving shape, until a CUDA graph captures the decode step.
//
// pages_per_step: accepted by the Python wrapper and ignored here; the
// Pallas kernel used it to sweep P pages per grid step, which a loop
// inside the block has no need for.  It changes no result.
#include "split_decode.cuh"

namespace {

using namespace splitkv;

struct Params {
  const void* q;           // (B, 1, H, D), contiguous
  const void* k_pool;      // (L, num_pages, page, KV, D), contiguous
  const void* v_pool;
  const float* k_scale;    // (L, num_pages, page, KV) f32, int8 pools only
  const float* v_scale;
  const int* table;        // (B, NB) physical page ids
  const int* kv_len;       // (B,)
  Partials part;           // (B, KV, splits, G, ...)
  int H, KV, G, num_pages, page, NB, layer, splits;
  float scale;             // 1 / sqrt(D)
};

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Params p) {
  extern __shared__ float smem[];
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int page = p.page, KV = p.KV;

  // this block's piece [s0, s1): whole pages of the live positions [0, n)
  const int n = imax(imin(p.kv_len[b], p.NB * page), 0);
  const int live_pages = (n + page - 1) / page;
  const int per = (live_pages + p.splits - 1) / p.splits * page;
  const int s0 = sp * per;
  const int s1 = imin(s0 + per, n);
  const int* table = p.table + (size_t)b * p.NB;
  const size_t page0 = (size_t)p.layer * p.num_pages;
  attend<QT, KVT, D>(
      static_cast<const QT*>(p.q) + ((size_t)b * p.H + (size_t)h * p.G) * D,
      static_cast<const KVT*>(p.k_pool), static_cast<const KVT*>(p.v_pool),
      p.k_scale, p.v_scale,
      [=](int pos) {                         // pool row of position pos
        return ((page0 + table[pos / page]) * page + pos % page) * KV + h;
      },
      s0, s1, p.G, p.scale, p.part,
      (((size_t)b * KV + h) * p.splits + sp) * p.G, smem);
}

template <typename QT, typename KVT>
cudaError_t run_typed(const Params& p, int B, int D, void* out,
                      cudaStream_t stream) {
  const dim3 grid(p.splits, p.KV, B);
  const size_t smem = smem_bytes<KVT>(D, imin(p.G, kMaxRows));
  cudaError_t err;
  switch (D) {
    case 16:
      err = launch_smem(paged_decode_kernel<QT, KVT, 16>, grid, kThreads,
                        smem, stream, p);
      break;
    case 32:
      err = launch_smem(paged_decode_kernel<QT, KVT, 32>, grid, kThreads,
                        smem, stream, p);
      break;
    case 64:
      err = launch_smem(paged_decode_kernel<QT, KVT, 64>, grid, kThreads,
                        smem, stream, p);
      break;
    case 128:
      err = launch_smem(paged_decode_kernel<QT, KVT, 128>, grid, kThreads,
                        smem, stream, p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_combine<QT>(out, p.part, B, p.H, p.KV, D, p.splits, stream);
}

}  // namespace

// out, q: (B, 1, H, D); pools (L, num_pages, page, KV, D); scales
// (L, num_pages, page, KV) f32 or null; table (B, NB) int32; kv_len (B,)
// int32; part: B * H * splits * (D + 2) f32 of scratch (the pieces' acc,
// then m, then l).  All device pointers, all contiguous, q and the pools
// 16-byte aligned.  Launches the split kernel and the combine on `stream`
// and returns the first launch error (0 = both launched);
// cudaErrorInvalidValue for a head dim, dtype pair or split count no
// kernel takes (the Python wrapper refuses those before calling).
extern "C" int paged_decode_attention(
    void* out, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* kv_len, void* part, int B, int H, int KV, int D,
    int num_pages, int page, int NB, int layer, int splits, int q_dtype,
    int kv_dtype, void* stream) {
  if (splits < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.table = static_cast<const int*>(table);
  p.kv_len = static_cast<const int*>(kv_len);
  p.part = partials(part, B, H, D, splits);
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.num_pages = num_pages;
  p.page = page;
  p.NB = NB;
  p.layer = layer;
  p.splits = splits;
  p.scale = (float)(1.0 / sqrt((double)D));   // as math.sqrt in Python
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32 && kv_dtype == kF32)
    return (int)run_typed<float, float>(p, B, D, out, s);
  if (q_dtype == kF32 && kv_dtype == kI8)
    return (int)run_typed<float, int8_t>(p, B, D, out, s);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return (int)run_typed<__nv_bfloat16, __nv_bfloat16>(p, B, D, out, s);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return (int)run_typed<__nv_bfloat16, int8_t>(p, B, D, out, s);
  return (int)cudaErrorInvalidValue;
}
