// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/decode_attention/paged.py::paged_decode_attention_fwd
// (Pallas body `_kernel`): one new query per slot attends, per KV head
// with its G grouped query heads, over the slot's pages of the stacked
// (L, num_pages, page, KV, D) pool, found through the block table; f32
// online softmax; blocks with j * page >= kv_len skipped; optional int8
// pages with per-row f32 scales, dequantized before the dot.
//
// What bounds it on this card: the bytes of the live K/V pages.  A slot
// of n tokens reads 2 * n * KV * D elements and does 4 * n * H * D flops,
// G flops per byte in bf16 (4 at granite-8b's G = 4) — far below the ~295
// flops per byte at which the H100's tensor cores, not its 3.35 TB/s of
// memory, would be the limit, and below the ~20 at which even f32 math
// on the CUDA cores (67 TFLOP/s) would be.  So the kernel is
// memory-bound, and what it must get right is to read each live row once
// and nothing else: it walks only the
// blocks below kv_len, straight from the table (no gathered copy of the
// slot's view, which the plain version materializes), reads each K/V page
// once per tile of up to 8 query rows (G <= 8 in every ported config, so
// once per (slot, kv-head)), and keeps m, l and acc on chip throughout.
//
// What holds it back (left for later work): one block per (slot,
// kv-head) gives B * KV blocks — 32 at the serving shape (B = 4, KV = 8)
// on 132 SMs — and each block streams its pages with plain loads, one
// page at a time, without cp.async or TMA to overlap the next page's
// load with this page's math.  Split-KV over pages and a TMA pipeline
// are the next steps.
//
// pages_per_step: accepted by the Python wrapper and ignored here; the
// Pallas kernel used it to sweep P pages per grid step, which a loop
// inside the block has no need for.  It changes no result.
#include "paged_attention.cuh"

namespace {

constexpr int kRows = 8;                     // query rows per tile

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(paged::kThreads)
    paged_decode_kernel(paged::Params p) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int kv_len = p.lens_a[b];
  paged::attend<QT, KVT, D, kRows>(p, b, h, kv_len - 1, kv_len, smem);
}

cudaError_t run(const paged::Params& p, int B, int D, int q_dtype,
                int kv_dtype, cudaStream_t stream) {
  const dim3 grid(p.KV, B);
  const size_t smem = paged::smem_bytes(D, kRows, p.page);
#define LAUNCH(QT, KVT, DD) \
  paged::launch_smem(paged_decode_kernel<QT, KVT, DD>, grid, \
                    paged::kThreads, smem, stream, p)
  PAGED_DISPATCH(q_dtype, kv_dtype)
#undef LAUNCH
}

}  // namespace

// out, q: (B, 1, H, D); pools (L, num_pages, page, KV, D); scales
// (L, num_pages, page, KV) f32 or null; table (B, NB) int32; kv_len (B,)
// int32.  All device pointers, all contiguous.  Returns the launch's
// cudaError_t (0 = launched).
extern "C" int paged_decode_attention(
    void* out, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* kv_len, int B, int H, int KV, int D, int num_pages,
    int page, int NB, int layer, int q_dtype, int kv_dtype,
    void* stream) {
  paged::Params p;
  p.out = out;
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.table = static_cast<const int*>(table);
  p.lens_a = static_cast<const int*>(kv_len);
  p.lens_b = nullptr;
  p.T = 1;
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
