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
// Empty slots: a slot with new_len == 0 visits no block, so l stays 0
// and the guarded finalize acc / max(l, 1e-30) writes exact zeros — what
// the Pallas kernel gives.  The plain version (ref.py), like the JAX
// oracle, softmaxes such a fully masked row uniformly instead.  The port
// follows the kernel; the tests pin the zeros.
//
// What bounds it on this card: at the serving shape (T = 32 tokens,
// G = 4, D = 128, page 16) one (slot, kv-head) page of K/V, 8 KB in bf16,
// feeds 4 * 128 * 16 * 128 flops — 128 flops per byte, under the H100's
// ~295 for the tensor cores, so the card's bound is the live K/V bytes,
// as in decode.  This kernel does its math in f32 on the CUDA cores
// (67 TFLOP/s, ~20 flops per byte), so at long chunks its own f32 math,
// not memory, is what limits it.  The design walks only the
// blocks below new_len, straight from the table, keeps each row tile's
// m, l and acc on chip across the sweep, and stops each tile's sweep at
// its last row's causal limit.  Rows go in tiles of 64; the serving
// shape's T * G = 128 rows make two tiles, and the second reads the
// slot's pages again (from L2 at these sizes).
//
// What holds it back (left for later work): B * KV blocks (32 at the
// serving shape) on 132 SMs; scores and p @ v on CUDA cores in f32
// rather than on the tensor cores (wgmma); plain loads without
// cp.async or TMA, one page at a time.
//
// pages_per_step: accepted by the Python wrapper and ignored, as in
// paged_decode.cu.  It changes no result.
#include "paged_attention.cuh"

namespace {

constexpr int kRows = 64;                    // query rows per tile

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(paged::kThreads)
    paged_prefill_kernel(paged::Params p) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  paged::attend<QT, KVT, D, kRows>(p, b, h, p.lens_a[b], p.lens_b[b], smem);
}

cudaError_t run(const paged::Params& p, int B, int D, int q_dtype,
                int kv_dtype, cudaStream_t stream) {
  const dim3 grid(p.KV, B);
  const size_t smem = paged::smem_bytes(D, kRows, p.page);
#define LAUNCH(QT, KVT, DD) \
  paged::launch_smem(paged_prefill_kernel<QT, KVT, DD>, grid, \
                    paged::kThreads, smem, stream, p)
  PAGED_DISPATCH(q_dtype, kv_dtype)
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
