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
// split across blocks instead (flash-decoding, split_decode.cuh):
//   * decode_attention_kernel, grid (splits, KV, B): block (s, h, b)
//     takes the s-th of `splits` contiguous pieces of slot b's window
//     [lo, hi) = [max(kv_start[b], 0), min(kv_len, T)), found on the
//     device (the host never reads kv_len or kv_start).  Pieces are whole
//     tiles of kTile positions, so when the window is short the last
//     pieces are empty.  `splits` is the host's choice from the static
//     T, B and KV: about two blocks per SM (8 at the serving shape, 256
//     blocks).  The block runs splitkv::attend over its piece: K and V
//     tiles by 16-byte cp.async into a 3-stage ring, the softmax on all
//     four warps, and its unnormalised partial (m, l, acc[G, D]) in f32
//     to scratch the wrapper allocates.
//   * decode_attention_combine_kernel (split_decode.cuh), grid (KV, B),
//     launched right after on the same stream, merges the pieces.
// Tiles are read only inside the window, so blocks outside it read
// nothing (the Pallas kernel's dead-block skip).
//
// Head dims: 16, 32, 64 and 128, the paged kernels' own, and 112, the
// zamba2 hybrid's shared attention (3584 / 32 heads).  Nothing in the body
// needs D to be a power of two: a bf16 row is 14 copies of 16 bytes, its
// 240-byte padded shared row keeps each quarter-warp's 16-byte reads on
// distinct banks, and p @ v takes 28 four-column units a row.
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
#include "split_decode.cuh"

namespace {

using namespace splitkv;

struct Params {
  const void* q;                             // (B, 1, H, D)
  const void* k;                             // (B, T, KV, D), q's dtype
  const void* v;
  const int* kv_len;                         // (1,): positions >= masked
  const int* kv_start;                       // (B,): positions < masked
  Partials part;                             // (B, KV, splits, G, ...)
  int T, H, KV, G, splits;
  float scale;                               // 1 / sqrt(D)
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(Params p) {
  extern __shared__ float smem[];
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;

  // this block's piece [s0, s1) of the slot's window [lo, hi)
  const int lo = imax(p.kv_start[b], 0);
  const int hi = imin(*p.kv_len, p.T);
  const int n = imax(hi - lo, 0);
  const int per = ((n + p.splits - 1) / p.splits + kTile - 1) / kTile * kTile;
  const int s0 = lo + sp * per;
  const int s1 = imin(s0 + per, hi);
  const size_t pos0 = (size_t)b * p.T;       // cache row of (b, 0)
  const int KV = p.KV;
  attend<T, T, D>(
      static_cast<const T*>(p.q) + ((size_t)b * p.H + (size_t)h * p.G) * D,
      static_cast<const T*>(p.k), static_cast<const T*>(p.v), nullptr,
      nullptr, [=](int pos) { return (pos0 + pos) * KV + h; }, s0, s1, p.G,
      p.scale, p.part, (((size_t)b * KV + h) * p.splits + sp) * p.G, smem);
}

template <typename T>
cudaError_t run_typed(const Params& p, int B, int D, void* out,
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
    case 112:                                // zamba2: 3584 / 32 heads
      err = launch_smem(decode_attention_kernel<T, 112>, grid, kThreads,
                        smem, stream, p);
      break;
    case 128:
      err = launch_smem(decode_attention_kernel<T, 128>, grid, kThreads,
                        smem, stream, p);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_combine<T>(out, p.part, B, p.H, p.KV, D, p.splits, stream);
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
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_start = static_cast<const int*>(kv_start);
  p.part = partials(part, B, H, D, splits);
  p.T = T;
  p.H = H;
  p.KV = KV;
  p.G = H / KV;
  p.splits = splits;
  p.scale = (float)(1.0 / sqrt((double)D));  // as math.sqrt in Python
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)run_typed<float>(p, B, D, out, s);
  if (dtype == kBF16)
    return (int)run_typed<__nv_bfloat16>(p, B, D, out, s);
  return (int)cudaErrorInvalidValue;
}
