// The tensor-core attention body shared by the bf16 flash kernel
// (flash_attention.cu) and the bf16 paged prefill kernel
// (paged_prefill.cu): the FlashAttention-2 shape on mma.sync, ldmatrix and
// cp.async (tc_ptx.cuh), which Hopper runs at sm_90a.
//
// A block owns one kv head of one sequence and a tile of 16 MT x WARPS
// query rows.  Rows are flattened t-major, as in paged_attention.cuh: row
// r is query token r / G, head hk G + r % G, at position base + r / G, so
// the G query heads that share a kv head read each K/V tile once.  Each
// warp owns 16 MT rows, MT m16 tiles that share every K and V fragment
// it loads.
//
// K/V arrive in tiles of 64 positions, through 16-byte cp.async copies
// into a two-stage ring in shared memory: tile i + 1 is in flight while
// tile i is used.  Position p of a tile is row kv_row(p) of the caller's
// K/V (a dense row, or a row found through a block table), so a tile may
// straddle pages of any size.  Positions at or past the block's last live
// one are zero-filled and never read from memory.  Shared rows are padded
// by 16 bytes, which spreads ldmatrix's eight row addresses over all 32
// banks.  int8 K/V rows arrive with their f32 scales and are multiplied in
// f32 and rounded once to bf16 in shared memory before use.
//
// Per tile, each warp computes S = Q K^T with Q and K taken by ldmatrix
// (Q stays in shared memory: registers go to the accumulators), runs the
// online softmax in f32 in registers (base 2 on the SFU, the scale folded
// into log2 e / sqrt(D); row max and row sum over the four lanes of a
// quad by __shfl_xor_sync, the sum only at the end), rounds P to bf16
// straight from the accumulator layout into the A operand, and
// accumulates O += P V with V taken by ldmatrix.trans.
// The finish is O / max(l, 1e-30), staged through the warp's own Q rows
// in shared memory and written in 16-byte stores; padding rows are never
// stored.
//
// Masking: position p is live for row r when p < kv_end and, causal,
// p <= base + r / G.  Masked scores are the finite NEG_INF of the TPU
// kernels (attention_common.cuh), so a row whose first tile is fully
// masked for it takes p = 1 there and the next live tile cancels that
// through corr = 0, as in the CUDA-core bodies.  A block with no live
// position (an empty prefill slot) visits no tile and writes exact zeros.
#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "tc_ptx.cuh"

namespace tc {

using namespace attn;  // kNegInf, to_f32, imin

constexpr int kTile = 64;   // K/V positions per tile
constexpr int kPad = 8;     // bf16 elements of padding per shared row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory of one block, in bytes: the Q tile and two stages
// of K and V in bf16, and for int8 K/V two stages of raw rows and scales.
__host__ __device__ constexpr size_t smem_bytes(int D, int rows,
                                                bool int8) {
  return 2 * ((size_t)rows * (D + kPad)
              + 4 * (size_t)kTile * (D + kPad))
         + (int8 ? 4 * (size_t)kTile * D + 4 * (size_t)kTile * 4 : 0);
}

// cp.async copies 16-byte rows: every tensor must start on 16 bytes.
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// One block's problem: query rows [r0, r0 + 16 MT WARPS) of nrows.
template <typename KVT>
struct Tile {
  const __nv_bfloat16* q;   // row r: q + (r / G) tok_stride + (r % G) D
  __nv_bfloat16* out;       // laid out as q
  const KVT* k;             // position p: k + kv_row(p), D elements
  const KVT* v;
  const float* k_scale;     // int8: position p's scale at kv_row(p) / D
  const float* v_scale;
  size_t tok_stride;        // elements from one query token to the next
  int G, nrows, r0;
  int base;                 // query token t sits at position base + t
  int kv_end;               // positions >= kv_end are masked
  int causal;
  float scale_log2;         // log2(e) / sqrt(D)
};

// Fragment loads from a row-major bf16 block in shared memory at `base`,
// `ld` elements per row.  lane = 8 i + j addresses row j of matrix i.
// A operand of a 16 x 16 block.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int ld) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, base + (8 * ((lane / 8) % 2) + lane % 8) * ld
                     + 8 * (lane / 16));
}

// B operands of two n8 tiles from a 16 (n) x 16 (k) block, rows along n
// (K's layout): b[0], b[1] for n 0-7, b[2], b[3] for n 8-15.
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4],
                                          const __nv_bfloat16* base,
                                          int ld) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, base + (8 * (lane / 16) + lane % 8) * ld
                     + 8 * ((lane / 8) % 2));
}

// B operands of two n8 tiles from a 16 (k) x 16 (n) block, rows along k
// (V's layout), transposed on the way: b[0], b[1] for n 0-7, b[2], b[3]
// for n 8-15.
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4],
                                          const __nv_bfloat16* base,
                                          int ld) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(b, base + (8 * ((lane / 8) % 2) + lane % 8) * ld
                           + 8 * (lane / 16));
}

// The A operand of a 16 x 16 block from the accumulators of its two
// 16 x 8 halves (columns 0-7 in c0, 8-15 in c1), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// kLse (off unless asked for, so the instantiations without it compile
// as before): also write each live row's natural-log softmax normalizer
// L = m + log(max(l, 1e-30)), in f32, to lse[(r / G) tok_stride / D +
// r % G] (the caller offsets lse to its first row, as it does q).
template <typename KVT, int D, int WARPS, int MT, bool kLse = false,
          class KvRow>
__device__ void attend(const Tile<KVT>& a, const KvRow& kv_row,
                       unsigned char* smem, float* lse = nullptr) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int R = 16 * MT * WARPS, kThreads = 32 * WARPS, DS = D + kPad;
  constexpr int CH = D / 8;                  // 16-byte chunks of a bf16 row
  constexpr int NT = kTile / 8;              // n8 tiles of scores
  constexpr bool kInt8 = std::is_same<KVT, int8_t>::value;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // R x DS
  __nv_bfloat16* kvs = qs + R * DS;          // stage s: K at 2s, V at 2s+1
  int8_t* raw = reinterpret_cast<int8_t*>(kvs + 4 * kTile * DS);  // int8
  float* scl = reinterpret_cast<float*>(raw + 4 * kTile * D);     // int8

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;      // accumulator row, column pair
  const int w0 = 16 * MT * warp;             // the warp's first row

  const int last = imin(a.r0 + R, a.nrows) - 1;
  const int t_end = a.causal ? imin(a.kv_end, a.base + last / a.G + 1)
                             : a.kv_end;
  const int n_tiles = t_end > 0 ? (t_end + kTile - 1) / kTile : 0;

  auto load_tile = [&](int i, int s) {
    const int k0 = i * kTile;
    if constexpr (kInt8) {
      constexpr int C8 = D / 16;             // 16-byte chunks of a row
      int8_t* kr = raw + 2 * s * kTile * D;
      int8_t* vr = kr + kTile * D;
      for (int e = tid; e < kTile * C8; e += kThreads) {
        REPRO_TRIP(tc_kv_copy_i8);
        const int t = e / C8, ch = e % C8, p = k0 + t;
        const bool live = p < t_end;
        const size_t off = live ? kv_row(p) + 16 * ch : 0;
        cp_async16(kr + t * D + 16 * ch, a.k + off, live);
        cp_async16(vr + t * D + 16 * ch, a.v + off, live);
      }
      float* ksc = scl + 2 * s * kTile;
      float* vsc = ksc + kTile;
      for (int t = tid; t < kTile; t += kThreads) {
        REPRO_TRIP(tc_scale_copy);
        const int p = k0 + t;
        const bool live = p < t_end;
        const size_t off = live ? kv_row(p) / D : 0;
        cp_async4(ksc + t, a.k_scale + off, live);
        cp_async4(vsc + t, a.v_scale + off, live);
      }
    } else {
      __nv_bfloat16* kt = kvs + 2 * s * kTile * DS;
      __nv_bfloat16* vt = kt + kTile * DS;
      for (int e = tid; e < kTile * CH; e += kThreads) {
        REPRO_TRIP(tc_kv_copy);
        const int t = e / CH, ch = e % CH, p = k0 + t;
        const bool live = p < t_end;
        const size_t off = live ? kv_row(p) + 8 * ch : 0;
        cp_async16(kt + t * DS + 8 * ch, a.k + off, live);
        cp_async16(vt + t * DS + 8 * ch, a.v + off, live);
      }
    }
  };

  for (int e = tid; e < R * CH; e += kThreads) {
    REPRO_TRIP(tc_q_copy);
    const int r = e / CH, ch = e % CH, row = a.r0 + r;
    const bool live = row < a.nrows;         // pad rows: zeros, never stored
    const size_t off = live ? (size_t)(row / a.G) * a.tok_stride
                                  + (size_t)(row % a.G) * D + 8 * ch
                            : 0;
    cp_async16(qs + r * DS + 8 * ch, a.q + off, live);
  }
  cp_async_commit();
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  // rows g and g + 8 of each of the warp's m16 tiles: their live limits;
  // the warp's first row has the lowest, and a tile that ends below it
  // needs no mask
  int lim[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = a.r0 + w0 + 16 * mt + g + 8 * h;
      lim[mt][h] =
          a.causal ? imin(a.kv_end, a.base + row / a.G + 1) : a.kv_end;
    }
  const int lim_lo = a.causal ? imin(a.kv_end, a.base + (a.r0 + w0) / a.G
                                                   + 1)
                              : a.kv_end;

  float o[MT][D / 8][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
    m[mt][0] = m[mt][1] = kNegInf;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    REPRO_TRIP(tc_tiles);
    const int s = i & 1;
    if (i + 1 < n_tiles) load_tile(i + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                      // Q and tile i have landed
    __syncthreads();
    const __nv_bfloat16* kt = kvs + 2 * s * kTile * DS;
    const __nv_bfloat16* vt = kt + kTile * DS;
    if constexpr (kInt8) {                   // dequantize in f32, round once
      const int8_t* kr = raw + 2 * s * kTile * D;
      const int8_t* vr = kr + kTile * D;
      const float* ksc = scl + 2 * s * kTile;
      const float* vsc = ksc + kTile;
      __nv_bfloat16* kw = kvs + 2 * s * kTile * DS;
      __nv_bfloat16* vw = kw + kTile * DS;
      for (int e = tid; e < kTile * D; e += kThreads) {
        REPRO_TRIP(tc_dequant);
        const int t = e / D, d = e % D;
        kw[t * DS + d] = __float2bfloat16_rn(to_f32(kr[e]) * ksc[t]);
        vw[t * DS + d] = __float2bfloat16_rn(to_f32(vr[e]) * vsc[t]);
      }
      __syncthreads();
    }

    float sc[MT][NT][4];                     // S = Q K^T, 16 MT x 64
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[MT][4];                    // Q from shared memory
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        load_a(qa[mt], qs + (w0 + 16 * mt) * DS + 16 * kk, DS);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        load_b_nk(b, kt + 16 * jp * DS + 16 * kk, DS);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(sc[mt][2 * jp], qa[mt], b[0], b[1]);
          mma_16816(sc[mt][2 * jp + 1], qa[mt], b[2], b[3]);
        }
      }
    }

    const int k0 = i * kTile;
    const bool ragged = k0 + kTile > lim_lo;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {        // online softmax, base 2
      float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = k0 + 8 * j + 2 * c + (e & 1);
          const float x = sc[mt][j][e] * a.scale_log2;
          sc[mt][j][e] = !ragged || pos < lim[mt][e / 2] ? x : kNegInf;
          mx[e / 2] = fmaxf(mx[e / 2], sc[mt][j][e]);
        }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2_approx(m[mt][h] - mx[h]);
        m[mt][h] = mx[h];
        l[mt][h] *= corr[h];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[mt][j][e] = exp2_approx(sc[mt][j][e] - m[mt][e / 2]);
          l[mt][e / 2] += sc[mt][j][e];      // this lane's part of the sum
        }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[mt][j][0] *= corr[0];
        o[mt][j][1] *= corr[0];
        o[mt][j][2] *= corr[1];
        o[mt][j][3] *= corr[1];
      }
    }

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // O += P V
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        acc_to_a(pa[mt], sc[mt][2 * kk], sc[mt][2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        load_b_kn(b, vt + 16 * kk * DS + 16 * dp, DS);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(o[mt][2 * dp], pa[mt], b[0], b[1]);
          mma_16816(o[mt][2 * dp + 1], pa[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();                         // before stage s is refilled
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 1);
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 2);
      l[mt][h] = fmaxf(l[mt][h], 1e-30f);
      if constexpr (kLse) {                  // m is in log2 units
        const int row = a.r0 + w0 + 16 * mt + g + 8 * h;
        if (c == 0 && row < a.nrows)
          lse[(size_t)(row / a.G) * (a.tok_stride / D) + row % a.G] =
              m[mt][h] * kLn2 + logf(l[mt][h]);
      }
    }
    __nv_bfloat16* os = qs + (w0 + 16 * mt) * DS;  // the warp's own Q rows
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(os + g * DS + 8 * j + 2 * c) =
          pack_bf16x2(o[mt][j][0] / l[mt][0], o[mt][j][1] / l[mt][0]);
      *reinterpret_cast<uint32_t*>(os + (g + 8) * DS + 8 * j + 2 * c) =
          pack_bf16x2(o[mt][j][2] / l[mt][1], o[mt][j][3] / l[mt][1]);
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * MT * CH; e += 32) {
    REPRO_TRIP(tc_out);
    const int r = e / CH, ch = e % CH, row = a.r0 + w0 + r;
    if (row < a.nrows)
      *reinterpret_cast<uint4*>(a.out + (size_t)(row / a.G) * a.tok_stride
                                + (size_t)(row % a.G) * D + 8 * ch) =
          *reinterpret_cast<const uint4*>(qs + (w0 + r) * DS + 8 * ch);
  }
}

}  // namespace tc
