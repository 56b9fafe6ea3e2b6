"""The CUDA kernels' own source, compiled for the CPU and held against the
plain versions.

The CUDA kernels (``src/repro_torch/csrc/*.cu``: paged attention, dense
and paged decode attention split over their positions with the combine
they share, flash attention, BabelStream's five and the Mamba1 selective
scan) build only with nvcc, on the card.
Here the same sources are compiled with g++ against small stand-ins for
``cuda_runtime.h`` and ``cuda_bf16.h``: each thread block runs as many
``std::thread``s as its launch asks for (128 for the paged, decode and
scan kernels and the bf16 flash kernel, 512 for the decode combine, 64
for the bf16 paged prefill, 256 for the f32 flash kernel and for dot,
1024 for the other stream kernels), sharing one
``std::barrier`` for ``__syncthreads()``; blocks of a 3-D grid run one
after another, and the two CUDA-only spellings (``<<<...>>>`` and
``extern __shared__``) are rewritten.  ``__shfl_down_sync`` is a slot per
thread and two block barriers, which is right only because every warp of
the stream kernels runs its shuffles on one uniform path — the property
their instruction census relies on.  The PTX of the tensor-core body
(``csrc/tc_ptx.cuh``: ``mma.sync`` m16n8k16, ``ldmatrix``, ``cp.async``)
is replaced by a stand-in (``TC_PTX``) of warp-collective operations on
the PTX ISA's fragment layouts, with a barrier per warp; ``__shfl_xor_sync``
and ``__syncwarp`` are per warp too.  The kernels are then driven through
the real wrappers — their argument checks, ctypes marshalling and launch
counters — on CPU tensors, and ``models.attention.attention`` through
its kernel route.  This checks the kernels' indexing, masking, row
tiling, split pieces (of a window, or of pages found through the block
table) and their combine, fragment layouts, online softmax, the dot
reduction chain and its ragged tail, and the scan's lanes, strided B/C
and ragged tiles before they reach the card; what
nvcc accepts, and the kernels' speed, only ``chip_smoke.py`` on the card
can show.
"""
import contextlib
import ctypes
import re
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import decode, paged, prefill_paged
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref,
    paged_prefill_attention_ref)
from repro_torch.kernels.flash_attention import flash
from repro_torch.kernels.ssm_scan import scan
from repro_torch.models import attention as attention_mod
from repro_torch.models.ssm import mamba1_scan
from repro_torch.models.attention import repeat_kv
from repro_torch.models.flash import flash_attention_ref
from repro_torch.kernels.stream import ref as stream_ref
from repro_torch.kernels.stream import stream
from repro_torch.models.kv_quant import quantize_rows

CUDA_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(16) uint4 { unsigned x, y, z, w; };
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local std::barrier<>* emu_barrier = nullptr;
inline thread_local float* emu_shared = nullptr;
inline thread_local float* emu_shfl = nullptr;   // one slot per thread
// a warp's collective operations: one slot per lane, and a barrier of the
// warp's own threads, so that warps may diverge in trip count
struct EmuLane { uint32_t w[6]; const void* ptr; float f; };
inline thread_local EmuLane* emu_warp = nullptr;  // the 32 lanes of a warp
inline thread_local std::barrier<>* emu_warp_barrier = nullptr;
// REPRO_TRIP(name): each thread's iterations of a marked loop, logged at
// the end of its block as (launch, marker, block, thread, count)
struct EmuTrip { long launch; std::string name; long block; int thread;
                 long count; };
inline std::mutex emu_trip_mutex;
inline std::vector<EmuTrip> emu_trip_log;
inline long emu_launches = 0;
inline thread_local std::map<std::string, long>* emu_counts = nullptr;
#define REPRO_TRIP(name) (++(*emu_counts)[#name])
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp_barrier->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const unsigned lane = threadIdx.x % 32;
  emu_warp[lane].f = v;
  __syncwarp();
  const float r = emu_warp[lane ^ mask].f;
  __syncwarp();
  return r;
}
inline float __shfl_down_sync(unsigned, float v, int delta) {
  const unsigned t = threadIdx.x;
  emu_shfl[t] = v;
  __syncthreads();
  const float r = t % 32 + delta < 32 ? emu_shfl[t + delta] : v;
  __syncthreads();
  return r;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t,
                const A&... args) {
  const int warps = (threads + 31) / 32;
  const long launch = emu_launches++;
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      std::vector<float> shared(smem / sizeof(float) + 4, NAN);
      std::vector<float> shfl(threads, NAN);
      std::vector<EmuLane> lanes(32 * warps);
      std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
      for (int w = 0; w < warps; ++w)
        warp_bars.push_back(std::make_unique<std::barrier<>>(
            std::min(32, threads - 32 * w)));
      std::barrier<> bar(threads);
      std::vector<std::thread> pool;
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([&, t] {
          threadIdx = dim3(t);
          blockIdx = dim3(bx, by, bz);
          blockDim = dim3(threads);
          gridDim = grid;
          emu_barrier = &bar;
          emu_shared = shared.data();
          emu_shfl = shfl.data();
          emu_warp = lanes.data() + 32 * (t / 32);
          emu_warp_barrier = warp_bars[t / 32].get();
          std::map<std::string, long> counts;
          emu_counts = &counts;
          kernel(args...);
          const long block = bx + grid.x * (by + grid.y * (long)bz);
          std::lock_guard<std::mutex> lock(emu_trip_mutex);
          for (const auto& [name, n] : counts)
            emu_trip_log.push_back({launch, name, block, t, n});
        });
      for (auto& th : pool) th.join();
    }
}
"""

CUDA_BF16 = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.x << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  __nv_bfloat16 b; b.x = (uint16_t)((u + 0x7fff + ((u >> 16) & 1)) >> 16);
  return b;
}
"""


# Stand-in for csrc/tc_ptx.cuh, written from the PTX ISA's fragment layouts
# for mma.m16n8k16 and ldmatrix (lane = 4 g + c; the lower-indexed element
# of a pair in the lower 16 bits): each operation is warp-collective —
# every lane posts its registers or its row address in its slot, the warp
# meets at its barrier, each lane computes its own result from all the
# slots, and the warp meets again before the slots are reused.  cp.async
# is a synchronous copy (zeros when the source is not valid), so commit
# and wait have nothing to do; the SFU's 2^x is std::exp2.
TC_PTX = r"""
#pragma once
#include <cstdint>
#include <cmath>
#include <cstring>
#include "cuda_bf16.h"
#include "cuda_runtime.h"
namespace tc {
inline float emu_bf16(uint32_t word, int high) {
  const uint32_t u = high ? (word & 0xffff0000u) : (word << 16);
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
// A (16 x 16): a0 rows 0-7 / cols 0-7, a1 rows 8-15 / cols 0-7, a2 rows
// 0-7 / cols 8-15, a3 rows 8-15 / cols 8-15; lane 4 g + c: row g, cols
// 2c, 2c + 1 of its block
inline float emu_a(const EmuLane* w, int row, int k) {
  return emu_bf16(w[4 * (row % 8) + (k % 8) / 2].w[row / 8 + 2 * (k / 8)],
                  k % 2);
}
// B (16 x 8, k x n): b0 rows 0-7, b1 rows 8-15; lane 4 g + c: rows 2c,
// 2c + 1 of column g
inline float emu_b(const EmuLane* w, int k, int n) {
  return emu_bf16(w[4 * n + (k % 8) / 2].w[4 + k / 8], k % 2);
}
inline void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                      uint32_t b1) {
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  for (int i = 0; i < 4; ++i) emu_warp[lane].w[i] = a[i];
  emu_warp[lane].w[4] = b0;
  emu_warp[lane].w[5] = b1;
  __syncwarp();
  for (int i = 0; i < 4; ++i) {      // d0, d1 row g; d2, d3 row g + 8
    const int row = g + 8 * (i / 2), col = 2 * c + i % 2;
    float s = 0.f;
    for (int k = 0; k < 16; ++k)
      s += emu_a(emu_warp, row, k) * emu_b(emu_warp, k, col);
    d[i] += s;
  }
  __syncwarp();
}
// register i of lane 4 g + c: row g, cols 2c, 2c + 1 of matrix i (rows
// addressed by lanes 8 i .. 8 i + 7); transposed: rows 2c, 2c + 1 of
// column g
inline void emu_ldmatrix(uint32_t (&r)[4], const void* row, bool trans) {
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  emu_warp[lane].ptr = row;
  __syncwarp();
  for (int i = 0; i < 4; ++i) {
    uint16_t lo, hi;
    if (!trans) {
      const char* p = static_cast<const char*>(emu_warp[8 * i + g].ptr);
      std::memcpy(&lo, p + 4 * c, 2);
      std::memcpy(&hi, p + 4 * c + 2, 2);
    } else {
      const char* p0 = static_cast<const char*>(emu_warp[8 * i + 2 * c].ptr);
      const char* p1 =
          static_cast<const char*>(emu_warp[8 * i + 2 * c + 1].ptr);
      std::memcpy(&lo, p0 + 2 * g, 2);
      std::memcpy(&hi, p1 + 2 * g, 2);
    }
    r[i] = lo | (uint32_t)hi << 16;
  }
  __syncwarp();
}
inline void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  emu_ldmatrix(r, row, false);
}
inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  emu_ldmatrix(r, row, true);
}
inline void cp_async16(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 16); else std::memset(dst, 0, 16);
}
inline void cp_async4(void* dst, const void* src, bool valid) {
  if (valid) std::memcpy(dst, src, 4); else std::memset(dst, 0, 4);
}
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
inline float exp2_approx(float x) { return std::exp2(x); }
inline uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__float2bfloat16_rn(lo).x
         | (uint32_t)__float2bfloat16_rn(hi).x << 16;
}
}  // namespace tc
"""

# One warp through the tensor-core body's fragment helpers
# (csrc/attention_tc.cuh): A (16 x 16) times B given as B^T (n x k rows,
# K's layout) and as B (k x n rows, V's layout), and the first product's
# accumulators turned back into an A operand (P's path) times B.
MMA_PROBE = r"""
#include "attention_tc.cuh"
namespace {
struct Probe { const uint16_t* a; const uint16_t* bt; const uint16_t* b;
               float* c; };
constexpr int LD = 24;                       // padded row, as in the body
__global__ void mma_probe_kernel(Probe p) {
  extern __shared__ float smem[];
  __nv_bfloat16* s = reinterpret_cast<__nv_bfloat16*>(smem);
  const int lane = threadIdx.x, g = lane / 4, c = lane % 4;
  for (int e = lane; e < 256; e += 32) {
    s[(e / 16) * LD + e % 16].x = p.a[e];
    s[16 * LD + (e / 16) * LD + e % 16].x = p.bt[e];
    s[32 * LD + (e / 16) * LD + e % 16].x = p.b[e];
  }
  __syncwarp();
  uint32_t a[4], bt[4], b[4], pa[4];
  tc::load_a(a, s, LD);
  tc::load_b_nk(bt, s + 16 * LD, LD);
  tc::load_b_kn(b, s + 32 * LD, LD);
  float acc[3][2][4] = {};
  tc::mma_16816(acc[0][0], a, bt[0], bt[1]);
  tc::mma_16816(acc[0][1], a, bt[2], bt[3]);
  tc::mma_16816(acc[1][0], a, b[0], b[1]);
  tc::mma_16816(acc[1][1], a, b[2], b[3]);
  tc::acc_to_a(pa, acc[0][0], acc[0][1]);
  tc::mma_16816(acc[2][0], pa, b[0], b[1]);
  tc::mma_16816(acc[2][1], pa, b[2], b[3]);
  for (int m = 0; m < 3; ++m)
    for (int n = 0; n < 2; ++n)
      for (int i = 0; i < 4; ++i)
        p.c[m * 256 + (g + 8 * (i / 2)) * 16 + 8 * n + 2 * c + i % 2] =
            acc[m][n][i];
}
}  // namespace
extern "C" int emu_mma_probe(const void* a, const void* bt, const void* b,
                             void* c) {
  Probe p{static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(bt),
          static_cast<const uint16_t*>(b), static_cast<float*>(c)};
  return (int)attn::launch_smem(mma_probe_kernel, dim3(1), 32,
                                3 * 16 * LD * 2, nullptr, p);
}
"""


# the trip log's C interface, in a source of its own
EMU_TRIPS = r"""
#include "cuda_runtime.h"
#include <cstring>
extern "C" long emu_trip_launches() { return emu_launches; }
extern "C" long emu_trip_entries() { return (long)emu_trip_log.size(); }
extern "C" void emu_trip_entry(long i, long* out, char* name) {
  const EmuTrip& e = emu_trip_log[i];
  out[0] = e.launch;
  out[1] = e.block;
  out[2] = e.thread;
  out[3] = e.count;
  std::strncpy(name, e.name.c_str(), 63);
  name[63] = 0;
}
extern "C" void emu_trip_clear() { emu_trip_log.clear(); }
"""


def _rewrite(src: str) -> str:
    src = src.replace("extern __shared__ float smem[];",
                      "float* smem = emu_shared;")
    return re.sub(r"(\w+)<<<(.*)>>>\((.*)\);", r"emu_launch(\1, \2, \3);",
                  src)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the CPU build of the CUDA sources "
                    "needs it")
    d = tmp_path_factory.mktemp("cuda_emu")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME)
    (d / "cuda_bf16.h").write_text(CUDA_BF16)
    for f in build.CSRC.glob("*.cu*"):
        out = f.name.replace(".cu", ".cpp") if f.suffix == ".cu" else f.name
        (d / out).write_text(_rewrite(f.read_text()))
    (d / "tc_ptx.cuh").write_text(TC_PTX)         # the PTX, emulated
    (d / "mma_probe.cpp").write_text(_rewrite(MMA_PROBE))
    (d / "emu_trips.cpp").write_text(EMU_TRIPS)
    lib = d / "libemu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-pthread", f"-I{d}", "-o", str(lib),
                    *map(str, sorted(d.glob("*.cpp")))], check=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture
def cuda_path_on_cpu(emulated, monkeypatch):
    """Route the wrappers' CUDA path to the emulated library on CPU
    tensors: the device checks see a card, the stream is 0."""
    monkeypatch.setattr(build, "library", lambda: emulated)
    for mod in (paged, prefill_paged):
        monkeypatch.setattr(mod, "on_cpu", lambda *a: False)
        monkeypatch.setattr(mod, "check_args",
                            lambda kind, *a: paged.check_layout(kind, *a))
        monkeypatch.setattr(mod.KERNEL, "_fn", None)
    for mod in (decode, flash):
        monkeypatch.setattr(mod, "on_cpu", lambda *a: False)
        monkeypatch.setattr(mod, "check_dense",
                            lambda kind, *a: decode.dense_layout(kind, *a))
        monkeypatch.setattr(mod.KERNEL, "_fn", None)
    monkeypatch.setattr(attention_mod, "on_card", lambda q: True)
    monkeypatch.setattr(scan, "on_cpu", lambda *a: False)
    monkeypatch.setattr(scan, "check_scan", scan.scan_layout)
    monkeypatch.setattr(scan.KERNEL, "_fn", None)
    monkeypatch.setattr(stream, "on_cpu", lambda *a: False)
    monkeypatch.setattr(stream, "check_device", lambda *a: None)
    for kernel in stream.KERNELS.values():
        monkeypatch.setattr(kernel, "_fn", None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))


def _case(seed, B, T, H, KV, D, page, NB, L, dtype, int8, empty=False):
    rng = np.random.RandomState(seed)
    P = B * NB + 2
    q = torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)).to(dtype)
    kp = torch.from_numpy(rng.randn(L, P, page, KV, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(L, P, page, KV, D).astype(np.float32))
    ks = vs = None
    if int8:
        (kp, ks), (vp, vs) = quantize_rows(kp), quantize_rows(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    tbl = torch.from_numpy(rng.permutation(np.arange(1, P))[:B * NB]
                           .reshape(B, NB).astype(np.int32))
    base = rng.randint(0, NB * page - T + 1, size=B).astype(np.int32)
    new = base + rng.randint(1, T + 1, size=B).astype(np.int32)
    if empty:
        base[0] = new[0] = 0
    return (q, kp, vp, tbl, torch.from_numpy(base), torch.from_numpy(new),
            int(rng.randint(0, L)), ks, vs)


# f32: only the order of sums differs; bf16: the output's own rounding,
# and int8 pages dequantized to f32 in the kernel but to bf16 in the plain
# version — the tolerances chip_smoke.py holds the card to
TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}

# (B, T, H, KV, D, page, NB, L, dtype, int8 pools): GQA, MQA, G=7 with
# T*G = 140 rows (three prefill row tiles), granite's G=4 / D=128, MHA on
# single-row pages, granite-20b's G=48 over one KV head (three decode row
# tiles), phi4-mini's G=3 / D=128, and the MoE archs' G=5 (llama4-scout,
# 40 over 8 heads) and G=6 (grok-1, 48 over 8) at D=128, T*G = 15 and 18
# rows against the prefill's 16-row tiles
CASES = [
    (2, 6, 4, 2, 16, 8, 3, 2, torch.float32, False),
    (3, 5, 4, 1, 32, 4, 5, 1, torch.float32, True),
    (2, 20, 14, 2, 64, 16, 3, 2, torch.bfloat16, False),
    (2, 3, 32, 8, 128, 16, 2, 1, torch.bfloat16, True),
    (2, 4, 4, 4, 16, 1, 9, 1, torch.float32, False),
    (2, 3, 48, 1, 128, 16, 2, 1, torch.bfloat16, False),
    (2, 3, 24, 8, 128, 16, 2, 1, torch.bfloat16, True),
    (2, 3, 40, 8, 128, 16, 2, 1, torch.bfloat16, False),
    (2, 3, 48, 8, 128, 16, 2, 1, torch.bfloat16, True),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_emulated_kernels_match_plain(case, cuda_path_on_cpu):
    *geom, dtype, int8 = case
    q, kp, vp, tbl, base, new, layer, ks, vs = _case(sum(geom), *geom,
                                                     dtype, int8, empty=True)
    tol = TOL[dtype]
    n0 = (paged.KERNEL.launches, prefill_paged.KERNEL.launches)

    got = prefill_paged.paged_prefill_attention(
        q, kp, vp, tbl, base, new, layer, k_scale=ks, v_scale=vs,
        pages_per_step=3)
    want = paged_prefill_attention_ref(q, kp, vp, tbl, base, new, layer,
                                       ks, vs)
    live = new > 0
    assert (got[~live] == 0).all()                   # empty slot: zeros
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               rtol=tol, atol=tol)

    kv_len = torch.maximum(new, torch.ones_like(new))
    got = paged.paged_decode_attention(q[:, :1].contiguous(), kp, vp, tbl,
                                       kv_len, layer, k_scale=ks, v_scale=vs)
    want = paged_decode_attention_ref(q[:, :1], kp, vp, tbl, kv_len, layer,
                                      ks, vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert (paged.KERNEL.launches, prefill_paged.KERNEL.launches) == \
        (n0[0] + 1, n0[1] + 1)


def _bf16_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).view(torch.int16).contiguous()


def test_emulated_mma_fragment_layout(emulated):
    """The stand-in's mma.m16n8k16 and ldmatrix, through the body's
    fragment helpers: A @ B with B loaded from K's layout (B^T rows) and
    from V's layout (B rows, transposed on load), and the accumulators of
    the first product rounded back into an A operand (P's path) — each
    against a float matmul of the same bf16 values."""
    rng = np.random.default_rng(16816)
    a, b = (torch.from_numpy(rng.standard_normal((16, 16), np.float32))
            .to(torch.bfloat16) for _ in range(2))
    abits, bbits = _bf16_bits(a), _bf16_bits(b)
    btbits = _bf16_bits(b.t().contiguous())
    c = torch.empty(3, 16, 16)
    assert emulated.emu_mma_probe(
        ctypes.c_void_p(abits.data_ptr()), ctypes.c_void_p(btbits.data_ptr()),
        ctypes.c_void_p(bbits.data_ptr()), ctypes.c_void_p(c.data_ptr())) == 0
    want = a.double() @ b.double()
    # f32 sums of 16 exact bf16 products: a few f32 ulps of sum |a b|
    tol = 1e-6 * (a.double().abs() @ b.double().abs()).max().item()
    torch.testing.assert_close(c[0].double(), want, rtol=0, atol=tol)
    torch.testing.assert_close(c[1].double(), want, rtol=0, atol=tol)
    p = c[0].to(torch.bfloat16).double()
    torch.testing.assert_close(c[2].double(), p @ b.double(), rtol=0,
                               atol=1e-6 * (p.abs() @ b.double().abs()).max()
                               .item())


# bf16 q on the tensor-core prefill body, (B, T, H, KV, D, page, NB, L,
# int8 pools): single-row pages (every position its own table entry),
# page 4 with int8 pools, G = 7 at page 16 over three 64-position tiles,
# and page 24, whose pages straddle the tiles' boundaries
TC_PREFILL_CASES = [
    (2, 5, 8, 2, 32, 1, 90, 1, False),
    (2, 9, 4, 1, 16, 4, 30, 2, True),
    (2, 6, 14, 2, 64, 16, 9, 1, False),
    (2, 7, 4, 2, 16, 24, 6, 1, True),
]


@pytest.mark.parametrize("case", TC_PREFILL_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_emulated_prefill_tiles_across_pages(case, cuda_path_on_cpu):
    """64-position K/V tiles gathered through the block table at several
    page sizes, bf16 and int8 pools under bf16 q, an empty slot (exact
    zeros), against the plain version at the bf16 tolerance."""
    *geom, int8 = case
    q, kp, vp, tbl, base, new, layer, ks, vs = _case(
        sum(geom) + 1, *geom, torch.bfloat16, int8, empty=True)
    n0 = prefill_paged.KERNEL.launches
    got = prefill_paged.paged_prefill_attention(
        q, kp, vp, tbl, base, new, layer, k_scale=ks, v_scale=vs)
    want = paged_prefill_attention_ref(q, kp, vp, tbl, base, new, layer,
                                       ks, vs)
    live = new > 0
    assert (got[~live] == 0).all()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               rtol=TOL[torch.bfloat16],
                               atol=TOL[torch.bfloat16])
    assert prefill_paged.KERNEL.launches == n0 + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_prefill_at_the_verify_shape(dtype, cuda_path_on_cpu):
    """The speculative verify's call: T = 5 (k = 4 proposals and the feed
    token), ragged grants 0-5 with one slot idle, every base mid-page.
    Then a rollback: each slot keeps part of its window, the next window
    starts at the truncated length and writes different rows over the
    rejected ones, and the rows past each new length hold stale values
    large enough to show any read of them.  Against the plain version
    both times."""
    B, T, H, KV, D, page, NB, L, layer = 6, 5, 8, 2, 32, 4, 8, 2, 1
    q, kp, vp, tbl, _, _, _, _, _ = _case(31, B, T, H, KV, D, page, NB, L,
                                          dtype, False)
    rng = np.random.RandomState(5)

    def write(pos_lo, pos_hi, value=None):
        for b in range(B):
            for pos in range(int(pos_lo[b]), int(pos_hi[b])):
                blk, off = tbl[b, pos // page], pos % page
                for pool in (kp, vp):
                    rows = (torch.full((KV, D), value) if value is not None
                            else torch.from_numpy(rng.randn(KV, D)
                                                  .astype(np.float32)))
                    pool[layer, blk, off] = rows.to(dtype)

    def check(base, new):
        n0 = prefill_paged.KERNEL.launches
        got = prefill_paged.paged_prefill_attention(q, kp, vp, tbl, base,
                                                    new, layer)
        want = paged_prefill_attention_ref(q, kp, vp, tbl, base, new, layer)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        assert prefill_paged.KERNEL.launches == n0 + 1

    base = torch.tensor([6, 9, 13, 7, 2, 10], dtype=torch.int32)
    grants = torch.tensor([5, 4, 3, 0, 2, 1], dtype=torch.int32)
    new = base + grants
    write(new, new + T, value=1e3)             # never read: past the length
    check(base, new)
    kept = torch.tensor([2, 1, 3, 0, 1, 1], dtype=torch.int32)
    base2 = base + kept                        # truncated to the accepted
    new2 = base2 + torch.tensor([5, 5, 4, 1, 0, 3], dtype=torch.int32)
    write(base2, new2)                         # rewritten over the rejected
    write(new2, torch.maximum(new, new2) + T, value=-1e3)
    check(base2, new2)


def test_emulated_decode_at_page_boundaries(cuda_path_on_cpu):
    """kv_len exactly on a page boundary, one past it and the full table:
    the dead-block skip is on j * page < kv_len, never on the table."""
    q, kp, vp, tbl, _, _, layer, _, _ = _case(5, 4, 1, 4, 2, 16, 4, 3, 1,
                                              torch.float32, False)
    kv_len = torch.tensor([4, 5, 12, 1], dtype=torch.int32)
    got = paged.paged_decode_attention(q, kp, vp, tbl, kv_len, layer)
    want = paged_decode_attention_ref(q, kp, vp, tbl, kv_len, layer)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# the paged decode kernel's pools: (q dtype, pool); int8 pools dequantize
# in f32 under either q
PAGED_POOLS = [(torch.float32, "f32"), (torch.bfloat16, "bf16"),
               (torch.float32, "int8"), (torch.bfloat16, "int8")]


def _paged_decode_case(seed, B, H, KV, D, page, NB, q_dtype, pool, lens):
    """One-token q and a 2-layer pool whose pages are scattered through a
    random table; kv_len as given."""
    q, kp, vp, tbl, _, _, _, ks, vs = _case(
        seed, B, 1, H, KV, D, page, NB, 2,
        torch.float32 if pool == "int8" else q_dtype, pool == "int8")
    return (q.to(q_dtype), kp, vp, tbl, torch.tensor(lens, dtype=torch.int32),
            ks, vs)


@pytest.mark.parametrize("q_dtype,pool", PAGED_POOLS,
                         ids=lambda x: str(x).replace("torch.", ""))
@pytest.mark.parametrize("G", [4, 7, 48])
def test_emulated_paged_decode_across_splits_and_pages(G, q_dtype, pool,
                                                       cuda_path_on_cpu):
    """B x KV = 12 leaves 22 splits of a 40-page table (page 4): kv_len
    of one token, one page, one page and a token, 100 (25 live pages, one
    or two a piece, pieces 13-21 empty) and the full table (two pages a
    piece), against the plain version; a slot with kv_len == 0 gives
    exact zeros.  G = 4 (granite-8b), 7 (qwen2-0.5b) and 48 (granite-20b:
    three row tiles of 16, each reading the piece again)."""
    B, KV, D, page, NB = 6, 2, 32, 4, 40
    assert paged.splits(NB, B, KV) == 22
    lens = [1, page, page + 1, 100, NB * page, 0]
    q, kp, vp, tbl, kv_len, ks, vs = _paged_decode_case(
        G + len(pool), B, G * KV, KV, D, page, NB, q_dtype, pool, lens)
    tol = TOL[q_dtype]
    n0 = paged.KERNEL.launches
    got = paged.paged_decode_attention(q, kp, vp, tbl, kv_len, 1,
                                       k_scale=ks, v_scale=vs)
    want = paged_decode_attention_ref(q, kp, vp, tbl, kv_len, 1, ks, vs)
    assert got.dtype == q_dtype and (got[-1] == 0).all()
    torch.testing.assert_close(got[:-1].float(), want[:-1].float(),
                               rtol=tol, atol=tol)
    assert paged.KERNEL.launches == n0 + 1


@pytest.mark.parametrize("q_dtype,pool", PAGED_POOLS,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_emulated_paged_kernels_on_aliased_tables(q_dtype, pool,
                                                  cuda_path_on_cpu):
    """Prefix sharing maps one physical page into several tables: slot 1's
    first 3 pages are slot 0's, and slot 2's first page is too.  Decode at
    kv_len off the page edges and a prefill chunk from a base that is not
    a page multiple (a sharer's first chunk after a mid-page share) read
    the aliased pages as the plain version does."""
    B, H, KV, D, page, NB, T = 3, 8, 2, 32, 4, 6, 5
    q, kp, vp, tbl, _, _, _, ks, vs = _case(
        17 + len(pool), B, T, H, KV, D, page, NB, 2,
        torch.float32 if pool == "int8" else q_dtype, pool == "int8")
    q = q.to(q_dtype)
    tbl[1, :3] = tbl[0, :3]
    tbl[2, :1] = tbl[0, :1]
    tol = TOL[q_dtype]
    kv_len = torch.tensor([13, 14, 7], dtype=torch.int32)
    got = paged.paged_decode_attention(q[:, :1].contiguous(), kp, vp, tbl,
                                       kv_len, 1, k_scale=ks, v_scale=vs)
    want = paged_decode_attention_ref(q[:, :1], kp, vp, tbl, kv_len, 1, ks,
                                      vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    base = torch.tensor([10, 10, 2], dtype=torch.int32)
    new = base + torch.tensor([T, 3, T], dtype=torch.int32)
    got = prefill_paged.paged_prefill_attention(
        q, kp, vp, tbl, base, new, 1, k_scale=ks, v_scale=vs)
    want = paged_prefill_attention_ref(q, kp, vp, tbl, base, new, 1, ks, vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_paged_decode_online_softmax_across_tiles(dtype,
                                                           cuda_path_on_cpu):
    """B x KV = 33 leaves 8 splits of a 56-page table (page 16): the full
    table gives pieces of 7 pages, four 32-position tiles that straddle
    pages, so the online softmax carries m, l and acc across tiles and
    the 3-stage cp.async ring reuses its stages; 600 tokens give pieces
    of 5 pages and a shorter last one, and 37 tokens leave pieces 3-7
    empty."""
    B, H, KV, D, page, NB = 3, 44, 11, 16, 16, 56
    assert paged.splits(NB, B, KV) == 8
    q, kp, vp, tbl, kv_len, _, _ = _paged_decode_case(
        57, B, H, KV, D, page, NB, dtype, "f32" if dtype == torch.float32
        else "bf16", [NB * page, 600, 37])
    got = paged.paged_decode_attention(q, kp, vp, tbl, kv_len)
    want = paged_decode_attention_ref(q, kp, vp, tbl, kv_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_emulated_paged_decode_splits_follow_static_shapes(
        cuda_path_on_cpu, monkeypatch):
    """The split count and the scratch the wrapper hands the kernel depend
    on (NB, B, KV) only: every kv_len, from all zeros to the full table,
    launches the same grid."""
    calls = []
    monkeypatch.setattr(paged.KERNEL, "_fn",
                        lambda *a: calls.append(a) or 0)
    B, H, KV, D, page, NB = 4, 32, 8, 16, 16, 22
    for lens in ([0] * B, [1, 80, 316, 200], [NB * page] * B):
        q, kp, vp, tbl, kv_len, _, _ = _paged_decode_case(
            3, B, H, KV, D, page, NB, torch.float32, "f32", lens)
        paged.paged_decode_attention(q, kp, vp, tbl, kv_len)
    assert paged.splits(NB, B, KV) == 8
    assert {a[17] for a in calls} == {8}             # the splits argument
    assert paged.block_smem_bytes("decode", torch.bfloat16, torch.bfloat16,
                                  128, 16, 4) == \
        paged.block_smem_bytes("decode", torch.bfloat16, torch.bfloat16,
                               128, 1, 4)


def test_emulated_paged_decode_refuses_misaligned_pool(cuda_path_on_cpu):
    """The kernel copies K and V rows 16 bytes at a time: a pool view 4
    bytes past a 16-byte boundary is refused, not read another way, and
    the same values in an aligned pool go through."""
    q, kp, vp, tbl, kv_len, _, _ = _paged_decode_case(
        5, 2, 4, 2, 16, 4, 3, torch.float32, "f32", [5, 12])
    shifted = torch.zeros(kp.numel() + 1)[1:].view(kp.shape)
    shifted.copy_(kp)
    n0 = paged.KERNEL.launches
    for k, v in ((shifted, vp), (kp, shifted)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            paged.paged_decode_attention(q, k, v, tbl, kv_len)
    assert paged.KERNEL.launches == n0
    torch.testing.assert_close(
        paged.paged_decode_attention(q, shifted.clone(), vp, tbl, kv_len),
        paged_decode_attention_ref(q, kp, vp, tbl, kv_len),
        rtol=2e-5, atol=2e-5)


def _dense(seed, B, S, T, H, KV, D, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dtype)
            for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]


# (B, T, H, KV, D, dtype): GQA; MQA over two 64-position tiles; G = 7;
# granite's G = 4 at D = 128; MHA
DECODE_CASES = [(2, 24, 4, 2, 16, torch.float32),
                (3, 150, 4, 1, 32, torch.float32),
                (2, 40, 14, 2, 64, torch.bfloat16),
                (2, 20, 32, 8, 128, torch.bfloat16),
                (2, 9, 4, 4, 16, torch.float32),
                (2, 40, 48, 1, 128, torch.bfloat16),
                (2, 20, 24, 8, 128, torch.bfloat16)]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_emulated_decode_attention_matches_plain(case, cuda_path_on_cpu):
    """A scalar kv_len below T and kv_start > 0 in every slot but the
    first; then no kv_start at all; then an empty window (kv_start >=
    kv_len) in slot 1, which the kernel gives as exact zeros."""
    B, T, H, KV, D, dtype = case
    q, k, v = _dense(T + H, B, 1, T, H, KV, D, dtype)
    tol = TOL[dtype]
    kv_len = torch.tensor(T - 3, dtype=torch.int32)
    start = torch.tensor([0] + [1 + 5 * b % (T - 4) for b in range(1, B)],
                         dtype=torch.int32)           # all below kv_len
    n0 = decode.KERNEL.launches
    for s in (start, None):
        got = decode.decode_attention(q, k, v, kv_len, s)
        want = decode_attention_ref(q, k, v, kv_len, s)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    empty = start.clone()
    empty[1] = T - 3
    got = decode.decode_attention(q, k, v, kv_len, empty)
    want = decode_attention_ref(q, k, v, kv_len, empty)
    assert (got[1] == 0).all()
    keep = torch.arange(B) != 1
    torch.testing.assert_close(got[keep].float(), want[keep].float(),
                               rtol=tol, atol=tol)
    assert decode.KERNEL.launches == n0 + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_decode_attention_across_splits(dtype, cuda_path_on_cpu):
    """A cache of 300 rows over 10 splits per kv head, each a whole number
    of 32-position tiles of the slot's window: a full window (the last
    piece 2 rows), kv_start = 37 (the pieces start inside a cache tile),
    a window of 40 (pieces 2-9 empty while the window is not) and one of
    a single row; then slot 3's window empty, which the kernel gives as
    exact zeros.  The same tolerances as the single-split cases."""
    B, T, H, KV, D = 4, 300, 8, 2, 32
    assert decode.splits(T, B, KV) == 10
    q, k, v = _dense(T, B, 1, T, H, KV, D, dtype)
    tol = TOL[dtype]
    kv_len = torch.tensor(290, dtype=torch.int32)
    start = torch.tensor([0, 37, 250, 289], dtype=torch.int32)
    n0 = decode.KERNEL.launches
    got = decode.decode_attention(q, k, v, kv_len, start)
    want = decode_attention_ref(q, k, v, kv_len, start)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    start[3] = 290
    got = decode.decode_attention(q, k, v, kv_len, start)
    want = decode_attention_ref(q, k, v, kv_len, start)
    assert (got[3] == 0).all()
    torch.testing.assert_close(got[:3].float(), want[:3].float(), rtol=tol,
                               atol=tol)
    assert decode.KERNEL.launches == n0 + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_decode_online_softmax_across_tiles(dtype,
                                                     cuda_path_on_cpu):
    """B x KV = 33 leaves 8 splits, so a 1090-row window gives pieces of
    five 32-position tiles: the online softmax carries m, l and acc
    across tiles and the 3-stage cp.async ring reuses its stages; slot 1
    starts mid-tile, slot 2's window is a single tile."""
    B, T, H, KV, D = 3, 1100, 11, 11, 16
    assert decode.splits(T, B, KV) == 8
    q, k, v = _dense(T + 1, B, 1, T, H, KV, D, dtype)
    kv_len = torch.tensor(1090, dtype=torch.int32)
    start = torch.tensor([0, 45, 1070], dtype=torch.int32)
    got = decode.decode_attention(q, k, v, kv_len, start)
    want = decode_attention_ref(q, k, v, kv_len, start)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_emulated_decode_refuses_misaligned_cache(cuda_path_on_cpu):
    """The kernel copies K and V 16 bytes at a time: a cache view 4 bytes
    past a 16-byte boundary is refused, not read another way."""
    q, k, v = _dense(3, 2, 1, 8, 4, 2, 16, torch.float32)
    shifted = torch.zeros(k.numel() + 1)[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode.decode_attention(q, shifted, v, 8)


# (B, S, T, H, KV, D, causal, dtype): a ragged causal S with GQA; two
# ragged q tiles over two ragged k/v tiles, non-causal; S != T, MQA;
# granite's head dim and group, causal; MHA, S == T == 64 exactly
FLASH_CASES = [(2, 37, 37, 4, 2, 16, True, torch.float32),
               (1, 70, 70, 2, 2, 32, False, torch.bfloat16),
               (2, 20, 45, 4, 1, 16, False, torch.float32),
               (1, 33, 33, 8, 2, 128, True, torch.bfloat16),
               (1, 64, 64, 2, 2, 64, True, torch.float32)]


# bf16 on the tensor-core body: S and T not multiples of 64, causal and
# not, S != T both ways, G = 7
FLASH_CASES += [(2, 100, 100, 4, 2, 32, True, torch.bfloat16),
                (1, 45, 130, 7, 1, 16, False, torch.bfloat16),
                (1, 130, 70, 4, 1, 64, True, torch.bfloat16),
                (1, 40, 90, 14, 2, 16, True, torch.bfloat16)]
# granite-20b (G = 48 over one KV head) and phi4-mini (G = 3) at D = 128
FLASH_CASES += [(1, 20, 20, 48, 1, 128, True, torch.bfloat16),
                (1, 33, 33, 24, 8, 128, True, torch.bfloat16)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_emulated_flash_attention_matches_plain(case, cuda_path_on_cpu):
    """k and v unrepeated (KV dividing H); the plain version runs on them
    repeated to H heads."""
    B, S, T, H, KV, D, causal, dtype = case
    q, k, v = _dense(S + T + D, B, S, T, H, KV, D, dtype)
    tol = TOL[dtype]
    n0 = flash.KERNEL.launches
    got = flash.flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, repeat_kv(k, H), repeat_kv(v, H), causal,
                               S, T)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert flash.KERNEL.launches == n0 + 1


def test_emulated_attention_route_takes_what_the_reference_serves(
        cuda_path_on_cpu):
    """``attention()`` on the kernel route at S = T = 600 (chunks of 1024:
    the reference's direct attention; 512 does not divide 600, so the JAX
    Pallas wrapper's contract refuses it) and at S = T = 608 over chunks
    of 32 (the reduced configs: the chunked reference, which 512 does not
    divide either) through the emulated flash kernel, against the
    reference dispatch, f32 within 2e-5.  The public wrapper keeps the
    512-block contract, and a shape both dispatches refuse still raises,
    with no launch."""
    n0 = flash.KERNEL.launches
    for S, chunk in ((600, 1024), (608, 32)):
        q, k, v = _dense(S, 1, S, S, 4, 2, 16, torch.float32)
        got = attention_mod.attention(q, k, v, True, chunk, chunk)
        want = attention_mod.attention(q, k, v, True, chunk, chunk,
                                       plain=True)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        if S == 600:
            torch.testing.assert_close(
                got, attention_mod.direct_attention(q, k, v, True),
                rtol=2e-5, atol=2e-5)
        with pytest.raises(ValueError, match="divide"):
            flash.flash_attention(q, k, v)
    assert flash.KERNEL.launches == n0 + 2
    q, k, v = _dense(7, 1, 40, 40, 2, 2, 16, torch.float32)
    for plain in (False, True):          # 32 * 32 < 40 * 40, 32 !| 40
        with pytest.raises(AssertionError):
            attention_mod.attention(q, k, v, True, 32, 32, plain=plain)
    assert flash.KERNEL.launches == n0 + 2


def test_emulated_moe_prefill_takes_the_pallas_routes_drops(
        cuda_path_on_cpu):
    """The MoE's capacity counts every row of a call, idle slots' among
    them, and an idle prefill slot's attention is exact zeros on the
    kernels (Pallas and CUDA) but a uniform softmax over its table's
    pages in both references.  llama4-scout reduced in f32 (E 4, top-1,
    capacity int(1.25 * 24 / 4) = 7 of 24 rows): one ``lm_prefill_paged``
    over pools holding earlier rows, slot 0 idle and first by index,
    slot 1 granted 8 rows from 0, slot 2 3 rows from 5 (5 pad rows).
    The port's kernel route (the emulated CUDA kernels) is within 1e-4 of
    the JAX package's ``attention_impl="pallas"`` route (interpret mode)
    on the live slots' logits and pools, and both kernel routes differ
    from both references (the JAX ``"reference"`` route and the port's
    plain route, within 1e-4 of each other) on a real slot by far more:
    the idle rows route differently and take other real rows'
    capacity."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import get_model as jget_model
    from repro_torch import configs as tconfigs
    from repro_torch.models.model import get_model as tget_model
    from repro_torch.models.params import params_from_jax

    arch = "llama4-scout-17b-a16e"
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(), dtype="float32")
    jp = jget_model(jcfg).init(jax.random.key(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    B, T, page, NB = 3, 8, 4, 8
    P = B * NB + 1
    rng = np.random.RandomState(0)
    shape = (tcfg.n_layers, P, page, tcfg.n_kv_heads, tcfg.head_dim)
    pools = {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}
    table = np.arange(B * NB, dtype=np.int32)[::-1].reshape(B, NB) + 1
    length = np.array([0, 0, 5], np.int32)
    toks = rng.randint(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    grants = np.array([0, 8, 3], np.int32)
    live = grants > 0
    out = {}
    for impl in ("pallas", "reference"):
        jm = jget_model(dataclasses.replace(jcfg, attention_impl=impl))
        jc = dict(jm.init_paged_cache(B, NB, page, P),
                  table=jnp.asarray(table), length=jnp.asarray(length),
                  **{n: jnp.asarray(a) for n, a in pools.items()})
        logits, jc = jm.prefill_step_paged(jp, jnp.asarray(toks), jc,
                                           jnp.asarray(grants))
        out["jax " + impl] = (np.asarray(logits)[live],
                              np.asarray(jc["k"])[:, 1:])
    n0 = prefill_paged.KERNEL.launches
    for name, plain in (("port kernel", False), ("port plain", True)):
        tc = tget_model(tcfg, plain).init_paged_cache(B, NB, page, P, "cpu")
        tc.update(table=torch.from_numpy(table.copy()),
                  length=torch.from_numpy(length.copy()),
                  **{n: torch.from_numpy(a.copy()) for n, a in pools.items()})
        logits, tc = tget_model(tcfg, plain).prefill_step_paged(
            tp, torch.from_numpy(toks), tc, torch.from_numpy(grants))
        out[name] = (logits.numpy()[live], tc["k"][:, 1:].numpy())
    assert prefill_paged.KERNEL.launches == n0 + tcfg.n_layers
    for got, want in (("port kernel", "jax pallas"),
                      ("port plain", "jax reference")):
        for a, b in zip(out[got], out[want]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    gap = np.abs(out["jax pallas"][0] - out["jax reference"][0]).max(-1)
    assert gap.max() > 0.05, gap


# (rows, cols): one full block of add and triad; a ragged 3-block array
# (guard, and a two-launch dot chain 3000 -> 3 -> 1); 4 blocks with a
# ragged last one; copy and mul (4096 f32 or 8192 bf16 elements a block):
# two full f32 blocks and one full bf16 block, and ragged last blocks with
# a ragged tail of n % 8 = 3 (f32 n % 4 = 3) and n % 8 = 1
STREAM_SHAPES = [(8, 128), (3, 1000), (16, 200), (8, 1024), (3, 1001),
                 (9, 1001)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", STREAM_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_emulated_stream_kernels_match_plain(shape, dtype, cuda_path_on_cpu):
    """copy, mul, add and triad bit-identical to the plain versions (the
    kernels round where they round); dot within 2^-20 of sum |a b|, the
    kernel's fixed tree of f32 sums against torch's order, each within
    log2(n) f32 epsilons of it."""
    rng = np.random.default_rng(sum(shape))
    a, b, c = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(dtype) for _ in range(3))
    n0 = stream.launch_counts()
    assert torch.equal(stream.copy(a), stream_ref.copy(a))
    assert torch.equal(stream.mul(c), stream_ref.mul(c))
    assert torch.equal(stream.add(a, b), stream_ref.add(a, b))
    assert torch.equal(stream.triad(b, c), stream_ref.triad(b, c))
    got, want = stream.dot(a, b), stream_ref.dot(a, b)
    assert got.dtype == torch.float32 and got.shape == ()
    scale = (a.float() * b.float()).abs().sum().item()
    assert abs(got.item() - want.item()) <= 2.0 ** -20 * scale
    passes = len(stream.dot_passes(a.numel()))
    assert {k: v - n0[k] for k, v in stream.launch_counts().items()} == \
        {"copy": 1, "mul": 1, "add": 1, "triad": 1, "dot": passes}


def test_emulated_stream_in_place_chain(cuda_path_on_cpu):
    """BabelStream's in-place chain through ``out=`` (each kernel writing
    an array another reads) and a dot of identical products, which the
    fixed tree sums exactly: n * a * b."""
    a, b, c = (torch.full((4, 512), v) for v in (0.1, 0.2, 0.0))
    for _ in range(3):
        stream.copy(a, out=c)
        stream.mul(c, out=b)
        stream.add(a, b, out=c)
        stream.triad(b, c, out=a)
    s = stream_ref.scalar_in(torch.float32)
    ga, gb, gc = (torch.tensor(v) for v in (0.1, 0.2, 0.0))
    for _ in range(3):
        gc = ga.clone()
        gb = s * gc
        gc = ga + gb
        ga = gb + s * gc
    for x, g in ((a, ga), (b, gb), (c, gc)):
        assert torch.equal(x, torch.full_like(x, g.item()))
    assert stream.dot(a, b).item() == (ga * gb).item() * a.numel()


# map_vec (csrc/stream.cu) in layouts the library does not build: several
# 16-byte vectors a thread in small blocks, as the sweep script
# instantiates it; op 0 copy, 1 mul, 2 add (x + w), 3 triad (x + s * w)
MAP_VEC_PROBE = r"""
#include "stream.cpp"
namespace {
template <int kT, int kV, typename T, typename Op>
__global__ void probe_kernel(const T* x, const T* w, T* y, long long n,
                             Op op) {
  map_vec<kT, kV>(x, w, y, n, op);
}
template <int kT, int kV, typename T, typename Op>
int run(Op op, const void* x, const void* w, void* y, long long n) {
  constexpr int per = kV * 16 / sizeof(T);
  return launch(probe_kernel<kT, kV, T, Op>, n, kT, per, 0, nullptr,
                (const T*)x, (const T*)w, (T*)y, n, op);
}
template <int kT, int kV, typename T>
int probe(int op, const void* x, const void* w, void* y, float s,
          long long n) {
  switch (op) {
    case 0: return run<kT, kV, T>(CopyOp{}, x, w, y, n);
    case 1: return run<kT, kV, T>(MulOp{s}, x, w, y, n);
    case 2: return run<kT, kV, T>(AddOp{}, x, w, y, n);
    default: return run<kT, kV, T>(TriadOp{s}, x, w, y, n);
  }
}
}  // namespace
extern "C" int probe_map_vec(int threads, int bf16, int op, const void* x,
                             const void* w, void* y, float s, long long n) {
  if (threads == 32)
    return bf16 ? probe<32, 4, __nv_bfloat16>(op, x, w, y, s, n)
                : probe<32, 4, float>(op, x, w, y, s, n);
  return bf16 ? probe<64, 2, __nv_bfloat16>(op, x, w, y, s, n)
              : probe<64, 2, float>(op, x, w, y, s, n);
}
"""


@pytest.fixture(scope="module")
def map_vec_probe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not installed: the CPU build of the CUDA sources "
                    "needs it")
    d = tmp_path_factory.mktemp("map_vec")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME)
    (d / "cuda_bf16.h").write_text(CUDA_BF16)
    (d / "stream.cpp").write_text(
        _rewrite((build.CSRC / "stream.cu").read_text()))
    (d / "probe.cpp").write_text(MAP_VEC_PROBE)
    lib = d / "libprobe.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", f"-I{d}", "-o", str(lib),
                    str(d / "probe.cpp")], check=True)
    fn = ctypes.CDLL(str(lib)).probe_map_vec
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                   ctypes.c_longlong]
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("threads,vectors", [(32, 4), (64, 2)],
                         ids=["t32v4", "t64v2"])
def test_emulated_map_vec_several_vectors(threads, vectors, dtype,
                                          map_vec_probe):
    """map_vec with 4 vectors in 32-thread blocks and 2 in 64-thread ones
    (512 f32 or 1024 bf16 elements a block): copy, mul, add and triad
    bit-identical to the plain versions, also in place (add and triad with
    the output aliasing each input in turn), over n = 7 (the tail alone),
    one whole block, and several blocks with a ragged last one and a
    ragged tail (n % 8 = 1 and 3)."""
    rng = np.random.default_rng(threads + vectors)
    per_block = threads * vectors * 16 // dtype.itemsize
    s = stream_ref.scalar_in(dtype)
    bf16 = dtype == torch.bfloat16
    for n in (7, per_block, 9009, 5 * per_block + 3):
        x, w = (torch.from_numpy(rng.standard_normal(n, np.float32))
                .to(dtype) for _ in range(2))
        wants = {0: stream_ref.copy(x), 1: stream_ref.mul(x),
                 2: stream_ref.add(x, w), 3: stream_ref.triad(x, w)}
        for op, want in wants.items():
            y = torch.zeros_like(x)
            assert map_vec_probe(threads, bf16, op, x.data_ptr(),
                                 w.data_ptr(), y.data_ptr(), s, n) == 0
            assert torch.equal(y, want), (n, op)
            for alias in ((0, 1) if op >= 2 else (0,)):
                z = [x.clone(), w.clone()]
                map_vec_probe(threads, bf16, op, z[0].data_ptr(),
                              z[1].data_ptr(), z[alias].data_ptr(), s, n)
                assert torch.equal(z[alias], want), (n, op, "in place",
                                                     alias)
                assert torch.equal(z[1 - alias], (x, w)[1 - alias])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 7), (9, 1001)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_emulated_copy_mul_in_place(shape, dtype, cuda_path_on_cpu):
    """copy and mul with ``out=`` the input itself: every thread reads its
    vectors and its tail element before it writes them, so the in-place
    result is the plain version's (n = 7: the ragged tail alone; 9009:
    three f32 or two bf16 blocks, the last ragged, and a 1-element
    tail)."""
    rng = np.random.default_rng(sum(shape) + 5)
    x = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(dtype)
    want = stream_ref.mul(x, 1.5)
    y = x.clone()
    assert stream.mul(y, 1.5, out=y) is y and torch.equal(y, want)
    assert stream.copy(y, out=y) is y and torch.equal(y, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 7), (9, 1001)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_emulated_add_triad_in_place(shape, dtype, cuda_path_on_cpu):
    """add and triad with ``out=`` each input in turn, through the
    wrappers: the result is the plain version's and the other input is
    untouched (n = 7: the ragged tail alone; 9009: ragged last block and
    a 1-element tail)."""
    rng = np.random.default_rng(sum(shape) + 6)
    x, w = (torch.from_numpy(rng.standard_normal(shape, np.float32))
            .to(dtype) for _ in range(2))
    for name in ("add", "triad"):
        fn, want = getattr(stream, name), getattr(stream_ref, name)(x, w)
        for alias in range(2):
            z = [x.clone(), w.clone()]
            assert fn(*z, out=z[alias]) is z[alias]
            assert torch.equal(z[alias], want), (name, alias)
            assert torch.equal(z[1 - alias], (x, w)[1 - alias])


# dot's ragged shapes: n = 7 (the tail alone), n % 8 = 3 in one block,
# and two blocks of 8192 with a 1-element tail (a two-launch chain 9009 ->
# 2 -> 1)
DOT_SHAPES = [(1, 7), (3, 1001), (9, 1001)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", DOT_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_emulated_dot_ragged_tail_and_bit_identity(shape, dtype,
                                                   cuda_path_on_cpu):
    """dot with n not a multiple of 8 or of a block: within 2^-20 of
    sum |a b| of the plain version and of the exact sum, bit-identical from
    run to run (a fixed order of sums), in the launches ``dot_passes``
    plans."""
    rng = np.random.default_rng(sum(shape) + 8)
    a, b = (torch.from_numpy(rng.standard_normal(shape, np.float32))
            .to(dtype) for _ in range(2))
    n0 = stream.launch_counts()["dot"]
    got, again = stream.dot(a, b), stream.dot(a, b)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    scale = (a.double() * b.double()).abs().sum().item()
    exact = (a.double() * b.double()).sum().item()
    for want in (stream_ref.dot(a, b).item(), exact):
        assert abs(got.item() - want) <= 2.0 ** -20 * scale
    passes = stream.dot_passes(a.numel())
    assert len(passes) == (1 if a.numel() <= 8192 else 2)
    assert stream.launch_counts()["dot"] - n0 == 2 * len(passes)


def test_emulated_dot_refuses_misaligned_view(cuda_path_on_cpu):
    """A view 4 bytes past a 16-byte boundary is refused: the kernel's
    16-byte loads need the boundary, and no scalar path stands in."""
    a = torch.ones(1025)[1:].view(8, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        stream.dot(a, torch.ones(8, 128))
    assert torch.equal(stream.dot(a.contiguous().clone(), a.clone()),
                       torch.tensor(1024.0))


@pytest.mark.parametrize("op", ["copy", "mul", "add", "triad"])
def test_emulated_copy_mul_refuse_misaligned_views(op, cuda_path_on_cpu):
    """copy, mul, add and triad load and store 16 bytes at a time: an
    input (either input of add and triad) or an ``out=`` 4 bytes past a
    16-byte boundary is refused, with no scalar path standing in; aligned
    tensors of the same values go through."""
    fn = getattr(stream, op)
    two = op in ("add", "triad")
    off = torch.ones(1025)[1:].view(8, 128)
    ok = torch.ones(8, 128)
    bad = [(off, ok), (ok, off)] if two else [(off,)]
    for args in bad:
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(*args)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(*((ok, ok) if two else (ok,)), out=off)
    n0 = stream.launch_counts()[op]
    args = (off.clone(), ok) if two else (off.clone(),)
    assert torch.equal(fn(*args), getattr(stream_ref, op)(*args))
    assert stream.launch_counts()[op] == n0 + 1


# (B, S, d_in, N, dtype): S over several 32-step tiles with a ragged last
# one; d_in not a multiple of the 128-channel block (a part-empty block);
# one step; N = 16 at a ragged S and d_in; bf16 at N = 8 and 16
SCAN_CASES = [(2, 70, 128, 8, torch.float32),
              (1, 37, 200, 16, torch.float32),
              (3, 1, 40, 16, torch.float32),
              (2, 45, 130, 8, torch.bfloat16),
              (1, 33, 96, 16, torch.bfloat16)]
# y: f32 within 2e-5 (the order of the N-sum and the exp implementations
# differ); bf16 y adds one bf16 ulp (2^-7 relative), the output's own
# rounding of two f32 values that differ by that much.  h_final is f32 on
# both sides from the same upcast inputs: 2e-5 in either dtype.
SCAN_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7 + 2e-5,
                                                          2e-5)}


def _scan_inputs(rng, B, S, d_in, N, dtype):
    """x, dt, A and B, C as strided column slices of one (B, S, 4 + 2N)
    tensor, as the model passes them (8-byte offsets in f32)."""
    x = torch.from_numpy(rng.standard_normal((B, S, d_in), np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, d_in), np.float32)) * 0.5 - 1.0)
    A = -torch.exp(torch.from_numpy(rng.standard_normal((d_in, N),
                                                        np.float32)) * 0.3)
    dbc = torch.from_numpy(rng.standard_normal((B, S, 4 + 2 * N),
                                               np.float32)).to(dtype)
    return x.to(dtype), dt.to(dtype), A, dbc[..., 4:4 + N], dbc[..., 4 + N:]


def _check_scan(x, dt, A, Bc, Cc):
    """The kernel against the plain version with B and C strided and
    contiguous; returns the number of launches."""
    rtol, atol = SCAN_TOL[x.dtype]
    want_y, want_h = mamba1_scan(x, dt, A, Bc, Cc)
    n0 = scan.KERNEL.launches
    for b, c in ((Bc, Cc), (Bc.contiguous(), Cc.contiguous())):
        y, h = scan.selective_scan(x, dt, A, b, c)
        assert y.dtype == x.dtype and h.dtype == torch.float32
        torch.testing.assert_close(y.float(), want_y.float(), rtol=rtol,
                                   atol=atol)
        torch.testing.assert_close(h, want_h, rtol=2e-5, atol=2e-5)
    return scan.KERNEL.launches - n0


# (B, S, d_in, N, dtype, lanes, 16-byte tiles): one lane a channel over
# five 32-step tiles (the 3-stage ring reuses its stages); 2 lanes at N = 8
# with 200-byte bf16 rows (plain loads) over two 64-channel blocks, the
# last part-empty; 4 lanes (the wrapper's) at N = 16 over seven 32-channel
# blocks, the last part-empty; 4 lanes at N = 8 (2 states a lane)
SCAN_LANE_CASES = [(2, 150, 72, 16, torch.float32, 1, True),
                   (1, 150, 100, 8, torch.bfloat16, 2, False),
                   (2, 99, 200, 16, torch.bfloat16, 4, True),
                   (1, 130, 48, 8, torch.float32, 4, True)]


@pytest.mark.parametrize("case", SCAN_LANE_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_emulated_selective_scan_lanes_and_tiles(case, cuda_path_on_cpu,
                                                monkeypatch):
    """Each channel's state split over 1, 2 and 4 lanes, y's sum over them
    by __shfl_xor_sync; S not a multiple of the tile and d_in not a
    multiple of the block; x and dt tiles by 16-byte cp.async or plain
    loads; strided and contiguous B/C; the same tolerances."""
    B, S, d_in, N, dtype, lanes, vec = case
    monkeypatch.setattr(scan, "LANES", lanes)
    x, dt, A, Bc, Cc = _scan_inputs(np.random.default_rng(S + d_in), B, S,
                                    d_in, N, dtype)
    assert scan.copies_16_bytes(x, dt) == vec
    assert _check_scan(x, dt, A, Bc, Cc) == 2


def test_emulated_selective_scan_misaligned_rows_take_plain_loads(
        cuda_path_on_cpu, monkeypatch):
    """x 4 bytes past a 16-byte boundary: its tiles cannot be copied 16
    bytes at a time, so the kernel reads them with plain loads and gives
    the same result; a lane count the kernel is not built for is refused
    by the C entry, and nothing launches."""
    x, dt, A, Bc, Cc = _scan_inputs(np.random.default_rng(6), 2, 40, 64, 16,
                                    torch.float32)
    shifted = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    shifted.copy_(x)
    assert scan.copies_16_bytes(x, dt) and \
        not scan.copies_16_bytes(shifted, dt)
    assert _check_scan(shifted, dt, A, Bc, Cc) == 2
    monkeypatch.setattr(scan, "LANES", 3)
    n0 = scan.KERNEL.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        scan.selective_scan(x, dt, A, Bc, Cc)
    assert scan.KERNEL.launches == n0


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_emulated_selective_scan_matches_plain(case, cuda_path_on_cpu):
    """B and C as strided column slices of one (B, S, 4 + 2N) tensor, as
    the model passes them, and once made contiguous."""
    B, S, d_in, N, dtype = case
    rng = np.random.default_rng(S + d_in + N)
    x = torch.from_numpy(rng.standard_normal((B, S, d_in), np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, d_in), np.float32)) * 0.5 - 1.0)
    A = -torch.exp(torch.from_numpy(rng.standard_normal((d_in, N),
                                                        np.float32)) * 0.3)
    dbc = torch.from_numpy(rng.standard_normal((B, S, 4 + 2 * N),
                                               np.float32)).to(dtype)
    x, dt = x.to(dtype), dt.to(dtype)
    Bc, Cc = dbc[..., 4:4 + N], dbc[..., 4 + N:]
    rtol, atol = SCAN_TOL[dtype]
    n0 = scan.KERNEL.launches
    want_y, want_h = mamba1_scan(x, dt, A, Bc, Cc)
    for b, c in ((Bc, Cc), (Bc.contiguous(), Cc.contiguous())):
        y, h = scan.selective_scan(x, dt, A, b, c)
        assert y.dtype == dtype and h.dtype == torch.float32
        torch.testing.assert_close(y.float(), want_y.float(), rtol=rtol,
                                   atol=atol)
        torch.testing.assert_close(h, want_h, rtol=2e-5, atol=2e-5)
    assert scan.KERNEL.launches == n0 + 2


# ---------------------------------------------------------------------------
# The trip models (kernels/trips.py) against the emulated kernels' own
# counts: every marked loop's REPRO_TRIP, per thread, reduced to each warp
# by its largest thread count, equals the model's per-warp trips.
# ---------------------------------------------------------------------------

def _emulated_trips(lib, first):
    """{(launch - first, marker): {warp key: count}} from the trip log,
    each warp keyed (block, thread // 32) and counted by its busiest
    thread."""
    lib.emu_trip_entry.argtypes = [ctypes.c_long,
                                   ctypes.POINTER(ctypes.c_long),
                                   ctypes.c_char_p]
    lib.emu_trip_entries.restype = ctypes.c_long
    buf = (ctypes.c_long * 4)()
    name = ctypes.create_string_buffer(64)
    out = {}
    for i in range(lib.emu_trip_entries()):
        lib.emu_trip_entry(i, buf, name)
        launch, block, thread, count = list(buf)
        if launch < first:
            continue
        warps = out.setdefault((launch - first, name.value.decode()), {})
        key = (block, thread // 32)
        warps[key] = max(warps.get(key, 0), count)
    return out


def _check_trips(lib, launches, call):
    """Run ``call`` on the emulated kernels and hold every launch's
    per-warp trips against the model's ``launches``."""
    lib.emu_trip_launches.restype = ctypes.c_long
    lib.emu_trip_clear()
    first = lib.emu_trip_launches()
    call()
    assert lib.emu_trip_launches() - first == len(launches)
    got = _emulated_trips(lib, first)
    for k, la in enumerate(launches):
        model = la.per_warp()
        markers = set(model) | {m for (j, m) in got if j == k}
        for m in markers:
            emu = np.zeros(la.warps, dtype=np.int64)
            for (block, w), n in got.get((k, m), {}).items():
                emu[block * la.warps_per_block + w] = n
            want = model.get(m, np.zeros(la.warps, dtype=np.int64))
            assert (emu == want).all(), (la.function, m, emu.tolist(),
                                         want.tolist())
    assert got, "no marked loop ran"


@pytest.mark.parametrize("q_dtype,pool", PAGED_POOLS,
                         ids=lambda x: str(x).replace("torch.", ""))
@pytest.mark.parametrize("G", [4, 48])
def test_trip_model_of_paged_decode(G, q_dtype, pool, emulated,
                                    cuda_path_on_cpu):
    """22 splits of a 40-page table (page 4): kv_len 0, one token, one
    page, one page and a token, 100 (pieces ending mid-page, pieces 13-21
    empty) and the full table; G = 48 walks three row tiles; int8 pools
    copy their scales."""
    B, KV, D, page, NB = 6, 2, 32, 4, 40
    lens = [1, page, page + 1, 100, NB * page, 0]
    q, kp, vp, tbl, kv_len, ks, vs = _paged_decode_case(
        G + len(pool), B, G * KV, KV, D, page, NB, q_dtype, pool, lens)
    model = paged.trip_model(B, G * KV, KV, D, page, NB, lens, q_dtype,
                             kp.dtype)
    _check_trips(emulated, model, lambda: paged.paged_decode_attention(
        q, kp, vp, tbl, kv_len, 1, k_scale=ks, v_scale=vs))


@pytest.mark.parametrize("case", [c for c in DECODE_CASES if c[4] >= 32],
                         ids=lambda c: "-".join(
                             str(x).replace("torch.", "") for x in c))
def test_trip_model_of_dense_decode(case, emulated, cuda_path_on_cpu):
    """kv_len below T, a kv_start in every slot but the first and an empty
    window in the last (kv_start >= kv_len)."""
    B, T, H, KV, D, dtype = case
    q, k, v = _dense(T + H, B, 1, T, H, KV, D, dtype)
    kv_len = T - 3
    start = [0] + [kv_len] * (B - 1) if B == 2 else [0, 5, kv_len]
    model = decode.trip_model(B, T, H, KV, D, kv_len, start, dtype)
    _check_trips(emulated, model, lambda: decode.decode_attention(
        q, k, v, kv_len, torch.tensor(start, dtype=torch.int32)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_trip_model_of_paged_prefill(case, emulated, cuda_path_on_cpu):
    """bf16 q on the tensor-core body, f32 q on the CUDA-core one: causal
    from random, unaligned bases, an empty slot, G up to 48 over several
    row tiles, single-row pages, int8 pools."""
    *geom, dtype, int8 = case
    B, T, H, KV, D, page, NB, L = geom
    q, kp, vp, tbl, base, new, layer, ks, vs = _case(sum(geom), *geom,
                                                     dtype, int8, empty=True)
    model = prefill_paged.trip_model(B, T, H, KV, D, page, NB,
                                     base.tolist(), new.tolist(), kp.dtype,
                                     q.dtype)
    _check_trips(emulated, model, lambda: prefill_paged.
                 paged_prefill_attention(q, kp, vp, tbl, base, new, layer,
                                         k_scale=ks, v_scale=vs))


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_trip_model_of_flash(case, emulated, cuda_path_on_cpu):
    """bf16 on the tensor-core body, f32 on the CUDA-core one; causal and
    not, S != T both ways."""
    B, S, T, H, KV, D, causal, dtype = case
    q, k, v = _dense(S + T + D, B, S, T, H, KV, D, dtype)
    model = flash.trip_model(B, S, T, H, KV, D, causal, dtype)
    _check_trips(emulated, model, lambda: flash.launch(q, k, v, causal))


@pytest.mark.parametrize("case", SCAN_LANE_CASES + [
    c + (scan.LANES, (c[2] * (2 if c[4] == torch.bfloat16 else 4)) % 16
         == 0) for c in SCAN_CASES], ids=lambda c: "-".join(
             str(x).replace("torch.", "") for x in c))
def test_trip_model_of_the_scan(case, emulated, cuda_path_on_cpu,
                                monkeypatch):
    """The ragged last tile (S not a multiple of 32), 1, 2 and 4 lanes,
    16-byte tiles and plain loads."""
    B, S, d_in, N, dtype, lanes, vec = case
    monkeypatch.setattr(scan, "LANES", lanes)
    x, dt, A, Bc, Cc = _scan_inputs(np.random.default_rng(S + d_in), B, S,
                                    d_in, N, dtype)
    assert scan.copies_16_bytes(x, dt) == vec
    model = scan.trip_model(B, S, d_in, N, dtype, lanes, vec)
    _check_trips(emulated, model,
                 lambda: scan.selective_scan(x, dt, A, Bc, Cc))
