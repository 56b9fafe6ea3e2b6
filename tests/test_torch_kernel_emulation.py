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
can show.  The stream, scan and trip-model cases are in
``test_torch_stream_scan_emulation.py``, and other slices' geometries in
``test_torch_{stub,hybrid}_emulation.py``: each imports this file's
fixtures and runs on a worker of its own.
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
from repro_torch.models.attention import repeat_kv
from repro_torch.models.flash import flash_attention_ref
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
