"""The stream kernels, the Mamba1 selective scan and the trip models,
each CUDA source compiled for the CPU and run as
``test_torch_kernel_emulation`` runs it (its fixtures and cases: g++
against the stand-in CUDA headers, a block's threads as
``std::thread``s), held against the plain versions.

  * BabelStream's copy, mul, add, triad and dot: bit identity for the
    elementwise four (in place and with ``out=`` each input), dot's
    ragged tails, the 16-byte vector layout at other block shapes
    (``map_vec``), and every kernel's refusal of a view off a 16-byte
    boundary.
  * The selective scan at 1, 2 and 4 lanes a channel, over ragged tiles,
    and its plain-load path for misaligned rows.
  * The trip models (``kernels/trips.py``) against each emulated
    kernel's own ``REPRO_TRIP`` counts, per warp: paged decode and
    prefill, dense decode, flash and the scan.

These sections were ``test_torch_kernel_emulation.py``'s last; they live
in a file of their own so that the test runner's ``--dist loadfile``
can give them a worker of their own.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import decode, paged, prefill_paged
from repro_torch.kernels.flash_attention import flash
from repro_torch.kernels.ssm_scan import scan
from repro_torch.kernels.stream import ref as stream_ref
from repro_torch.kernels.stream import stream
from repro_torch.models.ssm import mamba1_scan

from test_torch_kernel_emulation import (  # noqa: F401  (fixtures)
    CASES, CUDA_BF16, CUDA_RUNTIME, DECODE_CASES, FLASH_CASES, PAGED_POOLS,
    _case, _dense, _paged_decode_case, _rewrite, cuda_path_on_cpu,
    emulated)


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
