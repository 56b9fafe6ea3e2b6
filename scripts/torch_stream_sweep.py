#!/usr/bin/env python3
"""Sweep of the 16-byte vector layout of BabelStream's copy, mul, add and
triad (``map_vec`` in ``src/repro_torch/csrc/stream.cu``) on the card.

    python3 scripts/torch_stream_sweep.py       # on the card, ~1 min

Builds one library from a source written here that includes ``stream.cu``
and instantiates ``map_vec`` for every threads per block T and 16-byte
vectors a thread V: copy and mul (one input) over V in ``VECTORS`` with
two access policies, the file's own plain loads and stores or streaming
cache hints (``__ldcs``/``__stcs``, evict-first); add and triad (two
inputs, so two 16-byte loads a vector) over V in ``VECTORS_TWO`` with
plain access.  Each variant is first held bit-identical to the plain
version, then timed at BabelStream's 2^25 f32 elements: CUDA events
around ``ITERS`` back-to-back launches, in ``ROUNDS`` rounds that visit
every variant in turn, beside the port's wrappers (``stream.copy``,
``mul``, ``add``, ``triad``) and one PyTorch call each (``copy_``,
``torch.mul``, ``torch.add``, ``torch.add`` with ``alpha``).  Prints the
fastest round's ms per call and GB/s of every variant as a markdown
table, with the card's name and power limit.
"""
import ctypes
import hashlib
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

N = 2 ** 25                         # BabelStream's default size, f32
THREADS = (128, 256, 512, 1024)
VECTORS = (1, 2, 4, 8)              # copy, mul
VECTORS_TWO = (1, 2, 4)             # add, triad
ACCESS = {"plain": "PlainAccess", "hints": "StreamingAccess"}
ITERS, ROUNDS = 50, 3

STREAMING = r"""
namespace {
// map_vec's loads and stores with the streaming (evict-first) hints
struct StreamingAccess {
  template <typename T>
  static __device__ __forceinline__ Pack<T> load(const T* p) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    Pack<T> v;
    memcpy(&v, &u, 16);
    return v;
  }
  template <typename T>
  static __device__ __forceinline__ void store(T* p, const Pack<T>& v) {
    uint4 u;
    memcpy(&u, &v, 16);
    __stcs(reinterpret_cast<uint4*>(p), u);
  }
};
}  // namespace
"""

VARIANT = r"""
extern "C" __global__ void __launch_bounds__({t})
    sweep_copy_{tag}(const float* a, float* c, long long n) {{
  map_vec<{t}, {v}, {access}>(a, a, c, n, CopyOp{{}});
}}
extern "C" __global__ void __launch_bounds__({t})
    sweep_mul_{tag}(const float* c, float* b, float s, long long n) {{
  map_vec<{t}, {v}, {access}>(c, c, b, n, MulOp{{s}});
}}
extern "C" int run_copy_{tag}(const void* a, void* c, long long n,
                              void* stream) {{
  return launch(sweep_copy_{tag}, n, {t}, {v} * 4, 0, stream,
                (const float*)a, (float*)c, n);
}}
extern "C" int run_mul_{tag}(const void* c, void* b, float s, long long n,
                             void* stream) {{
  return launch(sweep_mul_{tag}, n, {t}, {v} * 4, 0, stream,
                (const float*)c, (float*)b, s, n);
}}
"""

VARIANT_TWO = r"""
extern "C" __global__ void __launch_bounds__({t})
    sweep_add_{tag}(const float* a, const float* b, float* c, long long n) {{
  map_vec<{t}, {v}>(a, b, c, n, AddOp{{}});
}}
extern "C" __global__ void __launch_bounds__({t})
    sweep_triad_{tag}(const float* b, const float* c, float* a, float s,
                      long long n) {{
  map_vec<{t}, {v}>(b, c, a, n, TriadOp{{s}});
}}
extern "C" int run_add_{tag}(const void* a, const void* b, void* c,
                             long long n, void* stream) {{
  return launch(sweep_add_{tag}, n, {t}, {v} * 4, 0, stream,
                (const float*)a, (const float*)b, (float*)c, n);
}}
extern "C" int run_triad_{tag}(const void* b, const void* c, void* a,
                               float s, long long n, void* stream) {{
  return launch(sweep_triad_{tag}, n, {t}, {v} * 4, 0, stream,
                (const float*)b, (const float*)c, (float*)a, s, n);
}}
"""

BYTES = {"copy": 8 * N, "mul": 8 * N, "add": 12 * N, "triad": 12 * N}


def variants():
    return [(t, v, h) for h in ACCESS for v in VECTORS for t in THREADS]


def variants_two():
    return [(t, v, "plain") for v in VECTORS_TWO for t in THREADS]


def tag(t, v, h):
    return f"t{t}_v{v}_{h}"


def source() -> str:
    parts = ['#include "stream.cu"', STREAMING]
    for t, v, h in variants():
        parts.append(VARIANT.format(t=t, v=v, access=ACCESS[h],
                                    tag=tag(t, v, h)))
    for t, v, h in variants_two():
        parts.append(VARIANT_TWO.format(t=t, v=v, tag=tag(t, v, h)))
    return "\n".join(parts)


def build_sweep() -> ctypes.CDLL:
    from repro_torch.kernels import build
    src = source()
    digest = hashlib.sha256((src + build.source_hash()).encode())
    out = build.BUILD_ROOT / f"sweep-{digest.hexdigest()[:16]}"
    lib = out / "libsweep.so"
    if not lib.exists():
        out.mkdir(parents=True, exist_ok=True)
        (out / "sweep.cu").write_text(src)
        t0 = time.perf_counter()
        res = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-shared",
                              f"-I{build.CSRC}", "-o", str(lib),
                              str(out / "sweep.cu")],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}{res.stderr}")
        print(f"built {len(variants()) + len(variants_two())} layouts in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return ctypes.CDLL(str(lib))


def bind(lib, name, args):
    """The C entry point ``name``, raising when its launch fails."""
    fn = getattr(lib, name)
    fn.argtypes = args
    fn.restype = ctypes.c_int

    def call(*a):
        err = fn(*a)
        if err:
            raise RuntimeError(f"{name}: launch failed with cudaError_t "
                               f"{err}")
    return call


def main() -> int:
    import torch

    from repro_torch.kernels.stream import ref, stream
    if not torch.cuda.is_available():
        print("torch_stream_sweep: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    lib = build_sweep()
    P, N_, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    s = ref.scalar_in(torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn(N, generator=gen, device="cuda")
    b, c = torch.empty_like(a), torch.empty_like(a)
    h = torch.cuda.current_stream().cuda_stream
    calls = {}
    for t, v, acc in variants():
        k = tag(t, v, acc)
        cp = bind(lib, f"run_copy_{k}", [P, P, N_, P])
        ml = bind(lib, f"run_mul_{k}", [P, P, F, N_, P])
        calls[("copy", t, v, acc)] = (
            lambda cp=cp: cp(a.data_ptr(), c.data_ptr(), N, h))
        calls[("mul", t, v, acc)] = (
            lambda ml=ml: ml(c.data_ptr(), b.data_ptr(), s, N, h))
    for t, v, acc in variants_two():
        k = tag(t, v, acc)
        ad = bind(lib, f"run_add_{k}", [P, P, P, N_, P])
        tr = bind(lib, f"run_triad_{k}", [P, P, P, F, N_, P])
        calls[("add", t, v, acc)] = (
            lambda ad=ad: ad(a.data_ptr(), b.data_ptr(), c.data_ptr(), N, h))
        calls[("triad", t, v, acc)] = (
            lambda tr=tr: tr(b.data_ptr(), c.data_ptr(), a.data_ptr(), s, N,
                             h))
    a2, b2, c2 = (x.view(-1, 2048) for x in (a, b, c))
    calls[("copy", "wrapper")] = lambda: stream.copy(a2, out=c2)
    calls[("mul", "wrapper")] = lambda: stream.mul(c2, out=b2)
    calls[("add", "wrapper")] = lambda: stream.add(a2, b2, out=c2)
    calls[("triad", "wrapper")] = lambda: stream.triad(b2, c2, out=a2)
    calls[("copy", "copy_")] = lambda: c.copy_(a)
    calls[("mul", "torch.mul")] = lambda: torch.mul(c, s, out=b)
    calls[("add", "torch.add")] = lambda: torch.add(a, b, out=c)
    calls[("triad", "torch.add alpha")] = (
        lambda: torch.add(b, c, alpha=0.4, out=a))

    # bit-identical first: fixed inputs a0, b0, c0; each call writes its
    # own output array (copy, add: c; mul: b; triad: a)
    a0 = a.clone()
    b0 = torch.randn(N, generator=gen, device="cuda")
    c0 = torch.randn(N, generator=gen, device="cuda")
    want = {"copy": (c, a0), "mul": (b, ref.mul(c0)),
            "add": (c, ref.add(a0, b0)), "triad": (a, ref.triad(b0, c0))}
    for key, fn in calls.items():
        if len(key) == 2 and key[1] != "wrapper":
            continue                        # the library calls round apart
        a.copy_(a0), b.copy_(b0), c.copy_(c0)
        got, expect = want[key[0]]
        got.zero_()
        fn()
        torch.cuda.synchronize()
        if not torch.equal(got, expect):
            raise AssertionError(f"{key}: differs from the plain version")
    del a0, b0, c0, want
    a.normal_(generator=gen), b.normal_(generator=gen)
    c.normal_(generator=gen)
    print(f"all {len(calls) - 4} kernel variants and wrappers "
          f"bit-identical to plain at 2^25 f32", flush=True)

    best = {key: float("inf") for key in calls}
    for _ in range(ROUNDS):
        for key, fn in calls.items():
            for _ in range(5):
                fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                fn()
            end.record()
            torch.cuda.synchronize()
            best[key] = min(best[key], start.elapsed_time(end) / ITERS)
    print(f"\ncard: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {N} f32 elements ({BYTES['copy']} bytes a "
          f"call of copy and mul, {BYTES['add']} of add and triad); fastest "
          f"of {ROUNDS} rounds of {ITERS} back-to-back calls\n")
    print("| op | threads T | vectors V | access | elements a block | ms | "
          "GB/s |")
    print("|---|---|---|---|---|---|---|")
    for key, ms in best.items():
        op, *rest = key
        if len(rest) == 3:
            t, v, acc = rest
            cols = f"{t} | {v} | {acc} | {t * v * 4}"
        else:
            cols = f"{rest[0]} | | | "
        print(f"| {op} | {cols} | {ms:.4f} | {BYTES[op] / ms / 1e6:.1f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
