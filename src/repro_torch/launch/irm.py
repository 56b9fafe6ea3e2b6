"""The paper's instruction roofline, recomputed and built for the H100.

    python -m repro_torch.launch.irm                  # on the card
    python -m repro_torch.launch.irm --device cpu     # Tables 1-2 only

First the paper's Tables 1-2 (the ComputeCurrent kernel on the V100,
MI60 and MI100), recomputed from its raw counter values with the port's
copy of Eqs. 1-4 beside the published numbers.  Then, on the card, the
H100's roofline built the paper's way:

  * the peak (Eq. 3) from the card: SMs x 4 warp schedulers x IPC 1 x
    the maximum SM clock (``core.hardware.h100_from_device``);
  * the memory roof from BabelStream's copy on the port's own kernels
    (``launch.babelstream``), the measurement the paper takes on the
    MI60 and MI100;
  * one point per BabelStream kernel at BabelStream's size.  Its
    instructions are a census of the kernel's SASS
    (``core.sass_counters``: the path one warp runs) times the warps
    launched, times 32 — thread instructions, so that Eq. 4's division by
    the warp gives warp instructions, the unit of Eq. 3's peak.  Its bytes
    are BabelStream's count and its runtime the fastest of the iterations;
  * one point per CUDA function of the application's looped kernels, as
    the paper places PIConGPU's kernels of interest beside BabelStream:
    paged decode and its combine, paged prefill, dense decode and its
    combine, flash attention and the selective scan, at the shapes of
    PERF.md's kernel table (``app_cases``).  Their instructions are the
    loop census (``sass_counters.loop_census``: each SASS loop tied to its
    marked source loop and scaled by the trip counts that the wrapper's
    ``trip_model`` gives the launch) times the warps, an interval
    [lo, hi] over the paths a forward branch can take; the point sits at
    hi.  Their bytes are the trip model's byte model, their runtime the
    kernel's device time in a ``torch.profiler`` trace (a wrapper's host
    time is not the kernel's work).  ``serve_points`` sums the two paged
    kernels over every launch of a serving run, the paper's method for
    an application.

Hardware counters (Nsight Compute) are not read: the census needs only
``cuobjdump`` and ``nvdisasm`` on a build with ``-lineinfo``.
"""
from __future__ import annotations

import argparse
import dataclasses
import re
import subprocess
import sys
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core import paper_data
from repro_torch.core import sass_counters as sc
from repro_torch.core.hardware import HardwareSpec, h100_from_device
from repro_torch.core.irm import InstructionRooflineModel, gpu_irm
from repro_torch.core.paper_model import KernelMeasurement
from repro_torch.core.report import markdown_table
from repro_torch.core.sass_counters import KernelCensus
from repro_torch.kernels.stream import stream
from repro_torch.kernels.trips import Launch
from repro_torch.launch import babelstream

IRM_COLUMNS = ("kernel", "warp_insts", "bytes", "ms", "inst_per_byte",
               "achieved_gips", "roof_gips", "achieved_over_roof", "bound")


def paper_rows() -> List[dict]:
    """Tables 1-2 recomputed beside the published values."""
    out = []
    for tname, table, published in (
            ("table1_lwfa", paper_data.TABLE1, paper_data.LWFA_PUBLISHED),
            ("table2_tweac", paper_data.TABLE2, paper_data.TWEAC_PUBLISHED)):
        for gpu, m in table.items():
            pub = published[gpu]
            out.append({
                "table": tname,
                "gpu": gpu,
                "peak_gips": m.peak_gips(),
                "peak_gips_published": pub["peak_gips"],
                "achieved_gips": m.achieved_gips(),
                "achieved_gips_published": pub["achieved_gips"],
                "intensity": m.intensity_performance(),
                "intensity_published": pub["intensity"],
                "bound": m.bound(),
            })
    return out


def warp_instructions(name: str, census: Dict[str, KernelCensus],
                      res: babelstream.Result) -> int:
    """Warp instructions of one call of BabelStream kernel ``name`` over
    the run's arrays: for every launch the call makes, the census's path
    length times the warps launched.  Exact when every warp runs its
    kernel's whole listing: for copy, mul, add and triad, n a multiple of
    a block's elements (``stream.block_elements``), so that every bounds
    guard holds.  dot is not held to it: its sum passes over the block
    partials run a ragged block by design."""
    per_block = stream.block_elements(name, res.dtype)
    if name != "dot" and res.n % per_block:
        raise ValueError(f"{name}: the census counts every warp's whole "
                         f"path, so n must be a multiple of the "
                         f"{per_block} elements of one of its blocks: no "
                         f"warp may leave at a bounds guard (got n = "
                         f"{res.n})")
    total = 0
    for fn, blocks, threads in stream.launches(name, res.dtype, res.n):
        if fn not in census:
            raise KeyError(f"{fn} is not in the SASS census "
                           f"(have {sorted(census)})")
        total += census[fn].warp_insts_per_warp * blocks * (threads // 32)
    return total


def stream_measurements(hw: HardwareSpec, census: Dict[str, KernelCensus],
                        res: babelstream.Result) -> List[KernelMeasurement]:
    """One ``KernelMeasurement`` per BabelStream kernel: thread
    instructions (warp instructions x the warp width), BabelStream's bytes
    (one array written, except by dot), the fastest time."""
    out = []
    for name in babelstream.FUNCTIONS:
        moved = res.bytes_moved(name)
        written = 0 if name == "dot" else moved // babelstream.ARRAYS_MOVED[
            name]
        out.append(KernelMeasurement(
            name=name, hw=hw, runtime_s=res.row(name)["min_s"],
            instructions=warp_instructions(name, census, res)
            * hw.lanes_per_issue,
            bytes_read=moved - written, bytes_written=written))
    return out


def irm_rows(model: InstructionRooflineModel,
             measurements: List[KernelMeasurement]) -> List[dict]:
    rows = []
    for m, p in zip(measurements, model.points):
        roof = model.roof_at(p.intensity)
        rows.append({
            "kernel": m.name, "warp_insts": int(m.scaled_instructions),
            "bytes": int(m.bytes_read + m.bytes_written),
            "ms": m.runtime_s * 1e3, "inst_per_byte": p.intensity,
            "achieved_gips": p.gips, "roof_gips": roof,
            "achieved_over_roof": p.gips / roof,
            "bound": model.classify(p)})
    return rows


def h100_irm(hw: HardwareSpec, census: Dict[str, KernelCensus],
             res: babelstream.Result
             ) -> Tuple[InstructionRooflineModel, List[dict]]:
    ms = stream_measurements(hw, census, res)
    model = gpu_irm(hw, ms, title=f"IRM — {hw.name}, BabelStream kernels")
    return model, irm_rows(model, ms)


def describe(model: InstructionRooflineModel) -> str:
    hw = model.hw
    return (f"{hw.name}: {hw.compute_units} SMs x {hw.schedulers_per_cu} "
            f"schedulers x IPC {hw.ipc} x {hw.frequency_ghz:.3f} GHz = peak "
            f"{hw.peak_gips():.2f} GIPS (Eq. 3); memory ceiling "
            f"{hw.memory_ceiling_gbs():.3f} GB/s (BabelStream copy, "
            f"measured; data sheet {hw.hbm_bw_theoretical_gbs:.0f} GB/s); "
            f"knee {model.knee():.4f} warp instructions per byte; "
            f"{hw.hbm_gib:.1f} GiB")


def h100_report(census: Dict[str, KernelCensus], res: babelstream.Result,
                clocks: str) -> List[str]:
    """The H100's roofline from a BabelStream run on the card and the
    census of the stream kernels, as lines: the spec (Eq. 3 peak, the
    measured ceiling, the knee), the SM clock ``clocks`` read after the
    run, the table of the five points, and every point above its roof
    (printed as it is, not clamped)."""
    model, rows = h100_irm(h100_from_device(res.copy_gbs()), census, res)
    lines = [describe(model),
             f"SM clock after the BabelStream loop, max: {clocks}",
             *markdown_table(rows, IRM_COLUMNS).splitlines()]
    lines += [f"{r['kernel']} sits above its roof: achieved/roof = "
              f"{r['achieved_over_roof']:.4f} (the roof is the port copy's "
              f"rate; not clamped)"
              for r in rows if r["achieved_over_roof"] > 1.0 + 1e-9]
    # (copy sits on the roof its own rate defines, up to rounding)
    return lines


# ---------------------------------------------------------------------------
# The application's kernels: the looped ones, counted by their trip models
# ---------------------------------------------------------------------------

APP_COLUMNS = ("kernel", "warp_insts_lo", "warp_insts_hi", "bytes", "ms",
               "inst_per_byte_lo", "inst_per_byte_hi", "achieved_gips_lo",
               "achieved_gips", "roof_gips", "achieved_over_roof", "bound")
PEAK_SLACK = 1.05             # the SM clock's rounding in Eq. 3's peak
ITERS = 36
TRACE_TRIES = 3               # a trace that missed launches is taken again


def serve_shapes() -> Tuple[List[int], List[int], int]:
    """The ``serve`` phase's lengths (chip_smoke.py): 8 prompts of 64-300
    tokens from RandomState(7), 32 new tokens, page 16.  Decode at the
    first four slots' lengths halfway through their decode, prefill of a
    32-token chunk from each one's last 32-aligned base, over a table of
    the engine's max_blocks pages: (lens, bases, NB)."""
    n = np.random.RandomState(7).randint(64, 301, size=8)
    lens = [int(x) + 16 for x in n[:4]]
    base = [int(x) - int(x) % 32 for x in n[:4]]
    return lens, base, -(-(int(n.max()) + 32 + 16) // 16)


class LoopCounter:
    """The loop census of a built library: its SASS (``cuobjdump``), the
    line of every instruction (``nvdisasm -g``) and the marked source
    loops; counts a ``Launch`` from its trip model."""

    def __init__(self, listing: str, lines, sources=None):
        self.fns = sc.split_functions(listing)
        self.lines = lines
        self.sources = sources if sources is not None else \
            sc.source_loops()
        self._cache: Dict[tuple, sc.LoopCensus] = {}

    @classmethod
    def of_library(cls, library) -> "LoopCounter":
        return cls(sc.sass_listing(library), sc.line_info(library))

    def function(self, pattern: str) -> str:
        names = [n for n in self.fns if re.search(pattern, n)]
        if len(names) != 1:
            raise KeyError(f"{pattern!r} matches {len(names)} SASS "
                           f"functions, not one")
        return names[0]

    def census(self, la: Launch) -> sc.LoopCensus:
        name = self.function(la.function)
        key = (name, tuple(sorted(la.steps.items())))
        if key not in self._cache:
            self._cache[key] = sc.loop_census(name, self.fns[name],
                                              self.lines.get(name, {}),
                                              self.sources, la.steps)
        return self._cache[key]

    def count(self, la: Launch) -> Tuple[int, int]:
        """(lo, hi) warp instructions of one launch."""
        lo, hi = self.census(la).count(la.entries(), la.warps)
        return sum(lo.values()), sum(hi.values())


def kernel_name(la: Launch) -> str:
    """The C++ name of a launch's kernel, as the profiler's key holds it."""
    return re.search(r"([A-Za-z_]+_kernel)I", la.function).group(1)


@dataclasses.dataclass
class AppCase:
    """One wrapper call at a PERF.md shape: ``call(i)`` runs it on input
    set i; ``launches`` its trip model."""

    name: str
    call: Callable[[int], object]
    launches: List[Launch]


def app_cases(torch, device: str = "cuda") -> List[AppCase]:
    """The looped kernels at PERF.md's shapes, granite-8b's attention
    geometry in bf16 (H 32, KV 8, D 128): paged decode and prefill at the
    ``serve`` phase's lengths (``serve_shapes``) on a 36-layer pool, each
    call on the next layer; dense decode at B 4, T = kv_len 486 over 36
    layers' caches; flash at B 4, S = T = 512, causal, over 8 input sets;
    the selective scan at falcon-mamba-7b's B 4, S 454, d_in 8192, N 16,
    over 4 input sets — so that every call reads device memory, not the
    50 MB L2."""
    from repro_torch.kernels.decode_attention import (
        decode, paged, prefill_paged)
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.kernels.ssm_scan import scan
    gen = torch.Generator(device=device)
    gen.manual_seed(2024)
    bf = torch.bfloat16
    B, H, KV, D, page, L = 4, 32, 8, 128, 16, 36

    def rand(*shape, dtype=bf):
        return torch.randn(*shape, generator=gen, device=device).to(dtype)

    lens, base, NB = serve_shapes()
    P = B * NB + 1
    kp, vp = rand(L, P, page, KV, D), rand(L, P, page, KV, D)
    tbl = torch.randperm(P - 1, generator=gen, device=device)[:B * NB] \
        .reshape(B, NB).to(torch.int32) + 1
    kvl = torch.tensor(lens, dtype=torch.int32, device=device)
    b0 = torch.tensor(base, dtype=torch.int32, device=device)
    new = b0 + 32
    qd, qp = rand(B, 1, H, D), rand(B, 32, H, D)
    cases = [
        AppCase("paged_decode", lambda i: paged.paged_decode_attention(
            qd, kp, vp, tbl, kvl, i % L),
            paged.trip_model(B, H, KV, D, page, NB, lens, bf, bf)),
        AppCase("paged_prefill", lambda i: prefill_paged
                .paged_prefill_attention(qp, kp, vp, tbl, b0, new, i % L),
                prefill_paged.trip_model(B, 32, H, KV, D, page, NB, base,
                                         [b + 32 for b in base], bf))]
    T = 486
    kc, vc = rand(L, B, T, KV, D), rand(L, B, T, KV, D)
    start = torch.zeros(B, dtype=torch.int32, device=device)
    cases.append(AppCase(
        "decode_attention", lambda i: decode.decode_attention(
            qd, kc[i % L], vc[i % L], T, start),
        decode.trip_model(B, T, H, KV, D, T, [0] * B, bf)))
    S, n_sets = 512, 8
    fl = [(rand(B, S, H, D), rand(B, S, KV, D), rand(B, S, KV, D))
          for _ in range(n_sets)]
    cases.append(AppCase(
        "flash_attention", lambda i: flash.flash_attention(*fl[i % n_sets]),
        flash.trip_model(B, S, S, H, KV, D, True)))
    Ss, d_in, N, n_sets = 454, 8192, 16, 4
    sets = []
    for _ in range(n_sets):
        x, dt = rand(B, Ss, d_in), rand(B, Ss, d_in, dtype=torch.float32)
        dt = torch.nn.functional.softplus(dt * 0.5 - 1.0).to(bf)
        A = -torch.exp(rand(d_in, N, dtype=torch.float32) * 0.3)
        bc = rand(B, Ss, 2 * N)
        sets.append((x, dt, A, bc[..., :N], bc[..., N:]))
    cases.append(AppCase(
        "selective_scan", lambda i: scan.selective_scan(*sets[i % n_sets]),
        scan.trip_model(B, Ss, d_in, N, bf, vec=scan.copies_16_bytes(
            sets[0][0], sets[0][1]))))
    return cases


def variant_launches() -> List[Launch]:
    """The looped kernels' other instantiations, for a census without a
    point: at the same shapes, paged decode and prefill on int8 pools and
    with f32 q (the CUDA-core prefill body), dense decode, flash and the
    scan in f32; dense decode and flash, bf16 and f32, at zamba2-7b's
    head dim 112 (32 heads over 32, the hybrid phase's S 454); and flash's
    training instantiations (which also write L), bf16 and f32, at
    qwen2-0.5b's training shape (B 4, S 4096, 14 heads over 2 of 64)."""
    import torch

    from repro_torch.kernels.decode_attention import (
        decode, paged, prefill_paged)
    from repro_torch.kernels.flash_attention import flash
    from repro_torch.kernels.ssm_scan import scan
    f32, bf, i8 = torch.float32, torch.bfloat16, torch.int8
    lens, base, NB = serve_shapes()
    new = [b + 32 for b in base]
    out = []
    for q, kv in ((bf, i8), (f32, f32), (f32, i8)):
        out += paged.trip_model(4, 32, 8, 128, 16, NB, lens, q, kv)
        out += prefill_paged.trip_model(4, 32, 32, 8, 128, 16, NB, base,
                                        new, kv, q)
    for dt in (bf, f32):
        out += decode.trip_model(4, 486, 32, 32, 112, 486, [0] * 4, dt)
        out += flash.trip_model(4, 454, 454, 32, 32, 112, True, dt)
        out += flash.trip_model(4, 4096, 4096, 14, 2, 64, True, dt,
                                with_lse=True)
    return out + decode.trip_model(4, 486, 32, 8, 128, 486, [0] * 4, f32) \
        + flash.trip_model(4, 512, 512, 32, 8, 128, True, f32) \
        + scan.trip_model(4, 454, 8192, 16, f32)


def device_us(torch, call: Callable[[int], object], iters: int = ITERS
              ) -> Dict[str, Tuple[float, int]]:
    """{profiler key: (device us, launches)} of every CUDA kernel that
    ``iters`` calls of ``call(i)`` ran, from a ``torch.profiler`` trace
    after a warm-up (as scripts/torch_kernel_profile.py reads it)."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(3):
        call(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            call(i)
        torch.cuda.synchronize()
    return {e.key: (e.device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0}


def kernel_us(times: Dict[str, Tuple[float, int]], la: Launch
              ) -> Tuple[float, int]:
    """(device us, launches) of the launch's kernel in a trace."""
    keys = [k for k in times if f"{kernel_name(la)}<" in k]
    if len(keys) != 1:
        raise KeyError(f"{kernel_name(la)}: {len(keys)} kernels of the "
                       f"trace match (the trace holds no device time for "
                       f"it, or more than one)")
    return times[keys[0]]


@dataclasses.dataclass
class AppPoint:
    """A kernel's warp instructions [lo, hi], bytes and device seconds."""

    kernel: str
    lo: int
    hi: int
    bytes: int
    seconds: float


def app_points(torch, counter: LoopCounter, cases: List[AppCase],
               iters: int = ITERS) -> List[AppPoint]:
    """One point per launch of each case (the split kernel and its
    combine apart, then their sum), per call: the census of the trip
    model, its bytes, the device time per call.  A point is read only from
    a trace that holds every launch of the ``iters`` calls: the profiler
    has been seen to drop a share of them (18 of 36 dense decode launches
    on an H100), so a short trace is taken again, up to ``TRACE_TRIES``
    times, and raises after that."""
    out = []
    for case in cases:
        names = [kernel_name(la) for la in case.launches]
        seen = []
        for _ in range(TRACE_TRIES):
            times = device_us(torch, case.call, iters)
            try:
                got = [kernel_us(times, la) for la in case.launches]
            except KeyError as e:
                seen.append(str(e))
            else:
                seen.append([n for _, n in got])
                if all(n == iters for _, n in got):
                    break
            print(f"[irm] {case.name}: the trace of {iters} calls holds "
                  f"{seen[-1]} launches of {names}; tracing again",
                  file=sys.stderr)
        else:
            raise AssertionError(f"{case.name}: launches of {names} in "
                                 f"{TRACE_TRIES} traces of {iters} calls: "
                                 f"{seen}")
        pts = []
        for la, (us, _) in zip(case.launches, got):
            lo, hi = counter.count(la)
            pts.append(AppPoint(f"{case.name}: {kernel_name(la)}", lo, hi,
                                la.bytes, us / iters * 1e-6))
        if len(pts) > 1:
            pts.append(AppPoint(f"{case.name}: sum", *(
                sum(getattr(p, f) for p in pts)
                for f in ("lo", "hi", "bytes", "seconds"))))
        out += pts
    return out


def serve_points(counter: LoopCounter, records: Dict[str, List[dict]],
                 times: Dict[str, Tuple[float, int]]) -> List[AppPoint]:
    """The paged decode and prefill kernels summed over every launch of a
    serving run (the paper's count of a kernel over an application's
    invocations): instructions and bytes from the calls a recording pass
    logged (``Kernel.record``), device time from a traced pass of the
    same traffic, whose launches must match the records."""
    from repro_torch.kernels.decode_attention import paged, prefill_paged
    out = []
    models = {"decode": lambda r: paged.trip_model(
        r["B"], r["H"], r["KV"], r["D"], r["page"], r["NB"], r["kv_len"],
        r["q_dtype"], r["kv_dtype"]),
        "prefill": lambda r: prefill_paged.trip_model(
        r["B"], r["T"], r["H"], r["KV"], r["D"], r["page"], r["NB"],
        r["base_len"], r["new_len"], r["kv_dtype"], r["q_dtype"])}
    for kind, recs in records.items():
        sums: Dict[str, list] = {}
        memo: Dict[tuple, list] = {}
        for r in recs:
            key = tuple((k, v.tobytes() if isinstance(v, np.ndarray) else v)
                        for k, v in sorted(r.items()) if k != "layer")
            if key not in memo:
                memo[key] = [(kernel_name(la), *counter.count(la), la.bytes)
                             for la in models[kind](r)]
            for name, lo, hi, nbytes in memo[key]:
                acc = sums.setdefault(name, [0, 0, 0, 0])
                acc[0] += lo
                acc[1] += hi
                acc[2] += nbytes
                acc[3] += 1
        for name, (lo, hi, nbytes, n) in sums.items():
            keys = [k for k in times if f"{name}<" in k]
            if len(keys) != 1 or times[keys[0]][1] != n:
                raise AssertionError(
                    f"serve {kind}: {name} launched "
                    f"{[times[k][1] for k in keys]} times in the traced "
                    f"pass, {n} in the recorded one")
            out.append(AppPoint(f"serve, {n} launches: {name}", lo, hi,
                                nbytes, times[keys[0]][0] * 1e-6))
    return out


def app_rows(model: InstructionRooflineModel, points: List[AppPoint]
             ) -> List[dict]:
    """The points as rows beside the roofline of ``model``: intensities
    and achieved GIPS at lo and hi, the roof and achieved/roof at hi."""
    rows = []
    for p in points:
        i_lo, i_hi = p.lo / p.bytes, p.hi / p.bytes
        g_lo, g_hi = p.lo / p.seconds / 1e9, p.hi / p.seconds / 1e9
        roof = model.roof_at(i_hi)
        rows.append({
            "kernel": p.kernel, "warp_insts_lo": p.lo, "warp_insts_hi": p.hi,
            "bytes": p.bytes, "ms": p.seconds * 1e3,
            "inst_per_byte_lo": i_lo, "inst_per_byte_hi": i_hi,
            "achieved_gips_lo": g_lo, "achieved_gips": g_hi,
            "roof_gips": roof, "achieved_over_roof": g_hi / roof,
            "bound": "memory" if i_hi < model.knee() else "compute"})
    return rows


def over_peak(hw: HardwareSpec, rows: List[dict]) -> List[str]:
    """Points whose achieved GIPS pass Eq. 3's peak by more than the
    clock's rounding: no cache lets a warp issue faster, so such a count
    is a census fault."""
    return [f"{r['kernel']}: {r['achieved_gips']:.2f} GIPS > "
            f"{PEAK_SLACK} x {hw.peak_gips():.2f}"
            for r in rows if r["achieved_gips"] > PEAK_SLACK * hw.peak_gips()]


def app_report(model: InstructionRooflineModel, points: List[AppPoint]
               ) -> List[str]:
    rows = app_rows(model, points)
    return [f"application kernels (loop census, device time; the point at "
            f"hi): peak {model.hw.peak_gips():.2f} GIPS, ceiling "
            f"{model.hw.memory_ceiling_gbs():.3f} GB/s, knee "
            f"{model.knee():.4f}",
            *markdown_table(rows, APP_COLUMNS).splitlines()]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    print("Paper Tables 1-2, recomputed (Eqs. 2-4) beside the published "
          "values:")
    print(markdown_table(paper_rows()))
    if args.device == "cpu":
        print("\nThe H100 roofline needs the card (run without --device "
              "cpu).")
        return 0
    import torch

    from repro_torch.core.sass_counters import census_library
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("[irm] no CUDA device: the H100 roofline is measured on the "
              "card (pass --device cpu for the paper's tables alone)",
              file=sys.stderr)
        return 2
    census = census_library(build.build(), select=r"^stream_")
    res = babelstream.run(device="cuda")      # 2^25 f32, 100 times
    print("\n" + babelstream.report(res))
    if not res.ok:
        return 1
    print("\n" + "\n".join(h100_report(census, res, sm_clocks())))
    model, _ = h100_irm(h100_from_device(res.copy_gbs()), census, res)
    points = app_points(torch, LoopCounter.of_library(build.build()),
                        app_cases(torch))
    print("\n" + "\n".join(app_report(model, points)))
    faults = over_peak(model.hw, app_rows(model, points))
    print("\n".join(faults))
    return 1 if faults else 0


def sm_clocks() -> str:
    """The SM clock now and its maximum, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
