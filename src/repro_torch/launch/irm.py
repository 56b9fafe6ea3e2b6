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
    are BabelStream's count and its runtime the fastest of the iterations.

Hardware counters (Nsight Compute) are not read: for these loop-free
kernels the census is exact and needs only ``cuobjdump``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from typing import Dict, List, Tuple

from repro_torch.core import paper_data
from repro_torch.core.hardware import HardwareSpec, h100_from_device
from repro_torch.core.irm import InstructionRooflineModel, gpu_irm
from repro_torch.core.paper_model import KernelMeasurement
from repro_torch.core.report import markdown_table
from repro_torch.core.sass_counters import KernelCensus
from repro_torch.kernels.stream import stream
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
    return 0


def sm_clocks() -> str:
    """The SM clock now and its maximum, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


if __name__ == "__main__":
    sys.exit(main())
