"""Instruction Roofline Model assembly: ceilings + achieved points.

An IRM (paper Figs 4-7) is a log-log plot with

  x: instruction intensity  [scaled instructions / byte]
  y: performance            [GIPS]

and two ceilings: the horizontal peak-GIPS line (Eq. 3) and the diagonal
memory roof  y = bandwidth_GBs * x  (bandwidth measured with a
STREAM-class benchmark where the profiler can't report it).  A traced
step on the H100 (``step_irm``, the counterpart of the JAX ``tpu_irm``)
has two instruction ceilings, the tensor cores' and the warp
schedulers', under the same memory roof.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.gpu_model import GpuInstructionProfile
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.paper_model import KernelMeasurement


@dataclasses.dataclass
class Ceiling:
    label: str
    gips: Optional[float] = None       # horizontal compute ceiling
    gbs: Optional[float] = None        # diagonal memory ceiling (GB/s)

    def y_at(self, intensity: float) -> float:
        if self.gips is not None:
            return self.gips
        return self.gbs * intensity


@dataclasses.dataclass
class IRMPoint:
    label: str
    intensity: float                   # inst/byte (issue-scaled)
    gips: float
    series: str = "HBM"


@dataclasses.dataclass
class InstructionRooflineModel:
    hw: HardwareSpec
    ceilings: List[Ceiling]
    points: List[IRMPoint]
    title: str = ""

    def roof_at(self, intensity: float) -> float:
        """The binding roof value at a given intensity."""
        return min(c.y_at(intensity) for c in self.ceilings)

    def headroom(self, p: IRMPoint) -> float:
        """roof / achieved — how far below the binding roof the point sits."""
        roof = self.roof_at(p.intensity)
        return roof / p.gips if p.gips else float("inf")

    def knee(self) -> float:
        """Intensity where the memory roof meets the lowest compute roof."""
        gips = min(c.gips for c in self.ceilings if c.gips is not None)
        gbs = max(c.gbs for c in self.ceilings if c.gbs is not None)
        return gips / gbs

    def classify(self, p: IRMPoint) -> str:
        return "memory" if p.intensity < self.knee() else "compute"


def gpu_irm(hw: HardwareSpec, measurements: List[KernelMeasurement],
            title: str = "") -> InstructionRooflineModel:
    """The paper's construction: Eq. 3 compute ceiling + BabelStream memory
    ceiling; points from Eq. 2/4."""
    ceilings = [
        Ceiling(label=f"Peak {hw.peak_gips():.2f} GIPS", gips=hw.peak_gips()),
        Ceiling(label=f"HBM {hw.memory_ceiling_gbs():.1f} GB/s",
                gbs=hw.memory_ceiling_gbs()),
    ]
    points = [IRMPoint(label=m.name, intensity=m.intensity(),
                       gips=m.achieved_gips()) for m in measurements]
    return InstructionRooflineModel(hw=hw, ceilings=ceilings, points=points,
                                    title=title or f"IRM — {hw.name}")


def step_irm(profiles: List[GpuInstructionProfile],
             title: str = "") -> InstructionRooflineModel:
    """H100 variant for traced steps: a tensor-core issue ceiling and a
    warp-instruction ceiling (Eq. 3), and the HBM roof (the measured
    BabelStream rate where the spec has one, else the data sheet's);
    each profile gives one point per unit class, both against the same
    HBM byte count."""
    if not profiles:
        raise ValueError("need at least one profile")
    hw = profiles[0].hw
    ceilings = [
        Ceiling(label=f"Tensor-core peak "
                      f"{hw.peak_tc_issues_per_s()/1e9:.2f} GIPS",
                gips=hw.peak_tc_issues_per_s() / 1e9),
        Ceiling(label=f"Warp peak {hw.peak_warp_issues_per_s()/1e9:.2f} "
                      f"GIPS",
                gips=hw.peak_warp_issues_per_s() / 1e9),
        Ceiling(label=f"HBM {hw.memory_ceiling_gbs():.0f} GB/s",
                gbs=hw.memory_ceiling_gbs()),
    ]
    points: List[IRMPoint] = []
    for p in profiles:
        points.append(IRMPoint(label=f"{p.name} (TC)",
                               intensity=p.tc_intensity,
                               gips=p.achieved_tc_gips, series="TC"))
        points.append(IRMPoint(label=f"{p.name} (warp)",
                               intensity=p.warp_intensity,
                               gips=p.achieved_warp_gips, series="WARP"))
    return InstructionRooflineModel(
        hw=hw, ceilings=ceilings, points=points,
        title=title or f"Instruction roofline — {hw.name}")
