"""Instruction Roofline Model assembly: ceilings + achieved points.

An IRM (paper Figs 4-7) is a log-log plot with

  x: instruction intensity  [scaled instructions / byte]
  y: performance            [GIPS]

and two ceilings: the horizontal peak-GIPS line (Eq. 3) and the diagonal
memory roof  y = bandwidth_GBs * x  (bandwidth measured with a
STREAM-class benchmark where the profiler can't report it).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

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
