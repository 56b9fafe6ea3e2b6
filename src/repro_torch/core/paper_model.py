"""Paper-faithful instruction roofline formulas (Leinhauser et al. 2021).

Implements Equations 1-4 exactly as published, for both the AMD (wavefront)
and NVIDIA (warp) variants, and the IRM point construction used for the
paper's Tables 1-2 and Figures 4-7.

Equation index
  Eq. 1:  instructions = SQ_INSTS_VALU * 4 + SQ_INSTS_SALU
  Eq. 2:  instruction intensity *performance* =
              (instructions / lanes) / ((bytes_read + bytes_written) * runtime)
          NOTE: the published Eq. 2 includes the multiplication by runtime;
          we reproduce it verbatim (it is what Tables 1-2 actually contain)
          and separately provide the runtime-free `instruction_intensity`
          (instructions / byte) used for plotting points on an IRM.
  Eq. 3:  GIPS_peak = CU * WFS_per_CU * IPC * frequency_GHz
  Eq. 4:  GIPS_achieved = (instructions / lanes) / (1e9 * runtime)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.hardware import HardwareSpec

AMD_SIMDS_PER_CU = 4       # Fig. 1 / GCN whitepaper: 4 SIMD vector units / CU
AMD_WAVEFRONT = 64
NVIDIA_WARP = 32


def amd_instructions(sq_insts_valu: float, sq_insts_salu: float,
                     simds_per_cu: int = AMD_SIMDS_PER_CU) -> float:
    """Eq. 1.  SQ_INSTS_VALU is reported per SIMD; there are 4 SIMD vector
    units per compute unit and a single scalar unit."""
    return sq_insts_valu * simds_per_cu + sq_insts_salu


def peak_gips(hw: HardwareSpec) -> float:
    """Eq. 3."""
    return hw.peak_gips()


def achieved_gips(instructions: float, runtime_s: float,
                  lanes_per_issue: int) -> float:
    """Eq. 4: instructions normalized to the native execution granularity
    (wavefront=64 / warp=32), in billions per second."""
    if runtime_s <= 0:
        raise ValueError("runtime must be positive")
    return (instructions / lanes_per_issue) / (1e9 * runtime_s)


def instruction_intensity_performance(instructions: float,
                                      bytes_read: float,
                                      bytes_written: float,
                                      runtime_s: float,
                                      lanes_per_issue: int) -> float:
    """Eq. 2 verbatim (includes the x runtime factor; see module docstring)."""
    denom = (bytes_read + bytes_written) * runtime_s
    if denom <= 0:
        raise ValueError("bytes and runtime must be positive")
    return (instructions / lanes_per_issue) / denom


def instruction_intensity(instructions: float, bytes_read: float,
                          bytes_written: float,
                          lanes_per_issue: int) -> float:
    """Runtime-free intensity in (scaled) instructions per byte — the x-axis
    of the paper's instruction roofline plots in instructions/byte units."""
    total = bytes_read + bytes_written
    if total <= 0:
        raise ValueError("bytes must be positive")
    return (instructions / lanes_per_issue) / total


def instruction_intensity_per_transaction(instructions: float,
                                          transactions: float,
                                          lanes_per_issue: int) -> float:
    """Ding & Williams' original x-axis (instructions / transaction), usable
    only where the profiler reports transactions (NVIDIA).  One transaction
    is 32 bytes."""
    if transactions <= 0:
        raise ValueError("transactions must be positive")
    return (instructions / lanes_per_issue) / transactions


@dataclasses.dataclass(frozen=True)
class KernelMeasurement:
    """One profiled kernel instance — the rocProf/nvprof record the paper's
    tables are built from."""

    name: str
    hw: HardwareSpec
    runtime_s: float
    instructions: float              # already Eq.1-scaled (or inst_executed)
    bytes_read: float
    bytes_written: float
    transactions: Optional[float] = None   # NVIDIA-only

    @property
    def scaled_instructions(self) -> float:
        return self.instructions / self.hw.lanes_per_issue

    def achieved_gips(self) -> float:
        return achieved_gips(self.instructions, self.runtime_s,
                             self.hw.lanes_per_issue)

    def intensity(self) -> float:
        return instruction_intensity(self.instructions, self.bytes_read,
                                     self.bytes_written,
                                     self.hw.lanes_per_issue)

    def intensity_performance(self) -> float:
        return instruction_intensity_performance(
            self.instructions, self.bytes_read, self.bytes_written,
            self.runtime_s, self.hw.lanes_per_issue)

    def peak_gips(self) -> float:
        return self.hw.peak_gips()

    def irm_point(self) -> tuple:
        """(x, y) for the instruction roofline plot: instructions/byte vs
        achieved GIPS."""
        return (self.intensity(), self.achieved_gips())

    def memory_bound_gips(self) -> float:
        """GIPS ceiling imposed by the memory roof at this point's intensity:
        intensity [inst/byte] x bandwidth [GB/s] = GIPS."""
        return self.intensity() * self.hw.memory_ceiling_gbs()

    def bound(self) -> str:
        """Which roof caps this kernel (the paper's bottleneck readout)."""
        return ("memory" if self.memory_bound_gips() < self.peak_gips()
                else "compute")
