"""H100 instruction-issue model of a whole step — the Eq. 2/3/4 analogue
for the port, counterpart of ``repro/core/tpu_model.py``.

The paper normalizes raw counter values to the machine's native
execution granularity (AMD: SQ_INSTS_VALU x 4 SIMDs over 64-lane
wavefronts).  An H100 SM has two instruction-bearing unit classes that a
step's census (``core/step_census.py``) counts:

  * the tensor cores: one issue is one warp-level m16n8k16 mma (4096
    FLOP), ceil-tiled, so a padded tile shows;
  * the warp schedulers: one issue is one 32-lane warp instruction of
    the CUDA cores (Eq. 3's GIPS).

This module turns those counts into the paper's headline quantities
for the step: peak GIPS per unit class, achieved GIPS at a runtime
(measured, or the three-term roofline's modeled time), and instruction
intensity in issues per byte.  JAX's ``mxu_``/``vpu_`` names are
``tc_``/``warp_`` here.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.step_census import Census


@dataclasses.dataclass
class GpuInstructionProfile:
    """The H100 'Table 1 row' for one traced step."""

    name: str
    hw: HardwareSpec
    runtime_s: float                  # measured, or roofline-modeled
    runtime_is_modeled: bool
    # issue counts (per device)
    tc_issues: float
    warp_issues: float
    scalar_ops: float
    # traffic
    hbm_bytes: float
    # raw flop context
    tc_flops: float
    warp_flops: float
    tc_flops_padded: float

    # --- Eq. 3 analogues ---------------------------------------------------
    @property
    def peak_tc_gips(self) -> float:
        return self.hw.peak_tc_issues_per_s() / 1e9

    @property
    def peak_warp_gips(self) -> float:
        return self.hw.peak_warp_issues_per_s() / 1e9

    # --- Eq. 4 analogues ---------------------------------------------------
    @property
    def achieved_tc_gips(self) -> float:
        return self.tc_issues / (1e9 * self.runtime_s)

    @property
    def achieved_warp_gips(self) -> float:
        return self.warp_issues / (1e9 * self.runtime_s)

    @property
    def achieved_total_gips(self) -> float:
        insts = self.tc_issues + self.warp_issues + self.scalar_ops
        return insts / (1e9 * self.runtime_s)

    # --- Eq. 2 analogue (runtime-free intensity, inst/byte) -----------------
    @property
    def tc_intensity(self) -> float:
        return self.tc_issues / self.hbm_bytes if self.hbm_bytes else 0.0

    @property
    def warp_intensity(self) -> float:
        return self.warp_issues / self.hbm_bytes if self.hbm_bytes else 0.0

    @property
    def total_intensity(self) -> float:
        insts = self.tc_issues + self.warp_issues + self.scalar_ops
        return insts / self.hbm_bytes if self.hbm_bytes else 0.0

    # --- padding efficiency: the IRM-only insight ---------------------------
    @property
    def tc_padding_efficiency(self) -> float:
        """useful tensor-core FLOPs / FLOPs of the issued mma tiles.
        < 1.0 means padded tiles (a decode row of M = 1 fills 1/16 of
        each), invisible on a FLOP roofline, visible on this one."""
        if not self.tc_flops_padded:
            return 1.0
        return self.tc_flops / self.tc_flops_padded

    @property
    def tc_utilization(self) -> float:
        return self.achieved_tc_gips / self.peak_tc_gips

    @property
    def warp_utilization(self) -> float:
        return self.achieved_warp_gips / self.peak_warp_gips

    def dominant_unit(self) -> str:
        return ("tc" if self.tc_utilization >= self.warp_utilization
                else "warp")

    def table_row(self) -> dict:
        return {
            "name": self.name,
            "hw": self.hw.name,
            "runtime_s": self.runtime_s,
            "runtime_modeled": self.runtime_is_modeled,
            "peak_tc_gips": self.peak_tc_gips,
            "peak_warp_gips": self.peak_warp_gips,
            "achieved_tc_gips": self.achieved_tc_gips,
            "achieved_warp_gips": self.achieved_warp_gips,
            "tc_intensity_inst_per_byte": self.tc_intensity,
            "warp_intensity_inst_per_byte": self.warp_intensity,
            "tc_padding_efficiency": self.tc_padding_efficiency,
            "tc_utilization": self.tc_utilization,
            "warp_utilization": self.warp_utilization,
            "dominant_unit": self.dominant_unit(),
        }


def profile_from_census(name: str, census: Census, hw: HardwareSpec,
                        runtime_s: float,
                        runtime_is_modeled: bool = True
                        ) -> GpuInstructionProfile:
    return GpuInstructionProfile(
        name=name, hw=hw, runtime_s=runtime_s,
        runtime_is_modeled=runtime_is_modeled,
        tc_issues=census.tc_issues,
        warp_issues=census.warp_issues,
        scalar_ops=census.scalar_ops,
        hbm_bytes=census.hbm_bytes,
        tc_flops=census.tc_flops,
        warp_flops=census.warp_flops,
        tc_flops_padded=census.tc_flops_padded,
    )
