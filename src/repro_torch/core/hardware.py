"""Hardware constants of the instruction roofline, for GPUs.

The paper (Leinhauser et al. 2021) builds instruction roofline models from a
small set of per-device constants: compute units, schedulers per unit, IPC,
frequency, native execution width (warp=32 / wavefront=64), and an
*empirically measured* memory bandwidth (BabelStream) where the profiler
cannot report one.  This module keeps exactly those fields, the paper's
three GPUs (Tables 1-2, Figs 4-7), and an H100 read from the card
(``h100_from_device``), whose memory ceiling is the port's own BabelStream
copy rate (``repro_torch.launch.babelstream``).
"""
from __future__ import annotations

import dataclasses
import subprocess
from typing import Dict, Optional

H100_HBM_GBS_DATA_SHEET = 3352.0   # H100 SXM5 HBM3, NVIDIA data sheet
H100_SCHEDULERS_PER_SM = 4         # warp schedulers per Hopper SM
H100_IPC = 1                       # warp instructions per cycle per scheduler
WARP = 32


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Constants needed to build instruction rooflines for one device."""

    name: str
    vendor: str                       # "amd" | "nvidia"
    # --- instruction ceiling (paper Eq. 3) -------------------------------
    compute_units: int                # CUs (AMD) / SMs (NVIDIA)
    schedulers_per_cu: int            # wavefront/warp schedulers per CU/SM
    ipc: int                          # instructions issued per cycle/scheduler
    frequency_ghz: float
    # --- native execution granularity (paper Eq. 4) ----------------------
    lanes_per_issue: int              # wavefront=64, warp=32
    # --- memory ceiling ---------------------------------------------------
    hbm_bw_theoretical_gbs: float
    hbm_bw_measured_gbs: Optional[float] = None  # BabelStream-style measured
    hbm_gib: float = 0.0              # device memory capacity

    # -- paper Eq. 3: GIPS_peak = CU x WFS/CU x IPC x freq ------------------
    def peak_gips(self) -> float:
        return (self.compute_units * self.schedulers_per_cu * self.ipc
                * self.frequency_ghz)

    # -- memory ceiling used for roofline plots ----------------------------
    def memory_ceiling_gbs(self) -> float:
        if self.hbm_bw_measured_gbs is not None:
            return self.hbm_bw_measured_gbs
        return self.hbm_bw_theoretical_gbs


# ---------------------------------------------------------------------------
# Registry.  The entries hold the exact constants the paper uses in
# Tables 1-2 (CU/SM count, schedulers, IPC, frequency) plus the BabelStream
# bandwidths from section 6.2.
# ---------------------------------------------------------------------------

MI60 = HardwareSpec(
    name="AMD Radeon Instinct MI60",
    vendor="amd",
    compute_units=64,
    schedulers_per_cu=1,
    ipc=1,
    frequency_ghz=1.800,
    lanes_per_issue=64,               # wavefront
    hbm_bw_theoretical_gbs=1000.0,
    # BabelStream copy: 808,975.476 MB/s (paper section 6.2)
    hbm_bw_measured_gbs=808.975476,
    hbm_gib=32.0,
)

MI100 = HardwareSpec(
    name="AMD Instinct MI100",
    vendor="amd",
    compute_units=120,
    schedulers_per_cu=1,
    ipc=1,
    frequency_ghz=1.502,
    lanes_per_issue=64,
    hbm_bw_theoretical_gbs=1200.0,
    # BabelStream copy: 933,355.781 MB/s (paper section 6.2)
    hbm_bw_measured_gbs=933.355781,
    hbm_gib=32.0,
)

V100 = HardwareSpec(
    name="NVIDIA Tesla V100",
    vendor="nvidia",
    compute_units=80,                 # SMs
    schedulers_per_cu=4,              # warp schedulers per SM
    ipc=1,
    frequency_ghz=1.530,
    lanes_per_issue=32,               # warp
    hbm_bw_theoretical_gbs=900.0,
    # paper: achieved >99% of theoretical via Nsight Compute
    hbm_bw_measured_gbs=None,
    hbm_gib=16.0,
)

REGISTRY: Dict[str, HardwareSpec] = {
    "mi60": MI60,
    "mi100": MI100,
    "v100": V100,
}


def get(name: str) -> HardwareSpec:
    key = name.lower().replace("-", "_")
    if key not in REGISTRY:
        raise KeyError(f"unknown hardware {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[key]


def h100_spec(name: str, sm_count: int, max_sm_clock_mhz: float,
              total_memory_bytes: int,
              measured_gbs: Optional[float] = None) -> HardwareSpec:
    """An H100 from what the card reports: Eq. 3 with 4 warp schedulers
    per SM issuing one warp instruction per cycle at the maximum SM clock
    (132 x 4 x 1 x 1.98 GHz = 1045.44 GIPS on an H100 SXM); the data
    sheet's HBM rate as the theoretical ceiling, and ``measured_gbs``
    (BabelStream's copy) as the roof when given."""
    return HardwareSpec(
        name=name, vendor="nvidia", compute_units=int(sm_count),
        schedulers_per_cu=H100_SCHEDULERS_PER_SM, ipc=H100_IPC,
        frequency_ghz=max_sm_clock_mhz / 1e3, lanes_per_issue=WARP,
        hbm_bw_theoretical_gbs=H100_HBM_GBS_DATA_SHEET,
        hbm_bw_measured_gbs=measured_gbs,
        hbm_gib=total_memory_bytes / 2 ** 30)


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock, from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout
    return float(out.strip().splitlines()[0])


def h100_from_device(measured_gbs: Optional[float] = None) -> HardwareSpec:
    """``h100_spec`` of card 0: SM count and memory size from torch, the
    maximum SM clock from ``nvidia-smi``.  Raises without a card."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("h100_from_device needs a CUDA device")
    props = torch.cuda.get_device_properties(0)
    return h100_spec(props.name, props.multi_processor_count,
                     max_sm_clock_mhz(), props.total_memory, measured_gbs)
