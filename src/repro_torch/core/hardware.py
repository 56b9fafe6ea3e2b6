"""Hardware constants of the instruction roofline, for GPUs.

The paper (Leinhauser et al. 2021) builds instruction roofline models from a
small set of per-device constants: compute units, schedulers per unit, IPC,
frequency, native execution width (warp=32 / wavefront=64), and an
*empirically measured* memory bandwidth (BabelStream) where the profiler
cannot report one.  This module keeps exactly those fields, the paper's
three GPUs (Tables 1-2, Figs 4-7), and an H100 read from the card
(``h100_from_device``), whose memory ceiling is the port's own BabelStream
copy rate (``repro_torch.launch.babelstream``).

The H100 also carries the ceilings of the three-term roofline
(``core/roofline.py``) and of the step profile (``core/gpu_model.py``),
with the JAX package's field meanings: a dense FLOP peak per dtype, the
link count and per-link rate per direction of the collective term, and
the tensor cores' issue geometry.

* **Tensor-core issue.** One issue is one warp-level
  ``mma.sync.aligned.m16n8k16`` (bf16 in, f32 accumulate): 16 x 8 x 16
  x 2 = 4096 FLOP, the instruction ``csrc/tc_ptx.cuh`` issues.  An SM's
  4 tensor cores do 1024 dense bf16 FLOP a clock each, so the peak is
  SMs x 4 x 1024 x the maximum SM clock (132 x 4 x 1024 x 1.98 GHz =
  1070.5 TFLOP/s; NVIDIA's data sheet gives 989.4, at a 1.83 GHz boost
  clock, and PERF.md's kernel bounds use that) and the issue peak is
  that over 4096.  Hopper's ``wgmma`` (a warpgroup's m64nNk16) does the
  work of many such issues in one instruction: counted in m16n8k16
  units, a ``wgmma`` kernel's issues are what the same products cost
  on the warp-level path, not its instruction count.
* **CUDA cores.** f32 at SMs x 128 lanes x 2 FLOP x the clock (66.9
  TFLOP/s at 1.98 GHz, the data sheet's figure); the warp-instruction
  peak is Eq. 3's (1045.44 GIPS on an H100 SXM).
* **NVLink 4.** 18 links x 25 GB/s per direction (450 GB/s a
  direction, the data sheet's 900 GB/s both ways).
"""
from __future__ import annotations

import dataclasses
import subprocess
from typing import Dict, Optional, Tuple

H100_HBM_GBS_DATA_SHEET = 3352.0   # H100 SXM5 HBM3, NVIDIA data sheet
H100_SCHEDULERS_PER_SM = 4         # warp schedulers per Hopper SM
H100_IPC = 1                       # warp instructions per cycle per scheduler
WARP = 32
H100_TC_PER_SM = 4                 # tensor cores per Hopper SM
H100_TC_FLOPS_PER_CLOCK = 1024     # dense bf16 FLOP a clock, per tensor core
H100_FP32_LANES_PER_SM = 128       # f32 CUDA cores per SM (an FMA is 2 FLOP)
H100_BF16_TFLOPS_DATA_SHEET = 989.4   # dense, SXM5 (at a 1.83 GHz boost)
H100_FP32_TFLOPS_DATA_SHEET = 66.9
H100_NVLINKS = 18                  # NVLink 4 links per GPU
H100_NVLINK_GBS = 25.0             # per link, per direction
MMA_M, MMA_N, MMA_K = 16, 8, 16    # mma.sync.aligned.m16n8k16 (csrc/tc_ptx.cuh)


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
    # --- compute ceiling in FLOP terms (three-term roofline) --------------
    peak_flops_bf16: Optional[float] = None      # dense, FLOP/s
    peak_flops_fp32: Optional[float] = None
    # --- tensor-core issue geometry (NVIDIA) --------------------------------
    tc_per_sm: int = 0                # tensor cores per SM
    tc_flops_per_clock: int = 0       # dense bf16 FLOP a clock, per core
    tc_mma: Tuple[int, int, int] = (MMA_M, MMA_N, MMA_K)  # one issue's m, n, k
    # --- interconnect (collective ceiling) --------------------------------
    links: int = 0                    # links per device
    link_bw_per_link_gbs: float = 0.0  # per direction

    # -- paper Eq. 3: GIPS_peak = CU x WFS/CU x IPC x freq ------------------
    def peak_gips(self) -> float:
        return (self.compute_units * self.schedulers_per_cu * self.ipc
                * self.frequency_ghz)

    # -- memory ceiling used for roofline plots ----------------------------
    def memory_ceiling_gbs(self) -> float:
        if self.hbm_bw_measured_gbs is not None:
            return self.hbm_bw_measured_gbs
        return self.hbm_bw_theoretical_gbs

    # -- tensor-core and warp issue peaks ------------------------------------
    def flops_per_tc_issue(self) -> float:
        """One warp-level mma: m x n x k multiply-adds, 2 FLOP each."""
        m, n, k = self.tc_mma
        return 2.0 * m * n * k

    def peak_tc_issues_per_s(self) -> float:
        """SMs x tensor cores x FLOP a clock x clock, over an issue's FLOP."""
        return (self.compute_units * self.tc_per_sm * self.tc_flops_per_clock
                * self.frequency_ghz * 1e9 / self.flops_per_tc_issue())

    def peak_warp_issues_per_s(self) -> float:
        """Eq. 3 in issues a second."""
        return self.peak_gips() * 1e9


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
    (BabelStream's copy) as the roof when given; the tensor-core and f32
    peaks at the same clock and NVLink 4 (see the module doc)."""
    clock_hz = max_sm_clock_mhz * 1e6
    return HardwareSpec(
        name=name, vendor="nvidia", compute_units=int(sm_count),
        schedulers_per_cu=H100_SCHEDULERS_PER_SM, ipc=H100_IPC,
        frequency_ghz=max_sm_clock_mhz / 1e3, lanes_per_issue=WARP,
        hbm_bw_theoretical_gbs=H100_HBM_GBS_DATA_SHEET,
        hbm_bw_measured_gbs=measured_gbs,
        hbm_gib=total_memory_bytes / 2 ** 30,
        peak_flops_bf16=(sm_count * H100_TC_PER_SM * H100_TC_FLOPS_PER_CLOCK
                         * clock_hz),
        peak_flops_fp32=sm_count * H100_FP32_LANES_PER_SM * 2 * clock_hz,
        tc_per_sm=H100_TC_PER_SM, tc_flops_per_clock=H100_TC_FLOPS_PER_CLOCK,
        links=H100_NVLINKS, link_bw_per_link_gbs=H100_NVLINK_GBS)


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
