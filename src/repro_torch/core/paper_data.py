"""Published raw measurements from Leinhauser et al. 2021, Tables 1 and 2.

These are the paper's own profiler readings (nvprof / rocProf) for the
ComputeCurrent kernel of PIConGPU's LWFA and TWEAC science cases.  They are
the ground truth our implementation of Eqs. 1-4 must reproduce:
tests/test_torch_irm.py recomputes Achieved GIPS and the two intensity
columns from the raw (instructions, bytes, runtime) triples and asserts they
match the published values within the paper's own stated rounding slack
("values ... are rounded to three decimal points and therefore manually
calculating ... may vary slightly").
"""
from __future__ import annotations

from repro_torch.core.hardware import MI60, MI100, V100
from repro_torch.core.paper_model import KernelMeasurement

# --- Table 1: LWFA simulation, ComputeCurrent kernel -----------------------

LWFA_V100 = KernelMeasurement(
    name="ComputeCurrent/LWFA", hw=V100,
    runtime_s=0.0040,
    instructions=279_498_240,
    bytes_read=267_280_000_000.0,
    bytes_written=97_329_000_000.0,
)
LWFA_MI60 = KernelMeasurement(
    name="ComputeCurrent/LWFA", hw=MI60,
    runtime_s=0.0127,
    instructions=502_440_960,
    bytes_read=1_125_436_000.0,
    bytes_written=432_711_000.0,
)
LWFA_MI100 = KernelMeasurement(
    name="ComputeCurrent/LWFA", hw=MI100,
    runtime_s=0.0025,
    instructions=449_796_480,
    bytes_read=1_124_711_000.0,
    bytes_written=408_483_000.0,
)

# Published derived values (Table 1).
LWFA_PUBLISHED = {
    "v100": dict(peak_gips=489.60, achieved_gips=2.178, intensity=0.006),
    "mi60": dict(peak_gips=115.20, achieved_gips=0.620, intensity=0.398),
    "mi100": dict(peak_gips=180.24, achieved_gips=2.856, intensity=1.863),
}

# --- Table 2: TWEAC simulation, ComputeCurrent kernel ----------------------

TWEAC_V100 = KernelMeasurement(
    name="ComputeCurrent/TWEAC", hw=V100,
    runtime_s=0.283,
    instructions=60_149_000_000,
    bytes_read=40_931_000_000.0,
    bytes_written=1_810_100_000.0,
)
TWEAC_MI60 = KernelMeasurement(
    name="ComputeCurrent/TWEAC", hw=MI60,
    runtime_s=0.394,
    instructions=90_319_028_127,
    bytes_read=11_451_009_000.0,
    bytes_written=785_101_000.0,
)
TWEAC_MI100 = KernelMeasurement(
    name="ComputeCurrent/TWEAC", hw=MI100,
    runtime_s=0.246,
    instructions=78_488_570_820,
    bytes_read=11_460_394_000.0,
    bytes_written=792_172_000.0,
)

TWEAC_PUBLISHED = {
    "v100": dict(peak_gips=489.60, achieved_gips=6.634, intensity=0.155),
    "mi60": dict(peak_gips=115.20, achieved_gips=3.586, intensity=0.293),
    "mi100": dict(peak_gips=180.24, achieved_gips=4.993, intensity=0.408),
}

TABLE1 = {"v100": LWFA_V100, "mi60": LWFA_MI60, "mi100": LWFA_MI100}
TABLE2 = {"v100": TWEAC_V100, "mi60": TWEAC_MI60, "mi100": TWEAC_MI100}

# V100 intensity in instructions/transaction, as quoted in the prose.
V100_LWFA_INTENSITY_PER_TXN = 0.178
V100_TWEAC_INTENSITY_PER_TXN = 4.931
TRANSACTION_BYTES = 32
