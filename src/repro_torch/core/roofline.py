"""Three-term roofline model of a traced step — port of
``repro/core/roofline.py``.

For a per-device step (census from ``core/step_census.py``):

    compute_term_s    = device_flops / peak_FLOP/s
                        (f32 products: at the f32 peak, see below)
    memory_term_s     = device_hbm_bytes / HBM_bw
    collective_term_s = device_collective_wire_bytes / (links x link_bw)

The dominant term is the modeled step time; the roofline fraction of each
term is term / max(term) and the bottleneck is argmax.  Since the census is
already per device, chip counts only enter via the sharded shapes — no
further division is needed (whole-job FLOPs / (chips x peak) is the same
as per-device FLOPs / peak).

The JAX model prices every FLOP at the bf16 peak, as the MXU runs f32
dots too.  The H100 runs f32 products on its CUDA cores with TF32 off,
so the census's ``tc_flops_f32`` goes at ``peak_flops_fp32`` (66.9
TFLOP/s against 1070.5) and every other FLOP at the bf16 peak; for a
census with no f32 product the two models agree term for term.

The link term is links x per-link rate (NVLink 4: 18 x 25 GB/s a
direction on an H100), the JAX model's uniform link.  A 16 x 16 mesh of
H100s spans 32 eight-GPU nodes, so most of its collective traffic
crosses nodes on InfiniBand, slower than NVLink; the port keeps the JAX
model's assumption, and its collective term is a floor.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.step_census import Census


@dataclasses.dataclass
class RooflineTerms:
    name: str
    hw_name: str
    n_devices: int
    # inputs (per device)
    flops: float
    hbm_bytes: float
    collective_wire_bytes: float
    # terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    # derived
    dominant: str                    # "compute" | "memory" | "collective"
    modeled_time_s: float            # max of the three terms
    bound_fraction: float            # dominant / sum  (1.0 == perfectly skewed)
    # usefulness accounting
    model_flops: Optional[float] = None      # 6ND-style algorithmic flops
    useful_flops_ratio: Optional[float] = None   # model_flops / census flops
    # roofline fractions: how close each non-dominant term is to the roof
    compute_fraction: float = 0.0    # compute_s / modeled_time_s
    memory_fraction: float = 0.0
    collective_fraction: float = 0.0
    # achieved-at-modeled-time rates
    achieved_tflops: float = 0.0     # per device, at modeled time
    achieved_gbs: float = 0.0
    mfu_vs_peak: float = 0.0         # useful model flops / (time x peak)

    def summary(self) -> str:
        return (f"{self.name}: compute {self.compute_s*1e3:.3f} ms | "
                f"memory {self.memory_s*1e3:.3f} ms | collective "
                f"{self.collective_s*1e3:.3f} ms -> {self.dominant}-bound "
                f"(modeled {self.modeled_time_s*1e3:.3f} ms, "
                f"MFU {self.mfu_vs_peak*100:.1f}%)")


def roofline_terms(name: str,
                   census: Census,
                   hw: HardwareSpec,
                   n_devices: int,
                   model_flops_total: Optional[float] = None,
                   peak_flops: Optional[float] = None) -> RooflineTerms:
    """Build the three-term roofline for one traced step.

    ``model_flops_total`` is the whole-job algorithmic FLOP count (e.g. 6ND);
    it is divided by ``n_devices`` for the per-device usefulness ratio.
    """
    peak = peak_flops or hw.peak_flops_bf16
    if not peak:
        raise ValueError(f"{hw.name} has no FLOP peak; pass peak_flops")
    hbm = hw.memory_ceiling_gbs() * 1e9
    link = hw.links * hw.link_bw_per_link_gbs * 1e9
    f32_peak = hw.peak_flops_fp32 or peak
    compute_s = ((census.flops - census.tc_flops_f32) / peak
                 + census.tc_flops_f32 / f32_peak)
    memory_s = census.hbm_bytes / hbm
    collective_s = (census.collective_wire_bytes / link) if link else 0.0
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    modeled = terms[dominant]
    total = sum(terms.values()) or 1.0

    model_flops_dev = (model_flops_total / n_devices
                       if model_flops_total else None)
    useful = (model_flops_dev / census.flops
              if model_flops_dev and census.flops else None)
    mfu = (model_flops_dev / (modeled * peak)
           if model_flops_dev and modeled > 0 else 0.0)
    return RooflineTerms(
        name=name, hw_name=hw.name, n_devices=n_devices,
        flops=census.flops, hbm_bytes=census.hbm_bytes,
        collective_wire_bytes=census.collective_wire_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, modeled_time_s=modeled,
        bound_fraction=terms[dominant] / total,
        model_flops=model_flops_total, useful_flops_ratio=useful,
        compute_fraction=compute_s / modeled if modeled else 0.0,
        memory_fraction=memory_s / modeled if modeled else 0.0,
        collective_fraction=collective_s / modeled if modeled else 0.0,
        achieved_tflops=(census.flops / modeled / 1e12) if modeled else 0.0,
        achieved_gbs=(census.hbm_bytes / modeled / 1e9) if modeled else 0.0,
        mfu_vs_peak=mfu,
    )


def to_row(t: RooflineTerms) -> Dict[str, object]:
    return {
        "name": t.name,
        "devices": t.n_devices,
        "flops_per_dev": t.flops,
        "hbm_bytes_per_dev": t.hbm_bytes,
        "collective_bytes_per_dev": t.collective_wire_bytes,
        "compute_s": t.compute_s,
        "memory_s": t.memory_s,
        "collective_s": t.collective_s,
        "dominant": t.dominant,
        "modeled_time_s": t.modeled_time_s,
        "useful_flops_ratio": t.useful_flops_ratio,
        "mfu_vs_peak": t.mfu_vs_peak,
    }
