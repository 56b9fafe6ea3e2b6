"""Quickstart of the PyTorch port: the paper's workflow end to end — the
twin of examples/quickstart.py.

1. Reproduce a row of the paper's Table 2 from raw rocProf counters.
2. Trace a PyTorch step on fake tensors with the port's per-device census
   (the counterpart of the XLA instruction census) and print its
   instruction roofline record on the H100.

Run:  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
      PYTHONPATH=src python examples/quickstart_torch.py      # on the card

The census never allocates (fake tensors).  With ``--device cuda`` (the
default) the same MLP also runs on the card, the card's own constants
(``h100_from_device``) replace the data sheet's, and the profile is at
the measured time; with ``--device cpu`` it is at the roofline's modeled
time.
"""
import argparse

import torch
import torch.nn.functional as F

from repro_torch.core import paper_data
from repro_torch.core.gpu_model import profile_from_census
from repro_torch.core.hardware import h100_from_device, h100_spec
from repro_torch.core.roofline import roofline_terms
from repro_torch.core.step_census import census_of_step

B, D, FF = 256, 512, 2048


def step(x, w1, w2):
    h = F.gelu(x @ w1)
    return (h @ w2).sum()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    # --- 1. paper Table 2, MI100 row ---------------------------------------
    m = paper_data.TWEAC_MI100
    print("== Leinhauser et al. Table 2 (TWEAC ComputeCurrent, MI100) ==")
    print(f"  peak GIPS (Eq.3):      {m.peak_gips():8.2f}   (published "
          f"180.24)")
    print(f"  achieved GIPS (Eq.4):  {m.achieved_gips():8.3f}   (published "
          f"4.993)")
    print(f"  intensity (Eq.2):      {m.intensity_performance():8.3f}"
          "   (published 0.408)")
    print(f"  bound: {m.bound()}")

    # --- 2. same methodology, applied to a traced PyTorch step -------------
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = [torch.empty(s, dtype=torch.bfloat16)
                for s in ((B, D), (D, FF), (FF, D))]
    census = census_of_step(step, *fake)
    runtime_s = None
    if args.device == "cuda":
        hw = h100_from_device()
        real = [torch.randn(t.shape, dtype=t.dtype, device="cuda") / 16
                for t in fake]
        step(*real)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(20):
            step(*real)
        end.record()
        end.synchronize()
        runtime_s = start.elapsed_time(end) / 20 / 1e3
    else:
        hw = h100_spec("NVIDIA H100 SXM (data sheet)", 132, 1980.0,
                       80 * 2 ** 30)
    terms = roofline_terms("quickstart_mlp", census, hw, n_devices=1)
    prof = profile_from_census(
        "quickstart_mlp", census, hw,
        runtime_s=runtime_s or terms.modeled_time_s,
        runtime_is_modeled=runtime_s is None)

    when = ("measured" if runtime_s else "modeled")
    print(f"\n== instruction roofline of the traced MLP step ({hw.name}, "
          f"{when} time) ==")
    print(f"  tensor-core flops: {census.tc_flops/1e9:.2f} GFLOP   "
          f"issues: {census.tc_issues:.0f} "
          f"(padding eff {prof.tc_padding_efficiency*100:.0f}%)")
    print(f"  warp issues: {census.warp_issues:.0f}   HBM bytes: "
          f"{census.hbm_bytes/1e6:.1f} MB")
    print("  " + terms.summary())
    print(f"  achieved tensor-core GIPS {prof.achieved_tc_gips:.4f} "
          f"(peak {prof.peak_tc_gips:.4f}) at {prof.runtime_s*1e3:.4f} ms "
          f"| intensity {prof.tc_intensity:.2e} inst/B")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
