"""Profile any assigned architecture x shape into an instruction-roofline
report + IRM figure, without hardware — the twin of
examples/profile_model.py.

The port's dry run traces the cell's real step on fake tensors over a
fake process group of the production mesh's size (256 ranks, or 512
with --multi-pod) and profiles it against an H100 SXM's data-sheet
constants; nothing runs on a device.

Run:  PYTHONPATH=src python examples/profile_model_torch.py \\
          --arch granite-8b --shape decode_32k [--multi-pod] [--plot out.svg]
"""
import argparse
import json

from repro_torch.core.gpu_model import GpuInstructionProfile
from repro_torch.core.irm import step_irm
from repro_torch.core.plotting import plot_irm
from repro_torch.launch import dryrun


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--plot", default="", help="an .svg path")
    args = ap.parse_args(argv)

    rec = dryrun.run_cell(args.arch, args.shape, args.multi_pod)
    print(json.dumps({k: v for k, v in rec.items()
                      if k in ("cell", "roofline", "irm", "memory",
                               "flop_counter", "build_info", "skipped")},
                     indent=2, default=str))

    if args.plot and "skipped" not in rec:
        irm, c = rec["irm"], rec["census"]
        prof = GpuInstructionProfile(
            name=rec["cell"], hw=dryrun.h100_sxm(),
            runtime_s=irm["runtime_s"], runtime_is_modeled=True,
            tc_issues=c["tc_issues"], warp_issues=c["warp_issues"],
            scalar_ops=c["scalar_ops"], hbm_bytes=c["hbm_bytes"],
            tc_flops=c["tc_flops"], warp_flops=c["warp_flops"],
            tc_flops_padded=c["tc_flops_padded"])
        plot_irm(step_irm([prof], title=rec["cell"]), args.plot)
        print(f"wrote {args.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
