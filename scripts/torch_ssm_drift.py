#!/usr/bin/env python3
"""How far falcon-mamba-7b's kernel path drifts from its plain path when
the selective scan matters, and what sets the drift.

    python3 scripts/torch_ssm_drift.py            # on one H100, ~2 min

The seeded random weights ``chip_smoke.py`` serves keep the scan's
output tiny (the init's fan-in scale on the conv taps), so its logit
check cannot see the scan kernel.  Here the conv taps are scaled by s and
dt_bias raised by delta, for a few (s, delta), and each prints, for the
4 prompts of ``chip_smoke.py``'s ssm phase (bf16, full width and depth):

  moved   max |logits(plain, scan output y set to 0) - logits(plain)|:
          how much the scan moves the logits;
  kernel  max |logits(kernel) - logits(plain)|: the check's drift;
  floor   max |logits(plain, y's last bit flipped at random in the share
          of elements where the kernel's y differs from the plain one)
          - logits(plain)|: the drift of a perturbation of the kernel's
          size and kind that no kernel makes;
  layers  the kernel against the plain scan on the same inputs at every
          layer of the plain path: the worst ratio of |y_k - y_p| to
          chip_smoke.py's bf16 scan tolerance (<= 1 holds) and of
          |h_k - h_p| to rtol = atol = 2e-5, and the share of y elements
          that differ;
  bound   LOGIT_ULPS = 8 bf16 ulps of the plain logits' scale.

Then, on the largest scaling, the same model in f32 (the bf16 weights
upcast): kernel against plain logits, where only the f32 order of sums
differs.  Each line ends with the card's name and power limit.
"""
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LOGIT_ULPS = 8
SCAN_RTOL, SCAN_ATOL = 2.0 ** -7 + 2e-5, 2e-5      # chip_smoke.SCAN_TOL bf16
SCALINGS = [(1.0, 0.0), (4.0, 2.0), (8.0, 2.0), (16.0, 2.0), (32.0, 2.0),
            (None, 0.0), (None, 2.0)]               # None: sqrt(d_in)


def scaled_params(params, cfg, s, delta):
    d_in = cfg.d_model * cfg.ssm_expand
    mixer = dict(params["blocks"]["mixer"])
    mixer["conv_w"] = mixer["conv_w"] * (math.sqrt(d_in) if s is None else s)
    mixer["dt_bias"] = mixer["dt_bias"] + delta
    return dict(params, blocks=dict(params["blocks"], mixer=mixer))


def prefill_logits(torch, model, params, prompts):
    from repro_torch.serve.engine import ServeConfig, ServingEngine
    with torch.no_grad():
        logits, _ = ServingEngine(model, params, ServeConfig()
                                  )._prefill_cache(prompts, 2)
    return logits.float()


def patched(ssm_mod, wrap, fn):
    """``fn()`` with the plain scan replaced by ``wrap(plain scan)``."""
    plain = ssm_mod.mamba1_scan
    ssm_mod.mamba1_scan = wrap(plain)
    try:
        return fn()
    finally:
        ssm_mod.mamba1_scan = plain


def measure(torch, cfg, params, prompts):
    from repro_torch.kernels.ssm_scan import scan
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.model import get_model
    kern, plain = get_model(cfg), get_model(cfg, plain_attention=True)
    lp = prefill_logits(torch, plain, params, prompts)
    lk = prefill_logits(torch, kern, params, prompts)
    stats = {"y": 0.0, "h": 0.0, "diff": []}

    def both(scan_plain):
        def run(*args):
            y, h = scan_plain(*args)
            yk, hk = scan.selective_scan(*args)
            a, b = yk.float(), y.float()
            stats["y"] = max(stats["y"], ((a - b).abs() / (
                SCAN_RTOL * b.abs() + SCAN_ATOL)).max().item())
            stats["h"] = max(stats["h"], ((hk - h).abs() / (
                2e-5 * h.abs() + 2e-5)).max().item())
            stats["diff"].append((yk != y).float().mean().item())
            return y, h
        return run

    def zero(scan_plain):
        def run(*args):
            y, h = scan_plain(*args)
            return torch.zeros_like(y), h
        return run

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    def flip(scan_plain):
        share = sum(stats["diff"]) / len(stats["diff"])

        def run(*args):
            y, h = scan_plain(*args)
            bits = y.view(torch.int16)
            mask = (torch.rand(y.shape, generator=gen, device=y.device)
                    < share).to(torch.int16)
            return (bits ^ mask).view(y.dtype), h
        return run

    def run_plain():
        return prefill_logits(torch, plain, params, prompts)

    patched(ssm_mod, both, run_plain)
    l0 = patched(ssm_mod, zero, run_plain)
    lf = patched(ssm_mod, flip, run_plain)
    scale = lp.abs().max().item()
    return dict(moved=(l0 - lp).abs().max().item(),
                kernel=(lk - lp).abs().max().item(),
                floor=(lf - lp).abs().max().item(),
                y_ratio=stats["y"], h_ratio=stats["h"],
                y_share=sum(stats["diff"]) / len(stats["diff"]),
                bound=LOGIT_ULPS * 2.0 ** -8 * scale, scale=scale,
                argmax=int((lk.argmax(-1) == lp.argmax(-1)).sum()))


def main() -> int:
    import dataclasses

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_ssm_drift: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import configs
    from repro_torch.kernels.ssm_scan import scan
    from repro_torch.models.model import get_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    cfg = configs.get("falcon-mamba-7b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)                           # chip_smoke.py's weights
    params = get_model(cfg).init(gen, "cuda")
    rng = np.random.RandomState(17)              # ... and prompts
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype("int32")
               for n in rng.randint(64, 501, size=4)]
    d_in = cfg.d_model * cfg.ssm_expand
    for s, delta in SCALINGS:
        r = measure(torch, cfg, scaled_params(params, cfg, s, delta),
                    prompts)
        tag = f"x{math.sqrt(d_in) if s is None else s:.1f}"
        print(f"[drift] bf16 conv taps {tag}, dt_bias +{delta}: moved "
              f"{r['moved']:.4e} kernel {r['kernel']:.4e} floor "
              f"{r['floor']:.4e} bound {r['bound']:.4e} (scale "
              f"{r['scale']:.3f}); argmax agree {r['argmax']}/4; layers: "
              f"y/tol {r['y_ratio']:.3f}, h/tol {r['h_ratio']:.3f}, y "
              f"differs in {r['y_share']:.4f} of elements; {gpu}",
              flush=True)
    s, delta = SCALINGS[-1]
    f32 = dataclasses.replace(cfg, dtype="float32")
    big = scaled_params(params, cfg, s, delta)
    del params
    up = _cast(torch, big, torch.float32)
    del big
    torch.cuda.empty_cache()
    kern, plain = get_model(f32), get_model(f32, plain_attention=True)
    n0 = scan.KERNEL.launches
    lk = prefill_logits(torch, kern, up, prompts)
    lp = prefill_logits(torch, plain, up, prompts)
    scale = lp.abs().max().item()
    print(f"[drift] f32 conv taps x{math.sqrt(d_in):.1f}, dt_bias +{delta}: "
          f"kernel {(lk - lp).abs().max().item():.4e} of scale {scale:.3f} "
          f"(f32 scan launches {scan.KERNEL.launches - n0}); argmax agree "
          f"{int((lk.argmax(-1) == lp.argmax(-1)).sum())}/4; {gpu}",
          flush=True)
    return 0


def _cast(torch, tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(torch, v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


if __name__ == "__main__":
    sys.exit(main())
