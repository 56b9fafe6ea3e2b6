"""The readings that a cell's correctness limits are set from, on the
chip, at the cell's own size, in one process:

- the program's number over many seeds (the lower reading), each seed a
  run of the cell's own driver with a short window;
- the control's over a few seeds: the reference put in the program's
  place at the precision below the configuration's (fp8 products for
  bf16) -- for a served cell the f32 reference's gap of the token the fp8
  reference puts first at each served position, for a training cell the
  fp8 reference's first steps held to the f32 reference's;
- for a training cell, a fault planted in the program at the same size:
  each step fed half of its rows (the mean taken over the rest);
- with ``--rates``, the knee of a serving mix: the cell as an open loop
  at each rate, and whether its backlog grows.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 8 --out calib.json

The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import checks  # noqa: E402
import common  # noqa: E402
import run as bench_run  # noqa: E402
from reference import dense_lm  # noqa: E402


def _free(device) -> None:
    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def serve_control(ctx, out) -> float:
    """The f32 reference's widest gap of the fp8 reference's first token
    over the served positions of the run's sample."""
    from repro_torch.models.model import get_model
    cfg, traffic = ctx["cell"]["config"], ctx["cell"]["traffic"]
    arch = common.arch_config(cfg, traffic.get("port"))
    model = get_model(arch)
    weights = common.make_weights(model.schema(), ctx["seed"],
                                  ctx["device"], arch.param_dtype)
    dense_lm.no_tf32()
    return max(dense_lm.served_gaps(weights, cfg, p, s, control=True)
               for p, s in out["sample"])


def train_half_batch(ctx, driver, ref) -> dict:
    """The program's first steps with every step fed the first half of
    its rows, held to the reference's full-batch readings."""
    arch, model, weights, opt, step, batches = driver.build(ctx)

    def half():
        for b in batches:
            n = b["tokens"].shape[0] // 2
            yield {k: v[:n] for k, v in b.items()}
    job = ctx["cell"]["traffic"]
    _, _, prog = driver.first_steps(step, opt, weights, half(),
                                    job["check_steps"],
                                    job["optimizer"]["b1"])
    return checks.train_checks(prog, ref)


def worst_leaves(prog, ref) -> dict:
    """The leaf behind each norm gap, with its gap."""
    import statistics
    out = {}
    keep = checks.moved_leaves(ref["grad"])
    for key, leaves in (("grad", ref["grad"]), ("change", keep)):
        med = statistics.median(ref[key][k] for k in leaves)
        gaps = {k: abs(prog[key][k] - ref[key][k])
                / max(ref[key][k], med, 1e-30) for k in leaves}
        k = max(gaps, key=gaps.get)
        out[key] = [k, gaps[k]]
    return out


def sweep(cell, driver, rates, seed, seconds, device, peaks) -> list:
    """The knee of an open-loop serving mix: the cell run at each rate
    (requests a second), with what a growing backlog shows: the engine's
    queue at the window's open and close, and the requests sent and
    finished in the window."""
    rows = []
    for rate in rates:
        traffic = dict(cell["traffic"], rate=rate,
                       backlog=cell["traffic"].get("backlog", 0))
        ctx = {"cell": dict(cell, traffic=traffic), "seed": seed,
               "seconds": seconds, "trace": 0, "device": device,
               "peaks": peaks}
        out = driver.run(ctx)
        rec, ticks = out["record"], out["ticks"]
        rows.append({"rate": rate, "sent": out["attempted"],
                     "finished": out["finished"],
                     "queue": [ticks[0]["queued"], ticks[-1]["queued"]],
                     "e2e": out["e2e"],
                     "ttft_p50_ms": common.quantile(rec["ttft_ms"], 0.5)
                     if rec["ttft_ms"] else None})
        print(json.dumps(rows[-1]), flush=True)
        _free(device)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rates", default="",
                    help="requests a second: sweep an open loop instead")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    bench_run.caches()
    cell = common.load_cell(args.workload)
    kind = cell["traffic"]["driver"]
    driver = bench_run._module(BENCH / "drivers" / f"{kind}.py")
    peaks = common.read_json(BENCH / "work" / "peaks.json")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    if args.rates:
        rows = sweep(cell, driver, [float(r) for r in args.rates.split(",")],
                     seeds[0], args.seconds, args.device, peaks)
        Path(args.out).write_text(json.dumps(rows, indent=1) + "\n")
        return 0
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    rows = []
    for seed in dict.fromkeys(seeds + controls):
        t0 = time.perf_counter()
        ctx = {"cell": cell, "seed": seed, "seconds": args.seconds,
               "trace": 0, "device": args.device, "peaks": peaks}
        out = driver.run(ctx)
        row = {"seed": seed, "program": {k: c["value"] for k, c in
                                         out["checks"].items()},
               "correct": out["correct"]}
        if kind == "train":
            row["program"] = checks.train_checks(out["prog"], out["ref"])
            row["losses"] = {"program": out["prog"]["losses"],
                             "reference": out["ref"]["losses"]}
            row["worst"] = worst_leaves(out["prog"], out["ref"])
        _free(args.device)
        if seed in controls:
            if kind == "serve":
                row["control"] = {"logit_gap": serve_control(ctx, out)}
            else:
                from repro_torch.models.model import get_model
                arch = common.arch_config(cell["config"],
                                          cell["traffic"].get("port"))
                ctrl = driver.reference(ctx, get_model(arch), arch, "fp8")
                _free(args.device)
                row["control"] = checks.train_checks(ctrl, out["ref"])
                row["control_losses"] = ctrl["losses"]
                row["control_worst"] = worst_leaves(ctrl, out["ref"])
                row["half_batch"] = train_half_batch(ctx, driver,
                                                     out["ref"])
            _free(args.device)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
