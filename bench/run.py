"""Runs one cell of the benchmark once and prints its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic and
limits are files found by the names in ``BENCHMARK.json``; its driver is
``bench/drivers/<the traffic file's driver>.py`` and each per-layer
metric is read by ``bench/metrics/<metric>.py`` (or, for
``<quantity>.<suffix>``, by ``bench/metrics/<quantity>.py``).  It measures the port,
``repro_torch`` under ``src/``, on the CUDA devices of the machine it is
started on, and exits with a code other than 0, printing no result, when
there is no such device, when the port cannot be imported, or when the
process has loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import common  # noqa: E402


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths:
    the port's own nvcc build is ``build/repro_torch/`` already."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None, device: str = None) -> int:
    """``device`` None: the CUDA devices, required.  A test passes "cpu"
    to drive the rest of a run on the port's plain route."""
    args = parse(argv)
    caches()
    try:
        cell = common.load_cell(args.workload)
    except (common.CellError, FileNotFoundError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    import torch
    chips = cell["cell"]["chips"]
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            print(f"bench: {args.workload} needs {chips} CUDA device(s); "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = "cuda"
        torch.cuda.set_device(0)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"bench: the port is not here ({e})", file=sys.stderr)
        return 4
    driver = _module(BENCH / "drivers"
                     / f"{cell['traffic']['driver']}.py")
    ctx = {"cell": cell, "seed": args.seed, "seconds": args.seconds,
           "trace": args.trace, "device": device,
           "peaks": common.read_json(BENCH / "work" / "peaks.json")}
    out = driver.run(ctx)
    bad = common.forbidden_modules()
    if bad:
        print(f"bench: the process loaded {', '.join(bad)}; the benchmark "
              f"measures the port alone", file=sys.stderr)
        return 5
    spec, name = cell["spec"], args.workload
    metrics = {}
    if args.trace:
        for m in common.cell_metrics(spec, name, "per_layer"):
            v = _module(common.reader_file(m["name"], BENCH)).read(
                out["record"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=out["t_open"] - T_START)
        for m in common.cell_metrics(spec, name, "end_to_end"):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = dict(out["device"], count=chips)
    result = {"correct": bool(out["correct"]),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": dev}
    if args.trace:
        from work import trace as wtrace
        tr = out["record"].get("trace")
        if tr:
            dev["busy_s"] = tr["busy_s"]
            dev["window_s"] = tr["window_s"]
            result["breakdown"] = wtrace.breakdown(tr)
    common.emit(result, out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
