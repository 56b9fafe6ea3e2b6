"""BabelStream on the port's own kernels: the memory ceiling of the card.

    python -m repro_torch.launch.babelstream               # 2^25 f32, cuda
    python -m repro_torch.launch.babelstream --device cpu --rows 64 \\
        --cols 256 --num-times 3

BabelStream's protocol (its ``main.cpp``), run through the wrappers of
``repro_torch.kernels.stream``: arrays start at a = 0.1, b = 0.2,
c = 0.0 with scalar 0.4; each of ``--num-times`` iterations runs
copy c = a, mul b = s * c, add c = a + b, triad a = b + s * c and
dot sum(a * b), in that order and in place; each call is timed on its own
(CUDA events around it, and a synchronise after it, as BabelStream
synchronises after every kernel; the host clock on the CPU).  The table
is BabelStream's: MBytes/sec = 1e-6 * bytes / fastest time, and the
fastest, slowest and mean time, the first iteration left out.  Bytes are
2N element sizes for copy, mul and dot and 3N for add and triad.  The
final arrays and the sum are then checked against BabelStream's scalar
recurrence (its ``check_solution``); a mismatch exits non-zero.

Copy's rate is the measured memory ceiling of the instruction roofline
(paper section 6.2).  The default size is BabelStream's: 2^25 elements
per array, 128 MiB each in f32, about eight times the H100's 50 MB L2, so
the rate is HBM's.  BabelStream's default type is f64; the JAX kernels
take f32 and bf16, so the port does too.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from typing import Dict, List

import torch

from repro_torch.kernels.stream import stream
from repro_torch.kernels.stream.ref import scalar_in

START_A, START_B, START_C = 0.1, 0.2, 0.0   # BabelStream's startA/B/C
FUNCTIONS = ("copy", "mul", "add", "triad", "dot")
ARRAYS_MOVED = {"copy": 2, "mul": 2, "add": 3, "triad": 3, "dot": 2}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EPS_FACTOR = 100.0                   # BabelStream: 100 * epsilon of T
ROWS, COLS = 16384, 2048             # 2^25 elements: BabelStream's default
NUM_TIMES = 100                      # BabelStream's default


@dataclasses.dataclass
class Result:
    """One BabelStream run: per-function times (seconds, every iteration)
    and what the solution check found."""

    n: int
    dtype: torch.dtype
    num_times: int
    device: str
    times: Dict[str, List[float]]
    sum: float
    gold_sum: float
    errors: Dict[str, float]         # mean |x - gold| of a, b, c; sum rel.
    limits: Dict[str, float]

    @property
    def ok(self) -> bool:
        return all(self.errors[k] <= self.limits[k] for k in self.errors)

    def bytes_moved(self, name: str) -> int:
        return ARRAYS_MOVED[name] * self.n * torch.finfo(self.dtype).bits // 8

    def row(self, name: str) -> Dict[str, float]:
        """BabelStream's row: the first iteration left out."""
        ts = self.times[name][1:]
        return {"function": name,
                "mbytes_per_sec": 1e-6 * self.bytes_moved(name) / min(ts),
                "min_s": min(ts), "max_s": max(ts),
                "avg_s": sum(ts) / len(ts)}

    def copy_gbs(self) -> float:
        """The measured memory ceiling: copy's rate in GB/s."""
        return self.row("copy")["mbytes_per_sec"] / 1e3

    def table(self) -> str:
        lines = [f"{'Function':<12}{'MBytes/sec':>14}{'Min (sec)':>14}"
                 f"{'Max':>14}{'Average':>14}"]
        for name in FUNCTIONS:
            r = self.row(name)
            lines.append(f"{name.capitalize():<12}"
                         f"{r['mbytes_per_sec']:>14.3f}{r['min_s']:>14.8f}"
                         f"{r['max_s']:>14.8f}{r['avg_s']:>14.8f}")
        return "\n".join(lines)


def gold(dtype: torch.dtype, num_times: int, n: int):
    """BabelStream's scalar recurrence in the arrays' type (each step
    rounding as the kernels do), and the expected sum: gold a * gold b
    * n in f32, the type dot accumulates in."""
    def t(x):
        return torch.tensor(x, dtype=dtype)
    a, b, c = t(START_A), t(START_B), t(START_C)
    s = t(scalar_in(dtype))
    for _ in range(num_times):
        c = a.clone()
        b = s * c
        c = a + b
        a = b + s * c
    return a, b, c, float(a.float() * b.float()) * n


def check_solution(a, b, c, total: float, num_times: int):
    """(errors, limits, expected sum).  Each array's mean absolute error
    against the recurrence is held to 100 epsilons of the type, as
    BabelStream holds it, here times the recurrence's value: BabelStream's
    bound is absolute, while the values decay to ~0.002 after 100
    iterations (a = 0.96^k * 0.1).  The sum's relative error is held to
    100 f32 epsilons: BabelStream's 1e-8 is a bound for its f64 default,
    and the port's dot accumulates in f32."""
    ga, gb, gc, gsum = gold(a.dtype, num_times, a.numel())
    eps = torch.finfo(a.dtype).eps * EPS_FACTOR
    errors, limits = {}, {}
    for name, x, g in (("a", a, ga), ("b", b, gb), ("c", c, gc)):
        errors[name] = (x.double() - float(g)).abs().mean().item()
        limits[name] = eps * abs(float(g))
    errors["sum"] = abs((total - gsum) / gsum)
    limits["sum"] = torch.finfo(torch.float32).eps * EPS_FACTOR
    return errors, limits, gsum


def run(rows: int = ROWS, cols: int = COLS,
        dtype: torch.dtype = torch.float32, num_times: int = NUM_TIMES,
        device: str = "cuda") -> Result:
    """BabelStream over (rows, cols) arrays on ``device``; by default its
    own size and count, 2^25 elements 100 times."""
    if num_times < 2:
        raise ValueError("num_times must be >= 2 (the first iteration is "
                         "left out of the table)")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu for the plain "
                           "versions on the CPU)")
    a = torch.full((rows, cols), START_A, dtype=dtype, device=dev)
    b = torch.full((rows, cols), START_B, dtype=dtype, device=dev)
    c = torch.full((rows, cols), START_C, dtype=dtype, device=dev)
    calls = {"copy": lambda: stream.copy(a, out=c),
             "mul": lambda: stream.mul(c, out=b),
             "add": lambda: stream.add(a, b, out=c),
             "triad": lambda: stream.triad(b, c, out=a),
             "dot": lambda: stream.dot(a, b)}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    spans = {name: [] for name in FUNCTIONS}
    total = None
    for _ in range(num_times):
        for name in FUNCTIONS:
            if dev.type == "cuda":
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = calls[name]()
                ev[1].record()
                torch.cuda.synchronize(dev)
                spans[name].append(ev)
            else:
                t0 = time.perf_counter()
                out = calls[name]()
                spans[name].append(time.perf_counter() - t0)
            if name == "dot":
                total = out
    if dev.type == "cuda":
        times = {k: [s.elapsed_time(e) / 1e3 for s, e in v]
                 for k, v in spans.items()}
    else:
        times = spans
    total = float(total)
    errors, limits, gsum = check_solution(a, b, c, total, num_times)
    return Result(n=a.numel(), dtype=dtype, num_times=num_times,
                  device=str(dev), times=times, sum=total, gold_sum=gsum,
                  errors=errors, limits=limits)


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def report(res: Result) -> str:
    where = gpu_line() if res.device.startswith("cuda") else \
        "CPU (plain versions; not a device measurement)"
    check = ", ".join(f"{k} {res.errors[k]:.3e} (limit {res.limits[k]:.3e})"
                      for k in res.errors)
    return "\n".join([
        f"BabelStream (port): {res.n} elements per array "
        f"({res.n * torch.finfo(res.dtype).bits // 8 / 2**20:.1f} MiB), "
        f"{str(res.dtype).replace('torch.', '')}, {res.num_times} times, "
        f"on {where}",
        res.table(),
        f"solution check: {'passed' if res.ok else 'FAILED'} ({check}); "
        f"sum {res.sum!r}, expected {res.gold_sum!r}",
        f"measured memory ceiling (copy): {res.copy_gbs():.3f} GB/s"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--cols", type=int, default=COLS)
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--num-times", type=int, default=NUM_TIMES)
    args = ap.parse_args()
    if args.rows < 1 or args.cols < 1:
        ap.error("--rows and --cols must be >= 1")
    if args.num_times < 2:
        ap.error("--num-times must be >= 2")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("[babelstream] no CUDA device: the port measures the card "
              "(pass --device cpu to run the plain versions on the CPU)",
              file=sys.stderr)
        return 2
    res = run(args.rows, args.cols, DTYPES[args.dtype], args.num_times,
              args.device)
    print(report(res))
    return 0 if res.ok else 1


if __name__ == "__main__":
    sys.exit(main())
