"""What every cell of the benchmark shares: the spec and a cell's files,
the port's configuration built from a configuration file, weights and
seeds made by the benchmark itself, the device's description, and the
result line.

The benchmark measures ``repro_torch``, the PyTorch and CUDA port, and
nothing else: no module here or under ``drivers/``, ``metrics/``,
``work/`` or ``reference/`` imports JAX or the JAX package ``repro``, and
``forbidden_modules`` names any that the process loaded all the same.
"""
from __future__ import annotations

import json
import math
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# loaded by nothing the benchmark runs; compared by whole top-level name,
# since the port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# configuration-file keys and the port's ArchConfig fields they set
PORT_FIELDS = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "head_dim": "d_head",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "qkv_bias": "qkv_bias",
    "torch_dtype": "dtype",
    "kv_dtype": "kv_dtype",
}


class CellError(RuntimeError):
    """A cell that the spec or its files do not define."""


def read_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Dict[str, Any]:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files: the
    spec, the workload entry, the configuration file, the traffic file
    (``bench/traffic/<traffic>.json``) and the limits of its correctness
    check (``bench/limits/<cell>.json``)."""
    spec = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json (cells: "
                        f"{', '.join(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if cell["config"] not in configs:
        raise CellError(f"workload {name!r} names configuration "
                        f"{cell['config']!r}, which BENCHMARK.json lacks")
    bench = root / "bench"
    return {"spec": spec, "cell": cell,
            "config": read_json(root / configs[cell["config"]]["file"]),
            "traffic": read_json(bench / "traffic" / f"{cell['traffic']}.json"),
            "limits": read_json(bench / "limits" / f"{name}.json")}


def cell_metrics(spec: Dict[str, Any], cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those without a ``workloads`` key, and those that list it."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]


def reader_file(name: str, bench: Path = BENCH) -> Path:
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    or, for a name with a suffix and no file of its own, the reader of
    its stem that the quantity's metrics share (``device_idle_pct.chat``
    and ``device_idle_pct.train`` read ``metrics/device_idle_pct.py``)."""
    own = bench / "metrics" / f"{name}.py"
    return own if own.exists() else \
        bench / "metrics" / f"{name.split('.')[0]}.py"


def arch_config(config: Dict[str, Any], overrides: Optional[dict] = None):
    """The port's ArchConfig for a configuration file: the registry's
    ``port_arch`` with every key of ``PORT_FIELDS`` that the file holds,
    then ``overrides`` (a traffic file's ``port`` entry, such as remat)."""
    import dataclasses

    from repro_torch import configs
    fields = {PORT_FIELDS[k]: v for k, v in config.items()
              if k in PORT_FIELDS}
    fields.update(overrides or {})
    return dataclasses.replace(configs.get(config["port_arch"]), **fields)


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed for one stream of a run (weights, traffic, the
    sample checked), from ``--seed``; any whole number is taken."""
    return (int(seed) * 1_000_003 + 7919 * stream) % (2 ** 63)


def make_weights(schema, seed: int, device, default_dtype):
    """Random weights for the port's parameter tree ``schema`` (leaves
    with ``shape``, ``init`` and ``dtype``), drawn by the benchmark from
    ``seed`` with a ``torch.Generator`` on ``device``, one call a leaf in
    the leaf's own dtype: fan-in normal (1/sqrt of the second-last dim),
    ``embed`` normal x 0.02, ``ones``, ``zeros``, and the SSM kinds.  The
    reference is given the same tensors, drawn again from the seed."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))

    def leaf(d):
        dt = d.dtype or default_dtype
        if d.init in ("zeros", "ssm_a_scalar"):
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        if d.init == "ssm_a":
            a = torch.log(torch.arange(1, d.shape[-1] + 1,
                                       dtype=torch.float32, device=device))
            return a.to(dt).expand(d.shape).contiguous()
        if d.init == "ssm_dt":
            lo, hi = math.log(1e-3), math.log(1e-1)
            u = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                           device=device)
            return torch.log(torch.expm1(torch.exp(lo + u * (hi - lo)))
                             + 1e-9).to(dt)
        if d.init == "embed":
            mult = 0.02
        elif d.init == "normal":
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            mult = 1.0 / math.sqrt(max(1, fan_in))
        else:
            raise NotImplementedError(f"init kind {d.init!r}")
        return torch.randn(d.shape, generator=gen, dtype=dt,
                           device=device).mul_(mult)

    def walk(tree):
        if hasattr(tree, "shape") and hasattr(tree, "init"):
            return leaf(tree)
        return {k: walk(tree[k]) for k in sorted(tree)}
    return walk(schema)


def forbidden_modules(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is JAX's, jaxlib's, flax's
    or the JAX package's, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device) -> Dict[str, Any]:
    """The result line's ``device``, its peak read now (``count`` is the
    cell's, set by ``run.py``)."""
    import torch
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "memory_peak_bytes": 0}


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def quantile(values: List[float], q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1) of ``values``."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def checks_line(checks: Dict[str, Dict[str, float]]) -> str:
    """``name value <= limit`` for every number compared."""
    return "; ".join(f"{k} {c['value']!r} <= {c['limit']!r}"
                     for k, c in checks.items())


def emit(result: Dict[str, Any], checks: Dict[str, Dict[str, float]]
         ) -> None:
    """The run's last lines: each number compared beside its limit on
    standard error, then the result as one JSON line on standard output,
    with the comparisons under ``checks``, its last key."""
    line = dict(result)
    line["checks"] = checks
    print("checks: " + checks_line(checks), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
