"""Tiny cells for the benchmark's CPU tests: a copy of ``bench/`` in a
temporary checkout, with configurations, traffic mixes, limits and a
per-layer metric added as new files and entries only, the way a later
change adds a cell."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SRC = ROOT / "src"
TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=2, intermediate_size=128, vocab_size=256,
            torch_dtype="float32")
CHAT, TRAIN = "granite-tiny.chat", "qwen2-tiny.train"
# the tiny cells' limits: the program reads ~1e-7 in f32 at this size
LIMITS = {CHAT: {"logit_gap": 1e-3},
          TRAIN: {"grad_gap": 1e-3, "change_gap": 1e-3, "grad_diff": 1e-3}}
NEW_METRIC = "ticks_in_window"


def paths() -> None:
    for p in (str(SRC), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def checkout(tmp: Path) -> Path:
    """A checkout at ``tmp`` holding BENCHMARK.json and bench/, with the
    tiny cells added by files and entries alone."""
    bench = tmp / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    g = json.loads((BENCH / "configs" / "granite-8b.json").read_text())
    g.update(TINY, max_position_embeddings=128)
    g.pop("kv_dtype")
    _write(bench / "configs" / "granite-tiny.json", g)
    q = json.loads((BENCH / "configs" / "qwen2-0.5b.json").read_text())
    q.update(TINY)
    _write(bench / "configs" / "qwen2-tiny.json", q)
    c = json.loads((BENCH / "traffic" / "chat.json").read_text())
    c.update(rate=20.0, backlog=4, pool=16, warm_ticks=2, trace_ticks=2,
             prompt={"dist": "uniform", "min": 8, "max": 40},
             output={"dist": "uniform", "min": 4, "max": 12},
             engine={"max_batch": 4, "page_size": 8,
                     "prefill_chunk_tokens": 16, "prefill_chunk": 4},
             check={"requests": 2})
    _write(bench / "traffic" / "chat-tiny.json", c)
    t = json.loads((BENCH / "traffic" / "train-4k.json").read_text())
    t.update(batch=4, seq_len=32)
    _write(bench / "traffic" / "train-tiny.json", t)
    for name, lim in LIMITS.items():
        _write(bench / "limits" / f"{name}.json", lim)
    (bench / "metrics" / f"{NEW_METRIC}.py").write_text(
        "def read(rec):\n"
        "    t = rec.get('tick_host_ms')\n"
        "    return float(len(t)) if t else None\n")
    spec["configs"] += [
        {"name": "granite-tiny", "source": "tiny", "reduced": [],
         "file": "bench/configs/granite-tiny.json", "why": "CPU test"},
        {"name": "qwen2-tiny", "source": "tiny", "reduced": [],
         "file": "bench/configs/qwen2-tiny.json", "why": "CPU test"}]
    spec["workloads"] += [
        {"name": CHAT, "config": "granite-tiny", "traffic": "chat-tiny",
         "chips": 1, "why": "CPU test"},
        {"name": TRAIN, "config": "qwen2-tiny", "traffic": "train-tiny",
         "chips": 1, "why": "CPU test"}]
    twin = {"granite-8b.chat": CHAT, "qwen2-0.5b.train-4k": TRAIN}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [twin[w] for w in list(m["workloads"])
                               if w in twin]
    spec["per_layer"].append(
        {"name": NEW_METRIC, "unit": "ticks", "better": "higher",
         "source": "program_counter", "layer": "engine", "moves":
         "serve_out_tok_s", "workloads": [CHAT]})
    _write(tmp / "BENCHMARK.json", spec)
    return tmp


def cli(root: Path, *args: str, timeout: float = 300):
    """``bench/run.py``'s main in a fresh process from ``root``, with its
    look for a chip skipped (the port's plain route on the CPU)."""
    code = ("import sys; sys.path.insert(0, 'bench'); import run; "
            f"sys.exit(run.main({list(args)!r}, device='cpu'))")
    # one thread a run: test workers side by side otherwise oversubscribe
    # the cores, and a tick can outlast the whole one-second window
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def ctx(root: Path, name: str, seed: int = 11, seconds: float = 1.0,
        trace: int = 0) -> dict:
    """A driver's context for a tiny cell, in this process."""
    paths()
    import common
    return {"cell": common.load_cell(name, root), "seed": seed,
            "seconds": seconds, "trace": trace, "device": "cpu",
            "peaks": common.read_json(BENCH / "work" / "peaks.json")}


def driver(kind: str):
    paths()
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"bench_driver_{kind}", BENCH / "drivers" / f"{kind}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
