"""Whole runs of the benchmark on the CPU, through the port's plain
route, with cells that a temporary checkout adds by new files alone: the
contract's result line, the traced run's per-layer metrics (a metric
added by its reader file among them), and the refusals."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

import bench_tiny as tiny

tiny.paths()
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("checkout"))


def _line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,e2e", [
    (tiny.CHAT, {"serve_out_tok_s", "setup_s"}),
    (tiny.TRAIN, {"train_tok_s", "setup_s"}),
])
def test_untraced_run_prints_the_contract_line(root, cell, e2e):
    rc, out, err = tiny.cli(root, "--workload", cell, "--seed",
                            str(2 ** 31 + 12345), "--seconds", "1",
                            "--trace", "0")
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == e2e
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["count"] == 1
    assert err.strip().splitlines()[-1].startswith("checks: ")


@pytest.mark.parametrize("cell,want", [
    (tiny.CHAT, {"tick_host_ms", "batch_occupancy", "serve_mfu",
                 "ttft_p95_ms.chat", "itl_p95_ms.chat", tiny.NEW_METRIC}),
    (tiny.TRAIN, {"train_mfu"}),
])
def test_traced_run_reads_the_per_layer_metrics(root, cell, want):
    rc, out, err = tiny.cli(root, "--workload", cell, "--seed", "7",
                            "--seconds", "1", "--trace", "1")
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert line["correct"] is True
    # device-trace metrics find no kernel on the CPU and are left out
    assert set(line["metrics"]) == want
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_work(root):
    """Two loops of one seed whose requests are all due at once send the
    same requests and serve the same tokens, tick for tick: the work is
    drawn from the seed alone.  (Requests due at a rate are sent by the
    wall clock, so which tick one joins can move by one between runs.)"""
    import common
    import loadgen
    from repro_torch.models.model import get_model
    d = tiny.driver("serve")
    c = tiny.ctx(root, tiny.CHAT)
    cfg = c["cell"]["config"]
    traffic = dict(c["cell"]["traffic"], rate=1e-6, backlog=6)
    arch = common.arch_config(cfg)
    runs = []
    for _ in range(2):
        model = get_model(arch)
        w = common.make_weights(model.schema(), 9, "cpu", arch.param_dtype)
        eng = d._engine(model, w, cfg, traffic, 9)
        loop = d.Load(eng, loadgen.RequestStream(
            traffic, cfg["vocab_size"], 9), traffic)
        for _ in range(8):
            if not eng.busy:           # every request served
                break
            loop.tick()
        runs.append(([(r["prompt"].tolist(), r["budget"])
                      for r in loop.req.values()], dict(eng.results)))
    assert runs[0] == runs[1] and runs[0][1]


def test_open_loop_at_a_fixed_rate(root):
    """An open loop sends at its rate whatever the engine does, and times
    each request from when it fell due."""
    d = tiny.driver("serve")
    c = tiny.ctx(root, tiny.CHAT, seconds=1.5)
    c["cell"]["traffic"].update(loop="open", rate=8.0, backlog=4)
    out = d.run(c)
    assert out["correct"] and out["attempted"] >= 10
    ttft = out["record"]["ttft_ms"]
    assert len(ttft) == out["attempted"] and min(ttft) > 0
    # an idle engine waits for the next arrival: every tick ran a request
    assert all(t["active"] >= 1 for t in out["ticks"])


def test_no_device_no_result():
    """Without a CUDA device the real command exits non-zero and prints
    nothing on standard output."""
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "granite-8b.chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tiny.ROOT, capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and bench/, the port
    is missing: non-zero, no result."""
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "bench")
    code = ("import sys; sys.path.insert(0, 'bench'); import run; "
            "sys.exit(run.main(['--workload', 'granite-8b.chat', "
            "'--seed', '1', '--seconds', '1'], device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_unknown_workload_is_refused(root):
    rc, out, err = tiny.cli(root, "--workload", "no-such.cell", "--seed",
                            "1", "--seconds", "1")
    assert rc != 0 and out == "" and "no workload" in err
