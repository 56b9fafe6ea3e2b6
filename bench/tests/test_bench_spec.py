"""The benchmark's spec and files, read as data on the CPU: every cell
loads from its files alone, the spec keeps to its contract, and nothing
the benchmark runs imports JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import re

import pytest

import bench_tiny as tiny

tiny.paths()
import common  # noqa: E402

SPEC = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[k]}) == len(SPEC[k])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_from_its_files(cell):
    c = common.load_cell(cell)
    assert c["cell"]["chips"] == 1
    kind = c["traffic"]["driver"]
    assert (tiny.BENCH / "drivers" / f"{kind}.py").exists()
    arch = common.arch_config(c["config"], c["traffic"].get("port"))
    assert arch.n_layers == c["config"]["num_hidden_layers"]
    assert arch.d_model == c["config"]["hidden_size"]
    assert set(c["limits"]) and all(v > 0 for v in c["limits"].values())
    e2e = common.cell_metrics(SPEC, cell, "end_to_end")
    per = common.cell_metrics(SPEC, cell, "per_layer")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert per
    for m in per:           # each moves an end-to-end metric this cell has
        assert m["moves"] in {x["name"] for x in e2e}
        assert common.reader_file(m["name"]).exists()


def test_config_files_state_their_source():
    for c in SPEC["configs"]:
        f = json.loads((tiny.ROOT / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert c["file"].startswith("bench/configs/")


@pytest.mark.parametrize("names,bad", [
    (["repro_torch", "repro_torch.serve.engine", "reprox", "jaxtyping"], []),
    (["repro.models", "torch"], ["repro"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax", "jax", "jaxlib"]),
])
def test_forbidden_modules_by_whole_top_level_name(names, bad):
    assert common.forbidden_modules(names) == bad


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_no_source_imports_jax_or_the_jax_package():
    for py in tiny.BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(py)}
        assert not tops & set(common.FORBIDDEN), py
    for py in (tiny.BENCH / "reference").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(py)}
        assert "repro_torch" not in tops, py


def test_loadgen_gives_every_seed_the_same_sizes():
    """Every seed sends the mix's sizes in one fixed order; the seed draws
    the ids alone."""
    import loadgen
    t = json.loads((tiny.BENCH / "traffic" / "chat.json").read_text())
    a = loadgen.RequestStream(t, 1000, 3)
    b = loadgen.RequestStream(t, 1000, 2 ** 31 + 5)
    assert list(a.prompts) == list(b.prompts)
    assert list(a.outputs) == list(b.outputs)
    assert list(a.prompts) != sorted(a.prompts)
    assert a.prompts.min() >= 512 and a.prompts.max() <= 3328
    c = loadgen.RequestStream(t, 1000, 3)
    x, y, z = a.next(), c.next(), b.next()
    assert x[1] == y[1] == z[1] and (x[0] == y[0]).all()
    assert len(x[0]) == len(z[0]) and (x[0] != z[0]).any()
