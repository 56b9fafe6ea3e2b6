"""The per-layer metrics read from the port's own spans
(``work/program_spans.py`` and its readers in ``metrics/``), on the CPU
through the port's plain route.  A tiny rag cell, added by files alone,
prints the requests' p75s in a traced run; untraced runs print the
end-to-end metrics they printed before.  The readers of the host's waits
for the device give no number where the ticks ran on the CPU, which
waits for no device (the recorder counted no synchronizing calls there);
over the same spans marked as counted, as a device's ticks are, they
give the spans' arithmetic.  Without the port's recorder (a parent
checkout) every reader gives nothing and raises nothing."""
from __future__ import annotations

import importlib.util
import json
import statistics
import sys
import warnings

import pytest

import bench_tiny as tiny

tiny.paths()
import common  # noqa: E402

RAG = "granite-tiny.rag"
NEW = ("tick_wait_ms.chat", "tick_wait_ms.rag", "host_syncs.chat",
       "host_syncs.rag", "host_syncs.train", "decode_host_ms",
       "queue_wait_ms", "admit_to_first_ms")


def _write(path, obj):
    path.write_text(json.dumps(obj, indent=1) + "\n")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny checkout with a tiny rag cell added: its traffic, limits
    and entry, and the rag cell's metrics extended to it."""
    root = tiny.checkout(tmp_path_factory.mktemp("checkout"))
    bench = root / "bench"
    t = json.loads((tiny.BENCH / "traffic" / "rag.json").read_text())
    t.update(rate=60.0, backlog=4, pool=16, warm_ticks=2, trace_ticks=16,
             prompt={"dist": "uniform", "min": 16, "max": 40},
             output={"dist": "uniform", "min": 2, "max": 6},
             engine={"max_batch": 4, "page_size": 8,
                     "prefill_chunk_tokens": 16, "prefill_chunk": 4},
             check={"requests": 2})
    _write(bench / "traffic" / "rag-tiny.json", t)
    _write(bench / "limits" / f"{RAG}.json", tiny.LIMITS[tiny.CHAT])
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": RAG, "config": "granite-tiny",
                              "traffic": "rag-tiny", "chips": 1,
                              "why": "CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "granite-8b.rag" in m.get("workloads", ()):
            m["workloads"].append(RAG)
    _write(root / "BENCHMARK.json", spec)
    return root


@pytest.fixture
def recorder():
    from repro_torch import spans
    spans.clear()
    yield spans
    spans.clear()


def _reader(name):
    path = common.reader_file(name, tiny.BENCH)
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _line(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,e2e", [
    (tiny.CHAT, {"serve_out_tok_s", "setup_s"}),
    (tiny.TRAIN, {"train_tok_s", "setup_s"}),
    (RAG, {"ttft_p75_ms", "setup_s"}),
])
def test_untraced_runs_print_the_same_end_to_end_metrics(root, cell, e2e):
    rc, out, err = tiny.cli(root, "--workload", cell, "--seed",
                            str(2 ** 31 + 77), "--seconds", "1",
                            "--trace", "0")
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert line["correct"] is True and set(line["metrics"]) == e2e


def test_traced_rag_run_reads_the_request_spans(root):
    rc, out, err = tiny.cli(root, "--workload", RAG, "--seed", "5",
                            "--seconds", "1", "--trace", "1")
    assert rc == 0, err[-3000:]
    line = _line(out)
    assert line["correct"] is True
    got = line["metrics"]
    # beside what the cell printed before; the device's metrics and the
    # waits for it read nothing on the CPU
    assert set(got) == {"prefill_mfu", "ttft_p95_ms.rag", "queue_wait_ms",
                        "admit_to_first_ms"}
    assert got["queue_wait_ms"]["unit"] == "ms"
    assert all(m["value"] > 0 for m in got.values())


def test_readers_over_a_traced_chat_run(root, recorder):
    d = tiny.driver("serve")
    # (the run's correctness is the CLI tests' to check: in this process,
    # beside other test workers, its one-second window may finish fewer
    # requests than the sample asks)
    rec = d.run(tiny.ctx(root, tiny.CHAT, seed=3, trace=1))["record"]
    ticks = recorder.trees(recorder.take(), "engine.tick")
    assert len(ticks) == tiny.ctx(root, tiny.CHAT)["cell"]["traffic"][
        "trace_ticks"]
    for name in ("tick_wait_ms.chat", "decode_host_ms", "host_syncs.chat"):
        assert _reader(name)(rec) is None       # ticks on the CPU
    for tick, _ in ticks:                       # as a device's ticks
        tick.syncs = {}
    waits = [sum(k.ms for k in kids
                 if k.name in ("engine.upload", "engine.readback"))
             for _, kids in ticks]
    assert _reader("tick_wait_ms.chat")(rec) == pytest.approx(
        statistics.mean(waits))
    loops = [(loop, [k for k in kids if k.parent == loop.id])
             for _, kids in ticks for loop in kids
             if loop.name == "engine.decode_loop"]
    host = sum(loop.ms - sum(k.ms for k in below) for loop, below in loops)
    steps = sum(loop.attrs["num_steps"] for loop, _ in loops)
    assert steps > 0 and _reader("decode_host_ms")(rec) == pytest.approx(
        host / steps)
    assert _reader("host_syncs.chat")(rec) == 0      # counted, none


def test_host_syncs_reads_each_root_subtree(recorder, monkeypatch):
    monkeypatch.setattr(recorder._REC, "_counting", lambda: True)
    with recorder.recording():
        for n in (3, 1):
            with recorder.span("engine.tick"):
                with recorder.span("engine.plan"):
                    for _ in range(n):
                        warnings.warn(recorder.SYNC_WARNING)
                warnings.warn(recorder.SYNC_WARNING)
        with recorder.span("train.step"):
            warnings.warn(recorder.SYNC_WARNING)
    assert _reader("host_syncs.chat")({}) == pytest.approx((4 + 2 + 1) / 3)


def test_request_readers_take_the_nearest_rank_p75(recorder):
    """As ``ttft_p75_ms``, which the two phases split; a resumed
    request's time back in the queue is not a first wait."""
    with recorder.recording():
        for i, ms in enumerate((5.0, 1.0, 4.0, 2.0, 3.0)):
            recorder.record("request.queued", 10.0, 10.0 + ms / 1e3,
                            rid=i, resumed=False)
            recorder.record("request.prefill", 20.0, 20.0 + 10 * ms / 1e3,
                            rid=i)
        recorder.record("request.queued", 30.0, 39.0, rid=0, resumed=True)
    assert _reader("queue_wait_ms")({}) == pytest.approx(4.0, abs=1e-3)
    assert _reader("admit_to_first_ms")({}) == pytest.approx(40.0,
                                                             abs=1e-3)


def test_readers_give_nothing_without_the_recorder(recorder, monkeypatch):
    """A parent checkout's port has no ``repro_torch.spans``."""
    import repro_torch
    monkeypatch.setattr(recorder._REC, "_counting", lambda: True)
    with recorder.recording():              # spans that must go unread
        with recorder.span("engine.tick"):
            pass
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    with pytest.raises(ImportError):
        from repro_torch import spans  # noqa: F401
    for name in NEW:
        assert _reader(name)({}) is None
