"""The port's span recorder (``repro_torch.spans``) and the spans its
engine and trainer record, on the CPU through the plain route: nesting,
self time, off and on, the profiler's ranges, the engine tick's phases
and waits, the requests' way to their first token, the repaired ``host_ms_trace``, the
train step's spans, and synchronizing calls counted where they happen
(driven by a stand-in warning source, with the recorder told to count as
on CUDA, which the CPU lacks)."""
from __future__ import annotations

import dataclasses
import time
import warnings
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import configs, spans
from repro_torch.models.model import get_model
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.serve.engine import PagedEngine, ServeConfig
from repro_torch.train.train_step import make_train_step
from torch_one_thread import _one_thread  # noqa: F401  (autouse)

PHASES = ("engine.plan", "engine.prefill_lane", "engine.decode_loop",
          "engine.bookkeep")
WAITS = ("engine.upload", "engine.readback")
MODES = {"lane": {}, "no_lane": {"prefill_lane": False},
         "spec": {"spec_k": 2}}


@pytest.fixture(autouse=True)
def _empty():
    spans.clear()
    yield
    spans.clear()


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(configs.get("qwen2-0.5b").reduced(),
                              dtype="float32")
    m = get_model(cfg)
    return m, m.init(torch.Generator().manual_seed(0), device="cpu")


def _engine(model, **kw):
    m, p = model
    cfg = ServeConfig(**dict(dict(max_batch=2, max_seq=64, page_size=8,
                                  max_new_tokens=6, prefill_chunk=3), **kw))
    draft = dict(draft_model=m, draft_params=p) if cfg.spec_k else {}
    return PagedEngine(m, p, cfg, **draft)


def _serve(eng, lengths=(9, 20, 5), seed=0):
    rng = np.random.default_rng(seed)
    vocab = eng.model.cfg.vocab_size
    rids = [eng.submit(rng.integers(0, vocab, n), 6) for n in lengths]
    eng.run()
    return rids


def _sync_here():
    """A stand-in for a synchronizing CUDA call: the warning torch raises
    under sync debug mode "warn", from this line."""
    warnings.warn(spans.SYNC_WARNING + " (Triggered internally)",
                  UserWarning)
    return f":{_sync_here.__code__.co_firstlineno + 3}"


# -- the recorder ------------------------------------------------------------

def test_spans_nest_and_self_time_is_duration_less_children():
    with spans.recording():
        with spans.span("a", k=1) as a:
            time.sleep(0.002)
            with spans.span("b") as b:
                time.sleep(0.003)
                with spans.span("c"):
                    time.sleep(0.001)
            with spans.span("d") as d:
                time.sleep(0.002)
    rec = spans.take()
    assert [s.name for s in rec] == ["c", "b", "d", "a"]
    by = {s.name: s for s in rec}
    assert by["a"].parent is None and by["a"].root == a.id
    assert by["b"].parent == a.id and by["d"].parent == a.id
    assert by["c"].parent == b.id and by["c"].root == a.id
    assert by["a"].attrs == {"k": 1}
    own = spans.self_ns(rec)
    assert own[a.id] == (a.end - a.start) - (b.end - b.start) \
        - (d.end - d.start)
    assert own[b.id] == (b.end - b.start) - (by["c"].end - by["c"].start)
    assert own[by["c"].id] == by["c"].end - by["c"].start
    assert by["a"].start <= by["b"].start <= by["c"].start \
        <= by["c"].end <= by["b"].end <= by["a"].end
    assert by["a"].syncs is None          # counted only where CUDA is


def test_discard_drops_a_root_and_its_descendants():
    with spans.recording():
        with spans.span("kept"):
            pass
        with spans.span("dropped") as r:
            with spans.span("child"):
                pass
            spans.record("request.queued", 1.0, 2.0, rid=3)
            spans.discard(r)
    assert sorted(s.name for s in spans.take()) == ["kept",
                                                    "request.queued"]


def test_off_an_engine_run_records_nothing(model):
    assert not spans.on()
    assert spans.span("engine.tick", tick=1) is spans.NULL
    with spans.span("x") as sp:
        assert sp is None
    eng = _engine(model)
    _serve(eng)
    assert eng.steps_run > 0 and spans.take() == []
    # the lifecycle times are kept whether or not spans are recorded
    for req in eng._reqs.values():
        assert req.t_queued <= req.t_admit <= req.t_first


def test_under_a_profiler_spans_are_ranges_of_the_same_name(model):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):   # warm the ranges
        with spans.span("warm"):
            pass
    spans.clear()
    eng = _engine(model)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.on()
        _serve(eng)
    assert not spans.on()
    rec = [s for s in spans.take() if not s.name.startswith("request.")]
    assert {s.name for s in rec} >= {"engine.tick", *PHASES, *WAITS}
    events = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        events.setdefault(e.name, []).append(e)
    mine = {}
    for s in sorted(rec, key=lambda s: s.start):
        mine.setdefault(s.name, []).append(s)
    for name, ours in mine.items():
        theirs = events.get(name, [])
        assert len(theirs) == len(ours), name
        for s, e in zip(ours, theirs):
            ms = e.time_range.elapsed_us() / 1e3
            assert abs(ms - s.ms) <= max(0.5, 0.1 * s.ms), (name, ms, s.ms)


# -- the engine --------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_engine_ticks_have_their_phases_and_waits(model, mode):
    eng = _engine(model, **MODES[mode])
    with spans.recording():
        _serve(eng)
    rec = spans.take()
    ticks = spans.trees(rec, "engine.tick")
    assert len(ticks) == eng.steps_run > 0
    ids = {s.id: s for s in rec}
    seen = Counter()
    for tick, kids in ticks:
        assert set(tick.attrs) == {"tick"}
        phases = [k for k in kids if k.parent == tick.id]
        names = [k.name for k in sorted(phases, key=lambda k: k.start)]
        assert names[0] == "engine.plan" and names[-1] == "engine.bookkeep"
        assert names == [p for p in PHASES if p in names]
        seen.update(names)
        for k in kids:
            if k.name in WAITS:
                assert ids[k.parent].name in PHASES
            if k.name == "engine.readback" \
                    and ids[k.parent].name == "engine.bookkeep":
                seen["tick readback"] += 1
            if k.name == "engine.prefill_lane":
                assert k.attrs["tokens"] > 0
            if k.name == "engine.decode_loop":
                assert k.attrs["num_steps"] >= 1
    assert seen["engine.decode_loop"] > 0
    assert seen["tick readback"] == len(ticks)
    assert (seen["engine.prefill_lane"] > 0) == (mode != "no_lane")


def test_request_spans_tile_submit_to_first_token(model):
    eng = _engine(model)
    with spans.recording():
        rids = _serve(eng, lengths=(9, 20, 5, 14))
    rec = spans.take()
    by = {}
    for s in rec:
        if s.name.startswith("request."):
            by.setdefault((s.name, s.attrs["rid"]), []).append(s)
    for rid in rids:
        req = eng._reqs[rid]
        (q,), (p,) = (by[(n, rid)] for n in (
            "request.queued", "request.prefill"))
        assert q.attrs["resumed"] is False
        assert q.attrs["prompt"] == req.prompt.size
        assert q.start == int(req.t_queued * 1e9)
        assert q.end == p.start == int(req.t_admit * 1e9)
        assert p.end == int(req.t_first * 1e9)
        assert q.ms + p.ms == pytest.approx(
            (req.t_first - req.t_queued) * 1e3, abs=1e-5)
        assert len(eng.results[rid]) == 6


def test_a_resumed_request_records_another_queued_span(model):
    eng = _engine(model, max_batch=2)
    with spans.recording():
        rng = np.random.default_rng(1)
        rid = eng.submit(rng.integers(0, 100, 12), 6)
        eng.step()
        eng.step()
        eng._preempt(0)
        eng.run()
    queued = [s for s in spans.take() if s.name == "request.queued"
              and s.attrs["rid"] == rid]
    assert [s.attrs["resumed"] for s in queued] == [False, True]
    assert queued[0].end <= queued[1].start


@pytest.mark.parametrize("mode", MODES)
def test_host_ms_trace_plus_waits_is_the_tick_wall_time(model, mode):
    eng = _engine(model, **MODES[mode])
    with spans.recording():
        _serve(eng)
    ticks = spans.trees(spans.take(), "engine.tick")
    assert len(ticks) == len(eng.host_ms_trace) == len(eng.wait_ms_trace)
    for (tick, kids), host, wait in zip(ticks, eng.host_ms_trace,
                                        eng.wait_ms_trace):
        waits = sum(k.ms for k in kids if k.name in WAITS)
        assert waits > 0 and abs(wait - waits) < 1.0
        assert abs(host + waits - tick.ms) < 1.0
        assert host > 0


# -- training ----------------------------------------------------------------

def test_train_step_spans(model):
    m, p = model
    opt = AdamW(AdamWConfig(lr=1e-3))
    step = make_train_step(m, opt, microbatches=2)
    toks = torch.randint(0, m.cfg.vocab_size, (4, 65),
                         generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    state = opt.init(p)
    with spans.recording():
        step(p, state, batch)
    rec = spans.take()
    (root, kids), = spans.trees(rec, "train.step")
    ids = {s.id: s for s in rec}
    below = Counter((ids[k.parent].name, k.name) for k in kids)
    assert below[("train.step", "train.microbatch")] == 2
    assert below[("train.microbatch", "train.forward")] == 2
    assert below[("train.microbatch", "train.backward")] == 2
    assert below[("train.step", "train.optimizer")] == 1
    assert sorted(k.attrs["i"] for k in kids
                  if k.name == "train.microbatch") == [0, 1]
    flash = [k for k in kids if k.name == "flash.backward"]
    assert flash and below[("train.backward", "flash.backward")] \
        == len(flash)
    assert all(k.attrs == {"S": 64, "T": 64} for k in flash)


# -- synchronizing calls -----------------------------------------------------

def test_syncs_land_on_the_innermost_span_with_their_line(monkeypatch):
    monkeypatch.setattr(spans._REC, "_counting", lambda: True)
    before = (warnings.filters[:], warnings.showwarning)
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with spans.recording():
            with spans.span("engine.tick") as tick:
                with spans.span("engine.plan") as plan:
                    site = _sync_here()
                    _sync_here()
                    warnings.warn("another warning")
                with spans.span("engine.bookkeep") as keep:
                    pass
                _sync_here()
            with spans.span("later"):
                pass
    assert [str(w.message) for w in shown] == ["another warning"]
    (key,) = plan.syncs
    assert key.endswith("test_torch_spans.py" + site)
    assert plan.syncs == {key: 2} and keep.syncs == {}
    assert tick.syncs == {key: 1} and tick.n_syncs == 1
    assert (warnings.filters[:], warnings.showwarning) == before
    # the counting ends with the root: later roots count afresh
    assert spans.take()[-1].syncs == {}


def test_sync_counting_is_restored_when_a_root_raises(monkeypatch):
    monkeypatch.setattr(spans._REC, "_counting", lambda: True)
    before = (warnings.filters[:], warnings.showwarning)
    with spans.recording():
        with pytest.raises(ValueError):
            with spans.span("train.step"):
                raise ValueError("boom")
    assert (warnings.filters[:], warnings.showwarning) == before
    (s,) = spans.take()
    assert s.attrs == {"error": "ValueError"} and s.syncs == {}
