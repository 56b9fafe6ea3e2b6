"""Overload handling in the port's paged engine against the JAX engine's,
on the CPU: preempt-and-recompute, deadlines, ``cancel``, a bounded queue,
seeded fault plans (squeeze, evict, drop, poison), the output guard, the
wedge detector, the per-tick host traces, and int8 pools in the engine.

The two engines run in lockstep from the same weights (bridged bit-exact
from the JAX tree: the reduced qwen2-0.5b in f32) with the same
submissions, cancels and fault plan, at the sizes of
tests/test_overload_props.py (page 4, ``max_seq`` 8-48, pools smaller
than every slot's full table).  After every tick the port must equal the
JAX engine in its grant plans (after the dropped-grant rewrite), its page
pool (tables, lengths, refcounts, free list, seized set, retained
entries), its slots, its queue order, every request's status and result,
and its overload counters; ``kv.check()``, the prefix index's check and
history == length hold on both (tests/test_paged_cache_props.py's
``_check_tick``), and a drained engine gives its whole pool back
(``_assert_drained_clean``).  Where the JAX engine raises, the port
raises the same message.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.serve import faults as jfaults
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.scheduler import TickScheduler as JTickScheduler
from repro_torch import configs as tconfigs
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.params import params_from_jax
from repro_torch.serve import faults as tfaults
from repro_torch.serve.engine import TERMINAL_STATUSES, RequestStatus
from repro_torch.serve.engine import PagedEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.scheduler import PREEMPT_POLICIES
from repro_torch.serve.scheduler import TickScheduler as TTickScheduler

from test_paged_cache_props import _assert_drained_clean, _check_tick
from torch_one_thread import _one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
BUDGETS = (3, 5)
PROMPT_LENS = (3, 5, 8)
OVERSOLD = dict(max_batch=3, max_seq=48, page_size=4, num_pages=8,
                prefill_chunk=3, max_new_tokens=max(BUDGETS))
COUNTERS = ("ticks", "steps_run", "joins", "rejected", "preemptions",
            "recompute_tokens", "cancelled", "deadline_exceeded",
            "quarantines", "dropped_grants", "fault_counts", "stalls",
            "tokens_out", "shared_tokens", "tokens_appended",
            "no_progress_ticks", "_idle", "_quarantined", "_squeezed",
            "reject_reason", "results", "util_trace", "occupancy_trace",
            "dispatch_trace", "prefill_upload_bytes")
KV_FIELDS = ("table", "length", "refcount", "retained_refs")
KV_COUNTERS = ("cow_copies", "cow_bytes", "page_bytes", "cow_dispatches",
               "shared_pages", "retained_hits", "retained_hit_tokens",
               "retained_dropped", "retained_reclaimed_pages", "owned",
               "free", "seized", "allocatable", "live_pages")
SLOT_FIELDS = ("rid", "forced", "out", "history", "budget", "served",
               "prompt_left", "active")
_MODELS = {}


def _models(kv_dtype="bf16"):
    if kv_dtype not in _MODELS:
        jcfg = dataclasses.replace(jconfigs.get("qwen2-0.5b").reduced(),
                                   dtype="float32", kv_dtype=kv_dtype)
        tcfg = dataclasses.replace(tconfigs.get("qwen2-0.5b").reduced(),
                                   dtype="float32", kv_dtype=kv_dtype)
        jm = jget_model(jcfg)
        jp = jm.init(jax.random.key(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _MODELS[kv_dtype] = (jm, jp, tget_model(tcfg), tp)
    return _MODELS[kv_dtype]


def _engines(kv_dtype="bf16", models=None, **serve):
    """A JAX and a port engine on the same weights (``models``: another
    arch's (jm, jp, tm, tp); by default ``_models(kv_dtype)``) and
    ServeConfig.  Each records its plans (the objects: the dropped-grant
    fault rewrites them after planning) and the port the rows of each
    dirty-row sync."""
    jm, jp, tm, tp = models or _models(kv_dtype)
    je = JPagedEngine(jm, jp, JServeConfig(**serve))
    te = TPagedEngine(tm, tp, TServeConfig(**serve))
    for e in (je, te):
        e.plans = []
        plan = e.scheduler.plan

        def recording(*args, _plan=plan, _e=e, **kwargs):
            p = _plan(*args, **kwargs)
            _e.plans.append(p)
            return p

        e.scheduler.plan = recording
    te.synced_rows = []
    sync = te._sync_dirty

    def recording_sync(kv, *mirrors):
        te.synced_rows.append(len(kv.dirty))
        return sync(kv, *mirrors)

    te._sync_dirty = recording_sync
    return je, te


def _plans(e):
    return [(p.steps.tolist(), p.prefill.tolist(), p.stalled, p.cow_copies,
             p.reclaimed) for p in e.plans]


def _jax_padded_upload(te):
    """The port's upload trace with each row sync padded to a power of two
    rows, as the JAX engine pads (and counts) its row batches."""
    row = (te.kv.max_blocks + 1) * 4
    return [u + ((1 << (n - 1).bit_length()) - n) * row if n else u
            for u, n in zip(te.upload_trace, te.synced_rows)]


def _same_state(je, te):
    """The port's engine state equals the JAX engine's."""
    jkv, tkv = je.kv, te.kv
    for name in KV_FIELDS:
        np.testing.assert_array_equal(getattr(tkv, name),
                                      np.asarray(getattr(jkv, name)), name)
    for name in KV_COUNTERS:
        assert getattr(tkv, name) == getattr(jkv, name), name
    assert [(e.tokens, e.pages, e.keys, e.stamp, e.hits)
            for e in tkv.retained] == \
        [(e.tokens, e.pages, e.keys, e.stamp, e.hits) for e in jkv.retained]
    assert [[getattr(s, f) for f in SLOT_FIELDS] for s in te.slots] == \
        [[getattr(s, f) for f in SLOT_FIELDS] for s in je.slots]
    np.testing.assert_array_equal(te._feed, je._feed)
    assert [r.rid for r in te.queue] == [r.rid for r in je.queue]
    assert {r: s.value for r, s in te.status.items()} == \
        {r: s.value for r, s in je.status.items()}
    assert {r: (q.emitted, q.preempts, q.deadline_tick)
            for r, q in te._reqs.items()} == \
        {r: (q.emitted, q.preempts, q.deadline_tick)
         for r, q in je._reqs.items()}
    for name in COUNTERS:
        assert getattr(te, name) == getattr(je, name), name
    assert _plans(te) == _plans(je)
    assert len(te.host_ms_trace) == len(je.host_ms_trace) == te.steps_run
    assert _jax_padded_upload(te) == je.upload_trace
    assert te.table_upload_bytes <= je.table_upload_bytes


def _step_both(je, te):
    """One tick of each engine and the comparison; returns the error both
    raised (type name, message), or None."""
    errs = []
    for e in (je, te):
        try:
            e.step()
            errs.append(None)
        except RuntimeError as exc:
            errs.append((type(exc).__name__, str(exc)))
    assert errs[0] == errs[1]
    if errs[0] is None:
        for e in (je, te):
            _check_tick(e)
    _same_state(je, te)
    return errs[0]


def _submit_both(je, te, prompt, budget=None, **kw):
    rid = je.submit(prompt, budget, **kw)
    assert te.submit(prompt, budget, **kw) == rid
    return rid


def _cancel_both(je, te, rid):
    ok = je.cancel(rid)
    assert te.cancel(rid) == ok
    return ok


def _drain_both(je, te, max_ticks=600):
    """Step both to the end, riding out squeezed pages as the JAX
    harness's ``_drain`` does."""
    t = 0
    while je.busy or te.busy or je._squeezed or te._squeezed:
        assert (je.busy, len(je._squeezed)) == (te.busy, len(te._squeezed))
        assert _step_both(je, te) is None
        t += 1
        assert t < max_ticks, "engines failed to terminate"


def _finish(je, te):
    """Drain, then: every rid terminal, the pools given back whole."""
    _drain_both(je, te)
    assert all(s in TERMINAL_STATUSES for s in te.status.values())
    assert not te.kv.seized
    for e in (je, te):
        _assert_drained_clean(e)
    _same_state(je, te)


def _rand(rng, n, vocab=256):
    return rng.randint(0, vocab, size=n).astype(np.int32)


def _uninterrupted(prompts_budgets):
    """Tokens of the port engine with a full pool and no faults."""
    _, _, tm, tp = _models()
    te = TPagedEngine(tm, tp, TServeConfig(max_batch=1, max_seq=64,
                                           page_size=4))
    rids = [te.submit(p, b) for p, b in prompts_budgets]
    te.run()
    return [te.results[r] for r in rids]


# ---------------------------------------------------------------------------
# capacity preemption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", PREEMPT_POLICIES)
def test_capacity_preemption_matches_jax(policy):
    """Six requests of up to 16 tokens over a pool of seven pages (three
    slots at four pages each would need twelve): the engines preempt
    victims under ``policy`` tick for tick, and the resumed requests give
    the tokens of an uninterrupted run."""
    je, te = _engines(preempt_policy=policy, **OVERSOLD)
    rng = np.random.RandomState(3)
    work = [(_rand(rng, n), 8) for n in (8, 5, 8, 3, 8, 5)]
    rids = [_submit_both(je, te, p, b) for p, b in work]
    _finish(je, te)
    assert te.scheduler.preempt_policy == policy
    assert te.preemptions > 0 and te.recompute_tokens > 0
    assert RequestStatus.PREEMPTED_RESUMED in {te.status[r] for r in rids}
    assert [te.results[r] for r in rids] == _uninterrupted(work)


def test_formerly_crashing_schedule_matches_jax():
    """test_overload_props.py's schedule: two requests that each fit the
    three-page pool alone but jointly wedge it."""
    je, te = _engines(max_batch=2, max_seq=8, page_size=4, num_pages=3,
                      prefill_chunk=2, max_new_tokens=4)
    rng = np.random.RandomState(0)
    work = [(_rand(rng, 3), 4), (_rand(rng, 3), 4)]
    for p, b in work:
        _submit_both(je, te, p, b)
    _finish(je, te)
    assert te.preemptions >= 1 and te.recompute_tokens > 0
    assert RequestStatus.PREEMPTED_RESUMED in set(te.status.values())
    assert [te.results[r] for r in (0, 1)] == _uninterrupted(work)


def test_no_preempt_raises_the_jax_error():
    """``preempt=False`` on a pool that cannot give any slot capacity
    raises the JAX engine's 'page pool exhausted' message."""
    je, te = _engines(max_batch=2, max_seq=8, page_size=4, num_pages=3,
                      prefill_chunk=2, max_new_tokens=4, preempt=False)
    rng = np.random.RandomState(0)
    for _ in range(2):
        _submit_both(je, te, _rand(rng, 3), 4)
    err = None
    for _ in range(20):
        err = _step_both(je, te)
        if err:
            break
    assert err is not None and "page pool exhausted" in err[1]


# ---------------------------------------------------------------------------
# the request lifecycle: deadlines, cancel, max_queue
# ---------------------------------------------------------------------------

def test_deadlines_queued_and_running_match_jax():
    """A running request overruns its deadline with partial output (an
    uninterrupted run's prefix); a queued one expires without running."""
    je, te = _engines(max_batch=1, max_seq=32, page_size=4, prefill_chunk=1,
                      max_new_tokens=8)
    rng = np.random.RandomState(2)
    p = _rand(rng, 3)
    a = _submit_both(je, te, p, 8, deadline_ticks=5)
    b = _submit_both(je, te, _rand(rng, 3), 6, deadline_ticks=1)
    _finish(je, te)
    assert te.status[a] is RequestStatus.DEADLINE_EXCEEDED
    assert te.status[b] is RequestStatus.DEADLINE_EXCEEDED
    assert te.deadline_exceeded == 2 and te.results[b] == []
    got = te.results[a]
    assert 0 < len(got) < 8
    assert got == _uninterrupted([(p, 8)])[0][:len(got)]


def test_default_deadline_from_config_matches_jax():
    """``ServeConfig.deadline_ticks`` is every request's default."""
    je, te = _engines(max_batch=2, max_seq=32, page_size=4, prefill_chunk=2,
                      max_new_tokens=5, deadline_ticks=3)
    rng = np.random.RandomState(12)
    rids = [_submit_both(je, te, _rand(rng, n), 5) for n in (3, 8, 5)]
    _finish(je, te)
    assert te._reqs[rids[0]].deadline_tick == 3
    assert te.deadline_exceeded > 0


def test_cancel_queued_and_running_matches_jax():
    je, te = _engines(max_batch=1, max_seq=32, page_size=4, prefill_chunk=1,
                      max_new_tokens=6)
    rng = np.random.RandomState(4)
    a, b, c = (_submit_both(je, te, _rand(rng, 5), 6) for _ in range(3))
    for _ in range(3):
        _step_both(je, te)
    assert te.status[a] is RequestStatus.RUNNING
    assert _cancel_both(je, te, a)               # running: frees the slot
    assert _cancel_both(je, te, b)               # queued
    assert not _cancel_both(je, te, b)           # already terminal
    assert not _cancel_both(je, te, 999)         # unknown rid
    _same_state(je, te)
    _finish(je, te)
    assert te.status[a] is te.status[b] is RequestStatus.CANCELLED
    assert te.status[c] is RequestStatus.FINISHED
    assert te.cancelled == 2 and te.results[b] == [] and te.results[a]


def test_cancel_races_preemption_same_tick_matches_jax():
    """test_overload_props.py's race: an evict requeues the victim (maybe
    re-admitting it in the same tick) and a cancel lands before the next
    tick; one terminal transition, CANCELLED, no token counted twice."""
    je, te = _engines(max_batch=2, max_seq=48, page_size=4, num_pages=8,
                      prefill_chunk=3, max_new_tokens=5)
    rng = np.random.RandomState(11)
    work = [(_rand(rng, n), 5) for n in (8, 5)]
    rids = [_submit_both(je, te, p, b) for p, b in work]
    for e, mod in ((je, jfaults), (te, tfaults)):
        e.install_faults(mod.FaultPlan([mod.FaultEvent(2, "evict", slot=0)]))
    raced = False
    for _ in range(200):
        if not (je.busy or te.busy):
            break
        pre = te.preemptions
        assert _step_both(je, te) is None
        if not raced and te.preemptions > pre:
            assert te.status[rids[0]] not in TERMINAL_STATUSES
            assert _cancel_both(je, te, rids[0])
            assert not _cancel_both(je, te, rids[0])
            raced = True
            _same_state(je, te)
    assert raced
    _finish(je, te)
    assert te.status[rids[0]] is RequestStatus.CANCELLED and te.cancelled == 1
    want = _uninterrupted(work)
    got = te.results[rids[0]]
    assert len(got) < len(want[0]) and got == want[0][:len(got)]
    assert te.results[rids[1]] == want[1]


def test_max_queue_rejects_matches_jax():
    je, te = _engines(max_batch=1, max_seq=32, page_size=4,
                      max_new_tokens=4, max_queue=2)
    p = np.arange(1, 4, dtype=np.int32)
    rids = [_submit_both(je, te, p, 4) for _ in range(4)]
    assert [te.status[r] for r in rids] == [RequestStatus.QUEUED] * 2 \
        + [RequestStatus.REJECTED] * 2
    assert "queue full" in te.reject_reason[rids[2]]
    _same_state(je, te)
    _finish(je, te)
    assert te.rejected == 2


def test_pool_too_small_rejects_matches_jax():
    """A request that needs more pages than the pool holds is rejected at
    submit, with the JAX engine's reason."""
    je, te = _engines(max_batch=2, max_seq=48, page_size=4, num_pages=4,
                      max_new_tokens=5)
    rid = _submit_both(je, te, _rand(np.random.RandomState(1), 9), 5)
    assert te.status[rid] is RequestStatus.REJECTED
    assert "allocatable pages" in te.reject_reason[rid]
    _same_state(je, te)


# ---------------------------------------------------------------------------
# the four recoverable faults, the kill, the wedge detector
# ---------------------------------------------------------------------------

def _with_plan(events, serve, work):
    je, te = _engines(**serve)
    for e, mod in ((je, jfaults), (te, tfaults)):
        e.install_faults(mod.FaultPlan([mod.FaultEvent(*a, **k)
                                        for a, k in events]))
    rids = [_submit_both(je, te, p, b) for p, b in work]
    _finish(je, te)
    return te, rids


def test_squeeze_matches_jax():
    """Two squeezes seize most of the free list: idle ticks or
    preemptions, the seized set in every check, released on schedule."""
    rng = np.random.RandomState(6)
    work = [(_rand(rng, 5), 5) for _ in range(3)]
    te, rids = _with_plan(
        [((2, "squeeze"), dict(pages=4, duration=5)),
         ((4, "squeeze"), dict(pages=2, duration=3))],
        dict(max_batch=2, max_seq=24, page_size=4, num_pages=7,
             prefill_chunk=2, max_new_tokens=5), work)
    assert te.fault_counts == {"squeeze": 2}
    assert [te.results[r] for r in rids] == _uninterrupted(work)


def test_evict_matches_jax():
    rng = np.random.RandomState(1)
    work = [(_rand(rng, 5), 5)]
    te, rids = _with_plan(
        [((3, "evict"), dict(slot=0)), ((6, "evict"), dict(slot=0))],
        dict(max_batch=2, max_seq=32, page_size=4, prefill_chunk=2,
             max_new_tokens=5), work)
    assert te.status[rids[0]] is RequestStatus.PREEMPTED_RESUMED
    assert te.preemptions >= 1
    assert te.results[rids[0]] == _uninterrupted(work)[0]


def test_drop_matches_jax():
    rng = np.random.RandomState(7)
    work = [(_rand(rng, 5), 5)]
    te, rids = _with_plan(
        [((1, "drop"), dict(slot=-1)), ((3, "drop"), dict(slot=0))],
        dict(max_batch=1, max_seq=32, page_size=4, prefill_chunk=2,
             max_new_tokens=5), work)
    assert te.dropped_grants > 0
    assert te.status[rids[0]] is RequestStatus.FINISHED
    assert te.results[rids[0]] == _uninterrupted(work)[0]


@pytest.mark.parametrize("tick", [1, 2])
def test_poison_matches_jax(tick):
    """Poison on the tick whose prefill chunk drains the prompt (1) and on
    a decode tick (2): the guard quarantines the slot, no garbage reaches
    the results, and the request resumes to the uninterrupted tokens."""
    rng = np.random.RandomState(5)
    work = [(_rand(rng, 3), 5), (_rand(rng, 6), 4)]
    te, rids = _with_plan(
        [((tick, "poison"), dict(slot=0))],
        dict(max_batch=2, max_seq=32, page_size=4, prefill_chunk=2,
             max_new_tokens=5, quarantine_ticks=2), work)
    assert te.quarantines == 1
    assert te.status[rids[0]] is RequestStatus.PREEMPTED_RESUMED
    assert [te.results[r] for r in rids] == _uninterrupted(work)


def test_kill_raises_before_the_tick():
    """A kill raises ``EngineKilled`` at the top of its tick in both
    engines, before any state moves; the port's plan drops it with
    ``without_kills_through`` as the JAX plan does."""
    je, te = _engines(max_batch=2, max_seq=32, page_size=4, max_new_tokens=4)
    events = [(2, "kill"), (4, "drop")]
    plans = [mod.FaultPlan([mod.FaultEvent(*a) for a in events])
             for mod in (jfaults, tfaults)]
    for e, plan in zip((je, te), plans):
        e.install_faults(plan)
    _submit_both(je, te, _rand(np.random.RandomState(9), 5), 4)
    _step_both(je, te)
    before = [s.history[:] for s in te.slots]
    with pytest.raises(tfaults.EngineKilled) as exc:
        te.step()
    with pytest.raises(jfaults.EngineKilled):
        je.step()
    assert exc.value.tick == 2 and te.fault_counts == {"kill": 1}
    assert [s.history for s in te.slots] == before
    kept = [plan.without_kills_through(2) for plan in plans]
    assert [dataclasses.astuple(ev) for ev in kept[1].events] == \
        [dataclasses.astuple(ev) for ev in kept[0].events] == [(4, "drop",
                                                                -1, 0, 1)]
    assert kept[1].last_tick == 4 and len(kept[1]) == 1


def test_wedge_detector_raises_the_jax_error():
    """A lone slot starved by a long squeeze idles; past ``wedge_ticks``
    idle ticks both engines raise 'engine wedged'."""
    je, te = _engines(max_batch=1, max_seq=32, page_size=4, num_pages=4,
                      prefill_chunk=2, max_new_tokens=8, wedge_ticks=2)
    for e, mod in ((je, jfaults), (te, tfaults)):
        e.install_faults(mod.FaultPlan(
            [mod.FaultEvent(2, "squeeze", pages=3, duration=8)]))
    _submit_both(je, te, _rand(np.random.RandomState(3), 3), 8)
    err = None
    for _ in range(10):
        err = _step_both(je, te)
        if err:
            break
    assert err is not None and "engine wedged" in err[1]
    assert te.no_progress_ticks == 3


# ---------------------------------------------------------------------------
# the oversubscription fuzz (test_overload_props.py's, seeds 0-3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,fault_ticks",
                         [(0, 0), (1, 0), (2, 25), (3, 25), (4, 10), (28, 10)])
def test_oversubscription_fuzz_matches_jax(seed, fault_ticks):
    """test_overload_props.py's schedule: 10 requests of up to 13 tokens
    over 7 pages, in bursts, 30% with tight deadlines, ~15% cancelled,
    under ``FaultPlan.random(seed)`` over ticks [1, fault_ticks] (0: no
    faults; 25 is the JAX harness's, 10 lands more events inside the
    schedule's ~12 ticks; seed 28's plan fires all four kinds, and
    chip_smoke.py runs it on the card); both engines in lockstep, every
    completed request as an uninterrupted run, every partial one its
    prefix."""
    je, te = _engines(**OVERSOLD)
    rng = np.random.RandomState(seed)
    if fault_ticks:
        plans = [mod.FaultPlan.random(seed, n_events=5,
                                      max_tick=fault_ticks, max_batch=3,
                                      max_pages=3, max_duration=4)
                 for mod in (jfaults, tfaults)]
        assert [dataclasses.astuple(e) for e in plans[1].events] == \
            [dataclasses.astuple(e) for e in plans[0].events]
        je.install_faults(plans[0])
        te.install_faults(plans[1])
    submitted = {}
    pending = [(_rand(rng, rng.choice(PROMPT_LENS)),
                int(rng.choice(BUDGETS)),
                int(rng.randint(4, 25)) if rng.rand() < 0.3 else 0)
               for _ in range(10)]
    ticks = 0
    while pending or je.busy:
        if pending and (ticks % 5 == 0 or not je.busy):
            for _ in range(min(len(pending), rng.randint(2, 5))):
                p, b, dl = pending.pop()
                submitted[_submit_both(je, te, p, b, deadline_ticks=dl)] = \
                    (p, b)
        if rng.rand() < 0.15 and submitted:
            _cancel_both(je, te, int(rng.choice(sorted(submitted))))
        if je.busy:
            assert _step_both(je, te) is None
        ticks += 1
        assert ticks < 1500
    _finish(je, te)
    if fault_ticks:
        assert te.fault_counts, "no fault fired"
    else:
        assert te.preemptions + te.deadline_exceeded + te.cancelled > 0
    want = _uninterrupted([submitted[r] for r in sorted(submitted)])
    for rid, w in zip(sorted(submitted), want):
        got, st = te.results[rid], te.status[rid]
        if st in (RequestStatus.FINISHED, RequestStatus.PREEMPTED_RESUMED):
            assert got == w, (rid, st)
        else:
            assert got == w[:len(got)], (rid, st)


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def test_pick_victim_matches_jax():
    """Both policies on hand-built slots, with and without ``generated``
    and ``exclude``, against the JAX scheduler."""
    class S:
        def __init__(self, active, out):
            self.active, self.out = active, out

    class KV:
        owned = [[1, 2, 3], [4], [5, 6], [], [7, 8]]

    slots = [S(True, [0, 0]), S(True, [0]), S(True, [0]), S(False, []),
             S(True, [0, 0, 0])]
    cases = [dict(), dict(exclude=(1, 2)), dict(generated={0: 9, 4: 0}),
             dict(generated={1: 5}, exclude=(2,))]
    for policy in PREEMPT_POLICIES:
        tsch = TTickScheduler(preempt_policy=policy)
        jsch = JTickScheduler(preempt_policy=policy)
        got = [tsch.pick_victim(slots, KV(), **c) for c in cases]
        assert got == [jsch.pick_victim(slots, KV(), **c) for c in cases]
    assert TTickScheduler().pick_victim(slots, KV()) == 2
    assert TTickScheduler(preempt_policy="most-pages").pick_victim(
        slots, KV()) == 0
    assert TTickScheduler().pick_victim([S(False, [])], KV()) == -1


@pytest.mark.parametrize("seed", range(6))
def test_fault_plan_random_matches_jax(seed):
    """Equal seeds give equal plans, with kills among the kinds too."""
    for kw in (dict(), dict(n_events=12, max_tick=30, max_batch=3,
                            kinds=tfaults.FAULT_KINDS)):
        jkw = dict(kw, kinds=jfaults.FAULT_KINDS) if kw else kw
        t = tfaults.FaultPlan.random(seed, **kw)
        j = jfaults.FaultPlan.random(seed, **jkw)
        assert [dataclasses.astuple(e) for e in t.events] == \
            [dataclasses.astuple(e) for e in j.events]
        assert repr(t) == repr(j) and t.last_tick == j.last_tick
        for tick in range(1, 41):
            assert [dataclasses.astuple(e) for e in t.events_at(tick)] == \
                [dataclasses.astuple(e) for e in j.events_at(tick)]
    assert tfaults.RECOVERABLE_KINDS == jfaults.RECOVERABLE_KINDS
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS


@pytest.mark.parametrize("bad", [dict(tick=1, kind="melt"),
                                 dict(tick=0, kind="drop"),
                                 dict(tick=1, kind="squeeze", pages=0)])
def test_fault_event_validation(bad):
    for mod in (tfaults, jfaults):
        with pytest.raises(ValueError):
            mod.FaultEvent(**bad)


def test_unknown_preempt_policy_raises():
    _, _, tm, tp = _models()
    with pytest.raises(ValueError, match="preempt policy"):
        TPagedEngine(tm, tp, TServeConfig(max_batch=1, max_seq=16,
                                          preempt_policy="coin-flip"))
    with pytest.raises(ValueError, match="preempt policy"):
        TTickScheduler(preempt_policy="coin-flip")


def test_drained_engine_holds_no_live_pages():
    """After an oversold run with a squeeze, a drained port engine holds
    zero live pages and references, and flushing the retained pool gives
    the whole pool back."""
    _, _, tm, tp = _models()
    te = TPagedEngine(tm, tp, TServeConfig(**OVERSOLD))
    te.install_faults(tfaults.FaultPlan(
        [tfaults.FaultEvent(3, "squeeze", pages=3, duration=2)]))
    rng = np.random.RandomState(8)
    for n in (8, 5, 8, 3, 8):
        te.submit(_rand(rng, n), 5)
    while te.busy or te._squeezed:
        te.step()
    assert te.kv.live_pages == 0 and not te.kv.seized
    _assert_drained_clean(te)


def test_trace_ticks_fill_the_traces():
    """``trace_ticks`` gives one entry per busy tick in each trace, and at
    two slots (every dirty-row count a power of two, so the JAX engine's
    padding adds nothing) the upload trace equals the JAX engine's tick
    for tick; ``trace_ticks=False`` leaves them empty, counters kept."""
    serve = dict(max_batch=2, max_seq=32, page_size=4, num_pages=6,
                 prefill_chunk=2, max_new_tokens=8)
    je, te = _engines(**serve)
    rng = np.random.RandomState(14)
    for n in (8, 7, 5):
        _submit_both(je, te, _rand(rng, n), 8)
    _finish(je, te)
    assert te.preemptions > 0
    assert len(te.host_ms_trace) == len(te.dispatch_trace) \
        == len(te.upload_trace) == te.steps_run > 0
    assert all(ms > 0 for ms in te.host_ms_trace)
    assert te.upload_trace == je.upload_trace
    assert te.dispatch_trace == je.dispatch_trace
    assert te.upload_bytes == je.upload_bytes == sum(te.upload_trace)
    assert te.table_upload_bytes == je.table_upload_bytes > 0
    _, _, tm, tp = _models()
    off = TPagedEngine(tm, tp, TServeConfig(trace_ticks=False, **serve))
    off.submit(_rand(rng, 5), 5)
    off.run()
    assert not (off.host_ms_trace or off.dispatch_trace or off.upload_trace)
    assert off.upload_bytes > 0


# ---------------------------------------------------------------------------
# int8 pools in the engine (test_kv_quant.py's engine tests, engine
# against engine)
# ---------------------------------------------------------------------------

def _same_int8_pools(je, te):
    """The port's int8 rows within one step of the JAX rows (the K/V the
    two packages quantize agree to f32 rounding, so a row can land on the
    other side of a rounding boundary) and the scales to f32 rounding."""
    for name in ("k", "v"):         # page 0 takes idle steps' appends
        d = np.abs(getattr(te.kv, name).numpy()[:, 1:].astype(np.int32)
                   - np.asarray(getattr(je.kv, name))[:, 1:].astype(np.int32))
        assert d.max() <= 1, name
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(te.kv, name).numpy()[:, 1:],
                                   np.asarray(getattr(je.kv, name))[:, 1:],
                                   rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_lane_vs_decode_token_identical(seed):
    """test_kv_quant.py's schedule on int8 pools: the port's engine (the
    prefill lane) gives the tokens of the JAX engine with the lane on and
    with prefill-by-decode; the port in lockstep with the lane-on one,
    here under an oversold pool so that resumes recompute into int8
    pages."""
    rng = np.random.RandomState(seed)
    reqs = [(_rand(rng, rng.choice((3, 5, 8, 11))), int(rng.choice((3, 5))))
            for _ in range(8)]
    serve = dict(max_batch=3, max_seq=48, max_new_tokens=5, page_size=4,
                 prefill_chunk=3, num_pages=9)
    je, te = _engines("int8", **serve)
    assert te.kv.quantized
    rids = []
    for i, (p, b) in enumerate(reqs):
        rids.append(_submit_both(je, te, p, b))
        if i % 3 == 2:
            _step_both(je, te)
    _finish(je, te)
    _same_int8_pools(je, te)
    jm, jp, _, _ = _models("int8")
    off = JPagedEngine(jm, jp, JServeConfig(prefill_lane=False, **serve))
    off_rids = [off.submit(p, b) for p, b in reqs]
    off.run()
    assert [te.results[r] for r in rids] == [off.results[r]
                                             for r in off_rids]


def test_int8_cow_preserves_rows_and_scales():
    """COW on int8 pools: both slots append into a shared partial page;
    the original page's shared int8 rows and scales stay bit-identical in
    the port, and both engines agree."""
    je, te = _engines("int8", max_batch=2, max_seq=32, max_new_tokens=4,
                      page_size=4, prefill_chunk=2, prefill_chunk_tokens=2)
    prompt = _rand(np.random.RandomState(17), 6)
    _submit_both(je, te, prompt)
    _step_both(je, te)                    # donor at 2 tokens: page partial
    _submit_both(je, te, prompt)
    je._admit()
    te._admit()
    n = te.shared_tokens
    assert 0 < n < te.kv.page and n == je.shared_tokens
    shared = [p for p in range(1, te.kv.num_pages) if te.kv.refcount[p] > 1]
    before = {p: (te.kv.k[:, p, :n].clone(), te.kv.k_scale[:, p, :n].clone())
              for p in shared}
    _step_both(je, te)
    assert te.kv.cow_copies > 0
    # a page's bytes: int8 K and V rows and their f32 scales, every layer
    L, _, page, KV, hd = te.kv.k.shape
    assert te.kv.page_bytes == je.kv.page_bytes == 2 * L * page * KV \
        * (hd + 4)
    assert te.kv.cow_bytes == te.kv.cow_copies * te.kv.page_bytes
    for p, (rows, scales) in before.items():
        assert torch.equal(rows, te.kv.k[:, p, :n])
        assert torch.equal(scales, te.kv.k_scale[:, p, :n])
    _same_int8_pools(je, te)
    _finish(je, te)
    assert te.results[0] == te.results[1] == je.results[0]


def test_int8_retained_adoption_carries_scales():
    """An adopter of a dead donor's retained int8 pages maps them with
    their scales untouched and emits the donor's stream, as the JAX
    engine does."""
    je, te = _engines("int8", max_batch=2, max_seq=48, max_new_tokens=4,
                      page_size=4, prefill_chunk=2)
    prompt = _rand(np.random.RandomState(41), 11)
    _submit_both(je, te, prompt)
    _drain_both(je, te)
    pages = list(te.kv.retained[-1].pages)
    k0 = te.kv.k[:, pages].clone()
    s0 = te.kv.k_scale[:, pages].clone()
    _submit_both(je, te, prompt)
    je._admit()
    te._admit()
    assert te.kv.retained_hits == je.kv.retained_hits == 1
    assert torch.equal(k0, te.kv.k[:, pages])
    assert torch.equal(s0, te.kv.k_scale[:, pages])
    _finish(je, te)
    assert te.results[0] == te.results[1] == je.results[1]


def test_int8_defrag_carries_scales():
    """Defrag permutes int8 pages and their scales together: a defrag
    every third tick changes no token, in lockstep with the JAX engine."""
    je, te = _engines("int8", max_batch=2, max_seq=48, max_new_tokens=4,
                      page_size=4, prefill_chunk=3)
    rng = np.random.RandomState(9)
    reqs = [(_rand(rng, n), 4) for n in (6, 9, 5, 7)]
    rids = [_submit_both(je, te, p, b) for p, b in reqs]
    while je.busy:
        _step_both(je, te)
        if te.steps_run % 3 == 0:
            je.defrag()
            te.defrag()
            _same_state(je, te)
            _same_int8_pools(je, te)
    _finish(je, te)
    _, _, tm, tp = _models("int8")
    plain = TPagedEngine(tm, tp, TServeConfig(max_batch=2, max_seq=48,
                                              max_new_tokens=4, page_size=4,
                                              prefill_chunk=3))
    plain_rids = [plain.submit(p, b) for p, b in reqs]
    plain.run()
    assert [te.results[r] for r in rids] == [plain.results[r]
                                             for r in plain_rids]


def test_launcher_overload_flags_cpu():
    """The launcher's overload flags and int8 pools on the CPU: the
    bounded queue rejects, the overload and host lines print."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--local-smoke",
         "--device", "cpu", "--kv-dtype", "int8", "--max-queue", "4",
         "--deadline-ticks", "40", "--preempt-policy", "most-pages",
         "--wedge-ticks", "50"], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert "4 rejected" in res.stdout and "rejected=4" in res.stdout
    assert "host ms per tick median" in res.stdout
