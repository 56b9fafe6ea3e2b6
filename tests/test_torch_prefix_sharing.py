"""Prefix sharing and cross-lifetime retention in the port's paged engine
and cache, against the JAX package's, on the CPU.

The two engines run in lockstep from the same weights (bridged bit-exact
from the JAX tree, f32, the reduced qwen2-0.5b and granite-8b) and the
same submissions, with the JAX engine's default sharing configuration
(``prefix_sharing`` and ``retain_prefixes`` on).  After every tick the
port's page-pool state — block tables, lengths, refcounts, free list,
retained entries and the sharing counters — must equal the JAX cache's,
its invariants (``kv.check()``, the prefix index's ``check``, history ==
length) must hold, and at the end the greedy tokens and the per-tick grant
plans must be identical.  The cache-level cases drive both caches with
the same calls and, where page contents are set by hand, compare the
pools bit for bit.  The cases follow tests/test_paged_cache_props.py at
small sizes.
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
from repro.serve import cache as jcache
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.params import params_from_jax
from repro_torch.serve import cache as tcache
from repro_torch.serve.engine import PagedEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(max_batch=3, max_seq=48, max_new_tokens=5, page_size=4,
             prefill_chunk=3)
COUNTERS = ("cow_copies", "cow_bytes", "page_bytes", "shared_pages",
            "retained_hits", "retained_hit_tokens", "retained_dropped",
            "retained_reclaimed_pages")
_MODELS = {}


def _models(arch="qwen2-0.5b", kv_dtype="bf16"):
    key = (arch, kv_dtype)
    if key not in _MODELS:
        jcfg = dataclasses.replace(jconfigs.get(arch).reduced(),
                                   dtype="float32", kv_dtype=kv_dtype)
        tcfg = dataclasses.replace(tconfigs.get(arch).reduced(),
                                   dtype="float32", kv_dtype=kv_dtype)
        jm = jget_model(jcfg)
        jp = jm.init(jax.random.key(0))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
        _MODELS[key] = (jm, jp, tget_model(tcfg), tp)
    return _MODELS[key]


def _engines(arch="qwen2-0.5b", **serve):
    jm, jp, tm, tp = _models(arch)
    je = JPagedEngine(jm, jp, JServeConfig(**serve))
    te = TPagedEngine(tm, tp, TServeConfig(**serve))
    for e in (je, te):
        e.plans = []
        plan = e.scheduler.plan

        def recording(*args, _plan=plan, _e=e, **kwargs):
            p = _plan(*args, **kwargs)
            _e.plans.append((p.steps.tolist(), p.prefill.tolist(),
                             p.cow_copies, p.reclaimed))
            return p

        e.scheduler.plan = recording
    return je, te


def _retained(kv):
    return [(e.tokens, e.pages, e.keys, e.stamp, e.hits)
            for e in kv.retained]


def _same_cache(jkv, tkv):
    """The port's host state equals the JAX cache's."""
    for name in ("table", "length", "refcount", "retained_refs"):
        np.testing.assert_array_equal(getattr(tkv, name),
                                      np.asarray(getattr(jkv, name)), name)
    assert tkv.owned == jkv.owned
    assert tkv.free == jkv.free
    assert _retained(tkv) == _retained(jkv)
    assert tkv._retained_keys.keys() == jkv._retained_keys.keys()
    for name in COUNTERS:
        assert getattr(tkv, name) == getattr(jkv, name), name
    assert tkv.allocatable == jkv.allocatable
    assert tkv.live_pages == jkv.live_pages
    assert tkv.logical_pages == jkv.logical_pages


def _check_tick(pe):
    """kv invariants, host history == length, the prefix index clean."""
    pe.kv.check()
    for i, slot in enumerate(pe.slots):
        if slot.active:
            assert len(slot.history) == int(pe.kv.length[i]), \
                f"slot {i}: history/length drift"
    pe._pindex.check(pe.slots)


def _snapshot_shared(pe):
    k = pe.kv.k.numpy()
    return {p: k[:, p].copy() for p in range(1, pe.kv.num_pages)
            if pe.kv.refcount[p] > 1}


def _step_both(je, te, frozen=None):
    """One tick of each engine, then the state comparison.  ``frozen``:
    the port's shared-page snapshot of the last tick, whose pages still
    shared must be bit-identical now.  Returns the new snapshot."""
    je.step()
    te.step()
    for e in (je, te):
        _check_tick(e)
    _same_cache(je.kv, te.kv)
    assert te.shared_tokens == je.shared_tokens
    assert te.tokens_appended == je.tokens_appended
    assert te.util_trace == je.util_trace
    assert te.occupancy_trace == je.occupancy_trace
    if frozen is not None:
        k = te.kv.k.numpy()
        for p, rows in frozen.items():
            if te.kv.refcount[p] > 1:
                np.testing.assert_array_equal(
                    rows, k[:, p], err_msg=f"shared page {p} mutated")
        return _snapshot_shared(te)
    return None


def _submit_both(je, te, prompt, budget=None):
    rid = je.submit(prompt, budget)
    assert te.submit(prompt, budget) == rid
    return rid


def _drain_both(je, te, frozen=None):
    while je.busy or te.busy:
        assert je.busy == te.busy
        frozen = _step_both(je, te, frozen)
    return frozen


def _assert_same_results(je, te, rids=None):
    rids = sorted(je.results) if rids is None else rids
    assert [te.results[r] for r in rids] == [je.results[r] for r in rids]
    assert te.plans == je.plans


def _assert_drained_clean(pe):
    """No live references, every non-retained page free; flushing the
    retained pool gives back the whole pool."""
    assert pe.kv.live_pages == 0
    assert (pe.kv.refcount[1:] == 0).all()
    assert len(pe.kv.free) == pe.kv.num_pages - 1 - pe.kv.retained_pages
    pe.kv.flush_retained()
    pe.kv.check()
    assert len(pe.kv.free) == pe.kv.num_pages - 1


def _rand(rng, n, vocab=256):
    return rng.randint(0, vocab, size=n).astype(np.int32)


# ---------------------------------------------------------------------------
# the engine at the JAX engine's default sharing configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-8b"])
def test_default_sharing_config_matches_jax(arch):
    """Shared system prompts (a 10-token one: two pages and two tokens, so
    sharers start mid-page), a mid-page common prefix, staggered joins,
    then exact repeats after every donor died (retained adoptions only)."""
    je, te = _engines(arch, max_batch=3, max_seq=48, max_new_tokens=6,
                      page_size=4, prefill_chunk=3, prefill_chunk_tokens=8)
    assert te._retain and te.kv.retain
    rng = np.random.RandomState(21)
    sys_a, sys_b = _rand(rng, 10), _rand(rng, 6)
    first = [np.concatenate([sys_a, _rand(rng, n)]) for n in (3, 1, 6, 2)]
    first += [np.concatenate([sys_b, _rand(rng, n)]) for n in (5, 2)]
    rids = [_submit_both(je, te, p, b)
            for p, b in zip(first[:2], (6, 3))]
    for p, b in zip(first[2:], (4, 5, 6, 3)):      # joins while donors live
        _step_both(je, te)
        rids.append(_submit_both(je, te, p, b))
    _drain_both(je, te)
    assert te.shared_tokens > 0 and te.kv.cow_copies > 0
    hits0 = te.kv.retained_hits
    again = [_submit_both(je, te, p, 4) for p in (first[0], first[3],
                                                  first[4])]
    _drain_both(je, te)
    assert te.kv.retained_hits > hits0
    assert te.kv.retained_hit_tokens > 0
    _assert_same_results(je, te, rids + again)
    assert te.logical_physical_ratio == je.logical_physical_ratio > 1.0
    for e in (je, te):
        _assert_drained_clean(e)


def test_default_serveconfig_serves():
    """``PagedEngine(model, params, ServeConfig())`` with every default
    (sharing and retention on) serves, token-identical to the JAX engine's
    default configuration."""
    jm, jp, tm, tp = _models()
    je, te = JPagedEngine(jm, jp, JServeConfig()), \
        TPagedEngine(tm, tp, TServeConfig())
    rng = np.random.RandomState(8)
    head = _rand(rng, 20)
    prompts = [np.concatenate([head, _rand(rng, n)]) for n in (4, 9)]
    for e in (je, te):
        for p in prompts:
            e.submit(p)
        e.run()
        e.submit(prompts[0])                       # after its donor died
        e.run()
    assert te.results == je.results
    assert te.shared_tokens == je.shared_tokens > 0
    assert te.kv.retained_hits == je.kv.retained_hits == 1


def test_retain_policy_and_cap_match_jax():
    """``retain_policy`` and ``retain_pool_pages`` reach the cache: under
    a cap of two idle pages and the popularity order, the retained pool
    and its drops follow the JAX engine's tick for tick."""
    je, te = _engines(retain_policy="popularity", retain_pool_pages=2,
                      **SMALL)
    assert te.kv.retain_policy == "popularity" and te.kv.retain_cap == 2
    rng = np.random.RandomState(31)
    prompts = [_rand(rng, n) for n in (9, 5, 8, 12)]
    for p in prompts + prompts[:2] + prompts[3:]:
        _submit_both(je, te, p)
        _step_both(je, te)
    _drain_both(je, te)
    assert te.kv.retained_dropped > 0
    assert len(te.kv._retained_only()) <= 2
    _assert_same_results(je, te)


# ---------------------------------------------------------------------------
# the shared-prefix fuzz (tests/test_paged_cache_props.py, small sizes)
# ---------------------------------------------------------------------------

def _fuzz(seed, min_ticks, n_requests, prefixes, defrag_every=0,
          frozen=False, **serve):
    je, te = _engines(**dict(SMALL, **serve))
    rng = np.random.RandomState(seed)
    snap = {} if frozen else None
    submitted = 0
    for _ in range(10 * min_ticks + 10 * n_requests + 100):
        want_more = submitted < n_requests or je.steps_run < min_ticks
        if want_more and rng.rand() < 0.6:
            for _ in range(rng.randint(1, 3)):
                if rng.rand() < 0.85:
                    p = np.concatenate([prefixes[rng.randint(len(prefixes))],
                                        _rand(rng, rng.choice((2, 3, 5)))])
                else:
                    p = _rand(rng, rng.choice((3, 5, 8)))
                _submit_both(je, te, p, int(rng.choice((3, 5))))
                submitted += 1
        if je.busy:
            disp0 = te.kv.cow_dispatches
            snap = _step_both(je, te, snap)
            assert te.kv.cow_dispatches - disp0 <= 1   # one flush a tick
        if defrag_every and je.steps_run \
                and je.steps_run % defrag_every == 0:
            je.defrag()
            te.defrag()
            _same_cache(je.kv, te.kv)
            te.kv.check()
            if frozen:
                snap = _snapshot_shared(te)
        if submitted >= n_requests and not je.busy \
                and je.steps_run >= min_ticks:
            break
    _drain_both(je, te, snap)
    _assert_same_results(je, te)
    assert te.joins == je.joins == submitted
    for e in (je, te):
        _assert_drained_clean(e)
    return te


def test_fuzz_shared_prefix_matches_jax():
    """Common-prefix families: admissions share resident pages, appends
    into the shared trailing page copy on write, shared pages stay
    bit-frozen tick by tick, and everything follows the JAX engine."""
    rng = np.random.RandomState(100)
    te = _fuzz(3, 30, 10, (_rand(rng, 6), _rand(rng, 9)), frozen=True)
    assert te.shared_tokens > 0 and te.kv.cow_copies > 0


def test_fuzz_shared_prefix_with_defrag_matches_jax():
    """Sharing with a defrag every 4 ticks: renumbering keeps refcounts,
    multi-table references and retained entries, as the JAX cache's."""
    rng = np.random.RandomState(200)
    te = _fuzz(5, 24, 8, (_rand(rng, 7),), defrag_every=4)
    assert te.shared_tokens > 0


def test_fuzz_odd_prefill_chunk_matches_jax():
    """Prefill chunk of 5 over pages of 4: mid-prompt chunks clip to page
    boundaries and shared prefixes end mid-page."""
    rng = np.random.RandomState(500)
    te = _fuzz(13, 20, 8, (_rand(rng, 6),), prefill_chunk_tokens=5)
    assert te.shared_tokens > 0


# ---------------------------------------------------------------------------
# engine-level regressions
# ---------------------------------------------------------------------------

def test_cow_preserves_shared_rows():
    """A partial page shared by two slots: both append into it on the
    next tick, the copy on write fires, and the shared rows of the
    original page are bit-identical afterwards."""
    je, te = _engines(max_batch=2, max_seq=32, max_new_tokens=4,
                      page_size=4, prefill_chunk=2, prefill_chunk_tokens=2)
    prompt = _rand(np.random.RandomState(17), 6)
    _submit_both(je, te, prompt)
    _step_both(je, te)                   # donor at 2 tokens: page PARTIAL
    _submit_both(je, te, prompt)
    je._admit()
    te._admit()
    n_shared = te.shared_tokens
    assert n_shared == je.shared_tokens and 0 < n_shared < te.kv.page
    shared = [p for p in range(1, te.kv.num_pages) if te.kv.refcount[p] > 1]
    assert shared
    before = {p: te.kv.k[:, p, :n_shared].clone() for p in shared}
    _step_both(je, te)
    assert te.kv.cow_copies > 0
    for p, rows in before.items():
        assert torch.equal(rows, te.kv.k[:, p, :n_shared]), p
    _drain_both(je, te)
    _assert_same_results(je, te)
    assert te.results[0] == te.results[1]


def test_sharer_survives_donor_eviction():
    """The donor finishes first: its exclusive pages go back (or to the
    retained pool), the shared ones stay live until the sharer ends."""
    je, te = _engines(max_batch=2, max_seq=32, max_new_tokens=2,
                      page_size=4, prefill_chunk=4)
    prompt = _rand(np.random.RandomState(23), 6)
    _submit_both(je, te, prompt, 2)
    _step_both(je, te)
    _submit_both(je, te, prompt, 5)
    _drain_both(je, te)
    assert te.shared_tokens > 0
    _assert_same_results(je, te)
    assert te.results[0] == te.results[1][:2]


def test_find_donor_collision_falls_back():
    """A prefix-index key that names the wrong slot (a digest collision)
    fails the history check, and the exact scan finds the donor; live
    matches win ties with the retained pool, as in the JAX engine."""
    je, te = _engines(**SMALL)
    rng = np.random.RandomState(71)
    donor = _rand(rng, 9)
    _submit_both(je, te, donor, 5)
    _submit_both(je, te, _rand(rng, 9), 5)
    _step_both(je, te)
    _step_both(je, te)
    prompt = [int(t) for t in donor[:7]] + [1, 2]
    for e in (je, te):
        assert e._find_donor(prompt) == ("live", 0, 7)
        h = 0
        for n, t in enumerate(prompt[:7], 1):   # every key names slot 1
            h = tcache.digest_step(h, t)
            e._pindex._map[(n, h)] = {1}
        assert e._find_donor(prompt) == ("live", 0, 7)
        assert e._find_donor(prompt[:1]) == (None, None, 0)   # cap 0


def test_defrag_compacts_to_prefix():
    """After a defrag the kept pages fill the pool's prefix [null | live
    | retained-only] and the free list is exactly the tail."""
    je, te = _engines(max_batch=3, max_seq=32, max_new_tokens=5,
                      page_size=2, prefill_chunk=2)
    rng = np.random.RandomState(13)
    for _ in range(5):
        _submit_both(je, te, _rand(rng, 4))
    for _ in range(4):
        _step_both(je, te)
    je.defrag()
    te.defrag()
    _same_cache(je.kv, te.kv)
    te.kv.check()
    live = te.kv.live_pages
    assert sorted({p for o in te.kv.owned for p in o}) == \
        list(range(1, live + 1))
    kept = live + len(te.kv._retained_only())
    assert sorted(te.kv.free) == list(range(kept + 1, te.kv.num_pages))
    assert te.kv.dirty == set(range(te.kv.B))
    _drain_both(je, te)
    _assert_same_results(je, te)
    assert len(te.results) == 5


def test_defrag_keeps_tokens():
    """A defrag between every two ticks changes no token: the port with
    defrags gives the tokens of the port without them."""
    rng = np.random.RandomState(61)
    head = _rand(rng, 9)
    prompts = [np.concatenate([head, _rand(rng, n)]) for n in (2, 5, 3, 4)]
    outs = []
    for every in (0, 1):
        _, _, tm, tp = _models()
        te = TPagedEngine(tm, tp, TServeConfig(**SMALL))
        rids = [te.submit(p) for p in prompts + prompts[:2]]
        while te.busy:
            te.step()
            if every:
                te.defrag()
            _check_tick(te)
        outs.append([te.results[r] for r in rids])
    assert outs[0] == outs[1]


def test_retained_reshare_bit_identical_after_donor_death():
    """A request submitted after its donor drained adopts the donor's
    frozen pages by reference — the same page ids, bit-identical rows —
    and serves the tokens of a cold run."""
    je, te = _engines(max_batch=2, max_seq=48, max_new_tokens=4,
                      page_size=4, prefill_chunk=2)
    prompt = _rand(np.random.RandomState(41), 11)
    _submit_both(je, te, prompt)
    _drain_both(je, te)
    assert not te.busy and te.kv.live_pages == 0 and te.kv.retained
    entry = te.kv.retained[-1]
    pages = list(entry.pages)
    rows = te.kv.k[:, pages].clone()
    _submit_both(je, te, prompt)
    je._admit()
    te._admit()
    _same_cache(je.kv, te.kv)
    n_hit = (len(prompt) // 4) * 4
    assert te.kv.retained_hits == 1 and te.kv.retained_hit_tokens == n_hit
    slot = next(i for i, s in enumerate(te.slots) if s.active)
    assert te.kv.owned[slot][:n_hit // 4] == pages[:n_hit // 4]
    assert te.kv.dirty >= {slot}
    assert torch.equal(rows, te.kv.k[:, pages])
    _drain_both(je, te)
    _assert_same_results(je, te)
    assert te.results[0] == te.results[1]
    for e in (je, te):
        _assert_drained_clean(e)


def test_retained_survives_defrag():
    """Defrag renumbers retained entries' pages: the digest lookup still
    hits afterwards, and the adopted rows are the pre-defrag rows."""
    je, te = _engines(max_batch=2, max_seq=48, max_new_tokens=4,
                      page_size=4, prefill_chunk=2)
    prompt = _rand(np.random.RandomState(43), 9)
    _submit_both(je, te, prompt)
    _drain_both(je, te)
    entry = te.kv.retained[-1]
    rows = te.kv.k[:, entry.pages].clone()
    je.defrag()
    te.defrag()
    _same_cache(je.kv, te.kv)
    te.kv.check()
    assert torch.equal(rows, te.kv.k[:, entry.pages])
    _submit_both(je, te, prompt)
    _step_both(je, te)
    assert te.kv.retained_hits == 1
    _drain_both(je, te)
    _assert_same_results(je, te)
    assert te.results[0] == te.results[1]


def test_retention_off_restores_legacy_drain():
    """``retain_prefixes=False``: a finished slot's pages go straight
    back to the free list."""
    je, te = _engines(max_batch=2, max_seq=48, max_new_tokens=4,
                      page_size=4, prefill_chunk=2, retain_prefixes=False)
    assert not te.kv.retain
    _submit_both(je, te, _rand(np.random.RandomState(44), 9))
    _drain_both(je, te)
    assert not te.kv.retained
    assert len(te.kv.free) == te.kv.num_pages - 1
    _assert_same_results(je, te)


# ---------------------------------------------------------------------------
# the cache alone, both packages driven by the same calls
# ---------------------------------------------------------------------------

def _caches(*args, kv_dtype="bf16", **kw):
    jm, _, tm, _ = _models(kv_dtype=kv_dtype)
    return jcache.PagedKVCache(jm, *args, **kw), \
        tcache.PagedKVCache(tm, *args, device="cpu", **kw)


def _fill_pools(jc, tc, seed=0):
    """The same random rows in both caches' pools (scales included)."""
    rng = np.random.RandomState(seed)
    for name in ("k", "v", "k_scale", "v_scale"):
        pool = getattr(tc, name)
        if pool is None:
            continue
        if pool.dtype == torch.int8:
            rows = rng.randint(-127, 128, size=pool.shape).astype(np.int8)
        else:
            rows = rng.randn(*pool.shape).astype(np.float32)
        setattr(jc, name, jax.numpy.asarray(rows))
        setattr(tc, name, torch.from_numpy(rows.copy()))


def _same_pools(jc, tc):
    for name in ("k", "v", "k_scale", "v_scale"):
        if getattr(tc, name) is not None:
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(jc, name)), name)


def test_digests_match_jax():
    rng = np.random.RandomState(3)
    toks = rng.randint(0, 1 << 17, size=64)
    assert tcache.prefix_digests(toks, 4) == jcache.prefix_digests(toks, 4)
    assert tcache.digest_step(0, 0) == jcache.digest_step(0, 0) == 1
    assert (tcache._HASH_MUL, tcache._HASH_MOD) == \
        (jcache._HASH_MUL, jcache._HASH_MOD)


def test_reclaim_never_touches_adopted_pages():
    """Reclamation skips an entry a live slot adopted and drops only idle
    entries; once the adopter is gone the entry is reclaimable."""
    jc, tc = _caches(3, 32, page_size=4, num_pages=10, retain=True)
    toks_a, toks_b = list(range(8)), list(range(100, 108))
    for c in (jc, tc):
        for toks in (toks_a, toks_b):
            c.ensure(0, 8)
            c.length[0] = 8
            c.free_slot(0, retain_tokens=toks)
        entry_a, n = c.match_retained(np.asarray(toks_a, np.int32), 32)
        assert n == 8
        c.adopt_retained(1, entry_a, 8)
        c.check()
        assert c.reclaim_retained(100) == 2
        assert entry_a in c.retained
        assert (c.refcount[entry_a.pages] == 1).all()
    _same_cache(jc, tc)
    for c in (jc, tc):
        c.free_slot(1)
        assert c.reclaim_retained(100) == 2 and not c.retained
        c.check()
        assert len(c.free) == c.num_pages - 1
    _same_cache(jc, tc)


@pytest.mark.parametrize("policy,survivor", [("lru", "young"),
                                             ("popularity", "old")])
def test_retain_policies_order_reclamation(policy, survivor):
    """lru drops the oldest-touched entry first; popularity the one with
    the fewest adoptions, even when it is the youngest."""
    jc, tc = _caches(2, 64, page_size=4, num_pages=12, retain=True,
                     retain_policy=policy)
    old, young = list(range(4)), list(range(50, 54))
    for c in (jc, tc):
        c.ensure(0, 4)
        c.length[0] = 4
        c.free_slot(0, retain_tokens=old)
        if policy == "popularity":               # make the old one popular
            e, _ = c.match_retained(np.asarray(old, np.int32), 64)
            c.adopt_retained(1, e, 4)
            c.free_slot(1)
        c.ensure(0, 4)
        c.length[0] = 4
        c.free_slot(0, retain_tokens=young)
        assert c.reclaim_retained(1) == 1
        c.check()
        assert c.retained[0].tokens == (young if survivor == "young"
                                        else old)
    _same_cache(jc, tc)


def test_cow_and_cow_many_match_jax():
    """The single-page ``cow`` and the batched ``cow_many`` wrappers:
    exclusive pairs are skipped, shared ones privatized in one flush, and
    a dry pool stops the batch at the first pair it cannot serve."""
    jc, tc = _caches(3, 16, page_size=4, num_pages=6)
    _fill_pools(jc, tc, seed=2)
    for c in (jc, tc):
        assert c.ensure(0, 8)
        c.length[0] = 8
        c.share(1, 0, 8)
        c.share(2, 0, 8)
        assert c.cow(1, 1)                       # one page, flushed at once
        assert not c._pending_cow
        assert c.cow_many([(0, 1), (2, 0), (2, 1), (1, 0)]) == 2
        c.check()
    _same_cache(jc, tc)
    _same_pools(jc, tc)
    assert tc.cow_dispatches == jc.cow_dispatches == 2


def test_retain_policy_checked():
    with pytest.raises(ValueError, match="retain_policy"):
        _caches(2, 16, page_size=4, retain_policy="fifo")


def test_retain_cap_bounds_idle_pages():
    """Retaining past ``retain_cap`` idle pages drops older entries."""
    jc, tc = _caches(2, 64, page_size=4, num_pages=16, retain=True,
                     retain_cap=2)
    for base in (0, 100, 200):
        for c in (jc, tc):
            c.ensure(0, 8)
            c.length[0] = 8
            c.free_slot(0, retain_tokens=list(range(base, base + 8)))
            c.check()
            assert len(c._retained_only()) <= 2
        _same_cache(jc, tc)
    assert tc.retained[-1].tokens == list(range(200, 208))


def test_alloc_reclaims_retained_before_running_dry():
    """``_alloc_page`` drains the retained pool before it reports a dry
    pool: a pool held entirely by retained entries still serves a full
    slot."""
    jc, tc = _caches(2, 32, page_size=4, num_pages=5, retain=True)
    for c in (jc, tc):
        c.ensure(0, 16)
        c.length[0] = 16
        c.free_slot(0, retain_tokens=list(range(16)))
        assert not c.free and c.allocatable == 4
        assert c.ensure(1, 12)
        c.check()
        assert c.retained_reclaimed_pages == 4   # the whole entry
        assert len(c.free) == 1
    _same_cache(jc, tc)


def test_match_retained_collision_falls_back():
    """A digest key that names the wrong entry (a collision) is caught by
    the token check, and the exact scan finds the right entry."""
    jc, tc = _caches(3, 32, page_size=4, retain=True)
    a, b = list(range(8)), [0, 1, 2, 3, 90, 91, 92, 93]
    for c in (jc, tc):
        for toks in (a, b):
            c.ensure(0, 8)
            c.length[0] = 8
            c.free_slot(0, retain_tokens=toks)
        ea, eb = c.retained
        key = (2, jcache.prefix_digests(b, 4)[-1])
        c._retained_keys[key] = [ea]             # forged collision
        entry, n = c.match_retained(np.asarray(b + [5], np.int32), 9)
        assert entry is eb and n == 8
        del c._retained_keys[key]                # a miss at 2 pages
        entry, n = c.match_retained(np.asarray(b + [5], np.int32), 9)
        assert n == 4


def _cache_op(c, op, i, draw, hist):
    """One call of the cache fuzz on cache ``c``; ``draw`` holds the
    random numbers, ``hist`` each slot's token history (the same for both
    packages).  Returns slot i's new history, or None if unchanged."""
    if op == 0 and not c.owned[i]:                # admit
        prompt = draw["prompt"]
        donors = [j for j in range(c.B) if c.owned[j] and c.length[j]]
        entry, n = c.match_retained(prompt, len(prompt))
        if donors and draw["coin"] < 0.5:
            d = donors[0]
            c.share(i, d, int(c.length[d]))
            return hist[d][:int(c.length[d])]
        if entry is not None:
            c.adopt_retained(i, entry, n)
            return list(prompt[:n])
        c.ensure(i, 1)
        c.length[i] = 1
        return list(prompt[:1])
    if op == 1 and c.owned[i] and c.length[i] + 3 <= 24:   # append
        if c.ensure(i, int(c.length[i]) + 3):
            c.length[i] += 3
            return hist[i] + draw["tail"]
    elif op == 2 and c.owned[i]:                  # reserve a COW
        c.cow_reserve(i, int(draw["coin"] * len(c.owned[i])))
    elif op == 3 and c.owned[i]:
        c.cow_rollback(i, 0)
    elif op == 4:
        c.cow_flush()
    elif op == 5 and c.owned[i]:                  # free, maybe retaining
        c.free_slot(i, retain_tokens=hist[i] if draw["coin"] < 0.7
                    else None)
        return []
    elif op == 6:
        c.reclaim_retained(1)
    elif op == 7:
        c.defrag()
    return None


# admit, append, reserve, rollback, flush, free, reclaim, defrag
OP_WEIGHTS = (0.2, 0.22, 0.12, 0.05, 0.1, 0.15, 0.04, 0.12)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_cache_ops_fuzz_matches_jax(kv_dtype):
    """Random admissions (share, adopt or fresh) / appends / copy-on-write
    reserve, rollback and flush / frees with and without retention (a
    pending copy among them) / reclaims / defrags on both caches: the
    host state (the dirty rows a call leaves too) equals the JAX cache's
    after every call, the mid-plan invariants hold, and the pools — int8 rows and their f32 scale pools
    too — are bit-identical after every flush and defrag."""
    B = 3
    jc, tc = _caches(B, 24, page_size=4, retain=True, kv_dtype=kv_dtype)
    assert tc.quantized == (kv_dtype == "int8")
    _fill_pools(jc, tc, seed=9)
    rng = np.random.RandomState(11)
    hist = [[] for _ in range(B)]
    freed = [[0, 1, 2, 3, 4, 5, 6, 7]]
    for _ in range(400):
        op, i = int(rng.choice(8, p=OP_WEIGHTS)), int(rng.randint(B))
        base = freed[rng.randint(len(freed))] if rng.rand() < 0.6 else []
        draw = dict(coin=rng.rand(),
                    tail=[int(t) for t in rng.randint(0, 50, size=3)])
        draw["prompt"] = (base[:rng.randint(4, 16)]
                          + [int(t) for t in rng.randint(0, 50, size=4)])
        before = list(hist[i])
        for c in (jc, tc):
            c.dirty.clear()
        new = [_cache_op(c, op, i, draw, hist) for c in (jc, tc)]
        assert new[0] == new[1]
        assert tc.dirty == jc.dirty            # the rows to re-upload
        if new[1] is not None:
            if op == 5 and before:
                freed.append(before)
            hist[i] = new[1]
        for c in (jc, tc):
            c.check(allow_pending=True)
        _same_cache(jc, tc)
        assert [p[:3] for p in tc._pending_cow] == \
            [p[:3] for p in jc._pending_cow]
        if op in (4, 7):
            _same_pools(jc, tc)
    for c in (jc, tc):
        c.cow_flush()
        for i in range(B):
            c.free_slot(i)
        c.flush_retained()
        c.check()
        assert len(c.free) == c.num_pages - 1
    _same_cache(jc, tc)
    _same_pools(jc, tc)
    assert tc.retained_hits > 0 and tc.shared_pages > tc.retained_hit_tokens
    assert tc.cow_dispatches > 0 and tc.retained_dropped > 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,shared", [((), True),
                                          (("--no-prefix-sharing",), False)])
def test_launcher_sharing_report(flags, shared):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--local-smoke",
         "--device", "cpu", *flags], env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    line = next(l for l in res.stdout.splitlines() if "prefix tokens" in l)
    n = int(line.split("shared ")[1].split()[0])
    assert (n > 0) == shared, line
    assert "retained adoptions" in res.stdout
