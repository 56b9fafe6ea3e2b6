"""Speculative draft-and-verify in the port's paged engine against the JAX
engine, on the CPU: the twins of tests/test_speculative.py, and the two
engines in lockstep.

f32, the reduced qwen2-0.5b with its weights bridged from the JAX tree;
the draft is the JAX tests' 1-layer slice of the target (sharing its
embedding, final norm and unembedding), whose proposals are mostly
rejected, or the target itself, whose proposals are all accepted.  Held:

  * the construction contract (a draft model, greedy, the prefill lane,
    one vocabulary), with the JAX engine's errors;
  * the verify cell: greedy, accept and the unembedded logits of every
    position against the JAX cell on the same cache, over ragged grants;
  * outputs identical to plain greedy decode for spec_k in {1, 3, 5}, on
    int8 pools too; all k accepted plus the bonus; a draft EOS mid-window;
    a tick that rejects every proposal still emits the bonus token;
  * the engine tick for tick against the JAX speculative engine (both
    pools' lengths and tables, slots, outputs, grant plans, the five
    counters, the dispatch and upload traces), sharing on and off, and
    under preemption at a pool of five pages (the JAX test's six never
    preempts: tests/test_speculative.py::test_preempt_mid_speculation_
    bit_identical fails on its own premise, ROADMAP queue 3).

``test_spec_cells_compile_once`` has no twin: nothing compiles here.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as jget_model
from repro.models import transformer as JT
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch.models import transformer as TT
from repro_torch.models.model import get_model as tget_model
from repro_torch.serve.engine import PagedEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig

from test_paged_cache_props import _check_tick
from test_torch_overload import SLOT_FIELDS, _models, _plans
from torch_one_thread import _one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
SPEC_COUNTERS = ("spec_proposed", "spec_accepted", "spec_trunc_tokens",
                 "draft_dispatches", "verify_dispatches")
TRACES = ("draft_dispatch_trace", "verify_dispatch_trace",
          "dispatch_trace", "tokens_out", "preemptions",
          "recompute_tokens", "shared_tokens", "tokens_appended", "results")
DRIVE = dict(max_batch=2, max_seq=96, max_new_tokens=18, prefill_chunk=4,
             page_size=8)


def _slice(tree):
    """The first layer of a stacked torch block tree."""
    if isinstance(tree, dict):
        return {k: _slice(v) for k, v in tree.items()}
    return tree[:1]


def _drafts(kv_dtype="bf16"):
    """(JAX, port) pairs of (model, params) of the 1-layer draft."""
    jm, jp, tm, tp = _models(kv_dtype)
    jdp = dict(jp, blocks=jax.tree.map(lambda x: x[:1], jp["blocks"]))
    tdp = dict(tp, blocks=_slice(tp["blocks"]))
    return ((jget_model(dataclasses.replace(jm.cfg, n_layers=1)), jdp),
            (tget_model(dataclasses.replace(tm.cfg, n_layers=1)), tdp))


def _prompts(n=4, seed=3, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=ln).astype(np.int32)
            for ln in rng.randint(4, 14, size=n)]


def _drive(prompts, spec_k=0, draft=None, kv_dtype="bf16", **kw):
    """The port's engine over ``prompts`` (the JAX tests' ``_drive``);
    ``draft`` "slice" or "self".  Returns (results, engine)."""
    _, _, tm, tp = _models(kv_dtype)
    dm = dp = None
    if spec_k:
        dm, dp = _drafts(kv_dtype)[1] if draft == "slice" else (tm, tp)
    eng = TPagedEngine(tm, tp, TServeConfig(spec_k=spec_k,
                                            **dict(DRIVE, **kw)),
                       draft_model=dm, draft_params=dp)
    for p in prompts:
        eng.submit(p)
    res = eng.run()
    eng.kv.check()
    if eng.dkv is not None:
        eng.dkv.check()
    return res, eng


# ---------------------------------------------------------------------------
# construction contract
# ---------------------------------------------------------------------------

def test_spec_requires_draft_greedy_lane_and_vocab():
    _, _, tm, tp = _models()
    dm, dp = _drafts()[1]
    with pytest.raises(ValueError, match="draft model"):
        TPagedEngine(tm, tp, TServeConfig(spec_k=2))
    with pytest.raises(ValueError, match="greedy"):
        TPagedEngine(tm, tp, TServeConfig(spec_k=2, temperature=0.7),
                     draft_model=dm, draft_params=dp)
    with pytest.raises(ValueError, match="prefill lane"):
        TPagedEngine(tm, tp, TServeConfig(spec_k=2, prefill_lane=False),
                     draft_model=dm, draft_params=dp)
    bad = tget_model(dataclasses.replace(dm.cfg,
                                         vocab_size=dm.cfg.vocab_size // 2))
    with pytest.raises(ValueError, match="tokenizer"):
        TPagedEngine(tm, tp, TServeConfig(spec_k=2), draft_model=bad,
                     draft_params=dp)
    eng = TPagedEngine(tm, tp, TServeConfig(spec_k=3), draft_model=dm,
                       draft_params=dp)
    assert eng._chunk == 4 and eng.dkv is not None
    assert not eng.dkv.retain and eng.accept_rate == 0.0


# ---------------------------------------------------------------------------
# the verify cell against the JAX cell
# ---------------------------------------------------------------------------

def test_verify_matches_jax_on_the_same_cache():
    """Three slots after ragged prompts, bases mid-page: proposals copied
    from the plain greedy chain (slot 0, all accepted), shifted off it at
    position 1 (slot 1, grant 3: one accepted) and an idle slot (grant
    0).  The port's greedy, accept and every position's f32 logits equal
    the JAX cell's; a chain shifted everywhere accepts nothing."""
    jm, jp, tm, tp = _models()
    B, k, page, NB = 3, 3, 8, 6
    table = np.arange(1, B * NB + 1, dtype=np.int32).reshape(B, NB)
    jc = dict(jm.init_paged_cache(B, NB, page, B * NB + 1),
              table=jnp.asarray(table))
    tc = tm.init_paged_cache(B, NB, page, B * NB + 1, "cpu")
    tc["table"] = torch.from_numpy(table.copy())
    prompts = _prompts(n=B, seed=5)
    T0 = max(len(p) for p in prompts)
    toks = np.zeros((B, T0), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    g = np.array([len(p) for p in prompts], np.int32)
    _, jc = jm.prefill_step_paged(jp, jnp.asarray(toks), jc, jnp.asarray(g))
    logits, tc = tm.prefill_step_paged(tp, torch.from_numpy(toks), tc,
                                       torch.from_numpy(g))
    feed = logits.argmax(-1).to(torch.int32)
    chain, c2 = [feed], {n: t.clone() for n, t in tc.items()}
    for _ in range(k):
        lg, c2 = tm.decode_step_paged(tp, chain[-1][:, None], c2)
        chain.append(lg.argmax(-1).to(torch.int32))
    chain = torch.stack(chain, 1).numpy()             # (B, k + 1)
    props = chain[:, 1:].copy()
    props[1, 1] = (props[1, 1] + 1) % tm.cfg.vocab_size
    tok = np.concatenate([chain[:, :1], props], 1)
    grants = np.array([k + 1, 3, 0], np.int32)

    def both(tok, grants):
        tcc = {n: t.clone() for n, t in tc.items()}
        jg, ja, jcc = jax.jit(jm.verify_many_paged)(
            jp, jnp.asarray(tok), dict(jc), jnp.asarray(grants))
        tg, ta, tcc = tm.verify_many_paged(tp, torch.from_numpy(tok), tcc,
                                           torch.from_numpy(grants))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        live = grants > 0
        np.testing.assert_array_equal(tg.numpy()[live], np.asarray(jg)[live])
        np.testing.assert_array_equal(tcc["length"].numpy(),
                                      np.asarray(jcc["length"]))
        return tg.numpy(), ta.numpy()

    gr, acc = both(tok, grants)
    assert acc.tolist() == [k, 1, 0]
    np.testing.assert_array_equal(gr[0, :k], chain[0, 1:])
    jl, _ = JT.lm_prefill_paged(jp, jm.cfg, jnp.asarray(tok), dict(jc),
                                jnp.asarray(grants), unembed_all=True)
    tl, _ = TT.lm_prefill_paged(tp, tm.cfg, torch.from_numpy(tok),
                                {n: t.clone() for n, t in tc.items()},
                                torch.from_numpy(grants), unembed_all=True)
    assert tl.shape == (B, k + 1, tm.cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                               rtol=1e-4, atol=1e-4)
    off = np.concatenate([chain[:, :1],
                          (chain[:, 1:] + 1) % tm.cfg.vocab_size], 1)
    gr, acc = both(off, np.full((B,), k + 1, np.int32))
    assert (acc == 0).all()                  # pure reject: the bonus is
    np.testing.assert_array_equal(gr[:, 0], chain[:, 1])   # the argmax


# ---------------------------------------------------------------------------
# engine-level token identity (the port alone)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec_k", [1, 3, 5])
def test_spec_token_identical_to_plain(spec_k):
    """With the 1-layer draft most proposals are rejected: the output is
    plain greedy decode's, and rejected rows really were truncated."""
    prompts = _prompts()
    plain, _ = _drive(prompts)
    spec, eng = _drive(prompts, spec_k=spec_k, draft="slice")
    assert plain == spec
    assert eng.spec_proposed > 0
    assert eng.verify_dispatches > 0 and eng.draft_dispatches > 0
    assert eng.spec_accepted < eng.spec_proposed
    assert eng.spec_trunc_tokens > 0


def test_all_k_accepted_with_bonus():
    """Draft = target: every proposal is accepted and a full tick emits
    k + 1 tokens; the draft's one-token deficit is replayed as a forced
    step and never costs an acceptance."""
    prompts = _prompts(n=2, seed=9)
    plain, _ = _drive(prompts)
    spec, eng = _drive(prompts, spec_k=3, draft="self")
    assert plain == spec
    assert eng.spec_proposed > 0
    assert eng.spec_accepted == eng.spec_proposed
    assert eng.spec_trunc_tokens == 0
    assert eng.verify_dispatches < sum(len(v) for v in spec.values())


def test_draft_eos_mid_window_finishes_slot():
    """An eos the draft proposes and the target accepts inside a window
    ends the slot there; the tokens after it are discarded."""
    prompts = _prompts(n=1, seed=11)
    plain, _ = _drive(prompts)
    j = next(j for j in range(1, len(plain[0]))
             if plain[0][j] not in plain[0][:j])
    eos = plain[0][j]
    plain_eos, _ = _drive(prompts, eos_id=eos)
    spec_eos, eng = _drive(prompts, spec_k=4, draft="self", eos_id=eos)
    assert plain_eos == spec_eos
    assert spec_eos[0][-1] == eos and len(spec_eos[0]) == j + 1
    assert not any(s.active for s in eng.slots)


def test_k0_accept_tick_progresses_on_bonus():
    """A tick that rejects every proposal still emits the bonus token."""
    _, _, tm, tp = _models()
    dm, dp = _drafts()[1]
    eng = TPagedEngine(tm, tp, TServeConfig(max_batch=1, max_seq=96,
                                            max_new_tokens=12, page_size=8,
                                            spec_k=4),
                       draft_model=dm, draft_params=dp)
    eng.submit(_prompts(n=1, seed=3)[0])
    saw_pure_reject = False
    while eng.busy:
        out_before = sum(len(s.out) for s in eng.slots)
        acc_before, prop_before = eng.spec_accepted, eng.spec_proposed
        eng.step()
        out_after = sum(len(s.out) for s in eng.slots) \
            + sum(len(v) for v in eng.results.values())
        if (eng.spec_proposed > prop_before
                and eng.spec_accepted == acc_before):
            assert out_after == out_before + 1
            saw_pure_reject = True
    assert saw_pure_reject


def test_spec_composes_with_int8_pages():
    """int8 pools with their scales on both the target and the draft:
    the output is the plain int8 engine's."""
    prompts = _prompts(n=3, seed=7)
    plain, _ = _drive(prompts, kv_dtype="int8")
    spec, eng = _drive(prompts, spec_k=3, draft="slice", kv_dtype="int8")
    assert plain == spec
    assert eng.kv.quantized and eng.dkv.quantized


# ---------------------------------------------------------------------------
# the engine tick for tick against the JAX speculative engine
# ---------------------------------------------------------------------------

def _spec_engines(models=None, drafts=None, **serve):
    """A JAX and a port speculative engine on the same weights, drafts
    and ServeConfig (``models``, ``drafts``: another arch's, as
    ``_models`` and ``_drafts`` give them; by default those), each
    recording its grant plans; the port also the dirty-row count of each
    table sync of the tick (``sync_log``)."""
    jm, jp, tm, tp = models or _models()
    (jdm, jdp), (tdm, tdp) = drafts or _drafts()
    je = JPagedEngine(jm, jp, JServeConfig(**serve), draft_model=jdm,
                      draft_params=jdp)
    te = TPagedEngine(tm, tp, TServeConfig(**serve), draft_model=tdm,
                      draft_params=tdp)
    for e in (je, te):
        e.plans = []
        plan = e.scheduler.plan

        def recording(*args, _plan=plan, _e=e, **kwargs):
            p = _plan(*args, **kwargs)
            _e.plans.append(p)
            return p

        e.scheduler.plan = recording
    te.sync_log = []
    sync = te._sync_dirty

    def recording_sync(kv, *mirrors):
        if kv.dirty:
            te.sync_log.append(len(kv.dirty))
        return sync(kv, *mirrors)

    te._sync_dirty = recording_sync
    return je, te


def _same_spec_state(je, te, padded_upload):
    for kv in ("kv", "dkv"):
        for name in ("length", "table"):
            np.testing.assert_array_equal(
                getattr(getattr(te, kv), name),
                np.asarray(getattr(getattr(je, kv), name)), f"{kv}.{name}")
    assert [[getattr(s, f) for f in SLOT_FIELDS] for s in te.slots] == \
        [[getattr(s, f) for f in SLOT_FIELDS] for s in je.slots]
    np.testing.assert_array_equal(te._feed, je._feed)
    assert {r: s.value for r, s in te.status.items()} == \
        {r: s.value for r, s in je.status.items()}
    for name in SPEC_COUNTERS + TRACES:
        assert getattr(te, name) == getattr(je, name), name
    assert _plans(te) == _plans(je)
    assert padded_upload == je.upload_trace


def _lockstep(prompts, budgets=None, deadlines=None, faults=(),
              models=None, drafts=None, **serve):
    """Submits ``prompts`` (with ``budgets`` and, by index, ``deadlines``)
    to both engines (``_spec_engines``), arms ``faults`` ((tick, kind,
    slot) each) on both, and steps them in lockstep to the end, holding
    the state equal after every tick; ``kv.check()``, ``dkv.check()``,
    the prefix index and history == length on both."""
    from repro.serve import faults as jfaults
    from repro_torch.serve import faults as tfaults
    je, te = _spec_engines(models, drafts, **serve)
    if faults:
        for e, mod in ((je, jfaults), (te, tfaults)):
            e.install_faults(mod.FaultPlan([mod.FaultEvent(t, k, slot=i)
                                            for t, k, i in faults]))
    for n, p in enumerate(prompts):
        b = budgets[n] if budgets else None
        dl = (deadlines or {}).get(n)
        assert je.submit(p, b, dl) == te.submit(p, b, dl)
    row = (te.kv.max_blocks + 1) * 4
    padded = []
    while je.busy or te.busy:
        assert je.busy == te.busy
        te.sync_log = []
        je.step()
        te.step()
        if len(padded) < len(te.upload_trace):
            # the JAX engine pads each row sync to a power of two rows
            padded.append(te.upload_trace[-1] + sum(
                ((1 << (n - 1).bit_length()) - n) * row
                for n in te.sync_log))
        for e in (je, te):
            _check_tick(e)
            e.dkv.check()
        _same_spec_state(je, te, padded)
        assert te.ticks < 400, "engines failed to terminate"
    assert te.kv.live_pages == 0 and te.dkv.live_pages == 0
    return je, te


@pytest.mark.parametrize("spec_k", [1, 3])
def test_spec_engine_matches_jax_tick_for_tick(spec_k):
    """The JAX tests' four prompts, sharing on (nothing to share): both
    pools, the slots and the five counters equal after every tick."""
    prompts = _prompts()
    je, te = _lockstep(prompts, spec_k=spec_k, **DRIVE)
    assert te.spec_proposed > te.spec_accepted > 0
    assert te.results == _drive(prompts)[0]


def test_spec_engine_with_prefix_sharing_matches_jax():
    """Shared-prefix traffic (a 13-token head behind four tails, then two
    repeats): shares from mid-page bases, copy on write and retained
    adoptions on the target while the draft recomputes every shared
    token by catch-up, tick for tick as in the JAX engine."""
    rng = np.random.RandomState(17)
    head = rng.randint(1, 256, size=13)
    prompts = [np.concatenate([head, rng.randint(1, 256, size=n)])
               .astype(np.int32) for n in (3, 7, 1, 12)]
    prompts += [prompts[1].copy(), prompts[3].copy()]
    je, te = _lockstep(prompts, budgets=[6, 9, 5, 8, 7, 6], max_batch=3,
                       max_seq=64, page_size=4, spec_k=2)
    assert te.shared_tokens > 0 and te.kv.cow_copies > 0
    assert te.kv.retained_hits == je.kv.retained_hits
    alone = _drive(prompts, max_batch=1, max_seq=64, page_size=4,
                   max_new_tokens=9)
    assert [te.results[r] for r in range(6)] == \
        [alone[0][r][:b] for r, b in enumerate([6, 9, 5, 8, 7, 6])]


def test_preempt_mid_speculation_matches_jax():
    """The twin of tests/test_speculative.py::test_preempt_mid_
    speculation_bit_identical at a pool of five pages, where speculation
    preempts (at the JAX test's six it does not): both engines preempt,
    in lockstep, the victims' drafts rebuild by catch-up, and the output
    equals the uninterrupted speculative run's and plain greedy decode's
    at the same pool."""
    prompts = _prompts(n=4, seed=13)
    oracle, _ = _drive(prompts, spec_k=3, draft="slice")
    plain, _ = _drive(prompts, num_pages=5)
    je, te = _lockstep(prompts, spec_k=3, num_pages=5, **DRIVE)
    assert te.preemptions > 0 and je.preemptions > 0
    assert te.results == oracle == plain


def test_spec_engine_under_faults_matches_jax():
    """A poison, an evict and a deadline under speculation: the output
    guard checks every kept token of a verified window and quarantines
    the slot, the evicted request's draft rebuilds by catch-up, the
    deadline counts ticks; tick for tick as in the JAX engine."""
    je, te = _lockstep(_prompts(n=4, seed=19), deadlines={3: 9},
                       faults=[(4, "poison", 0), (7, "evict", 1)],
                       spec_k=3, **DRIVE)
    assert te.quarantines == je.quarantines == 1
    assert te.preemptions == je.preemptions >= 1
    assert te.deadline_exceeded == je.deadline_exceeded == 1


def test_launcher_spec_flags_cpu():
    """``--spec-k`` with ``--draft-arch`` on the CPU prints the accept
    rate and the draft and verify calls; the JAX launcher's argument
    checks and draft-pool capacity check refuse what they refuse."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))

    def launch(*flags):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve",
             "--local-smoke", "--device", "cpu", *flags], env=env,
            capture_output=True, text=True, timeout=300)

    res = launch("--spec-k", "3", "--draft-arch", "qwen2-0.5b")
    assert res.returncode == 0, res.stderr
    assert "speculative: draft=qwen2-0.5b k=3, accept rate" in res.stdout
    assert "verify dispatches" in res.stdout
    res = launch("--spec-k", "2")
    assert res.returncode == 2 and "needs --draft-arch" in res.stderr
    res = launch("--spec-k", "2", "--draft-arch", "qwen2-0.5b",
                 "--no-prefill-lane")
    assert res.returncode == 2 and "prefill lane" in res.stderr
    res = launch("--spec-k", "60", "--draft-arch", "qwen2-0.5b")
    assert res.returncode != 0 and "SpecCapacityError" in res.stderr
