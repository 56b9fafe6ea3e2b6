"""The port's PagedEngine against the JAX package's, end to end on the CPU.

Both engines serve the same prompts from the same weights (bridged bit-
exact from the JAX tree) with prefix sharing and retention off (their
default, on, is held in test_torch_prefix_sharing.py).  In f32
the greedy outputs must be token-identical and every tick's grant plan
equal, with the page-pool invariants clean after every tick; a bf16 run
holds a logit-drift bound.  Also: the launcher's CPU smoke, the features
the port refuses, an unknown preemption policy, and that no module of the
port (nor chip_smoke.py) imports JAX or the JAX package.
"""
import ast
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
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.params import params_from_jax
from repro_torch.serve.engine import PagedEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig

REPO = Path(__file__).resolve().parents[1]
SERVE = dict(max_batch=3, max_seq=48, max_new_tokens=6, page_size=4,
             prefill_chunk=3, prefill_chunk_tokens=8,
             prefix_sharing=False, retain_prefixes=False)


def _models(arch, dtype, seed=0):
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(), dtype=dtype)
    jm = jget_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jm, jp, tget_model(tcfg), tp


def _workload(vocab, seed=5):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=n).astype(np.int32), int(b))
            for n, b in zip(rng.randint(3, 21, size=6),
                            rng.randint(3, 8, size=6))]


def _drive(engine, work):
    """Run to completion; returns (results, per-tick (steps, prefill))."""
    plans = []
    plan = engine.scheduler.plan

    def recording_plan(*args, **kwargs):
        p = plan(*args, **kwargs)
        plans.append((p.steps.tolist(), p.prefill.tolist()))
        return p

    engine.scheduler.plan = recording_plan
    rids = [engine.submit(p, max_new_tokens=b) for p, b in work]
    while engine.busy:
        engine.step()
        engine.kv.check()
    return [engine.results[r] for r in rids], plans


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-8b", "granite-20b",
                                  "phi4-mini-3.8b"])
def test_engine_token_identical_to_jax_f32(arch):
    jm, jp, tm, tp = _models(arch, "float32")
    work = _workload(jm.cfg.vocab_size)
    want, want_plans = _drive(JPagedEngine(jm, jp, JServeConfig(**SERVE)),
                              work)
    got, got_plans = _drive(TPagedEngine(tm, tp, TServeConfig(**SERVE)),
                            work)
    assert got == want
    assert got_plans == want_plans
    assert all(len(o) == b for o, (_, b) in zip(got, work))


def test_bf16_logit_drift_bound():
    """bf16 rounds at other places in the two frameworks, so bf16 is held
    to a drift bound, not identity: over a prefill chunk and a decode
    step of the reduced granite, the logits of the two packages may differ
    by at most 8 bf16 ulps (8 * 2**-8) of the logit scale."""
    jm, jp, tm, tp = _models("granite-8b", "bfloat16")
    rng = np.random.RandomState(2)
    B, T, page, nb = 2, 8, 4, 4
    toks = rng.randint(0, jm.cfg.vocab_size, size=(B, T)).astype(np.int32)
    grants = np.array([T, 5], np.int32)
    table = np.arange(1, 1 + B * nb, dtype=np.int32).reshape(B, nb)
    jc = jm.init_paged_cache(B, nb, page, B * nb + 1)
    jc = dict(jc, table=jax.numpy.asarray(table))
    tc = tm.init_paged_cache(B, nb, page, B * nb + 1, "cpu")
    tc["table"] = torch.from_numpy(table)
    jl, jc = jm.prefill_step_paged(jp, jax.numpy.asarray(toks), jc,
                                   jax.numpy.asarray(grants))
    tl, tc = tm.prefill_step_paged(tp, torch.from_numpy(toks), tc,
                                   torch.from_numpy(grants))
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    jl2, _ = jm.decode_step_paged(jp, jax.numpy.asarray(nxt), jc)
    tl2, _ = tm.decode_step_paged(tp, torch.from_numpy(nxt), tc)
    for j, t in ((jl, tl), (jl2, tl2)):
        j = np.asarray(j, np.float32)
        drift = np.abs(t.numpy() - j).max()
        assert drift <= 8 * 2.0 ** -8 * np.abs(j).max(), drift


def test_cache_copy_on_write_matches_jax():
    """The ported COW path (share, reserve, rollback, one flush per tick,
    free with a pending copy) keeps the host state of the JAX cache and
    copies the same page rows."""
    from repro.serve.cache import PagedKVCache as JCache
    from repro_torch.serve.cache import PagedKVCache as TCache
    jm, _, tm, _ = _models("qwen2-0.5b", "float32")
    jc = JCache(jm, 3, 16, page_size=4)
    tc = TCache(tm, 3, 16, page_size=4, device="cpu")
    for c in (jc, tc):
        assert c.ensure(0, 6)                       # two pages
    rows = np.random.RandomState(0).randn(*tc.k.shape).astype(np.float32)
    jc.k = jax.numpy.asarray(rows)
    tc.k = torch.from_numpy(rows.copy())
    for c in (jc, tc):
        c.share(1, 0, 6)
        c.share(2, 0, 6)
        assert c.shared_blocks(1, 6, 9) == [1]
        assert c.cow_reserve(1, 1) and c.cow_reserve(2, 0)
        assert c.cow_rollback(2, 0) == 1
        assert c.cow_reserve(2, 1)
        c.check(allow_pending=True)
        assert c.cow_flush() == 2
        c.check()
        assert c.cow_reserve(2, 0)
        c.free_slot(2)                              # cancels the pending copy
        c.check()
    for name in ("table", "length", "refcount", "owned", "free",
                 "cow_copies", "cow_bytes", "page_bytes", "shared_pages"):
        assert np.array_equal(np.asarray(getattr(tc, name), dtype=object),
                              np.asarray(getattr(jc, name), dtype=object)), name
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))


@pytest.mark.parametrize("change", [
    dict(spec_k=2), dict(snapshot_every_ticks=3), dict(prefill_lane=False)])
def test_engine_refuses_unported_features(change, tmp_path, monkeypatch):
    """The port refuses no feature of the JAX engine any more; each case
    keeps the JAX engine's behaviour.  ``snapshot_every_ticks`` with no
    ``snapshot_dir`` builds an engine that serves and writes nothing, as
    the JAX engine does; speculation without a draft model raises the
    JAX engine's ``ValueError``; ``prefill_lane=False`` builds an engine
    with no lane.  Their own tests hold the three against the JAX engine
    (test_torch_snapshot.py, test_torch_speculative.py,
    test_torch_prefill_by_decode.py)."""
    _, _, tm, tp = _models("qwen2-0.5b", "float32")
    cfg = TServeConfig(**dict(SERVE, **change))
    if "snapshot_every_ticks" in change:
        monkeypatch.chdir(tmp_path)
        engine = TPagedEngine(tm, tp, cfg)
        engine.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=4)
        while engine.busy or engine.ticks < 2 * cfg.snapshot_every_ticks:
            engine.step()
        assert len(engine.results[0]) == 4
        assert engine.snapshots_written == 0
        assert engine._last_snapshot_tick == -1
        assert os.listdir(tmp_path) == []
    elif "spec_k" in change:
        with pytest.raises(ValueError, match="draft model"):
            TPagedEngine(tm, tp, cfg)
    else:
        assert TPagedEngine(tm, tp, cfg)._chunk_tokens == 0


def test_engine_refuses_unknown_preempt_policy():
    """An unknown ``preempt_policy`` raises ``ValueError``, as the JAX
    scheduler does, instead of passing unread."""
    _, _, tm, tp = _models("qwen2-0.5b", "float32")
    with pytest.raises(ValueError, match="preempt policy"):
        TPagedEngine(tm, tp, TServeConfig(**dict(SERVE,
                                                 preempt_policy="lifo")))


def test_launcher_local_smoke_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--local-smoke",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    assert "8 requests" in res.stdout


def _port_files():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax or any
    module of the JAX package, at any depth of the file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_port_import_loads_no_jax():
    """Importing every module of the port pulls in neither jax nor repro."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
