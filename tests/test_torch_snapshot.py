"""Crash-consistent snapshots and kill-and-recover in the port's paged
engine (``repro_torch/serve/snapshot.py``) against the JAX package's, on
the CPU.

f32, the reduced qwen2-0.5b with its weights bridged from the JAX tree
(tests/test_torch_overload.py's ``_models``), at the sizes of
tests/test_snapshot_props.py, whose schedule (``_make_items``, submitted
on the engine's own tick counter by ``_run_schedule``) every drive here
uses.  Held:

  * lockstep: the two engines under the same schedule and the same
    recoverable ``FaultPlan.random``, snapshotting at the same ticks;
    each pair of files, both decoded by the JAX package's
    ``load_snapshot``, has equal state JSON (but for the RNG arrays and
    the fingerprint's ``package``, and the two upload counters, which the
    JAX engine pads to a power of two rows), exact tables, lengths,
    refcounts, ``retained_refs`` and feed, and pools within rtol = atol
    = 1e-5 on every page but the null page 0 (no request reads it; the
    idle steps of both packages write there differently).  The caches'
    ``page_bytes`` and ``cow_bytes`` are equal every tick;
  * the twins of every snapshot case of tests/test_snapshot_props.py
    (roundtrip, kill-restore fuzz, int8 with speculation, no prefix
    sharing, cold recovery, truncation, prune, fingerprint mismatch):
    each recovered port run gives the tokens and terminal statuses of
    the JAX engine's uninterrupted run;
  * bf16 pools round-trip byte for byte (and decode to the same bits in
    the JAX package); a temperature > 0 restore continues exactly as the
    uninterrupted port run; each package refuses the other's snapshot
    with its own ``SnapshotMismatchError`` naming ``package``;
  * the launcher's ``--snapshot-every``/``--snapshot-dir``/
    ``--restore-from``: their argument errors, the fingerprint check
    before the engine is built, and a restore that finishes the run.
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

from repro.serve import faults as jfaults
from repro.serve import snapshot as jsnap
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.models.model import get_model as tget_model
from repro_torch.serve import faults as tfaults
from repro_torch.serve import snapshot as tsnap
from repro_torch.serve.engine import PagedEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import TERMINAL_STATUSES
from repro_torch.serve.faults import (RECOVERABLE_KINDS, EngineKilled,
                                      FaultEvent, FaultPlan)

from test_paged_cache_props import _assert_drained_clean, _check_tick
from test_snapshot_props import BUDGETS, _make_items, _run_schedule
from test_torch_overload import _models
from test_torch_speculative import _drafts

REPO = Path(__file__).resolve().parents[1]
POOL_TOL = 1e-5                  # rtol = atol: f32 K/V of the two packages
POOLS = ("k", "v", "k_scale", "v_scale")
RNG = {"engine.key", "engine.dkey", "engine.generator", "engine.dgenerator"}
PADDED = ("table_upload_bytes", "upload_bytes")


def _serve(snap_dir, *, every=2, spec_k=0, prefix_sharing=True):
    """tests/test_snapshot_props.py's ``_mk`` config."""
    return dict(max_batch=3, max_seq=48, page_size=4, num_pages=8,
                prefill_chunk=3, max_new_tokens=max(BUDGETS), spec_k=spec_k,
                prefix_sharing=prefix_sharing,
                snapshot_every_ticks=every if snap_dir else 0,
                snapshot_dir=snap_dir or "")


def _port(snap_dir, *, kv_dtype="bf16", spec=False, **kw):
    _, _, tm, tp = _models(kv_dtype)
    dm, dp = _drafts(kv_dtype)[1] if spec else (None, None)
    return TPagedEngine(tm, tp, TServeConfig(**_serve(
        snap_dir, spec_k=2 if spec else 0, **kw)),
        draft_model=dm, draft_params=dp)


def _jax(snap_dir, *, kv_dtype="bf16", spec=False, **kw):
    jm, jp, _, _ = _models(kv_dtype)
    dm, dp = _drafts(kv_dtype)[0] if spec else (None, None)
    return JPagedEngine(jm, jp, JServeConfig(**_serve(
        snap_dir, spec_k=2 if spec else 0, **kw)),
        draft_model=dm, draft_params=dp)


def _plan_events(faults_mod, seed):
    return faults_mod.FaultPlan.random(seed, n_events=4, max_tick=20,
                                       max_batch=3, max_pages=3,
                                       max_duration=3,
                                       kinds=RECOVERABLE_KINDS).events


def _items(seed, **kw):
    return _make_items(_models()[0], seed, **kw)


def _jax_oracle(seed, items, *, with_faults=True, **kw):
    """The JAX engine's uninterrupted run of the schedule under the
    recoverable plan."""
    je = _jax(None, **kw)
    je.install_faults(jfaults.FaultPlan(
        list(_plan_events(jfaults, seed)) if with_faults else []))
    _run_schedule(je, items)
    return je


def _drive_with_recovery(mk, items, plan, snap_dir):
    """tests/test_snapshot_props.py's recovery protocol on the port: on
    ``EngineKilled`` restore the newest intact snapshot into a fresh
    engine (cold when none landed), re-arm the plan without the fired
    kills, drive on.  Returns (engine, kills, restores)."""
    pe = mk()
    pe.install_faults(plan)
    kills = restores = 0
    while True:
        try:
            _run_schedule(pe, items)
            return pe, kills, restores
        except EngineKilled as e:
            tick = e.tick
        kills += 1
        assert kills < 10, "kill storm: recovery never converged"
        latest = tsnap.latest_snapshot(snap_dir)
        pe = mk()
        if latest is not None:
            tsnap.restore_engine(pe, latest)
            restores += 1
        plan = plan.without_kills_through(tick)
        pe.install_faults(plan)


def _same_runs(got, want, label):
    """Same rids, the same terminal status and tokens per rid."""
    assert set(got.results) == set(want.results), f"{label}: rid sets"
    for rid in sorted(want.results):
        assert got.status[rid] in TERMINAL_STATUSES, f"{label} rid={rid}"
        assert got.status[rid].value == want.status[rid].value, \
            f"{label} rid={rid}: status"
        assert list(got.results[rid]) == list(want.results[rid]), \
            f"{label} rid={rid}: tokens"


def _kill_restore_case(tmp_path, seed, *, kill_ticks, with_faults=True,
                       every=2, **kw):
    """One seeded kill-and-recover drill of the port against the JAX
    engine's uninterrupted run."""
    items = _items(seed)
    oracle = _jax_oracle(seed, items, with_faults=with_faults, **kw)
    recoverable = list(_plan_events(tfaults, seed)) if with_faults else []
    plan = FaultPlan(recoverable + [FaultEvent(t, "kill")
                                    for t in kill_ticks])
    snap_dir = str(tmp_path)
    pe, kills, restores = _drive_with_recovery(
        lambda: _port(snap_dir, every=every, **kw), items, plan, snap_dir)
    assert kills == len(kill_ticks), "a scheduled kill never fired"
    _same_runs(pe, oracle, f"seed={seed}")
    pe.kv.check()
    if pe.dkv is not None:
        pe.dkv.check()
    _assert_drained_clean(pe)
    return pe, restores


# ---------------------------------------------------------------------------
# lockstep with the JAX engine: the same snapshots, tick for tick
# ---------------------------------------------------------------------------

def _same_snapshot(jpath, tpath):
    """The port's file against the JAX engine's, both decoded by the JAX
    package's ``load_snapshot`` (see the module docstring)."""
    jh, js, ja = jsnap.load_snapshot(jpath)
    th, ts, ta = jsnap.load_snapshot(tpath)
    assert th["tick"] == jh["tick"]
    fp = dict(th["fingerprint"])
    assert fp.pop("package") == "repro_torch"
    assert fp == jh["fingerprint"]
    jeng, teng = dict(js["engine"]), dict(ts["engine"])
    jc, tc = dict(jeng.pop("counters")), dict(teng.pop("counters"))
    for name in PADDED:                  # rows really uploaded vs padded
        assert tc.pop(name) <= jc.pop(name), name
    assert tc == jc
    assert teng == jeng
    assert ts["kv"] == js["kv"]
    assert ts["dkv"] == js["dkv"]
    assert [m for m in ts["arrays"] if m["name"] not in RNG] == \
        [m for m in js["arrays"] if m["name"] not in RNG]
    assert {n for n in ta if n in RNG} == \
        ({"engine.generator", "engine.dgenerator"} if ts["dkv"]
         else {"engine.generator"})
    for name, want in ja.items():
        if name in RNG:
            continue
        got = ta[name]
        if name.split(".")[1] in POOLS:
            np.testing.assert_allclose(got[:, 1:], want[:, 1:],
                                       rtol=POOL_TOL, atol=POOL_TOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    return th["tick"]


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_lockstep_snapshots_match_jax(tmp_path, spec):
    """Both engines under test_snapshot_props's schedule (seed 1) with
    its first four prompts repeated two ticks later and the fourth once
    more at tick 24 (live shares, a copy on write, retained adoptions),
    and its recoverable plan (preemptions), a snapshot every 2 ticks:
    every pair of files holds the same state (with ``spec`` a 1-layer
    draft and its pool too), and the caches' byte counters agree every
    tick."""
    seed = 1
    base = _items(seed)
    items = sorted(base + [(at + 2, p, b) for at, p, b in base[:4]]
                   + [(24, base[3][1], base[3][2])], key=lambda it: it[0])
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    je, te = _jax(jdir, spec=spec), _port(tdir, spec=spec)
    je.install_faults(jfaults.FaultPlan(list(_plan_events(jfaults, seed))))
    te.install_faults(FaultPlan(list(_plan_events(tfaults, seed))))
    compared = []
    for _ in range(400):
        for e in (je, te):
            while e._next_rid < len(items) \
                    and items[e._next_rid][0] <= e.ticks:
                _, p, b = items[e._next_rid]
                e.submit(p, b)
        if not je.busy and je._next_rid >= len(items) and not je._squeezed:
            break
        je.step()
        te.step()
        for e in (je, te):
            _check_tick(e)
        for a, b in ((je.kv, te.kv), (je.dkv, te.dkv)):
            if a is not None:
                assert (b.page_bytes, b.cow_bytes) == \
                    (a.page_bytes, a.cow_bytes)
        assert te._last_snapshot_tick == je._last_snapshot_tick
        if je._last_snapshot_tick == je.ticks:
            compared.append(_same_snapshot(
                jsnap.snapshot_path(jdir, je.ticks),
                tsnap.snapshot_path(tdir, te.ticks)))
    assert not te.busy and te.snapshots_written == je.snapshots_written
    assert len(compared) >= 8 and compared == list(
        range(2, 2 * len(compared) + 1, 2))
    assert te.kv.cow_copies and te.kv.retained_hits and te.preemptions
    _same_runs(te, je, "lockstep")


# ---------------------------------------------------------------------------
# twins of tests/test_snapshot_props.py
# ---------------------------------------------------------------------------

def test_snapshot_roundtrip_continue_identical(tmp_path):
    """A mid-flight snapshot; the original engine and a fresh restore
    both drain: the same tokens and statuses as each other and as the
    JAX engine's run, and the restored pool sane at once."""
    items = _items(42, n=5, last_tick=1)
    pe = _port(None)
    for _, p, b in items:
        pe.submit(p, b)
    for _ in range(4):
        pe.step()
        _check_tick(pe)
    path = tsnap.snapshot_path(str(tmp_path), pe.ticks)
    tsnap.save_snapshot(pe, path)
    fresh = tsnap.restore_engine(_port(None), path)
    assert (fresh.ticks, fresh._next_rid) == (pe.ticks, pe._next_rid)
    _check_tick(fresh)
    _run_schedule(pe, items)
    _run_schedule(fresh, items)
    _same_runs(fresh, pe, "roundtrip")
    _same_runs(fresh, _jax_oracle(42, items, with_faults=False),
               "roundtrip vs jax")
    _assert_drained_clean(fresh)


@pytest.mark.parametrize("seed", [0, 1])
def test_kill_restore_fuzz(tmp_path, seed):
    """Sharing on, a random recoverable plan and one kill after a
    snapshot exists: recovery restores from disk and matches the JAX
    engine's uninterrupted run."""
    _, restores = _kill_restore_case(tmp_path, seed, kill_ticks=(9,))
    assert restores == 1


def test_kill_restore_int8_speculative(tmp_path):
    """int8 target and draft pools (rows and scales), speculation in
    flight, two kills: the second lands on the restored engine."""
    pe, restores = _kill_restore_case(tmp_path, 5, kill_ticks=(7, 13),
                                      kv_dtype="int8", spec=True)
    assert pe.kv.quantized and pe.dkv.quantized
    assert restores >= 1


def test_kill_restore_no_prefix_sharing(tmp_path):
    """Sharing off: the restored prefix index stays empty."""
    pe, _ = _kill_restore_case(tmp_path, 3, kill_ticks=(8,),
                               prefix_sharing=False)
    assert not pe._pindex._map


def test_kill_before_first_snapshot_cold_recovery(tmp_path):
    """A kill at tick 1 with a cadence of 50: no snapshot exists, so
    recovery cold-starts and resubmits everything."""
    _, restores = _kill_restore_case(tmp_path, 7, kill_ticks=(1,),
                                     with_faults=False, every=50)
    assert restores == 0


def test_truncated_snapshot_detected_and_skipped(tmp_path):
    """Every truncation point (magic, header, state JSON, array bytes)
    raises ``SnapshotCorruptError`` and ``latest_snapshot`` falls back to
    the previous file, which restores."""
    pe = _port(None)
    for _, p, b in _items(9, n=3, last_tick=1):
        pe.submit(p, b)
    for _ in range(2):
        pe.step()
    good = tsnap.snapshot_path(str(tmp_path), 1)
    newer = tsnap.snapshot_path(str(tmp_path), 2)
    tsnap.save_snapshot(pe, good)
    tsnap.save_snapshot(pe, newer)
    assert tsnap.latest_snapshot(str(tmp_path)) == newer
    blob = open(newer, "rb").read()
    for cut in (4, 24, len(blob) // 2, len(blob) - 3):
        with open(newer, "wb") as f:
            f.write(blob[:cut])
        with pytest.raises(tsnap.SnapshotCorruptError):
            tsnap.load_snapshot(newer)
        assert tsnap.latest_snapshot(str(tmp_path)) == good, cut
    flipped = bytearray(blob)
    flipped[-1] ^= 1
    with open(newer, "wb") as f:
        f.write(bytes(flipped))
    with pytest.raises(tsnap.SnapshotCorruptError, match="checksum"):
        tsnap.load_snapshot(newer)
    assert tsnap.restore_engine(_port(None), good).ticks == pe.ticks


def test_prune_keeps_newest(tmp_path):
    pe = _port(None)
    pe.submit(np.arange(3, dtype=np.int32), 3)
    pe.step()
    for t in (1, 2, 3, 4):
        tsnap.save_snapshot(pe, tsnap.snapshot_path(str(tmp_path), t))
    removed = tsnap.prune_snapshots(str(tmp_path), keep=2)
    assert [os.path.basename(r) for r in removed] == \
        ["snap-00000001.bin", "snap-00000002.bin"]
    assert sorted(os.listdir(tmp_path)) == \
        ["snap-00000003.bin", "snap-00000004.bin"]


def test_fingerprint_mismatch_typed(tmp_path):
    pe = _port(None)
    pe.submit(np.arange(3, dtype=np.int32), 3)
    pe.step()
    path = tsnap.save_snapshot(pe, tsnap.snapshot_path(str(tmp_path), 1))
    _, _, tm, tp = _models()
    other = TPagedEngine(tm, tp, TServeConfig(
        max_batch=2, max_seq=64, page_size=4, num_pages=8,
        prefill_chunk=3, max_new_tokens=max(BUDGETS)))
    with pytest.raises(tsnap.SnapshotMismatchError) as ei:
        tsnap.restore_engine(other, path)
    assert "max_batch" in str(ei.value) and "max_seq" in str(ei.value)


# ---------------------------------------------------------------------------
# the port's own: bf16 bytes, sampling, across packages
# ---------------------------------------------------------------------------

def test_bf16_pools_roundtrip_byte_for_byte(tmp_path):
    """bf16 pools travel as their 16-bit patterns under the dtype name
    ``bfloat16``: restored bit for bit, decoded to the same bits by the
    JAX package, and the restored engine drains as the original."""
    cfg = dataclasses.replace(tconfigs.get("qwen2-0.5b").reduced(),
                              dtype="bfloat16")
    model = tget_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen, "cpu")
    serve = TServeConfig(**_serve(None))
    pe = TPagedEngine(model, params, serve)
    items = _items(4, n=5, last_tick=1)
    for _, p, b in items:
        pe.submit(p, b)
    for _ in range(3):
        pe.step()
    assert pe.kv.k.dtype == torch.bfloat16 and pe.kv.k.abs().sum() > 0
    path = tsnap.save_snapshot(pe, tsnap.snapshot_path(str(tmp_path), 3))
    _, state, jarrays = jsnap.load_snapshot(path)
    assert {m["name"]: m["dtype"] for m in state["arrays"]}["kv.k"] == \
        "bfloat16"
    fresh = tsnap.restore_engine(TPagedEngine(model, params, serve), path)
    for name in ("k", "v"):
        bits = getattr(pe.kv, name).view(torch.int16)
        assert torch.equal(getattr(fresh.kv, name).view(torch.int16), bits)
        np.testing.assert_array_equal(
            np.asarray(jarrays[f"kv.{name}"]).view(np.int16), bits.numpy())
    _run_schedule(pe, items)
    _run_schedule(fresh, items)
    _same_runs(fresh, pe, "bf16")


def test_temperature_restore_continues_identically(tmp_path):
    """Temperature 0.8: the generator's state travels in the snapshot,
    so a restore samples on exactly as the uninterrupted port run does
    (sampled tokens are the port's own: the JAX engine draws from a
    threefry key)."""
    items = _items(11, n=5, last_tick=2)
    runs = []
    for temperature in (0.8, 0.0):
        _, _, tm, tp = _models()
        serve = TServeConfig(**dict(_serve(None), temperature=temperature))
        pe = TPagedEngine(tm, tp, serve)
        for _ in range(4):
            _run_schedule_ticks(pe, items, 1)
        path = tsnap.save_snapshot(pe, tsnap.snapshot_path(
            str(tmp_path / str(temperature)), pe.ticks))
        fresh = tsnap.restore_engine(TPagedEngine(tm, tp, serve), path)
        _run_schedule(pe, items)
        _run_schedule(fresh, items)
        _same_runs(fresh, pe, f"temperature={temperature}")
        runs.append(pe.results)
    assert runs[0] != runs[1], "temperature 0.8 sampled the greedy tokens"


def _run_schedule_ticks(pe, items, n):
    """``n`` ticks of ``_run_schedule``'s loop."""
    for _ in range(n):
        while pe._next_rid < len(items) \
                and items[pe._next_rid][0] <= pe.ticks:
            _, p, b = items[pe._next_rid]
            pe.submit(p, b)
        pe.step()
        _check_tick(pe)


def test_cross_package_restore_refused(tmp_path):
    """Each package decodes the other's file (one container), and each
    refuses to restore it with its own ``SnapshotMismatchError`` naming
    ``package``."""
    items = _items(2, n=3, last_tick=1)
    je, te = _jax(None), _port(None)
    for e in (je, te):
        for _, p, b in items:
            e.submit(p, b)
        e.step()
        e.step()
    jpath = jsnap.save_snapshot(je, str(tmp_path / "jax.bin"))
    tpath = tsnap.save_snapshot(te, str(tmp_path / "port.bin"))
    assert tsnap.load_snapshot(jpath)[0]["tick"] == 2
    assert jsnap.load_snapshot(tpath)[0]["tick"] == 2
    with pytest.raises(tsnap.SnapshotMismatchError, match="package"):
        tsnap.restore_engine(_port(None), jpath)
    with pytest.raises(jsnap.SnapshotMismatchError, match="package"):
        jsnap.restore_engine(_jax(None), tpath)


# ---------------------------------------------------------------------------
# the launcher's snapshot flags
# ---------------------------------------------------------------------------

def _launch(*args, cwd=None):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--local-smoke",
         "--device", "cpu", *args], env=env, capture_output=True,
        text=True, timeout=300, cwd=cwd)


@pytest.mark.parametrize("args,msg", [
    (["--snapshot-every", "-1"], "--snapshot-every must be >= 0"),
    (["--snapshot-every", "2"], "needs --snapshot-dir"),
    (["--restore-from", "snap.bin", "--whole-batch"], "--whole-batch"),
], ids=["negative", "no-dir", "whole-batch"])
def test_launcher_snapshot_flag_errors(args, msg):
    res = _launch(*args)
    assert res.returncode == 2 and msg in res.stderr, res.stderr


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """One launcher run writing snapshots every 3 ticks; its output and
    the snapshot files left after pruning."""
    d = tmp_path_factory.mktemp("snaps")
    res = _launch("--snapshot-every", "3", "--snapshot-dir", str(d))
    assert res.returncode == 0, res.stderr
    return res.stdout, tsnap.list_snapshots(str(d))


def test_launcher_restore_finishes_the_run(launched):
    """A restore of the older of the two kept snapshots serves its
    in-flight work to the end: the same requests and token count."""
    out, snaps = launched
    assert "snapshots: " in out and len(snaps) == 2
    res = _launch("--restore-from", snaps[0])
    assert res.returncode == 0, res.stderr
    assert "restored tick" in res.stdout
    summary = [ln.split(": ", 1)[1].split(" joins")[0]
               for ln in (out + res.stdout).splitlines()
               if " on cpu: " in ln]
    assert len(summary) == 2 and summary[0] == summary[1], summary


def test_launcher_restore_fingerprint_fast_fail(launched):
    """A snapshot against other flags fails with the typed error naming
    the knob before the engine is built (no pool line printed)."""
    _, snaps = launched
    res = _launch("--restore-from", snaps[-1], "--batch", "3")
    assert res.returncode != 0
    assert "SnapshotMismatchError" in res.stderr
    assert "max_batch" in res.stderr
    assert "pool:" not in res.stdout
