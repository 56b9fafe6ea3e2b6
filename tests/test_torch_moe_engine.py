"""The port's engines serving MoE archs, in lockstep with the JAX engines,
on the CPU: llama4-scout and grok-1 ``.reduced()`` in f32, the weights
bridged bit-exact from the JAX tree.

The MoE's capacity counts every row of a call, idle slots, pad rows and
inactive decode slots among them (``models/moe.py``), so an MoE engine's
tokens depend on how it batches: with the prefill lane off, or under
speculation, the JAX engine itself gives other tokens than its default
path.  The port must give the JAX engine's tokens in each of those
configurations, drops included, and no identity between them is
asserted: ``test_batching_moves_moe_tokens`` pins that they differ.

  * ``PagedEngine`` with the default ServeConfig, with sharing off, and
    with ``prefill_lane=False``: grant plans, the page pool, slots,
    statuses, counters and tokens equal after every tick
    (``test_torch_overload``'s comparison), ``kv.check()`` and the prefix
    index every tick, drained clean.
  * ``spec_k=3`` with the target as its own draft: both pools, slots,
    the speculative counters and tokens equal after every tick.
  * ``ServingEngine``: ``generate_batch`` greedy, fused and legacy loop,
    equal to the JAX engine's tokens.
  * The launcher serves both archs on the CPU, paged and whole-batch.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.serve.engine import PagedEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import ServingEngine as TServingEngine

from test_torch_moe import GROK, LLAMA4, _models
from test_torch_overload import _engines, _finish, _step_both, _submit_both
from test_torch_speculative import _lockstep as _spec_lockstep
from torch_one_thread import _one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
ARCHS = [LLAMA4, GROK]
# five prompts of 5-40 tokens; four slots, page 8, three decode steps a
# tick, six new tokens
SERVE = dict(max_batch=4, max_seq=48, page_size=8, prefill_chunk=3,
             max_new_tokens=6)
MODES = {"default": {},
         "no-sharing": dict(prefix_sharing=False, retain_prefixes=False),
         "no-lane": dict(prefill_lane=False)}


def _prompts(vocab, n=5, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=ln).astype(np.int32)
            for ln in rng.randint(5, 41, size=n)]


def _vocab(arch):
    return _models(arch)[2].cfg.vocab_size


def _lockstep(arch, prompts, **serve):
    """Submits ``prompts`` (a tick after the first three) and drains both
    engines in lockstep, the state equal after every tick."""
    je, te = _engines(models=_models(arch), **serve)
    rids = []
    for n, p in enumerate(prompts):
        rids.append(_submit_both(je, te, p))
        if n == 2:
            assert _step_both(je, te) is None
    _finish(je, te)
    return je, te, rids


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_matches_jax_tick_for_tick(arch, mode):
    je, te, rids = _lockstep(arch, _prompts(_vocab(arch)),
                             **SERVE, **MODES[mode])
    res = [te.results[r] for r in rids]
    assert res == [je.results[r] for r in rids]
    assert all(len(t) == SERVE["max_new_tokens"] for t in res)
    if mode == "no-lane":
        assert te.forced_upload_bytes > 0 and te.prefill_upload_bytes == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_self_draft_matches_jax_tick_for_tick(arch):
    """``spec_k=3``, the target its own draft: the verify sees B x T rows
    where a decode step sees B, so capacity differs from plain decode;
    the port follows the JAX engine's speculative run tick for tick."""
    jm, jp, tm, tp = models = _models(arch)
    je, te = _spec_lockstep(_prompts(_vocab(arch)), models=models,
                            drafts=((jm, jp), (tm, tp)), spec_k=3, **SERVE)
    assert te.spec_proposed > 0
    assert te.results == je.results


@pytest.mark.parametrize("arch", ARCHS)
def test_batching_moves_moe_tokens(arch):
    """The designed divergence of the reference, on the port's engine
    (the tests above hold each configuration to the JAX engine's): with
    the lane off a prompt's rows ride decode steps of B rows instead of
    B x T-row chunks, and a verify sees B x T rows where a decode step
    sees B, so capacity drops other rows and some requests' tokens
    change; turning sharing off changes nothing on this traffic (no
    prefix is shared)."""
    _, _, tm, tp = _models(arch)
    prompts = _prompts(tm.cfg.vocab_size)
    out = {}
    for mode, kw in list(MODES.items()) + [("spec", dict(spec_k=3))]:
        draft = dict(draft_model=tm, draft_params=tp) if kw.get(
            "spec_k") else {}
        e = TPagedEngine(tm, tp, TServeConfig(**SERVE, **kw), **draft)
        rids = [e.submit(p) for p in prompts]
        e.run()
        out[mode] = [e.results[r] for r in rids]
    assert out["no-sharing"] == out["default"]
    for mode in ("no-lane", "spec"):
        assert out[mode] != out["default"], mode


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_matches_jax(arch):
    """Whole-batch ``generate_batch``, greedy, fused and legacy loop:
    prompts of 5, 17 and 9 tokens right-aligned with pad 0 (pad rows
    route too), six new tokens."""
    jm, jp, tm, tp = _models(arch)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, jm.cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 17, 9)]
    want = JServingEngine(jm, jp, JServeConfig(max_new_tokens=6)
                          ).generate_batch(prompts)
    for fused in (True, False):
        got = TServingEngine(tm, tp, TServeConfig(max_new_tokens=6)
                             ).generate_batch(prompts, fused=fused)
        assert got == want, fused
    assert all(len(o) == 6 for o in want)


@pytest.mark.parametrize("whole_batch", [False, True],
                         ids=["paged", "whole-batch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_moe_cpu(arch, whole_batch):
    """``launch.serve --local-smoke --device cpu`` serves both MoE archs
    (reduced), on the paged engine and whole-batch."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    extra = ["--whole-batch"] if whole_batch else []
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--local-smoke", "--device", "cpu", *extra], env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    want = ("generated 32 tokens across 4 requests" if whole_batch
            else "8 requests, 88 tokens")
    assert f"{arch}-reduced on cpu: {want}" in res.stdout
