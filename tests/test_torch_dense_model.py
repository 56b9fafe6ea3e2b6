"""The port's whole-batch path against the JAX package's, on the CPU:
``lm_forward`` (prefill, train, hidden), ``lm_decode`` with its cache
rows, ``decode_many`` and ``ServingEngine`` — same weights, bridged
bit-exact from the JAX tree, on qwen2-0.5b and granite-8b ``.reduced()``.

Logits, hidden states and cache rows are held in f32 with rtol = atol =
1e-4, as for the paged path: two layers of f32 matmuls and the unembed
summed in another order in each framework.  Greedy tokens must be
identical, fused and legacy; temperature sampling cannot reproduce JAX's
threefry draws, so there the port's fused loop is held to its own legacy
loop.  Prompts are at most 32 tokens or multiples of 32: the reduced
configs' attention chunks are 32, and the JAX reference's chunked path
asserts that they divide the prompt.
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

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.models import transformer as jT
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as tT
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.params import map_schema, params_from_jax
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import ServingEngine as TServingEngine
from torch_one_thread import _one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["qwen2-0.5b", "granite-8b", "granite-20b", "phi4-mini-3.8b"]


def _models(arch, dtype="float32", seed=1):
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(), dtype=dtype)
    jm = jget_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    return jm, jp, tget_model(tcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _tokens(vocab, B, S, seed):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_schema_is_the_bridged_schema(arch):
    """The weight bridge builds the whole-batch path's parameters: the
    JAX dense schema and the port's agree leaf for leaf (shape and init
    kind), and ``params_from_jax`` checks every bridged leaf against it."""
    cfg = tconfigs.get(arch)
    jschema = jax.tree.map(lambda d: (tuple(d.shape), d.init),
                           jT.schema(jconfigs.get(arch)),
                           is_leaf=lambda x: hasattr(x, "init"))
    tschema = map_schema(lambda d: (d.shape, d.init), tT.schema(cfg))
    assert tschema == jschema
    _models(arch)          # params_from_jax checks every leaf against it


@pytest.mark.parametrize("S", [8, 64], ids=["direct", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_jax(arch, S):
    """Prefill (last-position f32 logits and every layer's K/V), train
    logits and hidden states, through the direct (S = 8) and the chunked
    flash reference (S = 64 over chunks of 32) attention paths."""
    jm, jp, tm, tp = _models(arch)
    B = 2
    toks = _tokens(jm.cfg.vocab_size, B, S, seed=S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)
    for mode in ("train", "hidden"):
        jout, jaux, _ = jT.lm_forward(jp, jm.cfg, jnp.asarray(toks),
                                      jnp.asarray(pos), mode=mode)
        tout, taux, parts = tT.lm_forward(tp, tm.cfg, torch.from_numpy(toks),
                                          torch.from_numpy(pos.copy()),
                                          mode=mode)
        assert parts is None and float(taux) == float(jaux) == 0.0
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_decode_matches_jax(arch):
    """Prefill scattered into a (L, B, S + 4, KV, hd) cache, then three
    decode steps with a per-slot window (start = [0, 3]): logits, the
    cache rows written in place at ``pos``, and ``pos``."""
    jm, jp, tm, tp = _models(arch)
    B, S = 2, 8
    toks = _tokens(jm.cfg.vocab_size, B, S, seed=4)
    _, jparts = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    _, tparts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jc = jm.init_cache(B, S + 4)
    tc = tm.init_cache(B, S + 4, "cpu")
    for name in ("k", "v"):
        jc[name] = jc[name].at[:, :, :S].set(jparts[name])
        tc[name][:, :, :S] = tparts[name]
    start = np.array([0, 3], np.int32)
    jc = dict(jc, pos=jnp.int32(S), start=jnp.asarray(start))
    tc["pos"] = torch.tensor(S, dtype=torch.int32)
    tc["start"] = torch.from_numpy(start)
    for step in range(3):
        nxt = _tokens(jm.cfg.vocab_size, B, 1, seed=10 + step)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == S + 3
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


def test_decode_many_matches_jax_with_eos():
    """The fused loop in f32, greedy, with a stop token taken from the run
    itself: tokens, pad emission after eos, and the done flags."""
    jm, jp, tm, tp = _models("granite-8b")
    B, S, n = 3, 8, 6
    toks = _tokens(jm.cfg.vocab_size, B, S, seed=6)
    feed = _tokens(jm.cfg.vocab_size, B, 1, seed=7)
    jl, jparts = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    free, _, _, _ = jm.decode_many(jp, jnp.asarray(feed), _jcache(
        jm, jparts, B, S, n), jax.random.key(0), num_steps=n)
    eos = int(np.asarray(free)[2, 0])             # slot 0 stops at step 2
    want, _, _, jdone = jm.decode_many(jp, jnp.asarray(feed), _jcache(
        jm, jparts, B, S, n), jax.random.key(0), num_steps=n, eos_id=eos,
        pad_id=7)
    _, tparts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    tc = tm.init_cache(B, S + n, "cpu")
    for name in ("k", "v"):
        tc[name][:, :, :S] = tparts[name]
    tc["pos"] = torch.tensor(S, dtype=torch.int32)
    got, tc, tdone = tm.decode_many(tp, torch.from_numpy(feed), tc, None,
                                    num_steps=n, eos_id=eos, pad_id=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
    assert (got[3:, 0] == 7).all() and int(tc["pos"]) == S + n


def _jcache(jm, parts, B, S, n):
    c = jm.init_cache(B, S + n)
    for name in ("k", "v"):
        c[name] = c[name].at[:, :, :S].set(parts[name])
    return dict(c, pos=jnp.int32(S))


def _prompts(vocab, lens, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("lens", [(5, 17, 9), (64, 40, 3)],
                         ids=["direct", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_engine_token_identical_to_jax(arch, lens):
    """``generate_batch`` in f32 greedy, fused and legacy loop, equals the
    JAX ``ServingEngine``'s tokens; prompts right-aligned with pad 0 and
    no pad mask on both sides (S = 17: direct attention; S = 64: the
    chunked flash reference)."""
    jm, jp, tm, tp = _models(arch)
    prompts = _prompts(jm.cfg.vocab_size, lens)
    want = JServingEngine(jm, jp, JServeConfig(max_new_tokens=6)
                          ).generate_batch(prompts)
    for fused in (True, False):
        got = TServingEngine(tm, tp, TServeConfig(max_new_tokens=6)
                             ).generate_batch(prompts, fused=fused)
        assert got == want, fused
    assert all(len(o) == 6 for o in want)


def test_batch_composition_changes_tokens_in_both_packages():
    """Both ``ServingEngine``s right-align prompts with pad 0 and no pad
    mask, so a short prompt's tokens depend on what it is batched with: a
    5-token prompt served alone and batched with a 17-token one gives
    different greedy tokens, the same in both packages (qwen2-0.5b
    reduced, f32).  A pad mask in the port would be a deliberate
    divergence from the reference and must change this test."""
    jm, jp, tm, tp = _models("qwen2-0.5b")
    short, long_ = _prompts(jm.cfg.vocab_size, (5, 17))
    outs = {}
    for name, batch in (("alone", [short]), ("batched", [short, long_])):
        want = JServingEngine(jm, jp, JServeConfig(max_new_tokens=6)
                              ).generate_batch(batch)
        got = TServingEngine(tm, tp, TServeConfig(max_new_tokens=6)
                             ).generate_batch(batch)
        assert got == want, name
        outs[name] = got[0]
    assert outs["alone"] != outs["batched"]


def test_serving_engine_eos_and_temperature_self_consistent():
    """With a stop token the outputs end at it, fused and legacy alike; at
    temperature 0.9 the fused loop and the legacy loop draw the same
    tokens from equally seeded generators."""
    _, _, tm, tp = _models("qwen2-0.5b")
    prompts = _prompts(tm.cfg.vocab_size, (6, 11, 30), seed=8)
    greedy = TServingEngine(tm, tp, TServeConfig(max_new_tokens=8)
                            ).generate_batch(prompts)
    eos = greedy[1][3]
    outs = [TServingEngine(tm, tp, TServeConfig(max_new_tokens=8,
                                                eos_id=eos)
                           ).generate_batch(prompts, fused=f)
            for f in (True, False)]
    assert outs[0] == outs[1]
    assert outs[0][1] == greedy[1][:greedy[1].index(eos) + 1]
    hot = [TServingEngine(tm, tp, TServeConfig(max_new_tokens=8,
                                               temperature=0.9, seed=4)
                          ).generate_batch(prompts, fused=f)
           for f in (True, False)]
    assert hot[0] == hot[1] and hot[0] != greedy


def test_benchmark_decode_runs():
    _, _, tm, tp = _models("qwen2-0.5b")
    res = TServingEngine(tm, tp, TServeConfig()).benchmark_decode(
        batch=2, seq=32, steps=4)
    assert res["s_per_step_fused"] > 0 and res["s_per_step_loop"] > 0
    assert res["tokens_per_s"] == res["tokens_per_s_fused"]


@pytest.mark.parametrize("extra", [[], ["--legacy-loop"]],
                         ids=["fused", "legacy"])
def test_launcher_whole_batch_cpu(extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--local-smoke",
         "--device", "cpu", "--whole-batch", *extra], env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    mode = "legacy per-token loop" if extra else "fused decode_many"
    assert f"generated 32 tokens across 4 requests ({mode})" in res.stdout


def test_launcher_refuses_legacy_loop_without_whole_batch():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--local-smoke",
         "--device", "cpu", "--legacy-loop"], env=env, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 2 and "--whole-batch" in res.stderr
