"""The port's Mamba1 LM (falcon-mamba-7b) against the JAX package's, on
the CPU: schema and bridged weights, ``lm_forward``, ``lm_decode`` and
whole-batch serving through ``ServingEngine`` — same weights, bridged
bit-exact from the JAX tree, at ``.reduced()`` size in f32.

Logits and states are held with rtol = atol = 1e-4, as the port's dense
model is (two layers of f32 matmuls summed in another order in each
framework); greedy tokens must be identical.

The held reference for serving is the JAX package's own step-by-step
decode (``Model.decode_step`` fed the right-aligned, zero-padded prompt
rows one token at a time from a zero cache), not its ``ServingEngine``:
that engine gets no SSM cache parts from its prefill and decodes from a
zero state, as if the prompt had never been seen.  Its first token comes
from the prefill logits and agrees; the test below pins the zero state.
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
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.models import transformer as tT
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.params import init_params, map_schema, \
    params_from_jax
from repro_torch.serve.engine import PagedEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import ServingEngine as TServingEngine

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "falcon-mamba-7b"


def _models(dtype="float32", seed=1):
    jcfg = dataclasses.replace(jconfigs.get(ARCH).reduced(), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get(ARCH).reduced(), dtype=dtype)
    jm = jget_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    return jm, jp, tget_model(tcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def models():
    return _models()


def _right_aligned(prompts):
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    return toks


def _prompts(vocab, lens, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).astype(np.int32) for n in lens]


def _jax_stepwise(jm, jp, toks, n_new):
    """The JAX package's decode stepped over the rows ``toks`` (B, S) from
    a zero cache, then ``n_new - 1`` greedy steps.  Returns (tokens (n_new,
    B), the cache after the prompt, the logits at its last position)."""
    B, S = toks.shape
    dec = jax.jit(jm.decode_step)
    cache = jm.init_cache(B, S + n_new)
    for t in range(S):
        logits, cache = dec(jp, jnp.asarray(toks[:, t:t + 1]), cache)
    after_prompt = jax.tree.map(np.asarray, cache)
    last = np.asarray(logits)
    out = [np.argmax(last, -1).astype(np.int32)]
    for _ in range(n_new - 1):
        logits, cache = dec(jp, jnp.asarray(out[-1][:, None]), cache)
        out.append(np.asarray(jnp.argmax(logits, -1)).astype(np.int32))
    return np.stack(out), after_prompt, last


def test_ssm_schema_is_the_bridged_schema():
    """The JAX Mamba1 schema and the port's agree leaf for leaf (shape and
    init kind) at full size, and the bridge checks every leaf of the
    reduced model against it."""
    jschema = jax.tree.map(lambda d: (tuple(d.shape), d.init),
                           jT.schema(jconfigs.get(ARCH)),
                           is_leaf=lambda x: hasattr(x, "init"))
    tschema = map_schema(lambda d: (d.shape, d.init),
                         tT.schema(tconfigs.get(ARCH)))
    assert tschema == jschema
    assert set(tschema["blocks"]) == {"ln1", "mixer"}
    _models()


def test_init_params_ssm_kinds():
    """``ssm_a`` is log(1..N) on every channel, as in the JAX package, and
    ``ssm_dt`` puts softplus(dt_bias) in [1e-3, 1e-1]; shapes and dtypes
    are the JAX abstract tree's."""
    cfg = tconfigs.get(ARCH).reduced()
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jcfg = jconfigs.get(ARCH).reduced()
    jp = jget_model(jcfg).init(jax.random.key(0))
    mix, jmix = p["blocks"]["mixer"], jp["blocks"]["mixer"]
    assert mix["A_log"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        mix["A_log"].float().numpy(),
        np.asarray(jmix["A_log"].astype(jnp.float32)))
    dt = torch.nn.functional.softplus(mix["dt_bias"].float())
    assert dt.min() > 0.9e-3 and dt.max() < 1.1e-1
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), p)
    assert got == want


@pytest.mark.parametrize("S", [3, 20])
def test_lm_forward_matches_jax(models, S):
    """Prefill (last-position f32 logits), train logits and hidden states;
    the prefill's cache parts (the JAX prefill returns None) against the
    JAX decode's state after stepping over the same tokens."""
    jm, jp, tm, tp = models
    B = 2
    toks = np.random.RandomState(S).randint(0, 256, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    jl, jparts = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    assert jparts is None
    tl, tparts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _, stepped, slast = _jax_stepwise(jm, jp, toks, 1)
    np.testing.assert_allclose(tl.numpy(), slast, **TOL)
    for name in ("conv", "ssm"):
        assert tuple(tparts[name].shape) == stepped[name].shape
        np.testing.assert_allclose(tparts[name].numpy(), stepped[name],
                                   **TOL)
    for mode in ("train", "hidden"):
        jout, _, _ = jT.lm_forward(jp, jm.cfg, jnp.asarray(toks),
                                   jnp.asarray(pos), mode=mode)
        tout, taux, parts = tT.lm_forward(tp, tm.cfg, torch.from_numpy(toks),
                                          torch.from_numpy(pos.copy()),
                                          mode=mode)
        assert parts is None and float(taux) == 0.0
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


def test_lm_decode_matches_jax(models):
    """Three decode steps from the same state on both sides: logits, the
    conv and ssm states (updated in place in the port) and ``pos``."""
    jm, jp, tm, tp = models
    B, S = 2, 6
    toks = np.random.RandomState(4).randint(0, 256, (B, S)).astype(np.int32)
    _, jc, _ = _jax_stepwise(jm, jp, toks, 1)
    tc = tm.init_cache(B, S + 4, "cpu")
    for name in ("conv", "ssm"):
        tc[name].copy_(torch.from_numpy(np.array(jc[name])))
    tc["pos"] = torch.tensor(S, dtype=torch.int32)
    ssm_buf = tc["ssm"]
    jc = jax.tree.map(jnp.asarray, jc)
    for step in range(3):
        nxt = np.random.RandomState(10 + step).randint(0, 256, (B, 1)
                                                       ).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["ssm"] is ssm_buf and tc["ssm"].dtype == torch.float32
    assert int(tc["pos"]) == int(jc["pos"]) == S + 3
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


@pytest.mark.parametrize("lens", [(5, 12, 9), (1, 2), (17, 3, 8, 11)],
                         ids=["ragged", "shorter-than-conv", "four"])
def test_serving_engine_matches_jax_stepwise(models, lens):
    """``generate_batch`` greedy, fused and legacy loop, equals the JAX
    package's decode stepped over the same right-aligned padded rows
    (pads go through the state on both sides, as there is no pad mask)."""
    jm, jp, tm, tp = models
    prompts = _prompts(256, lens)
    want, _, _ = _jax_stepwise(jm, jp, _right_aligned(prompts), 6)
    want = [list(map(int, want[:, i])) for i in range(len(prompts))]
    for fused in (True, False):
        got = TServingEngine(tm, tp, TServeConfig(max_new_tokens=6)
                             ).generate_batch(prompts, fused=fused)
        assert got == want, fused


def test_reference_engine_drops_the_prompt_state(models):
    """The JAX ``ServingEngine``'s fault, pinned: after its
    ``_prefill_cache`` the conv and ssm caches are all zeros, while the
    port's equal the JAX decode's state after stepping over the prompt.
    So the JAX engine's first token (from the prefill logits) is the
    stepwise reference's and the port's, and every later one here is
    not."""
    jm, jp, tm, tp = models
    prompts = _prompts(256, (7, 12, 4), seed=5)
    toks = _right_aligned(prompts)
    _, stepped, _ = _jax_stepwise(jm, jp, toks, 1)
    jeng = JServingEngine(jm, jp, JServeConfig(max_new_tokens=4))
    _, jcache = jeng._prefill_cache(prompts, 4)
    assert not np.asarray(jcache["ssm"]).any()
    assert not np.asarray(jcache["conv"]).any()
    assert np.abs(stepped["ssm"]).max() > 1e-3
    teng = TServingEngine(tm, tp, TServeConfig(max_new_tokens=4))
    _, tcache = teng._prefill_cache(prompts, 4)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tcache[name].numpy(), stepped[name],
                                   **TOL)
    want, _, _ = _jax_stepwise(jm, jp, toks, 4)
    want = [list(map(int, want[:, i])) for i in range(len(prompts))]
    jout = jeng.generate_batch(prompts)
    tout = teng.generate_batch(prompts)
    assert tout == want
    assert [o[0] for o in jout] == [o[0] for o in want]
    assert all(j[1:] != w[1:] for j, w in zip(jout, want))


def test_serving_engine_bf16_fused_equals_legacy():
    """In the serving dtype (bf16 weights and conv state, f32 scan state)
    the two loops give the same in-vocab tokens; ``benchmark_decode`` runs
    on the SSM cache."""
    _, _, tm, tp = _models(dtype="bfloat16", seed=6)
    prompts = _prompts(256, (9, 3, 14), seed=7)
    eng = TServingEngine(tm, tp, TServeConfig(max_new_tokens=5))
    fused = eng.generate_batch(prompts)
    assert fused == eng.generate_batch(prompts, fused=False)
    assert all(len(o) == 5 and all(0 <= t < 256 for t in o) for o in fused)
    _, cache = eng._prefill_cache(prompts, 5)
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
    res = eng.benchmark_decode(batch=2, seq=32, steps=4)
    assert res["s_per_step_fused"] > 0 and res["s_per_step_loop"] > 0


def test_paged_path_refuses_ssm(models):
    """The paged engine and the paged model functions refuse an SSM arch,
    naming the JAX package's own refusal."""
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="JAX package"):
        TPagedEngine(tm, tp, TServeConfig(prefix_sharing=False,
                                          retain_prefixes=False))
    with pytest.raises(ValueError, match="PagedEngine refuses SSM"):
        tm.init_paged_cache(2, 4, 4, 9, "cpu")
    cache = {"length": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="whole-batch"):
        tm.decode_step_paged(tp, torch.zeros((2, 1), dtype=torch.int32),
                             cache)


@pytest.mark.parametrize("change", ["zamba2", "mamba2", "hybrid",
                                    "whisper"])
def test_unported_families_refused(change):
    """Mamba2 blocks in falcon-mamba's SSM family, and a hybrid of its
    Mamba1 blocks, raise NotImplementedError: not ported yet (the JAX
    package's decode cannot run them either).  The families refused here
    until they were ported now build their schema and whole-batch cache:
    the hybrid (zamba2, with the shared block and its attention caches)
    and the encoder-decoder (whisper, with the cross caches); the paged
    cache refuses both with ValueError, as the JAX ``PagedEngine`` does."""
    falcon = tconfigs.get(ARCH).reduced()
    if change in ("zamba2", "whisper"):
        name = "zamba2-7b" if change == "zamba2" else "whisper-large-v3"
        cfg = TArchConfig(**dataclasses.asdict(jconfigs.get(name)))
    elif change == "mamba2":
        cfg = dataclasses.replace(falcon, mamba_version=2)
    else:
        cfg = dataclasses.replace(falcon, family="hybrid")
    if change == "zamba2":
        assert "shared_attn" in tT.schema(cfg)
        assert {"conv", "ssm", "attn_k", "attn_v"} <= set(
            tT.cache_decls(cfg, 2, 8))
        with pytest.raises(ValueError, match="SSM and hybrid archs"):
            tT.paged_cache_decls(cfg, 2, 4, 4, 9)
        return
    if change == "whisper":
        assert {"encoder", "decoder", "ln_enc"} <= set(tT.schema(cfg))
        assert {"cross_k", "cross_v"} <= set(tT.cache_decls(cfg, 2, 8))
        with pytest.raises(ValueError, match="encoder-decoder"):
            tT.paged_cache_decls(cfg, 2, 4, 4, 9)
        return
    for fn in (lambda: tT.schema(cfg), lambda: tT.cache_decls(cfg, 2, 8),
               lambda: tT.paged_cache_decls(cfg, 2, 4, 4, 9)):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            fn()


def _launch(*extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--local-smoke", "--device", "cpu", *extra], env=env,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("extra", [[], ["--legacy-loop"]],
                         ids=["fused", "legacy"])
def test_launcher_serves_falcon_whole_batch_cpu(extra):
    res = _launch("--whole-batch", *extra)
    assert res.returncode == 0, res.stderr
    mode = "legacy per-token loop" if extra else "fused decode_many"
    assert (f"falcon-mamba-7b-reduced on cpu: generated 32 tokens across 4 "
            f"requests ({mode})") in res.stdout


def test_launcher_refuses_falcon_without_whole_batch():
    res = _launch()
    assert res.returncode == 2
    assert "--whole-batch" in res.stderr and "PagedEngine" in res.stderr
