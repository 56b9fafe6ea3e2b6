"""The port's zamba2 hybrid (Mamba2/SSD blocks and the shared attention
block) against the JAX package's, on the CPU: the SSD scan, its step and
the Mamba2 mixer; the schema and bridged weights; ``lm_forward``,
``Model.prefill``, ``lm_decode`` and whole-batch serving through
``ServingEngine`` — same weights, bridged bit-exact from the JAX tree, at
``.reduced()`` size in f32 (d_model 64, 8 SSD heads of 16, N 8, chunks of
16; 6 layers is one group, 13 is two groups and a tail layer).

Tolerances: the SSD functions hold rtol = atol = 1e-5 (one framework's
f32 einsums against another's, over a few chunks); logits and states
rtol = atol = 1e-4, as the port's dense and Mamba1 models are (layers of
f32 matmuls summed in another order); greedy tokens must be identical.

The held reference for serving is the JAX package's own step-by-step
decode, not its ``ServingEngine``: that engine takes the attention caches
from its prefill but no SSM state, so it decodes from a zero state as if
the prompt had never been seen.  Its first token comes from the prefill
logits and agrees; the test below pins the zero state.  The JAX
``ssd_scan`` also asserts that its chunks divide the sequence; the port
takes a ragged last chunk, held here against its own step loop.
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
from repro.models import ssm as jssm
from repro.models import transformer as jT
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as tT
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.params import init_params, map_schema, \
    params_from_jax
from repro_torch.serve.engine import PagedEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import ServingEngine as TServingEngine

REPO = Path(__file__).resolve().parents[1]
SSD_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "zamba2-7b"


def _models(n_layers=6, dtype="float32", seed=1):
    jcfg = dataclasses.replace(jconfigs.get(ARCH).reduced(), dtype=dtype,
                               n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.get(ARCH).reduced(), dtype=dtype,
                               n_layers=n_layers)
    jm = jget_model(jcfg)
    jp = jm.init(jax.random.key(seed))
    return jm, jp, tget_model(tcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def models():
    """Two groups of 6 and a tail layer: G = 2, R = 1."""
    return _models(13)


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


def _ssd_inputs(seed, B, S, H, hd, N):
    """x, dt (post-softplus, ~[0.02, 0.7]), A (H,) negative, B, C, h0."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, hd).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(B, S, H).astype(np.float32) - 1.0))
    A = -np.exp(rng.randn(H).astype(np.float32) * 0.5)
    Bc = rng.randn(B, S, N).astype(np.float32)
    Cc = rng.randn(B, S, N).astype(np.float32)
    h0 = rng.randn(B, H, hd, N).astype(np.float32)
    return x, dt, A, Bc, Cc, h0


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("S,chunk", [(16, 16), (48, 16), (7, 16), (64, 32)],
                         ids=["one-chunk", "three-chunks", "short", "two"])
@pytest.mark.parametrize("h0", [False, True], ids=["zero", "h0"])
def test_ssd_scan_matches_jax(S, chunk, h0):
    """Where the JAX function runs (chunks dividing S), the port's scan
    gives its y and h_final, from a zero state and from ``h0``."""
    x, dt, A, Bc, Cc, h = _ssd_inputs(S + chunk, 2, S, 3, 4, 5)
    h = h if h0 else None
    jy, jh = jssm.ssd_scan(*map(jnp.asarray, (x, dt, A, Bc, Cc)), chunk,
                           None if h is None else jnp.asarray(h))
    ty, th = tssm.ssd_scan(*_t(x, dt, A, Bc, Cc), chunk,
                           None if h is None else torch.from_numpy(h))
    assert th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SSD_TOL)


def test_ssd_scan_bf16_keeps_f32_state():
    """bf16 inputs: y comes back in bf16, the state in f32, both equal to
    the JAX function's on the same bf16 inputs."""
    x, dt, A, Bc, Cc, _ = _ssd_inputs(5, 2, 32, 3, 8, 4)
    jin = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, dt)]
    tin = [t.to(torch.bfloat16) for t in _t(x, dt)]
    jy, jh = jssm.ssd_scan(*jin, jnp.asarray(A), jnp.asarray(Bc),
                           jnp.asarray(Cc), 16)
    ty, th = tssm.ssd_scan(*tin, *_t(A, Bc, Cc), 16)
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SSD_TOL)


def test_ssd_step_matches_jax():
    x, dt, A, Bc, Cc, h = _ssd_inputs(11, 3, 1, 4, 8, 6)
    jy, jh = jssm.ssd_step(jnp.asarray(x[:, 0]), jnp.asarray(dt[:, 0]),
                           jnp.asarray(A), jnp.asarray(Bc[:, 0]),
                           jnp.asarray(Cc[:, 0]), jnp.asarray(h))
    ty, th = tssm.ssd_step(*_t(x[:, 0], dt[:, 0], A, Bc[:, 0], Cc[:, 0], h))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SSD_TOL)


@pytest.mark.parametrize("S", [37, 17])
def test_ragged_ssd_scan_equals_the_step_loop(S):
    """S = 37 (two chunks of 16 and one of 5) and 17 (16 and 1): the JAX
    scan refuses them (its ``S % c == 0`` assertion, pinned); the port's
    takes a ragged last chunk and equals its own ``ssd_step`` stepped over
    the sequence from ``h0``."""
    x, dt, A, Bc, Cc, h0 = _ssd_inputs(S, 2, S, 3, 4, 5)
    with pytest.raises(AssertionError):
        jssm.ssd_scan(*map(jnp.asarray, (x, dt, A, Bc, Cc)), 16,
                      jnp.asarray(h0))
    tx, tdt, tA, tB, tC, h = _t(x, dt, A, Bc, Cc, h0)
    ty, th = tssm.ssd_scan(tx, tdt, tA, tB, tC, 16, h.clone())
    ys = []
    for t in range(S):
        y, h = tssm.ssd_step(tx[:, t], tdt[:, t], tA, tB[:, t], tC[:, t], h)
        ys.append(y)
    np.testing.assert_allclose(ty.numpy(), torch.stack(ys, 1).numpy(),
                               **SSD_TOL)
    np.testing.assert_allclose(th.numpy(), h.numpy(), **SSD_TOL)


@pytest.mark.parametrize("S", [20, 32])
def test_mamba2_block_matches_jax(models, S):
    """The mixer of layer 3 over a sequence (chunks of 16: S = 20 is ragged,
    so the JAX call runs at S = 32 only) and one decode step: out, and the
    port's state against the JAX block stepped over the same tokens."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    jmix = jax.tree.map(lambda a: a[3], jp["blocks"]["mixer"])
    tmix = tT.layer_params(tp["blocks"]["mixer"], 3)
    x = np.random.RandomState(S).randn(2, S, cfg.d_model).astype(np.float32)
    out, state = tssm.mamba2_block(torch.from_numpy(x), tmix, cfg)
    if S % 16 == 0:
        jout, jstate = jssm.mamba2_block(jnp.asarray(x), jmix, jm.cfg)
        assert jstate is None
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    d_in = cfg.d_model * cfg.ssm_expand
    H = d_in // cfg.ssm_head_dim
    st = jssm.Mamba2State(
        conv=jnp.zeros((2, cfg.ssm_conv - 1, d_in), jnp.float32),
        ssm=jnp.zeros((2, H, cfg.ssm_head_dim, cfg.ssm_state), jnp.float32))
    outs = []
    for t in range(S):
        o, st = jssm.mamba2_block(jnp.asarray(x[:, t:t + 1]), jmix, jm.cfg,
                                  st)
        outs.append(np.asarray(o))
    np.testing.assert_allclose(out.numpy(), np.concatenate(outs, 1), **TOL)
    np.testing.assert_allclose(state.conv.numpy(), np.asarray(st.conv),
                               **TOL)
    np.testing.assert_allclose(state.ssm.numpy(), np.asarray(st.ssm), **TOL)
    nxt = np.random.RandomState(S + 1).randn(2, 1, cfg.d_model).astype(
        np.float32)
    jo, jst = jssm.mamba2_block(jnp.asarray(nxt), jmix, jm.cfg, st)
    to, tst = tssm.mamba2_block(torch.from_numpy(nxt), tmix, cfg, state)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tst.ssm.numpy(), np.asarray(jst.ssm), **TOL)
    np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst.conv),
                               **TOL)


def test_hybrid_schema_is_the_bridged_schema():
    """The JAX hybrid schema and the port's agree leaf for leaf (shape and
    init kind) at full size — the Mamba2 mixer stacked over 81 layers,
    ``shared_attn`` one weight set — and the bridge checks every leaf of
    the reduced model against it."""
    jschema = jax.tree.map(lambda d: (tuple(d.shape), d.init),
                           jT.schema(jconfigs.get(ARCH)),
                           is_leaf=lambda x: hasattr(x, "init"))
    tschema = map_schema(lambda d: (d.shape, d.init),
                         tT.schema(tconfigs.get(ARCH)))
    assert tschema == jschema
    assert set(tschema["shared_attn"]) == {"ln1", "ln2", "attn", "ffn"}
    assert tschema["shared_attn"]["attn"]["wq"][0] == (3584, 3584)
    assert tschema["blocks"]["mixer"]["A_log"] == ((81, 112), "ssm_a_scalar")
    _models()


def test_init_params_hybrid_kinds():
    """``ssm_a_scalar`` is zeros (A = -1 on every head), as in the JAX
    package; ``norm`` ones; shapes and dtypes are the JAX tree's."""
    cfg = tconfigs.get(ARCH).reduced()
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jget_model(jconfigs.get(ARCH).reduced()).init(jax.random.key(0))
    mix = p["blocks"]["mixer"]
    assert mix["A_log"].dtype == torch.bfloat16
    assert not mix["A_log"].any() and not np.asarray(
        jp["blocks"]["mixer"]["A_log"]).astype(np.float32).any()
    assert (mix["norm"] == 1).all()
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jp)
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), p)
    assert got == want


@pytest.mark.parametrize("n_layers", [6, 13])
def test_lm_forward_matches_jax(n_layers):
    """6 layers (one group, no tail) and 13 (two groups and a tail layer):
    prefill logits and the attention caches against JAX's prefill; the
    prefill's conv and ssm states (JAX's prefill returns none) against
    the JAX decode stepped over the same tokens; train logits and hidden
    states."""
    jm, jp, tm, tp = _models(n_layers, seed=n_layers)
    B, S = 2, 32
    toks = np.random.RandomState(S).randint(0, 256, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    jl, jparts = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tparts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    G = n_layers // 6
    assert set(jparts) == {"attn_k", "attn_v"}
    assert set(tparts) == {"attn_k", "attn_v", "conv", "ssm"}
    for name in ("attn_k", "attn_v"):
        assert tparts[name].shape[0] == G
        np.testing.assert_allclose(tparts[name].numpy(),
                                   np.asarray(jparts[name]), **TOL)
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
    """Three decode steps from the same cache on both sides: logits, every
    layer's conv and ssm state and both groups' attention caches (updated
    in place in the port), and ``pos``."""
    jm, jp, tm, tp = models
    B, S = 2, 6
    toks = np.random.RandomState(4).randint(0, 256, (B, S)).astype(np.int32)
    _, jc, _ = _jax_stepwise(jm, jp, toks, 4)
    tc = tm.init_cache(B, S + 4, "cpu")
    for name in ("conv", "ssm", "attn_k", "attn_v"):
        assert tuple(tc[name].shape) == jc[name].shape, name
        tc[name].copy_(torch.from_numpy(np.array(jc[name])))
    tc["pos"] = torch.tensor(S, dtype=torch.int32)
    bufs = {name: tc[name] for name in ("ssm", "attn_k")}
    jc = jax.tree.map(jnp.asarray, jc)
    for step in range(3):
        nxt = np.random.RandomState(10 + step).randint(0, 256, (B, 1)
                                                       ).astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert all(tc[name] is buf for name, buf in bufs.items())
    assert int(tc["pos"]) == int(jc["pos"]) == S + 3
    for name in ("conv", "ssm", "attn_k", "attn_v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


@pytest.mark.parametrize("lens", [(5, 12, 9), (17, 3), (20, 32, 7, 11)],
                         ids=["ragged", "ragged-chunk", "four"])
def test_serving_engine_matches_jax_stepwise(models, lens):
    """``generate_batch`` greedy, fused and legacy loop, equals the JAX
    package's decode stepped over the same right-aligned padded rows (pads
    go through the state and the attention on both sides: there is no pad
    mask).  S = 17 and 20 are not multiples of the chunks of 16: the port's
    prefill takes the ragged last chunk."""
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
    ``_prefill_cache`` the conv and ssm caches are all zeros (its
    attention caches are the prompt's), while the port's equal the JAX
    decode's state after stepping over the prompt.  So the JAX engine's
    first token (from the prefill logits) is the stepwise reference's and
    the port's, and the later ones here are not.  A batch whose longest
    prompt is not a multiple of the chunks fails in the JAX engine's
    prefill (the ``ssd_scan`` assertion) and is served by the port's."""
    jm, jp, tm, tp = models
    prompts = _prompts(256, (7, 12, 4), seed=5)
    toks = _right_aligned(prompts)
    _, stepped, _ = _jax_stepwise(jm, jp, toks, 1)
    jeng = JServingEngine(jm, jp, JServeConfig(max_new_tokens=4))
    _, jcache = jeng._prefill_cache(prompts, 4)
    assert not np.asarray(jcache["ssm"]).any()
    assert not np.asarray(jcache["conv"]).any()
    assert np.abs(np.asarray(jcache["attn_k"])).max() > 1e-3
    assert np.abs(stepped["ssm"]).max() > 1e-3
    teng = TServingEngine(tm, tp, TServeConfig(max_new_tokens=4))
    _, tcache = teng._prefill_cache(prompts, 4)
    S = toks.shape[1]
    for name in ("conv", "ssm", "attn_k", "attn_v"):
        rows = (slice(None),) * 2 + (slice(0, S),) * name.startswith("attn")
        np.testing.assert_allclose(tcache[name][rows].numpy(),
                                   stepped[name][rows], **TOL)
    want, _, _ = _jax_stepwise(jm, jp, toks, 4)
    want = [list(map(int, want[:, i])) for i in range(len(prompts))]
    jout = jeng.generate_batch(prompts)
    tout = teng.generate_batch(prompts)
    assert tout == want
    assert [o[0] for o in jout] == [o[0] for o in want]
    assert jout != want
    ragged = _prompts(256, (17, 5), seed=6)
    with pytest.raises(AssertionError):
        jeng.generate_batch(ragged)
    assert all(len(o) == 4 for o in teng.generate_batch(ragged))


def test_serving_engine_bf16_fused_equals_legacy():
    """In the serving dtype (bf16 weights, conv state and attention
    caches, f32 SSD state), at 7 layers (one group and a tail layer), the
    two loops give the same in-vocab tokens; ``benchmark_decode`` runs on
    the hybrid cache."""
    _, _, tm, tp = _models(7, dtype="bfloat16", seed=6)
    prompts = _prompts(256, (9, 3, 21), seed=7)
    eng = TServingEngine(tm, tp, TServeConfig(max_new_tokens=5))
    fused = eng.generate_batch(prompts)
    assert fused == eng.generate_batch(prompts, fused=False)
    assert all(len(o) == 5 and all(0 <= t < 256 for t in o) for o in fused)
    _, cache = eng._prefill_cache(prompts, 5)
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == cache["attn_k"].dtype == torch.bfloat16
    res = eng.benchmark_decode(batch=2, seq=32, steps=4)
    assert res["s_per_step_fused"] > 0 and res["s_per_step_loop"] > 0


def test_paged_path_refuses_hybrid(models):
    """The paged engine and the paged model functions refuse the hybrid
    with ValueError, as the JAX package's ``PagedEngine`` does."""
    jm, jp, tm, tp = models
    with pytest.raises(ValueError, match="decoder-only attention LM"):
        JPagedEngine(jm, jp, JServeConfig(prefix_sharing=False,
                                          retain_prefixes=False))
    with pytest.raises(ValueError, match="JAX package"):
        TPagedEngine(tm, tp, TServeConfig(prefix_sharing=False,
                                          retain_prefixes=False))
    with pytest.raises(ValueError, match="SSM and hybrid archs"):
        tm.init_paged_cache(2, 4, 4, 9, "cpu")
    cache = {"length": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(ValueError, match="whole-batch"):
        tm.decode_step_paged(tp, torch.zeros((2, 1), dtype=torch.int32),
                             cache)


@pytest.mark.parametrize("change", ["mamba1-hybrid", "no-groups",
                                    "mamba2-ssm"])
def test_unrunnable_hybrid_layouts_refused(change):
    """What the JAX package's hybrid and SSM decode cannot run is refused
    with NotImplementedError, saying why: a hybrid of Mamba1 blocks, a
    hybrid without attention groups, and Mamba2 blocks in the SSM
    family."""
    zamba = TArchConfig(**dataclasses.asdict(jconfigs.get(ARCH)))
    cfg = {"mamba1-hybrid": dataclasses.replace(zamba, mamba_version=1),
           "no-groups": dataclasses.replace(zamba, attn_every=0),
           "mamba2-ssm": dataclasses.replace(zamba, family="ssm")}[change]
    why = "cache_decls" if change == "mamba2-ssm" else "Mamba2State"
    for fn in (lambda: tT.schema(cfg), lambda: tT.cache_decls(cfg, 2, 8)):
        with pytest.raises(NotImplementedError, match=why):
            fn()


def _launch(*extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--local-smoke", "--device", "cpu", *extra], env=env,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("extra", [[], ["--legacy-loop"]],
                         ids=["fused", "legacy"])
def test_launcher_serves_zamba2_whole_batch_cpu(extra):
    res = _launch("--whole-batch", *extra)
    assert res.returncode == 0, res.stderr
    mode = "legacy per-token loop" if extra else "fused decode_many"
    assert (f"zamba2-7b-reduced on cpu: generated 32 tokens across 4 "
            f"requests ({mode})") in res.stdout


def test_launcher_refuses_zamba2_without_whole_batch():
    res = _launch()
    assert res.returncode == 2
    assert "--whole-batch" in res.stderr and "PagedEngine" in res.stderr
