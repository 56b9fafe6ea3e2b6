"""The port's encoder-decoder (whisper: layernorm, the gelu MLP,
sinusoidal positions, the encoder, cross-attention) against the JAX
package's, on the CPU: whisper-large-v3 ``.reduced()`` in f32 (2 + 2
layers, d_model 64, 4 heads over 2 KV heads of 16), the weights bridged
bit-exact from the JAX tree, 32 frames from a numpy seed.

  * ``layernorm``, ``gelu_mlp`` and ``sinusoidal_positions`` against the
    JAX functions: rtol = atol = 1e-5, as the other layers (the positions
    table at 1500 positions: within an f32 ulp of frequency times the
    position, see its test).
  * ``whisper_encode``, ``whisper_forward`` (train logits; prefill's last
    logits and its cache parts) and ``decode_step`` after the prefill:
    within rtol = atol = 1e-4 (four layers and the unembed summed in
    another order).
  * Greedy tokens of ``decode_many`` identical to JAX's stepwise decode.
  * The padded cross cache, a reference-side fault kept as it is: the
    decode step attends every row of ``cross_k``/``cross_v`` (no
    ``kv_len``), and ``cache_decls`` sizes them by ``max_seq``.  With
    ``max_seq`` equal to the frame count the step agrees with the
    teacher-forced forward to ~1e-7; zero-padded to 40 rows (as
    ``tests/test_models_smoke.py`` builds the cache) the zero rows dilute
    the softmax and it differs by more than 1e-2.  The port gives JAX's
    logits in both cases.
  * ``PagedEngine`` refuses the arch in both packages; ``ServingEngine``
    refuses it by name where the JAX engine fails with ``KeyError:
    'frames'``; so does the launcher.
"""
import dataclasses
import math
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
from repro.models import layers as jl
from repro.models import transformer as jT
from repro.serve.engine import PagedEngine as JPagedEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tT
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.params import params_from_jax
from repro_torch.serve.engine import PagedEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import ServingEngine as TServingEngine
from torch_one_thread import _one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
ARCH = "whisper-large-v3"
FN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
FRAMES = 32
_MODELS = {}


def _models():
    if not _MODELS:
        jcfg = dataclasses.replace(jconfigs.get(ARCH).reduced(),
                                   dtype="float32")
        tcfg = dataclasses.replace(tconfigs.get(ARCH).reduced(),
                                   dtype="float32")
        jm = jget_model(jcfg)
        jp = jm.init(jax.random.key(3))
        _MODELS["m"] = (jm, jp, tget_model(tcfg), params_from_jax(
            jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return _MODELS["m"]


def _inputs(cfg, B, S, seed):
    """frames (B, FRAMES, d) f32 and decoder tokens (B, S) int32."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, FRAMES, cfg.d_model).astype(np.float32),
            rng.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_layernorm():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 64) * 3 + 1).astype(np.float32)
    s, b = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    np.testing.assert_allclose(
        tl.layernorm(torch.from_numpy(x), torch.from_numpy(s),
                     torch.from_numpy(b), 1e-5).numpy(),
        np.asarray(jl.layernorm(jnp.asarray(x), jnp.asarray(s),
                                jnp.asarray(b), 1e-5)), **FN_TOL)


def test_gelu_mlp():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 32).astype(np.float32)
    wu, bu = rng.randn(32, 48).astype(np.float32) / 6, \
        rng.randn(48).astype(np.float32)
    wd, bd = rng.randn(48, 32).astype(np.float32) / 7, \
        rng.randn(32).astype(np.float32)
    t = tl.gelu_mlp(*map(torch.from_numpy, (x, wu, bu, wd, bd)))
    j = jl.gelu_mlp(*map(jnp.asarray, (x, wu, bu, wd, bd)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **FN_TOL)


@pytest.mark.parametrize("d_model", [64, 1280])
def test_sinusoidal_positions(d_model):
    """At whisper's 1500 encoder positions.  The frequencies are XLA's f32
    ``exp`` of the same exponents bit for bit (``_exp_as_xla``), so the
    tables differ only by sin and cos of the same f32 angles: within one
    f32 ulp at 1 everywhere.  (A frequency an ulp off would move the
    angle by up to an ulp at position 1500, 1.2e-4.)"""
    pos = np.arange(1500, dtype=np.int32)[None]
    t = tl.sinusoidal_positions(torch.from_numpy(pos), d_model)
    j = np.asarray(jl.sinusoidal_positions(jnp.asarray(pos), d_model))
    assert t.shape == (1, 1500, d_model)
    half = d_model // 2
    exps = -np.arange(half, dtype=np.float32) * np.float32(
        math.log(10000.0) / max(1, half - 1))
    assert np.array_equal(tl._exp_as_xla(torch.from_numpy(exps)).numpy(),
                          np.asarray(jnp.exp(jnp.asarray(exps))))
    np.testing.assert_allclose(t.numpy()[0], j[0], rtol=0, atol=2.0 ** -23)


def test_encode_and_forward_match_jax():
    jm, jp, tm, tp = _models()
    cfg = tm.cfg
    frames, toks = _inputs(cfg, 2, 12, 4)
    je = jT.whisper_encode(jp, jm.cfg, jnp.asarray(frames))
    te = tT.whisper_encode(tp, cfg, torch.from_numpy(frames))
    assert te.shape == (2, FRAMES, cfg.d_model)
    np.testing.assert_allclose(_np(te), _np(je), **TOL)
    jt, _, _ = jT.whisper_forward(jp, jm.cfg, jnp.asarray(frames),
                                  jnp.asarray(toks), mode="train")
    tt, _, _ = tT.whisper_forward(tp, cfg, torch.from_numpy(frames),
                                  torch.from_numpy(toks), mode="train")
    assert tt.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(_np(tt), _np(jt), **TOL)
    jh, _, _ = jT.whisper_forward(jp, jm.cfg, jnp.asarray(frames),
                                  jnp.asarray(toks), mode="hidden")
    th, _, _ = tT.whisper_forward(tp, cfg, torch.from_numpy(frames),
                                  torch.from_numpy(toks), mode="hidden")
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)


def _prefill_both(B, S, seed):
    jm, jp, tm, tp = _models()
    frames, toks = _inputs(tm.cfg, B, S + 8, seed)
    jl_, jparts = jm.prefill(jp, {"frames": jnp.asarray(frames),
                                  "tokens": jnp.asarray(toks[:, :S])})
    tl_, tparts = tm.prefill(tp, {"frames": torch.from_numpy(frames),
                                  "tokens": torch.from_numpy(toks[:, :S])})
    return frames, toks, (jl_, jparts), (tl_, tparts)


def _caches(jparts, tparts, B, S, max_seq):
    """Both packages' decode caches of ``max_seq`` rows with the prefill's
    parts copied in (zero rows past them), ``pos`` = S."""
    jm, _, tm, _ = _models()
    jc, tc = jm.init_cache(B, max_seq), tm.init_cache(B, max_seq, "cpu")
    for k, src in jparts.items():
        n = src.shape[2]
        jc[k] = jc[k].at[:, :, :n].set(src)
        tc[k][:, :, :n] = tparts[k]
    jc["pos"] = jnp.asarray(S, jnp.int32)
    tc["pos"] = torch.tensor(S, dtype=torch.int32)
    return jc, tc


def test_prefill_and_decode_step_match_jax():
    jm, jp, tm, tp = _models()
    B, S = 2, 10
    frames, toks, (jl_, jparts), (tl_, tparts) = _prefill_both(B, S, 5)
    np.testing.assert_allclose(_np(tl_), _np(jl_), **TOL)
    assert set(tparts) == set(jparts) == {"k", "v", "cross_k", "cross_v"}
    for k in jparts:
        np.testing.assert_allclose(_np(tparts[k]), _np(jparts[k]), **TOL)
    assert tparts["cross_k"].shape == (tm.cfg.n_layers, B, FRAMES,
                                       tm.cfg.n_kv_heads, tm.cfg.head_dim)
    jc, tc = _caches(jparts, tparts, B, S, FRAMES)
    nxt = toks[:, S:S + 1]
    jd, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
    td, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
    np.testing.assert_allclose(_np(td), _np(jd), **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == S + 1
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **TOL)


def test_decode_many_greedy_matches_jax_stepwise():
    jm, jp, tm, tp = _models()
    B, S, steps = 3, 4, 10
    _, _, (jl_, jparts), (tl_, tparts) = _prefill_both(B, S, 6)
    jc, tc = _caches(jparts, tparts, B, S, FRAMES)
    tok = jnp.argmax(jl_, -1).astype(jnp.int32)[:, None]
    first = torch.from_numpy(np.array(tok))
    assert torch.equal(first[:, 0], tl_.argmax(-1).to(torch.int32))
    want = []
    for _ in range(steps):
        logits, jc = jm.decode_step(jp, tok, jc)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        want.append(np.asarray(tok[:, 0]))
    got, tc, _ = tm.decode_many(tp, first, tc, None, steps)
    np.testing.assert_array_equal(got.numpy(), np.stack(want))
    assert int(tc["pos"]) == S + steps


@pytest.mark.parametrize("max_seq,dilutes", [(FRAMES, False), (40, True)])
def test_padded_cross_cache_dilutes_in_both_packages(max_seq, dilutes):
    """One decode step against the teacher-forced forward's logits at the
    same position, from a cache of ``max_seq`` rows: the cross cache's
    zero rows past the 32 frames take part in the decode's softmax."""
    jm, jp, tm, tp = _models()
    B, S = 2, 16
    frames, toks, (_, jparts), (_, tparts) = _prefill_both(B, S, 7)
    jc, tc = _caches(jparts, tparts, B, S, max_seq)
    nxt = toks[:, S:S + 1]
    jd, _ = jm.decode_step(jp, jnp.asarray(nxt), jc)
    td, _ = tm.decode_step(tp, torch.from_numpy(nxt), tc)
    jt, _, _ = jT.whisper_forward(jp, jm.cfg, jnp.asarray(frames),
                                  jnp.asarray(toks[:, :S + 1]))
    tt, _, _ = tT.whisper_forward(tp, tm.cfg, torch.from_numpy(frames),
                                  torch.from_numpy(toks[:, :S + 1]))
    dj = np.abs(_np(jd) - _np(jt)[:, S]).max()
    dt = np.abs(_np(td) - _np(tt)[:, S]).max()
    np.testing.assert_allclose(_np(td), _np(jd), **TOL)
    if dilutes:
        assert dj > 1e-2 and dt > 1e-2
    else:
        assert dj < 1e-5 and dt < 1e-5


def test_paged_engine_refuses_in_both_packages():
    jm, jp, tm, tp = _models()
    with pytest.raises(ValueError, match="decoder-only attention LM"):
        JPagedEngine(jm, jp, JServeConfig())
    with pytest.raises(ValueError, match="decoder-only attention LM.*"
                                         "encoder-decoder"):
        TPagedEngine(tm, tp, TServeConfig())


def test_serving_engine_refuses_by_name():
    jm, jp, tm, tp = _models()
    prompts = [np.arange(1, 6, dtype=np.int32)]
    with pytest.raises(KeyError, match="frames"):
        JServingEngine(jm, jp, JServeConfig(max_new_tokens=2)
                       ).generate_batch(prompts)
    with pytest.raises(ValueError, match="whisper-large-v3-reduced.*stub-"
                                         "frontend.*frames"):
        TServingEngine(tm, tp, TServeConfig(max_new_tokens=2)
                       ).generate_batch(prompts)


@pytest.mark.parametrize("whole_batch", [False, True])
def test_launcher_refuses(whole_batch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--local-smoke",
         "--device", "cpu", "--arch", ARCH]
        + (["--whole-batch"] if whole_batch else []), env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 2
    assert "whisper-large-v3 is an encoder-decoder arch" in res.stderr
