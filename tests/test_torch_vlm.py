"""The port's VLM family (qwen2-vl: M-RoPE, a stub frontend's embedding
inputs) against the JAX package's, on the CPU: qwen2-vl-72b
``.reduced()`` in f32 (sections (4, 2, 2) over a head dim of 16), the
weights bridged bit-exact from the JAX tree.

  * ``mrope_angles`` against the JAX function, with three distinct
    streams, at the reduced and the published sections: rtol = atol =
    1e-5, as the other layers.  With three equal streams it is
    ``rope_angles`` exactly.
  * ``Model.prefill`` of (B, S, d) embeddings with distinct (3, B, S)
    position streams: the last position's logits and the cache parts
    within rtol = atol = 1e-4 of JAX's (two layers and the unembed summed
    in another order); ``lm_forward``'s train logits likewise.  Distinct
    streams move the logits in both packages (only they test the
    sections: the decode and paged paths broadcast one position).
  * No positions equals three ``arange`` streams, at B = 1 and 4, in both
    packages.  The JAX ``Model.prefill`` feeds a (B, S) array to
    ``mrope_angles``, which indexes its batch axis as the stream axis;
    the angles come out right only because every row is the same
    ``arange`` (the port builds the three streams itself).
  * ``decode_step`` (token ids through the embedding table) after the
    prefill: logits within 1e-4; ``decode_many`` greedy tokens identical
    to JAX's stepwise decode.
  * ``PagedEngine`` serving text prompts tick for tick with the JAX
    engine (plans, pool, slots, statuses, counters, tokens), default
    ServeConfig and sharing off.
  * ``ServingEngine`` refuses the arch by name; the JAX engine fails with
    ``KeyError: 'embeds'`` at the same point.  The launcher serves text
    prompts paged and refuses ``--whole-batch``.
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
from repro.models import layers as jl
from repro.models import transformer as jT
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tT
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.params import params_from_jax
from repro_torch.serve.engine import ServeConfig as TServeConfig
from repro_torch.serve.engine import ServingEngine as TServingEngine

from test_torch_overload import _engines, _finish, _step_both, _submit_both

REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen2-vl-72b"
FN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
_MODELS = {}


def _models():
    if not _MODELS:
        jcfg = dataclasses.replace(jconfigs.get(ARCH).reduced(),
                                   dtype="float32")
        tcfg = dataclasses.replace(tconfigs.get(ARCH).reduced(),
                                   dtype="float32")
        jm = jget_model(jcfg)
        jp = jm.init(jax.random.key(2))
        _MODELS["m"] = (jm, jp, tget_model(tcfg), params_from_jax(
            jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return _MODELS["m"]


def _embeds(cfg, B, S, seed):
    return np.random.RandomState(seed).randn(B, S, cfg.d_model).astype(
        np.float32)


def _streams(B, S, seed):
    """Three distinct (3, B, S) streams: a patch grid's layout (t fixed,
    h the row, w the column) then text whose streams advance together."""
    rng = np.random.RandomState(seed)
    grid = S // 2
    rows = np.arange(grid) // 4
    cols = np.arange(grid) % 4
    text = rows.max() + 1 + np.arange(S - grid)
    pos = np.stack([np.concatenate([np.zeros(grid), text]),
                    np.concatenate([rows, text]),
                    np.concatenate([cols, text])]).astype(np.int32)
    pos = np.broadcast_to(pos[:, None], (3, B, S)).copy()
    pos += rng.randint(0, 3, size=(1, B, 1)).astype(np.int32)  # per-row base
    return pos


def _arange_streams(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32)[None, None],
                           (3, B, S)).copy()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("sections,head_dim", [((4, 2, 2), 16),
                                               ((16, 24, 24), 128)])
def test_mrope_angles_matches_jax(sections, head_dim):
    pos = np.random.RandomState(0).randint(0, 3000, size=(3, 2, 7)).astype(
        np.int32)
    tc, ts = tl.mrope_angles(torch.from_numpy(pos), head_dim, 1e6, sections)
    jc, js = jl.mrope_angles(jnp.asarray(pos), head_dim, 1e6, sections)
    assert tc.shape == (2, 7, head_dim // 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **FN_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **FN_TOL)


def test_mrope_equal_streams_is_rope():
    pos = np.random.RandomState(1).randint(0, 3000, size=(2, 9)).astype(
        np.int32)
    p = torch.from_numpy(pos)
    mc, ms = tl.mrope_angles(p[None].expand(3, 2, 9), 16, 1e4, (4, 2, 2))
    rc, rs = tl.rope_angles(p, 16, 1e4)
    assert torch.equal(mc, rc) and torch.equal(ms, rs)


@pytest.mark.parametrize("B", [1, 4])
def test_prefill_distinct_streams_matches_jax(B):
    jm, jp, tm, tp = _models()
    S = 24
    emb, pos = _embeds(tm.cfg, B, S, 3), _streams(B, S, 4)
    jl_, jc = jm.prefill(jp, {"embeds": jnp.asarray(emb),
                              "positions": jnp.asarray(pos)})
    tl_, tc = tm.prefill(tp, {"embeds": torch.from_numpy(emb),
                              "positions": torch.from_numpy(pos)})
    assert tl_.shape == (B, tm.cfg.vocab_size)
    np.testing.assert_allclose(_np(tl_), _np(jl_), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), **TOL)
    # the train forward at every position
    jt, _, _ = jT.lm_forward(jp, jm.cfg, jnp.asarray(emb), jnp.asarray(pos))
    tt, _, _ = tT.lm_forward(tp, tm.cfg, torch.from_numpy(emb),
                             torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tt), _np(jt), **TOL)


def test_distinct_streams_move_the_logits():
    """The sections only show with distinct streams: against three equal
    ``arange`` streams the logits move, by the same amount in both
    packages."""
    jm, jp, tm, tp = _models()
    B, S = 2, 24
    emb, pos = _embeds(tm.cfg, B, S, 5), _streams(B, S, 6)
    flat = _arange_streams(B, S)
    moved = []
    for p in (pos, flat):
        jl_, _ = jm.prefill(jp, {"embeds": jnp.asarray(emb),
                                 "positions": jnp.asarray(p)})
        tl_, _ = tm.prefill(tp, {"embeds": torch.from_numpy(emb),
                                 "positions": torch.from_numpy(p)})
        moved.append((_np(jl_), _np(tl_)))
    dj = np.abs(moved[0][0] - moved[1][0]).max()
    dt = np.abs(moved[0][1] - moved[1][1]).max()
    assert dj > 1e-3 and dt > 1e-3
    np.testing.assert_allclose(dt, dj, rtol=1e-2)


@pytest.mark.parametrize("B", [1, 4])
def test_no_positions_equals_arange_streams(B):
    jm, jp, tm, tp = _models()
    S = 16
    emb = _embeds(tm.cfg, B, S, 7)
    flat = _arange_streams(B, S)
    j0, _ = jm.prefill(jp, {"embeds": jnp.asarray(emb)})
    j1, _ = jm.prefill(jp, {"embeds": jnp.asarray(emb),
                            "positions": jnp.asarray(flat)})
    t0, _ = tm.prefill(tp, {"embeds": torch.from_numpy(emb)})
    t1, _ = tm.prefill(tp, {"embeds": torch.from_numpy(emb),
                            "positions": torch.from_numpy(flat)})
    np.testing.assert_array_equal(_np(j0), _np(j1))
    assert torch.equal(t0, t1)
    np.testing.assert_allclose(_np(t0), _np(j0), **TOL)


def _decode_cache(m, parts, B, S, max_seq, torch_side):
    """The prefill's cache parts copied into a whole-batch decode cache of
    ``max_seq`` rows, ``pos`` = S."""
    if torch_side:
        cache = m.init_cache(B, max_seq, "cpu")
        for k, src in parts.items():
            cache[k][:, :, :S] = src
        cache["pos"] = torch.tensor(S, dtype=torch.int32)
        return cache
    cache = m.init_cache(B, max_seq)
    for k, src in parts.items():
        cache[k] = cache[k].at[:, :, :S].set(src)
    cache["pos"] = jnp.asarray(S, jnp.int32)
    return cache


def test_decode_after_embeds_prefill_matches_jax():
    """Text tokens after an embeddings prefill: one ``decode_step``'s
    logits within 1e-4, then ``decode_many``'s greedy tokens equal to
    JAX's stepwise greedy decode."""
    jm, jp, tm, tp = _models()
    B, S, steps = 2, 24, 6
    emb, pos = _embeds(tm.cfg, B, S, 8), _streams(B, S, 9)
    jlast, jparts = jm.prefill(jp, {"embeds": jnp.asarray(emb),
                                    "positions": jnp.asarray(pos)})
    tlast, tparts = tm.prefill(tp, {"embeds": torch.from_numpy(emb),
                                    "positions": torch.from_numpy(pos)})
    jcache = _decode_cache(jm, jparts, B, S, S + steps + 1, False)
    tcache = _decode_cache(tm, tparts, B, S, S + steps + 1, True)
    first = np.array(jnp.argmax(jlast, -1), np.int32)[:, None]
    assert np.array_equal(first, tlast.argmax(-1).numpy()[:, None])
    jlog, jcache = jm.decode_step(jp, jnp.asarray(first), jcache)
    tlog, tcache = tm.decode_step(tp, torch.from_numpy(first), tcache)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    want, tok = [], jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
    for _ in range(steps - 1):
        want.append(np.asarray(tok[:, 0]))
        jlog, jcache = jm.decode_step(jp, tok, jcache)
        tok = jnp.argmax(jlog, -1).astype(jnp.int32)[:, None]
    tok0 = torch.from_numpy(np.array(want[0], np.int32))[:, None]
    got, _, _ = tm.decode_many(tp, tok0, tcache, None, steps - 2)
    np.testing.assert_array_equal(got.numpy(), np.stack(want[1:]))


SERVE = dict(max_batch=3, max_seq=48, page_size=8, prefill_chunk=3,
             max_new_tokens=6)


@pytest.mark.parametrize("mode", ["default", "no-sharing"])
def test_paged_engine_serves_text_prompts_tick_for_tick(mode):
    """Text prompts (token ids: the paged steps force ``embed_inputs``,
    as the JAX ``Model`` does) with a shared head, through both engines in
    lockstep, the state equal after every tick."""
    extra = {} if mode == "default" else dict(prefix_sharing=False,
                                              retain_prefixes=False)
    je, te = _engines(models=_models(), **SERVE, **extra)
    rng = np.random.RandomState(11)
    head = rng.randint(0, 256, size=12).astype(np.int32)
    prompts = [np.concatenate([head, rng.randint(0, 256, size=n).astype(
        np.int32)]) for n in (3, 9, 20, 5)]
    rids = []
    for n, p in enumerate(prompts):
        rids.append(_submit_both(je, te, p))
        if n == 1:
            assert _step_both(je, te) is None
    _finish(je, te)
    for r in rids:
        assert te.results[r] == list(je.results[r])
        assert len(te.results[r]) == SERVE["max_new_tokens"]
    if mode == "default":
        assert te.shared_tokens == je.shared_tokens > 0


def test_serving_engine_refuses_by_name():
    """The JAX engine's prefill builds {"tokens": ...} and fails with
    ``KeyError: 'embeds'``; the port refuses the arch by name at the same
    point."""
    jm, jp, tm, tp = _models()
    prompts = [np.arange(1, 6, dtype=np.int32)]
    with pytest.raises(KeyError, match="embeds"):
        JServingEngine(jm, jp, JServeConfig(max_new_tokens=2)
                       ).generate_batch(prompts)
    with pytest.raises(ValueError, match="qwen2-vl-72b-reduced.*stub-"
                                         "frontend.*embeddings"):
        TServingEngine(tm, tp, TServeConfig(max_new_tokens=2)
                       ).generate_batch(prompts)


@pytest.mark.parametrize("whole_batch", [False, True])
def test_launcher(whole_batch):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--local-smoke",
         "--device", "cpu", "--arch", ARCH, "--new-tokens", "4"]
        + (["--whole-batch"] if whole_batch else []), env=env,
        capture_output=True, text=True, timeout=300)
    if whole_batch:
        assert res.returncode == 2
        assert "qwen2-vl-72b is a stub-frontend arch" in res.stderr
    else:
        assert res.returncode == 0, res.stderr
        assert "qwen2-vl-72b-reduced on cpu: 8 requests" in res.stdout
