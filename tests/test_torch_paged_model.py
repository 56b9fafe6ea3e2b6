"""The port's paged forward passes against the JAX package's, and the
port's fused decode loop against its own stepwise loop.

Logits and pool rows are held in f32 with rtol = atol = 1e-4: two layers
of f32 matmuls (d_model 64, d_ff 128) and the unembed sum in another order
in each framework, a few ulps per sum.  Greedy and temperature sampling of
the fused loop must equal the stepwise loop exactly (same ops, same
generator draws); temperature sampling is not compared with JAX, whose
threefry draws a torch generator cannot reproduce.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro_torch import configs as tconfigs
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.model import sample_token
from repro_torch.models.params import params_from_jax
from torch_one_thread import _one_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)
B, T, PAGE, NB = 2, 8, 4, 6


def _models(arch, **change):
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(),
                               dtype="float32", **change)
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(),
                               dtype="float32", **change)
    jm = jget_model(jcfg)
    jp = jm.init(jax.random.key(1))
    return jm, jp, tget_model(tcfg), params_from_jax(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _caches(jm, tm):
    table = (np.arange(B * NB, dtype=np.int32)[::-1].reshape(B, NB) + 1)
    jc = dict(jm.init_paged_cache(B, NB, PAGE, B * NB + 1),
              table=jnp.asarray(table))
    tc = tm.init_paged_cache(B, NB, PAGE, B * NB + 1, "cpu")
    tc["table"] = torch.from_numpy(table.copy())
    return jc, tc


def _pools_close(jc, tc, names):
    for name in names:
        j = np.asarray(jc[name])[:, 1:]              # page 0: null, garbage
        t = tc[name][:, 1:].numpy()
        if j.dtype == np.int8:                       # a rounding may flip
            assert np.abs(t.astype(int) - j.astype(int)).max() <= 1, name
            assert (t == j).mean() > 0.999, name
        else:
            np.testing.assert_allclose(t, j, **TOL, err_msg=name)
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(jc["length"]))


@pytest.mark.parametrize("arch,kv_dtype", [("qwen2-0.5b", "bf16"),
                                           ("granite-8b", "bf16"),
                                           ("qwen2-0.5b", "int8")])
def test_paged_prefill_and_decode_match_jax(arch, kv_dtype):
    """Two ragged prefill chunks (one slot idle in the second) then two
    decode steps (one slot inactive in the second): logits at every step,
    and the pool rows at the same (layer, page, row)."""
    jm, jp, tm, tp = _models(arch, kv_dtype=kv_dtype)
    rng = np.random.RandomState(3)
    names = ["k", "v"] + (["k_scale", "v_scale"] if kv_dtype == "int8"
                          else [])
    jc, tc = _caches(jm, tm)
    for grants in ([T, 5], [6, 0]):
        toks = rng.randint(0, jm.cfg.vocab_size, (B, T)).astype(np.int32)
        g = np.asarray(grants, np.int32)
        jl, jc = jm.prefill_step_paged(jp, jnp.asarray(toks), jc,
                                       jnp.asarray(g))
        tl, tc = tm.prefill_step_paged(tp, torch.from_numpy(toks), tc,
                                       torch.from_numpy(g))
        live = g > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **TOL)
    _pools_close(jc, tc, names)
    for active in ([True, True], [False, True]):
        toks = rng.randint(0, jm.cfg.vocab_size, (B, 1)).astype(np.int32)
        a = np.asarray(active)
        jl, jc = jm.decode_step_paged(jp, jnp.asarray(toks), jc,
                                      jnp.asarray(a))
        tl, tc = tm.decode_step_paged(tp, torch.from_numpy(toks), tc,
                                      torch.from_numpy(a))
        np.testing.assert_allclose(tl.numpy()[a], np.asarray(jl)[a], **TOL)
    _pools_close(jc, tc, names)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_decode_many_matches_stepwise(temperature):
    """The fused loop under a (B,) grant vector equals stepping the model
    one token at a time under the same per-step masks, with the same
    generator: tokens, pools and lengths."""
    _, _, tm, tp = _models("qwen2-0.5b")
    caches = []
    for _ in range(2):
        c = tm.init_paged_cache(B, NB, PAGE, B * NB + 1, "cpu")
        c["table"] = torch.arange(1, 1 + B * NB,
                                  dtype=torch.int32).reshape(B, NB)
        prompt = torch.tensor([[5, 9, 2, 7], [3, 3, 8, 1]], dtype=torch.int32)
        _, c = tm.prefill_step_paged(tp, prompt, c,
                                     torch.tensor([4, 3], dtype=torch.int32))
        caches.append(c)
    steps = torch.tensor([5, 2], dtype=torch.int32)
    feed = torch.tensor([[11], [4]], dtype=torch.int32)
    g1 = torch.Generator().manual_seed(7)
    toks, fused = tm.decode_many_paged(tp, feed, caches[0], g1, steps,
                                       num_steps=5, temperature=temperature)
    g2 = torch.Generator().manual_seed(7)
    tok, stepped, want = feed[:, 0], caches[1], []
    for s in range(5):
        act = steps > s
        logits, stepped = tm.decode_step_paged(tp, tok[:, None], stepped,
                                               act)
        tok = torch.where(act, sample_token(logits, g2, temperature), tok)
        want.append(tok)
    assert torch.equal(toks, torch.stack(want))
    assert torch.equal(fused["length"], torch.tensor([9, 5],
                                                     dtype=torch.int32))
    for name in ("k", "v", "length"):
        assert torch.equal(fused[name], stepped[name]), name
    assert (toks[2:, 1] == toks[1, 1]).all()         # frozen once inactive


def test_sample_token_greedy_and_temperature():
    logits = torch.tensor([[0.0, 5.0, 1.0], [9.0, -1.0, 0.0]])
    assert sample_token(logits, None, 0.0).tolist() == [1, 0]
    g = torch.Generator().manual_seed(0)
    draws = sample_token(logits[:1].expand(2000, 3), g, 1.0)
    assert draws.dtype == torch.int32
    freq = torch.bincount(draws, minlength=3).float() / 2000
    want = torch.softmax(logits[0], 0)                # (0.0066, 0.976, 0.018)
    assert (freq - want).abs().max().item() < 0.015
