"""The port's MoE layer (``models/moe.py``) and its place in the model
against the JAX package's, on the CPU.

Configurations (``.reduced()``, f32 unless stated): llama4-scout (swiglu
experts, top-1 of 4), grok-1 (gelu experts, top-2 of 4) and grok-1 at
``ep_shards`` 8, the full grok block layout (G = 2E: two ff-slices an
expert, whose partial outputs sum).  Inputs come from numpy seeds, the
model weights from the JAX tree through ``params_from_jax``.

  * ``route``, ``aux_loss`` and ``moe_ffn`` at capacity factor 1.25 (the
    default; drops happen) and 100 (none), for n = 1, 4 and 4 x 32 rows:
    the experts equal; gates, probs, aux and outputs within rtol = atol =
    1e-5 (a d_model-64 and a d_ff-128 f32 dot summed in another order).
  * A pinned drop: a low-index row that carries no request takes an
    expert's only slot, and the later real row gets exactly 0 from the
    MoE in both packages.
  * The model calls: ``lm_forward`` (train logits and aux; prefill),
    ``lm_decode``, ``decode_many_paged`` with a grant vector and with
    forced tokens, ``lm_prefill_paged`` with an idle slot and pad rows,
    and ``lm_verify_paged``: logits within rtol = atol = 1e-4 (two layers
    and the unembed), greedy tokens identical.
  * bf16: the experts agree on at least 90% of rows and, where they do,
    the outputs are within four bf16 ulps of the output's scale (each
    framework rounds every expert product to bf16, and the G = 2E layout
    rounds once more in the block sum); no identity is asserted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro.models import moe as jmoe
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tT
from repro_torch.models.model import get_model as tget_model
from repro_torch.models.params import init_params, map_schema, params_from_jax

LLAMA4, GROK = "llama4-scout-17b-a16e", "grok-1-314b"
MOE_CFGS = {"llama4": (LLAMA4, {}), "grok": (GROK, {}),
            "grok-ep8": (GROK, {"ep_shards": 8})}
ROWS = {"n1": (1, 1), "n4": (4, 1), "n128": (4, 32)}
FN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ULPS = 4
_MODELS = {}


def _cfgs(arch, dtype="float32", **change):
    return (dataclasses.replace(jconfigs.get(arch).reduced(), dtype=dtype,
                                **change),
            dataclasses.replace(tconfigs.get(arch).reduced(), dtype=dtype,
                                **change))


def _models(arch):
    if arch not in _MODELS:
        jcfg, tcfg = _cfgs(arch)
        jm = jget_model(jcfg)
        jp = jm.init(jax.random.key(1))
        _MODELS[arch] = (jm, jp, tget_model(tcfg), params_from_jax(
            jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return _MODELS[arch]


def _moe_inputs(cfg, B, S, seed):
    """x (B, S, d) and the router and expert blocks, f32 numpy."""
    rng = np.random.RandomState(seed)
    d, E, G = cfg.d_model, cfg.n_experts, cfg.ep_shards
    ffp = E * cfg.d_ff // G
    x = rng.randn(B, S, d).astype(np.float32)
    router = (rng.randn(d, E) / 8).astype(np.float32)
    w1 = (rng.randn(G, d, ffp) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.randn(G, ffp, d) / np.sqrt(ffp)).astype(np.float32)
    w3 = ((rng.randn(G, d, ffp) / np.sqrt(d)).astype(np.float32)
          if cfg.ffn_kind == "swiglu" else None)
    return x, router, w1, w2, w3


def _both(arrays, dtype):
    """The same numpy arrays as JAX and torch arrays of ``dtype``."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    j = [None if a is None else jnp.asarray(a).astype(jd) for a in arrays]
    t = [None if a is None else torch.from_numpy(a).to(td) for a in arrays]
    return j, t


@pytest.mark.parametrize("arch", [LLAMA4, GROK])
def test_moe_schema_is_the_jax_schema(arch):
    """The MoE block's leaves (router, w1, w2 and, for swiglu experts
    only, w3) in the JAX schema's shapes and init kinds, at full width
    and reduced; ``init_params`` gives the JAX abstract params' shapes
    and dtypes; ``check_supported`` takes both archs."""
    for reduce in (False, True):
        jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
        if reduce:
            jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
        tT.check_supported(tcfg)
        tT.check_supported(tcfg, paged=True)
        jschema = jax.tree.map(lambda d: (tuple(d.shape), d.init),
                               jT.schema(jcfg),
                               is_leaf=lambda x: hasattr(x, "init"))
        tschema = map_schema(lambda d: (d.shape, d.init), tT.schema(tcfg))
        assert tschema == jschema
        assert ("w3" in tschema["blocks"]["moe"]) == (arch == LLAMA4)
    want = jax.tree.map(lambda s: (s.shape, str(s.dtype)),
                        jget_model(jcfg).abstract_params())
    got = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace(
        "torch.", "")), got)
    assert got == want


def test_dense_gelu_ffn_still_refused():
    """The dense gelu FFN was refused while the JAX ``layers.gelu_mlp``
    was not ported; it is now, with whisper.  grok-1's dense counterpart
    (the gelu MLP with biases in place of the experts) is taken and its
    train logits match the JAX package's."""
    jcfg, tcfg = (dataclasses.replace(c, n_experts=0, family="dense")
                  for c in _cfgs(GROK))
    tT.check_supported(tcfg)
    jp = jget_model(jcfg).init(jax.random.key(7))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert set(tp["blocks"]["ffn"]) == {"w_up", "b_up", "w_down", "b_down"}
    toks = np.random.RandomState(8).randint(0, tcfg.vocab_size, (2, 12))
    pos = np.broadcast_to(np.arange(12)[None], (2, 12)).astype(np.int32)
    jl, _, _ = jT.lm_forward(jp, jcfg, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(pos))
    tl, _, _ = tT.lm_forward(tp, tcfg, torch.from_numpy(toks),
                             torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("rows", list(ROWS))
@pytest.mark.parametrize("factor", [1.25, 100.0])
@pytest.mark.parametrize("which", list(MOE_CFGS))
def test_route_aux_and_moe_ffn_match_jax(which, factor, rows):
    arch, change = MOE_CFGS[which]
    jcfg, tcfg = _cfgs(arch, capacity_factor=factor, **change)
    B, S = ROWS[rows]
    arrays = _moe_inputs(jcfg, B, S, seed=B * S)
    (jx, jr, jw1, jw2, jw3), (tx, tr, tw1, tw2, tw3) = _both(arrays,
                                                             "float32")
    d = jcfg.d_model
    jg, je, jp = jmoe.route(jx.reshape(B * S, d), jr, jcfg)
    tg, te, tp = tmoe.route(tx.reshape(B * S, d), tr, tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **FN_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **FN_TOL)
    np.testing.assert_allclose(
        float(tmoe.aux_loss(te, tp, tcfg.n_experts)),
        float(jmoe.aux_loss(je, jp, jcfg.n_experts)), **FN_TOL)
    jo, ja = jmoe.moe_ffn(jx, jr, jw1, jw2, jw3, jcfg)
    to, ta = tmoe.moe_ffn(tx, tr, tw1, tw2, tw3, tcfg)
    assert to.shape == (B, S, d) and ta.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FN_TOL)
    np.testing.assert_allclose(float(ta), float(ja), **FN_TOL)
    # at factor 100 nothing is dropped: every row gets its k experts
    if factor == 100.0:
        assert (to.abs().sum(-1) > 0).all()


def test_pinned_drop_takes_a_real_rows_slot():
    """Four decode rows, E = 4, top-1, capacity int(1.25 * 4 / 4) = 1:
    row 0 (an inactive slot: it carries no request) and row 2 (a real
    one) both pick expert 0.  Row 0 comes first by index and takes the
    only slot, so row 2 gets exactly 0 from the MoE in both packages,
    while rows 1 and 3 (experts 1 and 2, alone) keep their outputs."""
    jcfg, tcfg = _cfgs(LLAMA4)
    x, router, w1, w2, w3 = _moe_inputs(jcfg, 4, 1, seed=5)
    d, E = jcfg.d_model, jcfg.n_experts
    router[:] = 0.0
    router[:E, :E] = 10.0 * np.eye(E, dtype=np.float32)
    x[:, 0, :E] = 0.0
    for row, e in enumerate([0, 1, 0, 2]):
        x[row, 0, e] = 1.0
    (jx, jr, jw1, jw2, jw3), (tx, tr, tw1, tw2, tw3) = _both(
        (x, router, w1, w2, w3), "float32")
    _, je, _ = jmoe.route(jx.reshape(4, d), jr, jcfg)
    assert np.asarray(je)[:, 0].tolist() == [0, 1, 0, 2]
    jo = np.asarray(jmoe.moe_ffn(jx, jr, jw1, jw2, jw3, jcfg)[0])[:, 0]
    to = tmoe.moe_ffn(tx, tr, tw1, tw2, tw3, tcfg)[0].numpy()[:, 0]
    for out in (jo, to):
        assert (out[2] == 0.0).all()
        assert all(np.abs(out[r]).max() > 0 for r in (0, 1, 3))
    np.testing.assert_allclose(to, jo, **FN_TOL)


@pytest.mark.parametrize("which", list(MOE_CFGS))
def test_moe_ffn_bf16_drift(which):
    """bf16 over 4 x 32 rows at the default capacity: where the two
    packages route a row alike (at least 90% of rows), its output is
    within BF16_ULPS bf16 ulps of the output's scale."""
    arch, change = MOE_CFGS[which]
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16", **change)
    B, S = ROWS["n128"]
    arrays = _moe_inputs(jcfg, B, S, seed=11)
    (jx, jr, *jw), (tx, tr, *tw) = _both(arrays, "bfloat16")
    d = jcfg.d_model
    _, je, _ = jmoe.route(jx.reshape(B * S, d), jr, jcfg)
    _, te, _ = tmoe.route(tx.reshape(B * S, d), tr, tcfg)
    same = (te.numpy() == np.asarray(je)).all(-1)
    assert same.mean() >= 0.9
    jo = np.asarray(jmoe.moe_ffn(jx, jr, *jw, jcfg)[0].astype(jnp.float32))
    to = tmoe.moe_ffn(tx, tr, *tw, tcfg)[0].float().numpy()
    jo, to = jo.reshape(B * S, d)[same], to.reshape(B * S, d)[same]
    bound = BF16_ULPS * 2.0 ** -8 * np.abs(jo).max()
    assert np.abs(to - jo).max() <= bound


# ---------------------------------------------------------------------------
# the model calls
# ---------------------------------------------------------------------------

def _tokens(vocab, B, S, seed):
    return np.random.RandomState(seed).randint(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("S", [8, 64], ids=["direct", "chunked"])
@pytest.mark.parametrize("arch", [LLAMA4, GROK])
def test_lm_forward_matches_jax(arch, S):
    """Train logits and the summed MoE aux, then prefill (last-position
    logits and every layer's K/V), through the direct and the chunked
    attention reference.  At S = 64 (128 rows) each expert's capacity
    binds."""
    jm, jp, tm, tp = _models(arch)
    B = 2
    toks = _tokens(jm.cfg.vocab_size, B, S, seed=S)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    jl, jaux, _ = jT.lm_forward(jp, jm.cfg, jnp.asarray(toks),
                                jnp.asarray(pos), mode="train")
    tl, taux, _ = tT.lm_forward(tp, tm.cfg, torch.from_numpy(toks),
                                torch.from_numpy(pos.copy()), mode="train")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), **FN_TOL)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


@pytest.mark.parametrize("arch", [LLAMA4, GROK])
def test_lm_decode_matches_jax(arch):
    """Prefill scattered into a whole-batch cache, then three decode
    steps with a per-slot window: logits, cache rows and ``pos``."""
    jm, jp, tm, tp = _models(arch)
    B, S = 3, 8
    toks = _tokens(jm.cfg.vocab_size, B, S, seed=4)
    _, jparts = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    _, tparts = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jc = jm.init_cache(B, S + 4)
    tc = tm.init_cache(B, S + 4, "cpu")
    for name in ("k", "v"):
        jc[name] = jc[name].at[:, :, :S].set(jparts[name])
        tc[name][:, :, :S] = tparts[name]
    start = np.array([0, 3, 1], np.int32)
    jc = dict(jc, pos=jnp.int32(S), start=jnp.asarray(start))
    tc["pos"] = torch.tensor(S, dtype=torch.int32)
    tc["start"] = torch.from_numpy(start)
    for step in range(3):
        nxt = _tokens(jm.cfg.vocab_size, B, 1, seed=10 + step)
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl).argmax(-1))
    assert int(tc["pos"]) == int(jc["pos"]) == S + 3
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   **TOL)


B_PAGED, PAGE, NB = 3, 4, 8


def _paged_caches(jm, tm):
    table = (np.arange(B_PAGED * NB, dtype=np.int32)[::-1]
             .reshape(B_PAGED, NB) + 1)
    jc = dict(jm.init_paged_cache(B_PAGED, NB, PAGE, B_PAGED * NB + 1),
              table=jnp.asarray(table))
    tc = tm.init_paged_cache(B_PAGED, NB, PAGE, B_PAGED * NB + 1, "cpu")
    tc["table"] = torch.from_numpy(table.copy())
    return jc, tc


def _pools_close(jc, tc):
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name][:, 1:].numpy(),
                                   np.asarray(jc[name])[:, 1:], **TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(tc["length"].numpy(),
                                  np.asarray(jc["length"]))


_PREFILLED = {}


def _prefilled(arch):
    """Both packages' caches after two ragged prefill chunks of T = 8:
    grants [8, 5, 0] (slot 2 idle, slot 1 with 3 pad rows), then [6, 0,
    8]; the last-granted logits of each chunk held equal on the way.
    Built once an arch; each caller gets its own copy of the port's."""
    if arch not in _PREFILLED:
        _PREFILLED[arch] = _prefill_twice(arch)
    jm, jp, tm, tp, jc, tc = _PREFILLED[arch]
    return jm, jp, tm, tp, dict(jc), {n: t.clone() for n, t in tc.items()}


def _prefill_twice(arch):
    jm, jp, tm, tp = _models(arch)
    rng = np.random.RandomState(3)
    jc, tc = _paged_caches(jm, tm)
    for grants in ([8, 5, 0], [6, 0, 8]):
        toks = rng.randint(0, jm.cfg.vocab_size,
                           (B_PAGED, 8)).astype(np.int32)
        g = np.asarray(grants, np.int32)
        jl, jc = jm.prefill_step_paged(jp, jnp.asarray(toks), jc,
                                       jnp.asarray(g))
        tl, tc = tm.prefill_step_paged(tp, torch.from_numpy(toks), tc,
                                       torch.from_numpy(g))
        live = g > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   **TOL)
        np.testing.assert_array_equal(tl.argmax(-1).numpy()[live],
                                      np.asarray(jl).argmax(-1)[live])
    return jm, jp, tm, tp, jc, tc


@pytest.mark.parametrize("arch", [LLAMA4, GROK])
def test_prefill_paged_with_idle_slot_and_pad_rows(arch):
    """``lm_prefill_paged`` with an idle slot and pad rows past a grant
    (the rows still route and take capacity): last-granted logits and
    the pools after two chunks, then one decode step."""
    jm, jp, tm, tp, jc, tc = _prefilled(arch)
    _pools_close(jc, tc)
    a = np.array([True, False, True])
    nxt = _tokens(jm.cfg.vocab_size, B_PAGED, 1, seed=9)
    jl, jc = jm.decode_step_paged(jp, jnp.asarray(nxt), jc, jnp.asarray(a))
    tl, tc = tm.decode_step_paged(tp, torch.from_numpy(nxt), tc,
                                  torch.from_numpy(a))
    np.testing.assert_allclose(tl.numpy()[a], np.asarray(jl)[a], **TOL)
    _pools_close(jc, tc)


@pytest.mark.parametrize("forced", [False, True], ids=["grants", "forced"])
@pytest.mark.parametrize("arch", [LLAMA4, GROK])
def test_decode_many_paged_matches_jax(arch, forced):
    """The fused decode loop under a (B,) grant vector [5, 2, 4], plain
    or with forced tokens (slot 0 at steps 0-2, slot 2 at steps 0 and
    3): greedy tokens identical, pools and lengths."""
    jm, jp, tm, tp, jc, tc = _prefilled(arch)
    steps = 5
    grants = np.array([5, 2, 4], np.int32)
    feed = _tokens(jm.cfg.vocab_size, B_PAGED, 1, seed=12)
    ftok = fmask = None
    if forced:
        ftok = _tokens(jm.cfg.vocab_size, steps, B_PAGED, seed=13)
        fmask = np.zeros((steps, B_PAGED), bool)
        fmask[:3, 0] = True
        fmask[[0, 3], 2] = True
    jt, jc, _ = jm.decode_many_paged(
        jp, jnp.asarray(feed), jc, jax.random.key(0), jnp.asarray(grants),
        None if ftok is None else jnp.asarray(ftok),
        None if fmask is None else jnp.asarray(fmask), num_steps=steps)
    tt, tc = tm.decode_many_paged(
        tp, torch.from_numpy(feed), tc, None, torch.from_numpy(grants),
        None if ftok is None else torch.from_numpy(ftok),
        None if fmask is None else torch.from_numpy(fmask), num_steps=steps)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _pools_close(jc, tc)


@pytest.mark.parametrize("arch", [LLAMA4, GROK])
def test_verify_paged_matches_jax(arch):
    """``lm_verify_paged`` over grants [4, 2, 0] (slot 2 idle): greedy at
    the granted positions, accept counts, every granted position's f32
    logits and the advanced lengths."""
    jm, jp, tm, tp, jc, tc = _prefilled(arch)
    toks = _tokens(jm.cfg.vocab_size, B_PAGED, 4, seed=14)
    grants = np.array([4, 2, 0], np.int32)
    tcc = {n: t.clone() for n, t in tc.items()}
    jg, ja, jc2 = jm.verify_many_paged(jp, jnp.asarray(toks), dict(jc),
                                       jnp.asarray(grants))
    tg, ta, tcc = tm.verify_many_paged(tp, torch.from_numpy(toks), tcc,
                                       torch.from_numpy(grants))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for b, g in enumerate(grants):
        np.testing.assert_array_equal(tg.numpy()[b, :g],
                                      np.asarray(jg)[b, :g])
    np.testing.assert_array_equal(tcc["length"].numpy(),
                                  np.asarray(jc2["length"]))
    jl, _ = jT.lm_prefill_paged(jp, jm.cfg, jnp.asarray(toks), dict(jc),
                                jnp.asarray(grants), unembed_all=True)
    tl, _ = tT.lm_prefill_paged(tp, tm.cfg, torch.from_numpy(toks),
                                {n: t.clone() for n, t in tc.items()},
                                torch.from_numpy(grants), unembed_all=True)
    for b, g in enumerate(grants):
        np.testing.assert_allclose(tl.numpy()[b, :g], np.asarray(jl)[b, :g],
                                   **TOL)


def test_null_page_collisions_settle_on_the_last_row():
    """Rows without a request all write the null page 0 and collide
    there.  For MoE archs every colliding row writes the last one's
    values, so the null page holds what a sequential scatter leaves (and
    the JAX package's scatter on the CPU), in any order the device lands
    them; live rows are untouched."""
    from repro_torch.models.transformer import _last_writer, _write_rows
    phys = torch.tensor([0, 3, 0, 2, 0])
    off = torch.tensor([1, 2, 1, 1, 1])
    assert _last_writer(phys, off, 4).tolist() == [4, 1, 4, 3, 4]
    rows = torch.arange(5, dtype=torch.float32)[:, None, None].expand(
        5, 1, 2).contiguous()
    cache = {n: torch.zeros(1, 4, 4, 1, 2) for n in ("k", "v")}
    _write_rows(cache, 0, phys, off, rows, -rows, settle=True)
    assert (cache["k"][0, 0, 1] == 4).all()
    assert (cache["v"][0, 0, 1] == -4).all()
    assert (cache["k"][0, 3, 2] == 1).all()
    assert (cache["k"][0, 2, 1] == 3).all()
    jc = jnp.zeros((4, 4, 1, 2)).at[jnp.asarray(phys), jnp.asarray(off)].set(
        jnp.asarray(rows.numpy()))
    np.testing.assert_array_equal(cache["k"][0].numpy(), np.asarray(jc))
