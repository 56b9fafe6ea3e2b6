"""Prefill-by-decode in the port against the JAX package, on the CPU.

With ``prefill_lane=False`` the paged engine has no prefill lane: prompt
tokens ride the decode loop as forced tokens of ``decode_many_paged``,
one step per token.  Held here, in f32 on the reduced qwen2-0.5b with the
weights bridged from the JAX tree:

  * ``Model.decode_many_paged`` with forced tokens, under each of the
    three forms its ``active`` takes (a per-step mask, one mask for every
    step, per-slot grants), against the JAX cell on the same cache:
    tokens equal, pools within 1e-4, lengths equal;
  * the engine with ``prefill_lane=False`` in lockstep with the JAX
    engine's: grant plans, the page pool, slots (histories, forced
    tokens, outputs), statuses and counters after every tick, the forced
    and prefill upload bytes among them; and its outputs equal to the
    lane engine's;
  * on int8 pools, the port's engine with the lane and without gives the
    same tokens (``test_kv_quant.py::test_int8_lane_vs_decode_token_
    identical`` on the port's own engine).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.serve.engine import PagedEngine as TPagedEngine
from repro_torch.serve.engine import ServeConfig as TServeConfig

from test_torch_overload import (_engines, _finish, _models, _rand,
                                 _step_both, _submit_both)
from test_torch_paged_model import B, _caches, _pools_close
from test_torch_paged_model import _models as _step_models
from torch_one_thread import _one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
STEPS = 5
ACTIVE = {                       # the three forms of decode_many_paged's
    "per-step mask": np.array([[1, 1], [1, 0], [1, 1], [0, 1], [1, 1]],
                              bool),
    "one mask": np.array([True, False]),
    "grants": np.array([5, 2], np.int32),
}


@pytest.mark.parametrize("form", list(ACTIVE))
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_forced_decode_many_matches_jax(form, kv_dtype):
    """Forced tokens over the first steps of each slot (slot 0 forced at
    steps 0-2, slot 1 at step 0 and again at step 3), under each form of
    ``active``: the port's loop gives the JAX cell's tokens (overridden
    where forced, frozen where inactive), pools and lengths."""
    jm, jp, tm, tp = _step_models("qwen2-0.5b", kv_dtype=kv_dtype)
    jc, tc = _caches(jm, tm)
    prompt = np.array([[5, 9, 2, 7], [3, 3, 8, 1]], np.int32)
    grants = np.array([4, 3], np.int32)
    _, jc = jm.prefill_step_paged(jp, jnp.asarray(prompt), jc,
                                  jnp.asarray(grants))
    _, tc = tm.prefill_step_paged(tp, torch.from_numpy(prompt), tc,
                                  torch.from_numpy(grants))
    rng = np.random.RandomState(2)
    forced_tok = rng.randint(0, jm.cfg.vocab_size,
                             (STEPS, B)).astype(np.int32)
    forced_mask = np.zeros((STEPS, B), bool)
    forced_mask[:3, 0] = True
    forced_mask[[0, 3], 1] = True
    feed = np.array([[11], [4]], np.int32)
    active = ACTIVE[form]
    jt, jc, _ = jax.jit(jm.decode_many_paged,
                        static_argnames=("num_steps", "temperature"))(
        jp, jnp.asarray(feed), jc, jax.random.key(0), jnp.asarray(active),
        jnp.asarray(forced_tok), jnp.asarray(forced_mask),
        num_steps=STEPS)
    tt, tc = tm.decode_many_paged(
        tp, torch.from_numpy(feed), tc, torch.Generator().manual_seed(0),
        torch.from_numpy(active), torch.from_numpy(forced_tok),
        torch.from_numpy(forced_mask), num_steps=STEPS)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    names = ["k", "v"] + (["k_scale", "v_scale"] if kv_dtype == "int8"
                          else [])
    _pools_close(jc, tc, names)
    mask = active if active.dtype == bool else \
        np.arange(STEPS)[:, None] < active[None]
    mask = np.broadcast_to(mask, (STEPS, B))
    want_len = grants + mask.sum(0)
    np.testing.assert_array_equal(tc["length"].numpy(), want_len)
    # where a slot is active and forced, the forced token comes out
    sel = mask & forced_mask
    np.testing.assert_array_equal(tt.numpy()[sel], forced_tok[sel])


def test_plain_decode_many_builds_no_forced_arrays():
    """Without forced tokens the grant form stays the lean loop: the
    JAX cell's plain twin gives the same tokens and pools."""
    jm, jp, tm, tp = _step_models("qwen2-0.5b")
    jc, tc = _caches(jm, tm)
    feed = np.array([[11], [4]], np.int32)
    steps = np.array([3, 1], np.int32)
    jt, jc, _ = jm.decode_many_paged(jp, jnp.asarray(feed), jc,
                                     jax.random.key(0), jnp.asarray(steps),
                                     None, None, num_steps=3)
    tt, tc = tm.decode_many_paged(tp, torch.from_numpy(feed), tc, None,
                                  torch.from_numpy(steps), num_steps=3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    _pools_close(jc, tc, ["k", "v"])


# ---------------------------------------------------------------------------
# the engine without a lane, tick for tick against the JAX engine
# ---------------------------------------------------------------------------

NO_LANE = dict(max_batch=3, max_seq=48, page_size=4, prefill_chunk=3,
               max_new_tokens=5, prefill_lane=False)


def _lockstep(serve, work, stagger=3):
    """Submits ``work`` to both engines (a tick after every ``stagger``
    submissions) and drains them in lockstep, comparing the forced and
    prefill upload counters after every tick as well."""
    je, te = _engines(**serve)
    assert te._chunk_tokens == je._chunk_tokens == 0
    rids = []
    for n, (p, b) in enumerate(work):
        rids.append(_submit_both(je, te, p, b))
        if n % stagger == stagger - 1:
            assert _step_both(je, te) is None
            assert te.forced_upload_bytes == je.forced_upload_bytes
    while je.busy or te.busy:
        assert _step_both(je, te) is None
        assert te.forced_upload_bytes == je.forced_upload_bytes
        assert te.prefill_upload_bytes == je.prefill_upload_bytes == 0
    _finish(je, te)
    return je, te, rids


def _lane_tokens(serve, work):
    """The port's tokens for ``work`` with the prefill lane on."""
    _, _, tm, tp = _models()
    te = TPagedEngine(tm, tp, TServeConfig(**dict(serve, prefill_lane=True)))
    rids = [te.submit(p, b) for p, b in work]
    te.run()
    return [te.results[r] for r in rids]


@pytest.mark.parametrize("sharing", [False, True])
def test_no_lane_engine_matches_jax_tick_for_tick(sharing):
    """Eight requests of 3-16 prompt tokens, staggered, with sharing off
    and on (three prompts behind a common 9-token head, one repeat):
    the two engines agree after every tick, every prompt token goes up
    as a forced token, no lane bytes move, and the tokens are the lane
    engine's."""
    rng = np.random.RandomState(21)
    head = _rand(rng, 9)
    work = [(_rand(rng, n), int(b)) for n, b in
            zip((3, 16, 5, 8, 11), rng.randint(3, 6, size=5))]
    work += [(np.concatenate([head, _rand(rng, n)]), 4) for n in (2, 5)]
    work += [(work[5][0].copy(), 5), (head.copy(), 3)]
    serve = dict(NO_LANE, prefix_sharing=sharing, retain_prefixes=sharing)
    je, te, rids = _lockstep(serve, work)
    assert te.forced_upload_bytes > 0 and te.prefill_upload_bytes == 0
    if sharing:
        assert te.shared_tokens > 0
    assert [te.results[r] for r in rids] == _lane_tokens(serve, work)


def test_no_lane_engine_under_preemption_matches_jax():
    """An oversold pool (seven pages for three slots of up to four): the
    victims requeue and recompute their prompt and output as forced
    tokens, tick for tick as in the JAX engine, and finish with the lane
    engine's tokens."""
    rng = np.random.RandomState(3)
    work = [(_rand(rng, n), 8) for n in (8, 5, 8, 3, 8, 5)]
    serve = dict(NO_LANE, num_pages=8, max_new_tokens=8)
    je, te, rids = _lockstep(serve, work, stagger=6)
    assert te.preemptions > 0 and te.recompute_tokens > 0
    assert [te.results[r] for r in rids] == _lane_tokens(serve, work)


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_lane_vs_decode_token_identical(seed):
    """test_kv_quant.py's schedule on the port's own engine: int8 pools,
    the prefill lane on and off, staggered submissions; both write paths
    quantize the same rows, so the tokens are identical."""
    _, _, tm, tp = _models("int8")
    rng = np.random.RandomState(seed)
    reqs = [(_rand(rng, rng.choice((3, 5, 8, 11))), int(rng.choice((3, 5))))
            for _ in range(8)]
    outs = {}
    for lane in (True, False):
        pe = TPagedEngine(tm, tp, TServeConfig(
            max_batch=3, max_seq=48, max_new_tokens=5, page_size=4,
            prefill_chunk=3, prefill_lane=lane))
        assert pe.kv.quantized
        rids = []
        for i, (p, b) in enumerate(reqs):
            rids.append(pe.submit(p, b))
            if i % 3 == 2:
                pe.step()
                pe.kv.check()
        res = pe.run()
        pe.kv.check()
        assert pe.kv.live_pages == 0
        assert (pe.forced_upload_bytes > 0) == (not lane)
        outs[lane] = [res[r] for r in rids]
    assert outs[True] == outs[False]


def test_launcher_no_prefill_lane_cpu():
    """``--no-prefill-lane`` on the CPU serves every request with prompts
    uploaded as forced tokens and no lane bytes."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--local-smoke",
         "--device", "cpu", "--no-prefill-lane"], env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "8 requests" in res.stdout
    line = next(ln for ln in res.stdout.splitlines()
                if "prefill-by-decode" in ln)
    assert "0 prefill-lane bytes" in line and " 0 forced" not in line
