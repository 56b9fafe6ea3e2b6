"""The dense decode kernel (split over its positions) and the flash
kernel emulated on the CPU as ``test_torch_kernel_emulation`` runs them
(its fixtures and cases), held against the plain versions, and
``models.attention.attention`` and an MoE prefill through the kernel
routes.

This section was ``test_torch_kernel_emulation.py``'s; it lives in a
file of its own so that ``--dist loadfile`` gives it a worker of its
own.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import decode, prefill_paged
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import flash
from repro_torch.models import attention as attention_mod
from repro_torch.models.attention import repeat_kv
from repro_torch.models.flash import flash_attention_ref

from test_torch_kernel_emulation import (  # noqa: F401  (fixtures)
    DECODE_CASES, FLASH_CASES, TOL, _dense, _one_thread, cuda_path_on_cpu,
    emulated)


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_emulated_decode_attention_matches_plain(case, cuda_path_on_cpu):
    """A scalar kv_len below T and kv_start > 0 in every slot but the
    first; then no kv_start at all; then an empty window (kv_start >=
    kv_len) in slot 1, which the kernel gives as exact zeros."""
    B, T, H, KV, D, dtype = case
    q, k, v = _dense(T + H, B, 1, T, H, KV, D, dtype)
    tol = TOL[dtype]
    kv_len = torch.tensor(T - 3, dtype=torch.int32)
    start = torch.tensor([0] + [1 + 5 * b % (T - 4) for b in range(1, B)],
                         dtype=torch.int32)           # all below kv_len
    n0 = decode.KERNEL.launches
    for s in (start, None):
        got = decode.decode_attention(q, k, v, kv_len, s)
        want = decode_attention_ref(q, k, v, kv_len, s)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    empty = start.clone()
    empty[1] = T - 3
    got = decode.decode_attention(q, k, v, kv_len, empty)
    want = decode_attention_ref(q, k, v, kv_len, empty)
    assert (got[1] == 0).all()
    keep = torch.arange(B) != 1
    torch.testing.assert_close(got[keep].float(), want[keep].float(),
                               rtol=tol, atol=tol)
    assert decode.KERNEL.launches == n0 + 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_decode_attention_across_splits(dtype, cuda_path_on_cpu):
    """A cache of 300 rows over 10 splits per kv head, each a whole number
    of 32-position tiles of the slot's window: a full window (the last
    piece 2 rows), kv_start = 37 (the pieces start inside a cache tile),
    a window of 40 (pieces 2-9 empty while the window is not) and one of
    a single row; then slot 3's window empty, which the kernel gives as
    exact zeros.  The same tolerances as the single-split cases."""
    B, T, H, KV, D = 4, 300, 8, 2, 32
    assert decode.splits(T, B, KV) == 10
    q, k, v = _dense(T, B, 1, T, H, KV, D, dtype)
    tol = TOL[dtype]
    kv_len = torch.tensor(290, dtype=torch.int32)
    start = torch.tensor([0, 37, 250, 289], dtype=torch.int32)
    n0 = decode.KERNEL.launches
    got = decode.decode_attention(q, k, v, kv_len, start)
    want = decode_attention_ref(q, k, v, kv_len, start)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    start[3] = 290
    got = decode.decode_attention(q, k, v, kv_len, start)
    want = decode_attention_ref(q, k, v, kv_len, start)
    assert (got[3] == 0).all()
    torch.testing.assert_close(got[:3].float(), want[:3].float(), rtol=tol,
                               atol=tol)
    assert decode.KERNEL.launches == n0 + 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_decode_online_softmax_across_tiles(dtype,
                                                     cuda_path_on_cpu):
    """B x KV = 33 leaves 8 splits, so a 1090-row window gives pieces of
    five 32-position tiles: the online softmax carries m, l and acc
    across tiles and the 3-stage cp.async ring reuses its stages; slot 1
    starts mid-tile, slot 2's window is a single tile."""
    B, T, H, KV, D = 3, 1100, 11, 11, 16
    assert decode.splits(T, B, KV) == 8
    q, k, v = _dense(T + 1, B, 1, T, H, KV, D, dtype)
    kv_len = torch.tensor(1090, dtype=torch.int32)
    start = torch.tensor([0, 45, 1070], dtype=torch.int32)
    got = decode.decode_attention(q, k, v, kv_len, start)
    want = decode_attention_ref(q, k, v, kv_len, start)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_emulated_decode_refuses_misaligned_cache(cuda_path_on_cpu):
    """The kernel copies K and V 16 bytes at a time: a cache view 4 bytes
    past a 16-byte boundary is refused, not read another way."""
    q, k, v = _dense(3, 2, 1, 8, 4, 2, 16, torch.float32)
    shifted = torch.zeros(k.numel() + 1)[1:].view(k.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode.decode_attention(q, shifted, v, 8)


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_emulated_flash_attention_matches_plain(case, cuda_path_on_cpu):
    """k and v unrepeated (KV dividing H); the plain version runs on them
    repeated to H heads."""
    B, S, T, H, KV, D, causal, dtype = case
    q, k, v = _dense(S + T + D, B, S, T, H, KV, D, dtype)
    tol = TOL[dtype]
    n0 = flash.KERNEL.launches
    got = flash.flash_attention(q, k, v, causal=causal)
    want = flash_attention_ref(q, repeat_kv(k, H), repeat_kv(v, H), causal,
                               S, T)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert flash.KERNEL.launches == n0 + 1


def test_emulated_attention_route_takes_what_the_reference_serves(
        cuda_path_on_cpu):
    """``attention()`` on the kernel route at S = T = 600 (chunks of 1024:
    the reference's direct attention; 512 does not divide 600, so the JAX
    Pallas wrapper's contract refuses it) and at S = T = 608 over chunks
    of 32 (the reduced configs: the chunked reference, which 512 does not
    divide either) through the emulated flash kernel, against the
    reference dispatch, f32 within 2e-5.  The public wrapper keeps the
    512-block contract, and a shape both dispatches refuse still raises,
    with no launch."""
    n0 = flash.KERNEL.launches
    for S, chunk in ((600, 1024), (608, 32)):
        q, k, v = _dense(S, 1, S, S, 4, 2, 16, torch.float32)
        got = attention_mod.attention(q, k, v, True, chunk, chunk)
        want = attention_mod.attention(q, k, v, True, chunk, chunk,
                                       plain=True)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        if S == 600:
            torch.testing.assert_close(
                got, attention_mod.direct_attention(q, k, v, True),
                rtol=2e-5, atol=2e-5)
        with pytest.raises(ValueError, match="divide"):
            flash.flash_attention(q, k, v)
    assert flash.KERNEL.launches == n0 + 2
    q, k, v = _dense(7, 1, 40, 40, 2, 2, 16, torch.float32)
    for plain in (False, True):          # 32 * 32 < 40 * 40, 32 !| 40
        with pytest.raises(AssertionError):
            attention_mod.attention(q, k, v, True, 32, 32, plain=plain)
    assert flash.KERNEL.launches == n0 + 2


def test_emulated_moe_prefill_takes_the_pallas_routes_drops(
        cuda_path_on_cpu):
    """The MoE's capacity counts every row of a call, idle slots' among
    them, and an idle prefill slot's attention is exact zeros on the
    kernels (Pallas and CUDA) but a uniform softmax over its table's
    pages in both references.  llama4-scout reduced in f32 (E 4, top-1,
    capacity int(1.25 * 24 / 4) = 7 of 24 rows): one ``lm_prefill_paged``
    over pools holding earlier rows, slot 0 idle and first by index,
    slot 1 granted 8 rows from 0, slot 2 3 rows from 5 (5 pad rows).
    The port's kernel route (the emulated CUDA kernels) is within 1e-4 of
    the JAX package's ``attention_impl="pallas"`` route (interpret mode)
    on the live slots' logits and pools, and both kernel routes differ
    from both references (the JAX ``"reference"`` route and the port's
    plain route, within 1e-4 of each other) on a real slot by far more:
    the idle rows route differently and take other real rows'
    capacity."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro.models import get_model as jget_model
    from repro_torch import configs as tconfigs
    from repro_torch.models.model import get_model as tget_model
    from repro_torch.models.params import params_from_jax

    arch = "llama4-scout-17b-a16e"
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get(arch).reduced(), dtype="float32")
    jp = jget_model(jcfg).init(jax.random.key(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    B, T, page, NB = 3, 8, 4, 8
    P = B * NB + 1
    rng = np.random.RandomState(0)
    shape = (tcfg.n_layers, P, page, tcfg.n_kv_heads, tcfg.head_dim)
    pools = {n: rng.randn(*shape).astype(np.float32) for n in ("k", "v")}
    table = np.arange(B * NB, dtype=np.int32)[::-1].reshape(B, NB) + 1
    length = np.array([0, 0, 5], np.int32)
    toks = rng.randint(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    grants = np.array([0, 8, 3], np.int32)
    live = grants > 0
    out = {}
    for impl in ("pallas", "reference"):
        jm = jget_model(dataclasses.replace(jcfg, attention_impl=impl))
        jc = dict(jm.init_paged_cache(B, NB, page, P),
                  table=jnp.asarray(table), length=jnp.asarray(length),
                  **{n: jnp.asarray(a) for n, a in pools.items()})
        logits, jc = jm.prefill_step_paged(jp, jnp.asarray(toks), jc,
                                           jnp.asarray(grants))
        out["jax " + impl] = (np.asarray(logits)[live],
                              np.asarray(jc["k"])[:, 1:])
    n0 = prefill_paged.KERNEL.launches
    for name, plain in (("port kernel", False), ("port plain", True)):
        tc = tget_model(tcfg, plain).init_paged_cache(B, NB, page, P, "cpu")
        tc.update(table=torch.from_numpy(table.copy()),
                  length=torch.from_numpy(length.copy()),
                  **{n: torch.from_numpy(a.copy()) for n, a in pools.items()})
        logits, tc = tget_model(tcfg, plain).prefill_step_paged(
            tp, torch.from_numpy(toks), tc, torch.from_numpy(grants))
        out[name] = (logits.numpy()[live], tc["k"][:, 1:].numpy())
    assert prefill_paged.KERNEL.launches == n0 + tcfg.n_layers
    for got, want in (("port kernel", "jax pallas"),
                      ("port plain", "jax reference")):
        for a, b in zip(out[got], out[want]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    gap = np.abs(out["jax pallas"][0] - out["jax reference"][0]).max(-1)
    assert gap.max() > 0.05, gap
