"""The dense CUDA kernels at the zamba2 hybrid's head dim, D = 112 (3584 /
32 heads), compiled for the CPU as ``test_torch_kernel_emulation``
compiles them (its fixtures), and the hybrid's kernel route end to end.

  * Dense decode at D = 112, f32 and bf16, MHA as zamba2's shared block
    (G = 1) and G = 2: random windows, no window and an empty one (exact
    zeros), and windows on the split pieces' edges over a 300-row cache.
  * Flash at D = 112: the bf16 tensor-core body (7 k16 blocks of Q K^T,
    7 pairs of n8 tiles of P V) and the f32 CUDA-core body, causal and
    not, S = T over several q and k/v tiles, S != T both ways.
  * The trip models at D = 112 against the emulated kernels' own
    ``REPRO_TRIP`` counts.
  * zamba2 ``.reduced()`` in f32 with its heads widened to 112 (two heads,
    13 layers: two applications of the shared block) on the kernel route
    — its prefill's attention through ``models.attention.attention`` to
    the flash kernel, its decode steps through the dense decode kernel —
    against the plain route: logits within 1e-4, greedy tokens identical,
    and each kernel launched once per application.

The tolerances are the emulation file's: f32 2e-5, bf16 1e-2 for a
kernel; 1e-4 for a model's logits, as the parity tests hold two
frameworks' f32 sums.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.kernels.decode_attention import decode
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import flash
from repro_torch.models import attention as attention_mod
from repro_torch.models.attention import repeat_kv
from repro_torch.models.flash import flash_attention_ref
from repro_torch.models.model import get_model

from test_torch_kernel_emulation import (  # noqa: F401  (fixtures)
    TOL, _dense, cuda_path_on_cpu, emulated, _one_thread)
from test_torch_stream_scan_emulation import _check_trips

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
D = 112

# (B, T, H, KV, dtype): zamba2's MHA, and G = 2
DECODE_CASES = [(2, 40, 4, 4, torch.float32),
                (2, 70, 4, 4, torch.bfloat16),
                (3, 45, 4, 2, torch.bfloat16)]


def _ids(c):
    return "-".join(str(x).replace("torch.", "") for x in c)


@pytest.mark.parametrize("case", DECODE_CASES, ids=_ids)
def test_emulated_decode_attention_at_d112(case, cuda_path_on_cpu):
    """A scalar kv_len below T with a kv_start in every slot but the
    first, then no kv_start, then slot 1's window empty: exact zeros."""
    B, T, H, KV, dtype = case
    assert D in decode.HEAD_DIMS
    q, k, v = _dense(T + H, B, 1, T, H, KV, D, dtype)
    tol = TOL[dtype]
    kv_len = torch.tensor(T - 3, dtype=torch.int32)
    start = torch.tensor([0] + [2 + 7 * b for b in range(1, B)],
                         dtype=torch.int32)
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
def test_emulated_decode_attention_d112_across_splits(dtype,
                                                      cuda_path_on_cpu):
    """10 splits of a 300-row cache: a full window, one starting inside a
    tile (37), one of 40 rows (most pieces empty), one of a single row;
    then slot 3's window empty."""
    B, T, H, KV = 4, 300, 2, 2
    assert decode.splits(T, B, KV) == 10
    q, k, v = _dense(T + D, B, 1, T, H, KV, D, dtype)
    tol = TOL[dtype]
    kv_len = torch.tensor(290, dtype=torch.int32)
    start = torch.tensor([0, 37, 250, 289], dtype=torch.int32)
    got = decode.decode_attention(q, k, v, kv_len, start)
    torch.testing.assert_close(
        got.float(), decode_attention_ref(q, k, v, kv_len, start).float(),
        rtol=tol, atol=tol)
    start[3] = 290
    got = decode.decode_attention(q, k, v, kv_len, start)
    want = decode_attention_ref(q, k, v, kv_len, start)
    assert (got[3] == 0).all()
    torch.testing.assert_close(got[:3].float(), want[:3].float(), rtol=tol,
                               atol=tol)


# (B, S, T, H, KV, causal, dtype): ragged causal S; two ragged q and k/v
# tiles, non-causal; S < T and S > T; 130 rows of G = 1 over two bf16
# row tiles of 128 and three k/v tiles of 64; G = 2; f32 on the CUDA cores
FLASH_CASES = [(2, 37, 37, 2, 2, True, torch.bfloat16),
               (1, 70, 70, 2, 2, False, torch.bfloat16),
               (1, 20, 150, 2, 2, False, torch.bfloat16),
               (1, 90, 33, 2, 2, False, torch.bfloat16),
               (1, 130, 130, 1, 1, True, torch.bfloat16),
               (1, 40, 40, 4, 2, True, torch.bfloat16),
               (2, 37, 37, 2, 2, True, torch.float32),
               (1, 20, 45, 2, 2, False, torch.float32),
               (1, 70, 64, 2, 1, True, torch.float32)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=_ids)
def test_emulated_flash_at_d112(case, cuda_path_on_cpu):
    B, S, T, H, KV, causal, dtype = case
    q, k, v = _dense(S + T + D, B, S, T, H, KV, D, dtype)
    n0 = flash.KERNEL.launches
    got = flash.launch(q, k, v, causal)
    want = flash_attention_ref(q, repeat_kv(k, H), repeat_kv(v, H), causal,
                               S, T)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert flash.KERNEL.launches == n0 + 1


@pytest.mark.parametrize("case", DECODE_CASES, ids=_ids)
def test_trip_model_of_dense_decode_at_d112(case, emulated,
                                            cuda_path_on_cpu):
    """kv_len below T, a kv_start in every slot but the first and an empty
    window in the last."""
    B, T, H, KV, dtype = case
    q, k, v = _dense(T + H, B, 1, T, H, KV, D, dtype)
    kv_len = T - 3
    start = [0, kv_len] if B == 2 else [0, 5, kv_len]
    model = decode.trip_model(B, T, H, KV, D, kv_len, start, dtype)
    _check_trips(emulated, model, lambda: decode.decode_attention(
        q, k, v, kv_len, torch.tensor(start, dtype=torch.int32)))


@pytest.mark.parametrize("case", FLASH_CASES[::2], ids=_ids)
def test_trip_model_of_flash_at_d112(case, emulated, cuda_path_on_cpu):
    B, S, T, H, KV, causal, dtype = case
    q, k, v = _dense(S + T + D, B, S, T, H, KV, D, dtype)
    model = flash.trip_model(B, S, T, H, KV, D, causal, dtype)
    _check_trips(emulated, model, lambda: flash.launch(q, k, v, causal))


def test_emulated_attention_route_at_d112(cuda_path_on_cpu):
    """``models.attention.attention`` at D = 112, f32: S = T = 48 over the
    reduced chunks of 32 (48 * 48 > 32 * 32 and 32 does not divide 48:
    the reference dispatch refuses it, and so does the kernel route, with
    no launch), S = T = 64 (the chunked reference on the plain route) and
    S = T = 24 (direct attention): the kernel route through the flash
    kernel, against the plain route."""
    n0 = flash.KERNEL.launches
    for S in (64, 24):
        q, k, v = _dense(S, 2, S, S, 2, 2, D, torch.float32)
        got = attention_mod.attention(q, k, v, True, 32, 32)
        want = attention_mod.attention(q, k, v, True, 32, 32, plain=True)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert flash.KERNEL.launches == n0 + 2
    q, k, v = _dense(48, 1, 48, 48, 2, 2, D, torch.float32)
    with pytest.raises(AssertionError):
        attention_mod.attention(q, k, v, True, 32, 32)
    assert flash.KERNEL.launches == n0 + 2


def test_emulated_hybrid_kernel_route(cuda_path_on_cpu):
    """zamba2 reduced, f32, heads of 112, 13 layers (G = 2, R = 1): the
    prefill of 2 x 64 tokens and 5 greedy decode steps on the kernel route
    against the plain route."""
    cfg = dataclasses.replace(tconfigs.get("zamba2-7b").reduced(),
                              dtype="float32", n_layers=13, n_heads=2,
                              n_kv_heads=2, d_head=D)
    params = get_model(cfg).init(torch.Generator().manual_seed(21), "cpu")
    rng = np.random.RandomState(22)
    B, S, steps = 2, 64, 5
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S)).astype(
        np.int32))
    G = cfg.n_layers // cfg.attn_every
    n0 = (flash.KERNEL.launches, decode.KERNEL.launches)
    out = {}
    for plain in (False, True):
        m = get_model(cfg, plain_attention=plain)
        last, parts = m.prefill(params, {"tokens": toks})
        cache = m.init_cache(B, S + steps + 1, "cpu")
        for name, src in parts.items():
            cache[name][tuple(slice(0, n) for n in src.shape)] = src
        cache["pos"] = torch.tensor(S, dtype=torch.int32)
        first = last.argmax(-1).to(torch.int32)[:, None]
        step, cache = m.decode_step(params, first, cache)
        more, _, _ = m.decode_many(params, step.argmax(-1).to(
            torch.int32)[:, None], cache, None, steps)
        out[plain] = (last, step, more)
    torch.testing.assert_close(out[False][0], out[True][0], **MODEL_TOL)
    torch.testing.assert_close(out[False][1], out[True][1], **MODEL_TOL)
    assert torch.equal(out[False][2], out[True][2])
    assert flash.KERNEL.launches - n0[0] == G
    assert decode.KERNEL.launches - n0[1] == G * (1 + steps)
