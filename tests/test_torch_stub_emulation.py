"""The CUDA kernels, compiled for the CPU as ``test_torch_kernel_emulation``
compiles them (its fixtures), at the geometries the stub-frontend
families bring, and the two families' kernel routes end to end.

  * The paged decode and prefill kernels at qwen2-vl's G = 8 (64 query
    heads over 8 KV heads) at D = 128, bf16, f32 and int8 pools.
  * The dense decode kernel at whisper's G = 1, D = 64 (its decoder's
    self-attention) and at G = 8, D = 128 (qwen2-vl's whole-batch decode).
  * The flash kernel at whisper's shapes, G = 1 at D = 64: non-causal S = T
    (the encoder), causal (the decoder's self-attention) and non-causal
    with S != T both ways (the cross-attention); and at G = 8, D = 128,
    causal (qwen2-vl's prefill).
  * whisper ``.reduced()`` in f32 on the kernel route (flash for the
    encoder, the decoder and the cross-attention; dense decode for the
    self-attention decode) against the plain route: prefill and decode
    logits within 1e-4 and greedy tokens identical; and qwen2-vl
    ``.reduced()``: an embeddings prefill with distinct M-RoPE streams, a
    paged prefill chunk and a paged decode step on the kernel route
    against the plain route, likewise.

The tolerances are the emulation file's: f32 2e-5, bf16 1e-2 for a
kernel; 1e-4 for a model's logits, as the parity tests hold two
frameworks' f32 sums.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.kernels.decode_attention import decode, paged, prefill_paged
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref,
    paged_prefill_attention_ref)
from repro_torch.kernels.flash_attention import flash
from repro_torch.models.attention import repeat_kv
from repro_torch.models.flash import flash_attention_ref
from repro_torch.models.model import get_model

from test_torch_kernel_emulation import (  # noqa: F401  (fixtures)
    TOL, _case, _dense, cuda_path_on_cpu, emulated)

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)

# (B, T, H, KV, D, page, NB, L, dtype, int8 pools): qwen2-vl's G = 8 at
# D = 128; T * G = 24 rows against the prefill's 16-row tiles
PAGED_CASES = [(2, 3, 64, 8, 128, 16, 2, 1, torch.bfloat16, False),
               (2, 3, 64, 8, 128, 16, 2, 1, torch.float32, False),
               (2, 3, 64, 8, 128, 16, 2, 1, torch.bfloat16, True)]


@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_emulated_paged_kernels_at_g8(case, cuda_path_on_cpu):
    *geom, dtype, int8 = case
    q, kp, vp, tbl, base, new, layer, ks, vs = _case(sum(geom), *geom,
                                                     dtype, int8, empty=True)
    tol = TOL[dtype]
    n0 = (paged.KERNEL.launches, prefill_paged.KERNEL.launches)
    got = prefill_paged.paged_prefill_attention(
        q, kp, vp, tbl, base, new, layer, k_scale=ks, v_scale=vs)
    want = paged_prefill_attention_ref(q, kp, vp, tbl, base, new, layer,
                                       ks, vs)
    live = new > 0
    assert (got[~live] == 0).all()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               rtol=tol, atol=tol)
    kv_len = torch.maximum(new, torch.ones_like(new))
    got = paged.paged_decode_attention(q[:, :1].contiguous(), kp, vp, tbl,
                                       kv_len, layer, k_scale=ks, v_scale=vs)
    want = paged_decode_attention_ref(q[:, :1], kp, vp, tbl, kv_len, layer,
                                      ks, vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert (paged.KERNEL.launches, prefill_paged.KERNEL.launches) == \
        (n0[0] + 1, n0[1] + 1)


# (B, T, H, KV, D, dtype): whisper's G = 1 at D = 64; qwen2-vl's G = 8 at
# D = 128
DECODE_CASES = [(2, 40, 4, 4, 64, torch.float32),
                (2, 70, 4, 4, 64, torch.bfloat16),
                (2, 20, 64, 8, 128, torch.bfloat16)]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_emulated_decode_attention_stub_geometries(case, cuda_path_on_cpu):
    B, T, H, KV, D, dtype = case
    q, k, v = _dense(T + H, B, 1, T, H, KV, D, dtype)
    kv_len = torch.tensor(T - 2, dtype=torch.int32)
    start = torch.tensor([0, 3], dtype=torch.int32)
    n0 = decode.KERNEL.launches
    for s in (start, None):
        got = decode.decode_attention(q, k, v, kv_len, s)
        want = decode_attention_ref(q, k, v, kv_len, s)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    assert decode.KERNEL.launches == n0 + 2


# (B, S, T, H, KV, D, causal, dtype): whisper's encoder (non-causal S = T),
# decoder (causal) and cross-attention (non-causal, S < T and S > T) at
# G = 1, D = 64; qwen2-vl's causal prefill at G = 8, D = 128
FLASH_CASES = [(1, 150, 150, 2, 2, 64, False, torch.bfloat16),
               (1, 70, 70, 2, 2, 64, False, torch.float32),
               (2, 37, 37, 2, 2, 64, True, torch.bfloat16),
               (2, 20, 150, 2, 2, 64, False, torch.bfloat16),
               (1, 20, 150, 2, 2, 64, False, torch.float32),
               (1, 90, 33, 2, 2, 64, False, torch.bfloat16),
               (1, 24, 24, 16, 2, 128, True, torch.bfloat16)]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_emulated_flash_stub_geometries(case, cuda_path_on_cpu):
    B, S, T, H, KV, D, causal, dtype = case
    q, k, v = _dense(S + T + D, B, S, T, H, KV, D, dtype)
    n0 = flash.KERNEL.launches
    got = flash.launch(q, k, v, causal)
    want = flash_attention_ref(q, repeat_kv(k, H), repeat_kv(v, H), causal,
                               S, T)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert flash.KERNEL.launches == n0 + 1


def _reduced(arch, seed):
    cfg = dataclasses.replace(tconfigs.get(arch).reduced(), dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    return cfg, get_model(cfg).init(gen, "cpu")


def test_emulated_whisper_kernel_route(cuda_path_on_cpu):
    """64 frames (the reduced chunks of 32 divide them: the plain side's
    encoder takes the chunked reference), 6 decoder tokens, 5 greedy
    steps from a cache of 64 rows (the frame count: no padded cross
    rows)."""
    cfg, params = _reduced("whisper-large-v3", 12)
    rng = np.random.RandomState(13)
    B, F, S, steps = 2, 64, 6, 5
    batch = {"frames": torch.from_numpy(
        rng.randn(B, F, cfg.d_model).astype(np.float32)),
        "tokens": torch.from_numpy(
        rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    n0 = (flash.KERNEL.launches, decode.KERNEL.launches)
    out = {}
    for plain in (False, True):
        m = get_model(cfg, plain_attention=plain)
        last, parts = m.prefill(params, batch)
        cache = m.init_cache(B, F, "cpu")
        for k, src in parts.items():
            cache[k][:, :, :src.shape[2]] = src
        cache["pos"] = torch.tensor(S, dtype=torch.int32)
        first = last.argmax(-1).to(torch.int32)[:, None]
        step, cache = m.decode_step(params, first, cache)
        toks, _, _ = m.decode_many(params, step.argmax(-1).to(
            torch.int32)[:, None], cache, None, steps)
        out[plain] = (last, step, toks)
    torch.testing.assert_close(out[False][0], out[True][0], **MODEL_TOL)
    torch.testing.assert_close(out[False][1], out[True][1], **MODEL_TOL)
    assert torch.equal(out[False][2], out[True][2])
    # flash: encoder + decoder self + cross, per layer, in the prefill;
    # dense decode: one per decoder layer per step
    L = cfg.n_layers
    assert flash.KERNEL.launches - n0[0] == cfg.encoder_layers + 2 * L
    assert decode.KERNEL.launches - n0[1] == L * (1 + steps)


def test_emulated_vlm_kernel_route(cuda_path_on_cpu):
    """An embeddings prefill (a 4 x 4 patch grid, then 8 text positions
    whose streams advance together), then a paged prefill chunk of text
    tokens and a paged decode step, kernel route against plain."""
    cfg, params = _reduced("qwen2-vl-72b", 14)
    rng = np.random.RandomState(15)
    B, S = 2, 24
    grid = np.arange(16)
    text = 4 + np.arange(S - 16)
    pos = np.stack([np.concatenate([np.zeros(16), text]),
                    np.concatenate([grid // 4, text]),
                    np.concatenate([grid % 4, text])]).astype(np.int32)
    batch = {"embeds": torch.from_numpy(
        rng.randn(B, S, cfg.d_model).astype(np.float32)),
        "positions": torch.from_numpy(np.broadcast_to(
            pos[:, None], (3, B, S)).copy())}
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, 16)).astype(
        np.int32))
    grants = torch.tensor([16, 11], dtype=torch.int32)
    n0 = (flash.KERNEL.launches, paged.KERNEL.launches,
          prefill_paged.KERNEL.launches)
    out = {}
    for plain in (False, True):
        m = get_model(cfg, plain_attention=plain)
        last, _ = m.prefill(params, batch)
        cache = m.init_paged_cache(B, 3, 8, 7, "cpu")
        cache["table"] = torch.arange(1, 7, dtype=torch.int32).reshape(B, 3)
        chunk, cache = m.prefill_step_paged(params, toks, cache, grants)
        nxt = chunk.argmax(-1).to(torch.int32)[:, None]
        step, _ = m.decode_step_paged(params, nxt, cache)
        out[plain] = (last, chunk, step)
    for a, b in zip(out[False], out[True]):
        torch.testing.assert_close(a, b, **MODEL_TOL)
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    L = cfg.n_layers
    assert (flash.KERNEL.launches - n0[0], paged.KERNEL.launches - n0[1],
            prefill_paged.KERNEL.launches - n0[2]) == (L, L, L)
