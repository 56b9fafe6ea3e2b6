"""The port's dense attention against the JAX package's, on the same numpy
inputs: the plain versions of the dense decode and flash kernels against
the Pallas kernels run as the JAX tests run them (``interpret=True``) and
against the JAX oracles; the ``attention`` dispatch, ``chunked_attention``
and ``direct_attention(kv_start=...)`` against their JAX functions.

Tolerances: the kernels' plain versions are held at rtol = atol = 2e-5 in
f32, as the JAX tests hold Pallas against jnp (only the order of sums
differs); the layers at 1e-5, as ``test_torch_layers.py`` holds
``direct_attention``.

The one designed divergence: a decode slot whose window is empty
(kv_start >= kv_len) gives exact zeros from the CUDA kernel, and from the
Pallas kernel when kv_len falls on one of its block boundaries, while the
oracles (JAX's and the port's plain version) softmax it uniformly.  The
Pallas zeros and the oracles' mean are pinned here; the CUDA kernel's
zeros in ``test_torch_kernel_emulation.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode import decode_attention_fwd
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jdecode_ref)
from repro.kernels.flash_attention.flash import flash_attention_fwd
from repro.models import attention as jattn
from repro.models.flash import flash_attention_ref as jflash_ref
from repro_torch.kernels.decode_attention import decode
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import flash
from repro_torch.models import attention as tattn
from repro_torch.models.flash import _pairs_by_i, flash_attention_ref

KTOL = dict(rtol=2e-5, atol=2e-5)
LTOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, B, S, T, H, KV, D):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, H, D).astype(np.float32),
            rng.randn(B, T, KV, D).astype(np.float32),
            rng.randn(B, T, KV, D).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# (B, T, H, KV, D) of tests/test_decode_fused.py: GQA, MQA, MHA, odd T
DECODE_SHAPES = [(2, 32, 4, 2, 16), (3, 48, 4, 1, 16), (1, 128, 8, 8, 64),
                 (2, 24, 6, 2, 32)]


@pytest.mark.parametrize("B,T,H,KV,D", DECODE_SHAPES)
def test_decode_plain_matches_pallas_and_ref(B, T, H, KV, D):
    q, k, v = _qkv(B * T + D, B, 1, T, H, KV, D)
    rng = np.random.RandomState(1)
    kv_len = int(rng.randint(1, T + 1))
    starts = rng.randint(0, kv_len, size=B).astype(np.int32)
    got = decode.decode_attention(*_t(q, k, v), torch.tensor(kv_len),
                                  torch.from_numpy(starts))
    for want in (decode_attention_fwd(*_j(q, k, v), jnp.int32(kv_len),
                                      jnp.asarray(starts), interpret=True),
                 jdecode_ref(*_j(q, k, v), jnp.int32(kv_len),
                             jnp.asarray(starts))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)


def test_decode_plain_without_start_mask():
    q, k, v = _qkv(2, 2, 1, 40, 4, 2, 16)
    got = decode_attention_ref(*_t(q, k, v), 17, None)
    want = decode_attention_fwd(*_j(q, k, v), jnp.int32(17), None,
                                interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)


def test_decode_empty_window_divergence_pinned():
    """kv_start >= kv_len: the Pallas kernel skips every block when kv_len
    sits on its block boundary (T = 256 -> blocks of 128) and gives zeros,
    as the CUDA kernel does for every empty window; the oracles give the
    uniform mean of all T value rows."""
    q, k, v = _qkv(4, 2, 1, 256, 4, 2, 16)
    starts = np.array([128, 200], np.int32)
    pallas = np.asarray(decode_attention_fwd(
        *_j(q, k, v), jnp.int32(128), jnp.asarray(starts), interpret=True))
    assert (pallas == 0).all()
    plain = decode.decode_attention(*_t(q, k, v), 128,
                                    torch.from_numpy(starts))
    mean = np.repeat(v.mean(axis=1), 2, axis=1)[:, None]    # (B, 1, H, D)
    np.testing.assert_allclose(plain.numpy(), mean, **KTOL)
    np.testing.assert_allclose(
        plain.numpy(), np.asarray(jdecode_ref(*_j(q, k, v), jnp.int32(128),
                                              jnp.asarray(starts))), **KTOL)


# (B, S, T, H, D, block_q, block_kv) of tests/test_flash_pallas.py, plus
# its cross-length case
FLASH_SHAPES = [(1, 256, 256, 1, 128, 128, 128),
                (2, 256, 256, 2, 128, 64, 128),
                (1, 512, 512, 1, 128, 128, 64)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("B,S,T,H,D,bq,bkv", FLASH_SHAPES)
def test_flash_plain_matches_pallas_and_ref(causal, B, S, T, H, D, bq, bkv):
    q, k, v = _qkv(S + bq + bkv, B, S, T, H, H, D)
    got = flash.flash_attention(*_t(q, k, v), causal=causal, block_q=bq,
                                block_kv=bkv)
    for want in (flash_attention_fwd(*_j(q, k, v), causal=causal, block_q=bq,
                                     block_kv=bkv, interpret=True),
                 jflash_ref(*_j(q, k, v), causal, bq, bkv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)


def test_flash_plain_cross_lengths():
    """T != S (the cross-attention shape of the JAX tests)."""
    q, k, v = _qkv(8, 1, 128, 384, 1, 1, 128)
    got = flash.flash_attention(*_t(q, k, v), causal=False, block_q=128,
                                block_kv=128)
    want = flash_attention_fwd(*_j(q, k, v), causal=False, block_q=128,
                               block_kv=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("S,H,KV", [(37, 4, 2), (64, 4, 1), (96, 2, 2)])
def test_flash_wrapper_takes_unrepeated_kv(causal, S, H, KV):
    """The wrapper takes k, v unrepeated (KV dividing H) and equals the JAX
    kernel on repeated heads; S <= 512 need not be a multiple of anything
    (one block of S rows, as in JAX)."""
    q, k, v = _qkv(S + H + KV, 2, S, S, H, KV, 16)
    got = flash.flash_attention(*_t(q, k, v), causal=causal)
    want = flash_attention_fwd(
        *_j(q), jattn.repeat_kv(jnp.asarray(k), H),
        jattn.repeat_kv(jnp.asarray(v), H), causal=causal, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)


def test_flash_ref_block_enumeration():
    """The static triangular enumeration: causal leaves out the blocks past
    the diagonal, in q-major order; non-causal keeps all."""
    assert _pairs_by_i(2, 4, True, 2, 1) == [(0, 0), (0, 1), (1, 0), (1, 1),
                                            (1, 2), (1, 3)]
    assert len(_pairs_by_i(3, 2, False, 4, 4)) == 6
    q, k, v = _t(*_qkv(3, 1, 48, 48, 2, 2, 16))
    with pytest.raises(AssertionError):
        flash_attention_ref(q, k, v, True, 32, 32)           # 32 !| 48


def test_flash_wrapper_refuses_what_jax_refuses():
    """Block min(512, S) must divide S (S = 600 does not), likewise T —
    the JAX wrapper's asserts — on the CPU and on a device alike."""
    q, k, v = _t(*_qkv(5, 1, 600, 600, 2, 2, 16))
    with pytest.raises(ValueError, match="divide"):
        flash.flash_attention(q, k, v)
    q2, k2, v2 = _t(*_qkv(5, 1, 64, 520, 2, 2, 16))
    with pytest.raises(ValueError, match="divide"):
        flash.flash_attention(q2, k2, v2, causal=False)


# (S, T, chunk): direct (S * T <= chunk^2, no chunk need divide: 600 at
# the full configs' 1024, as 512 does not); chunked and dividing (608 over
# the reduced configs' 32); refused (40 over 32; 1100 over 1024)
ROUTE_SHAPES = [(600, 600, 1024), (608, 608, 32), (40, 40, 32),
                (1100, 1100, 1024), (37, 24, 32)]


@pytest.mark.parametrize("S,T,chunk", ROUTE_SHAPES)
def test_kernel_route_shape_rule_is_the_reference_dispatch(S, T, chunk):
    """``check_reference_shape``, the card route's shape rule, refuses
    exactly what the JAX reference dispatch refuses, with the same
    error."""
    q = jnp.zeros((1, S, 2, 16), jnp.float32)
    k = jnp.zeros((1, T, 2, 16), jnp.float32)
    try:
        jattn.attention(q, k, k, True, chunk, chunk, impl="reference")
        refused = None
    except AssertionError as e:
        refused = e.args
    if refused is None:
        tattn.check_reference_shape(S, T, chunk, chunk)
    else:
        with pytest.raises(AssertionError) as info:
            tattn.check_reference_shape(S, T, chunk, chunk)
        assert info.value.args == refused


def test_decode_splits_fill_the_card():
    """Blocks per (slot, kv head) from the static shape: about two blocks
    per SM in all (8 splits, 256 blocks at the whole-batch serving shape),
    never more than the cache's 32-position tiles, at least one."""
    assert decode.splits(486, 4, 8) == 8
    assert decode.grid_blocks(4, 486, 8) == 256 >= 4 * 4 * 8
    assert decode.splits(24, 2, 2) == 1
    assert decode.splits(150, 3, 1) == 5
    assert decode.splits(4096, 64, 8) == 1
    assert decode.splits(4096, 1, 1) == 4096 // 32
    assert decode.splits(16384, 1, 1) == decode.TARGET_BLOCKS


def test_flash_wrapper_refuses_gradients_off_the_cpu():
    """Off the CPU, a tensor neither on the CPU nor on a CUDA device is
    refused, with or without a gradient: flash's training route (it has a
    backward since the training slice) checks the device as its forward
    does.  Dense decode, which has no backward, refuses a call that needs
    a gradient before anything else."""
    meta = [torch.empty(1, 64, 2, 16, device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(*meta)
    meta[0].requires_grad_(True)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention(*meta)
    with pytest.raises(NotImplementedError, match="no backward"):
        decode.decode_attention(meta[0][:, :1], meta[1], meta[2], 3)
    with pytest.raises(ValueError, match="CUDA"):
        decode.decode_attention(meta[0][:, :1].detach(), meta[1], meta[2], 3)


@pytest.mark.parametrize("args,match", [
    ((torch.zeros(2, 1, 4, 16), torch.zeros(2, 8, 3, 16),
      torch.zeros(2, 8, 3, 16)), "KV must divide H"),
    ((torch.zeros(2, 1, 4, 24), torch.zeros(2, 8, 2, 24),
      torch.zeros(2, 8, 2, 24)), "head dim"),
    ((torch.zeros(2, 1, 4, 16), torch.zeros(2, 8, 2, 16,
                                            dtype=torch.bfloat16),
      torch.zeros(2, 8, 2, 16, dtype=torch.bfloat16)), "dtype"),
    ((torch.zeros(2, 1, 4, 16), torch.zeros(2, 16, 2, 8).transpose(1, 3),
      torch.zeros(2, 8, 2, 16)), "contiguous"),
    ((torch.zeros(2, 1, 4, 16), torch.zeros(2, 8, 2, 16),
      torch.zeros(2, 9, 2, 16)), "equal"),
])
def test_dense_layout_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        decode.dense_layout("decode", *args)


def test_direct_attention_kv_start_matches_jax():
    q, k, v = _qkv(6, 3, 1, 20, 4, 2, 16)
    starts = np.array([0, 5, 11], np.int32)
    got = tattn.direct_attention(*_t(q, k, v), True, q_offset=13, kv_len=14,
                                 kv_start=torch.from_numpy(starts))
    want = jattn.direct_attention(*_j(q, k, v), True, q_offset=13,
                                  kv_len=14, kv_start=jnp.asarray(starts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LTOL)


# (B, S, T, H, KV, chunk, q_offset, kv_len): decode, small (direct), long
# (chunked flash reference), an explicit kv_len with S > 1 (direct)
DISPATCH = [(2, 1, 24, 4, 2, 8, 23, 24), (2, 8, 8, 4, 2, 8, None, None),
            (1, 64, 64, 4, 1, 16, None, None), (2, 4, 12, 4, 4, 2, 6, 10)]


@pytest.mark.parametrize("case", DISPATCH, ids=["decode", "small", "long",
                                                "kv_len"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_attention_dispatch_matches_jax(case, causal):
    B, S, T, H, KV, c, off, kvl = case
    q, k, v = _qkv(B + S + T, B, S, T, H, KV, 16)
    want = jattn.attention(*_j(q, k, v), causal, c, c, q_offset=off,
                           kv_len=kvl, impl="reference")
    for plain in (False, True):                   # CPU: both are the plain
        got = tattn.attention(*_t(q, k, v), causal, c, c, q_offset=off,
                              kv_len=kvl, plain=plain)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LTOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_chunked_attention_matches_jax(causal):
    q, k, v = _qkv(7, 2, 32, 48, 4, 2, 16)
    got = tattn.chunked_attention(*_t(q, k, v), causal, 8, 16)
    want = jattn.chunked_attention(*_j(q, k, v), causal, 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LTOL)
    np.testing.assert_array_equal(
        tattn.repeat_kv(torch.from_numpy(k), 4).numpy(),
        np.asarray(jattn.repeat_kv(jnp.asarray(k), 4)))
