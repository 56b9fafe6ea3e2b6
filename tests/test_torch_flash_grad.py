"""The port's chunked flash reference under its custom backward
(``repro_torch/models/flash.py``) against ``jax.vjp`` of the JAX
package's ``flash_attention_ref``, and ``models.attention.attention``'s
gradients against the JAX function's, on the same numpy-seeded inputs.

The tolerance is the JAX package's own for its flash gradients
(tests/test_flash_ref.py: rtol = atol = 2e-4), the forward's its 2e-5.
A ``saved_tensors_hooks`` count shows that the backward keeps (q, k, v,
out, L) and nothing of a block's (cq x ck) size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attention as j_attention
from repro.models.flash import flash_attention_ref as j_flash
from repro_torch.models.attention import attention
from repro_torch.models.flash import _flash_fwd, flash_attention_ref, flash_bwd
from torch_one_thread import _one_thread  # noqa: F401  (autouse)

GRAD = dict(rtol=2e-4, atol=2e-4)
FWD = dict(rtol=2e-5, atol=2e-5)


def _qkv(B, S, T, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), np.float32),
            rng.standard_normal((B, T, KV, D), np.float32),
            rng.standard_normal((B, T, KV, D), np.float32),
            rng.standard_normal((B, S, H, D), np.float32))   # cotangent


def _torch_vjp(fn, q, k, v, dout):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fn(tq, tk, tv)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), \
        tv.grad.numpy()


def _jax_vjp(fn, q, k, v, dout):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out),) + tuple(np.asarray(g) for g in
                                      vjp(jnp.asarray(dout)))


# (B, S, T, H, D, cq, ck, causal): causal square over 4 x 4 blocks, over
# 2 x 8 and 8 x 2; non-causal S != T both ways; causal S != T (top-left
# aligned); one block
FLASH_CASES = [(2, 64, 64, 2, 16, 16, 16, True),
               (1, 64, 64, 3, 8, 32, 8, True),
               (1, 64, 64, 1, 16, 8, 32, True),
               (2, 32, 96, 2, 16, 16, 32, False),
               (1, 96, 32, 2, 8, 32, 16, False),
               (1, 48, 96, 2, 16, 16, 32, True),
               (1, 16, 16, 2, 8, 16, 16, False)]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_custom_vjp_matches_jax(case):
    B, S, T, H, D, cq, ck, causal = case
    q, k, v, dout = _qkv(B, S, T, H, H, D, seed=S + T + cq)
    got = _torch_vjp(lambda a, b, c: flash_attention_ref(a, b, c, causal,
                                                         cq, ck),
                     q, k, v, dout)
    want = _jax_vjp(lambda a, b, c: j_flash(a, b, c, causal, cq, ck),
                    q, k, v, dout)
    np.testing.assert_allclose(got[0], want[0], **FWD)
    for g, w, name in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD)


def test_flash_backward_saves_no_block():
    """The residuals are q, k, v, out and L — packed once each — and no
    saved tensor has a block's (cq x ck) extent; the backward runs from
    them alone."""
    B, S, H, D, c = 1, 64, 2, 8, 16
    q, k, v, dout = _qkv(B, S, S, H, H, D, seed=1)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    packed = []

    def pack(t):
        packed.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = flash_attention_ref(tq, tk, tv, True, c, c)
    assert sorted(packed) == sorted([(B, S, H, D)] * 4 + [(B, S, H)])
    out.backward(torch.from_numpy(dout))
    assert all(x.grad is not None for x in (tq, tk, tv))


def test_flash_bwd_takes_ragged_chunks():
    """``flash_bwd`` on chunks that do not divide S and T (the kernel
    route's backward at any shape) gives the gradients of the dividing
    chunks within the f32 tolerance."""
    B, S, H, D = 1, 60, 2, 8
    q, k, v, dout = (torch.from_numpy(x) for x in _qkv(B, S, S, H, H, D, 4))
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    out = flash_attention_ref(tq, tk, tv, True, 60, 60)
    out.backward(dout)
    _, L = _flash_fwd(q, k, v, True, 60, 60)
    for cq, ck in ((16, 16), (32, 7), (60, 64)):
        dq, dk, dv = flash_bwd(q, k, v, out.detach(), L, dout, True, cq, ck)
        for g, w in ((dq, tq.grad), (dk, tk.grad), (dv, tv.grad)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD)


# (B, S, T, H, KV, D, chunk, causal): the direct branch (S T <= chunk^2)
# and the chunked branch over 32-blocks, GQA (G = 2 and 7) and MQA
ATTN_CASES = [(2, 16, 16, 4, 2, 16, 32, True),
              (1, 24, 24, 14, 2, 8, 32, True),
              (2, 64, 64, 4, 2, 16, 32, True),
              (1, 64, 64, 14, 2, 8, 32, True),
              (1, 64, 96, 4, 1, 16, 32, False)]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_attention_grads_match_jax(case):
    """GQA k and v unrepeated: the gradients flow through ``repeat_kv``'s
    transpose (a sum over each group) in both packages."""
    B, S, T, H, KV, D, chunk, causal = case
    q, k, v, dout = _qkv(B, S, T, H, KV, D, seed=S * H + T)
    got = _torch_vjp(lambda a, b, c: attention(a, b, c, causal, chunk,
                                               chunk), q, k, v, dout)
    want = _jax_vjp(lambda a, b, c: j_attention(a, b, c, causal, chunk,
                                                chunk), q, k, v, dout)
    np.testing.assert_allclose(got[0], want[0], **FWD)
    for g, w, name in zip(got[1:], want[1:], "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD)
