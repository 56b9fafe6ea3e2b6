"""The port's fused unembed cross-entropy (``repro_torch/models/losses.py``)
and ``cross_entropy`` against the JAX package's, on the same numpy-seeded
inputs.

Tolerances are those of the JAX package's own tests
(tests/test_losses.py): the value within rtol 1e-5 / atol 1e-6, the
gradients within rtol 1e-4 / atol 1e-6 (f32), and bf16 within 5e-2 of the
naive logits path, its gradients finite.  The chunk is halved until it
divides S, as in the JAX function: S = 40 with chunk 16 runs chunks of
8, S = 24 with chunk 512 one chunk of 24, S = 7 chunks of 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.losses import fused_unembed_xent as j_xent
from repro.models.model import cross_entropy as j_ce
from repro_torch.models.losses import chunk_size, fused_unembed_xent
from repro_torch.models.model import cross_entropy

VALUE = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tensors here are small, and on a machine
    whose test workers share the cores more threads only oversubscribe
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, d, V, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, S, d), np.float32)
    table = rng.standard_normal((V, d), np.float32) * 0.1
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    return h, table, labels


def _j_naive(h, table, labels):
    return j_ce(jnp.dot(h, table.T).astype(jnp.float32), labels)


# (B, S, d, V, chunk): the JAX test's shapes, then chunks that do not
# divide S (halved to 8, to S itself, to 1)
SHAPES = [(2, 32, 16, 50, 8), (1, 64, 8, 17, 16), (3, 16, 32, 128, 16),
          (2, 40, 16, 33, 16), (1, 24, 8, 20, 512), (2, 7, 8, 11, 4)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_fused_xent_value_and_grads_match_jax(shape):
    B, S, d, V, chunk = shape
    h, table, labels = _inputs(B, S, d, V, seed=sum(shape))
    jval, jgrads = jax.value_and_grad(
        lambda a, b: j_xent(a, b, jnp.asarray(labels), chunk=chunk),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(table))
    th = torch.from_numpy(h).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    val = fused_unembed_xent(th, tt, torch.from_numpy(labels), chunk=chunk)
    val.backward()
    np.testing.assert_allclose(val.item(), np.asarray(jval), **VALUE)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgrads[0]),
                               **GRAD)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgrads[1]),
                               **GRAD)
    # and the naive path, as the JAX test holds its fused function to it
    np.testing.assert_allclose(
        val.item(), np.asarray(_j_naive(h, table, labels)), **VALUE)


def test_chunk_rule_matches_jax():
    """min(chunk, S), halved until it divides S."""
    assert [chunk_size(S, c) for S, c in
            ((32, 8), (40, 16), (24, 512), (7, 4), (4096, 512), (96, 64))] \
        == [8, 8, 24, 1, 512, 32]


def test_fused_xent_upstream_gradient_scales():
    """A cotangent g other than 1 scales both gradients by g, as
    (softmax - onehot) g / (B S) does in the JAX backward."""
    h, table, labels = _inputs(2, 16, 8, 24, seed=5)
    _, vjp = jax.vjp(lambda a, b: j_xent(a, b, jnp.asarray(labels), 8),
                     jnp.asarray(h), jnp.asarray(table))
    jdh, jdt = vjp(jnp.float32(2.5))
    th = torch.from_numpy(h).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    (fused_unembed_xent(th, tt, torch.from_numpy(labels), 8) * 2.5).backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), **GRAD)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jdt), **GRAD)


@pytest.mark.parametrize("B,S,V", [(2, 16, 50), (1, 9, 7)])
def test_cross_entropy_matches_jax(B, S, V):
    rng = np.random.default_rng(B * S + V)
    logits = rng.standard_normal((B, S, V), np.float32) * 3
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    want = j_ce(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.item(), np.asarray(want), **VALUE)


def test_fused_xent_bf16():
    """bf16 h and table: the value within the JAX test's 5e-2 of the
    naive logits path and of the JAX fused function, the gradients finite
    and in the inputs' dtype; the activation-dtype product then f32
    statistics, as in the JAX function."""
    h, table, labels = _inputs(2, 16, 8, 32, seed=2)
    jh = jnp.asarray(h, jnp.bfloat16)
    jt = jnp.asarray(table, jnp.bfloat16)
    jval = j_xent(jh, jt, jnp.asarray(labels), chunk=8)
    naive = _j_naive(jh, jt, jnp.asarray(labels))
    th = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    tt = torch.from_numpy(table).to(torch.bfloat16).requires_grad_()
    val = fused_unembed_xent(th, tt, torch.from_numpy(labels), chunk=8)
    val.backward()
    for want in (jval, naive):
        np.testing.assert_allclose(val.item(), np.asarray(want, np.float32),
                                   rtol=5e-2, atol=5e-2)
    for g in (th.grad, tt.grad):
        assert g.dtype == torch.bfloat16
        assert torch.isfinite(g.float()).all()
