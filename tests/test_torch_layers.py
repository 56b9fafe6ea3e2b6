"""The port's layers, int8 row quantization and direct attention against
the JAX functions they port, on the same numpy inputs.  f32 is held with
rtol = atol = 1e-5 (only the order of sums may differ); quantization must
be bit-identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import kv_quant as jq
from repro.models import layers as jl
from repro_torch.models import attention as tattn
from repro_torch.models import kv_quant as tq
from repro_torch.models import layers as tl
from torch_one_thread import _one_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_rmsnorm():
    rng = np.random.RandomState(0)
    x, s = _rand(rng, 2, 3, 64), _rand(rng, 64)
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-5),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    rng = np.random.RandomState(1)
    x, w, b = _rand(rng, 2, 5, 32), _rand(rng, 32, 48), _rand(rng, 48)
    tb, jb = (torch.from_numpy(b), jnp.asarray(b)) if bias else (None, None)
    _close(tl.dense(torch.from_numpy(x), torch.from_numpy(w), tb),
           jl.dense(jnp.asarray(x), jnp.asarray(w), jb))


def test_embed_unembed():
    rng = np.random.RandomState(2)
    table = _rand(rng, 50, 16)
    toks = rng.randint(0, 50, size=(3, 7)).astype(np.int32)
    _close(tl.embed(torch.from_numpy(toks).long(), torch.from_numpy(table)),
           jl.embed(jnp.asarray(toks), jnp.asarray(table)))
    h = _rand(rng, 3, 16)
    _close(tl.unembed(torch.from_numpy(h), torch.from_numpy(table)),
           jl.unembed(jnp.asarray(h), jnp.asarray(table)))


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope(theta):
    rng = np.random.RandomState(3)
    pos = rng.randint(0, 3000, size=(2, 5)).astype(np.int32)
    tc, ts = tl.rope_angles(torch.from_numpy(pos), 16, theta)
    jc, js = jl.rope_angles(jnp.asarray(pos), 16, theta)
    _close(tc, jc)
    _close(ts, js)
    x = _rand(rng, 2, 5, 4, 16)
    _close(tl.apply_rope(torch.from_numpy(x), tc, ts),
           jl.apply_rope(jnp.asarray(x), jc, js))


def test_swiglu():
    rng = np.random.RandomState(4)
    x = _rand(rng, 2, 3, 32)
    wg, wu, wd = _rand(rng, 32, 64), _rand(rng, 32, 64), _rand(rng, 64, 32)
    _close(tl.swiglu(*map(torch.from_numpy, (x, wg, wu, wd))),
           jl.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))


def test_quantize_rows_bit_identical():
    rng = np.random.RandomState(5)
    x = _rand(rng, 3, 4, 2, 16) * 3
    x[0, 0, 0] = 0.0                                 # all-zero row: scale 1
    x[1, 1, 1, :4] = [127.0, 0.5, 1.5, -2.5]         # exact .5 ties
    x[1, 1, 1, 4:] = 0.0
    tqv, tsc = tq.quantize_rows(torch.from_numpy(x))
    jqv, jsc = jq.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsc.numpy().view(np.uint32),
                                  np.asarray(jsc).view(np.uint32))
    assert tsc[0, 0, 0].item() == 1.0
    np.testing.assert_array_equal(tqv[1, 1, 1, :4].numpy(), [127, 0, 2, -2])
    np.testing.assert_array_equal(
        tq.dequantize_rows(tqv, tsc).numpy(),
        np.asarray(jq.dequantize_rows(jqv, jsc)))


@pytest.mark.parametrize("kw", [
    dict(causal=True, q_offset=3),
    dict(causal=True, q_offset=np.array([0, 5], np.int32),
         kv_len=np.array([4, 9], np.int32)),
    dict(causal=False, kv_len=np.array([1, 12], np.int32)),
    dict(causal=False, kv_len=7),
    dict(causal=True, q_offset=np.array([0, 2], np.int32),
         kv_len=np.array([0, 6], np.int32)),          # fully masked slot
])
@pytest.mark.parametrize("H,KV", [(4, 2), (7, 1), (4, 4)])
def test_direct_attention(kw, H, KV):
    rng = np.random.RandomState(6)
    S = 1 if not kw["causal"] else 3
    q, k, v = _rand(rng, 2, S, H, 8), _rand(rng, 2, 12, KV, 8), \
        _rand(rng, 2, 12, KV, 8)

    def conv(val, to):
        return to(val) if isinstance(val, np.ndarray) else val

    tkw = {n: conv(a, torch.from_numpy) for n, a in kw.items()}
    jkw = {n: conv(a, jnp.asarray) for n, a in kw.items()}
    _close(tattn.direct_attention(*map(torch.from_numpy, (q, k, v)), **tkw),
           jattn.direct_attention(*map(jnp.asarray, (q, k, v)), **jkw))
