"""The training slice's kernel work, on the CUDA sources compiled for the
CPU as ``test_torch_kernel_emulation`` compiles them (its fixtures).

  * The flash kernel's training instantiations (``kLse``: the bf16
    tensor-core body and the f32 CUDA-core body) write each row's L =
    m + log(max(l, 1e-30)): held against the plain forward's L at qwen2's
    G = 7 and at G = 1, D = 64, causal and not, with ragged last q and
    k/v tiles; their outputs are the serving instantiations' bit for bit.
  * Their trip models against the emulated ``REPRO_TRIP`` counts.
  * The kernel route under autograd (the emulated forward with L, then
    the plain chunked backward) against the plain route: ``attention``'s
    gradients, and a reduced qwen2's ``Model.loss`` and every gradient
    leaf with the flash kernel launched twice a layer (forward and remat
    recompute).
  * No kernel route drops a gradient: dense decode, paged decode and
    paged prefill raise on a call whose inputs need a gradient (each
    returned a result with no ``grad_fn`` before), and run as before
    under ``torch.no_grad()`` or on inputs that need none; the selective
    scan, which has a training route (``SelectiveScan``), returns a
    result with a ``grad_fn`` from one launch.

Tolerances: a kernel's output as in the emulation file (f32 2e-5, bf16
1e-2); L in f32 within 2e-5, in bf16 within 1e-4 (the scores' f32
accumulation order and the exp2 of the tensor-core body; P's rounding to
bf16 touches only P V); f32 gradients within 1e-4 of each tensor's max
abs, as a model's f32 parity is held; bf16 gradients within a relative
norm error of 2e-2 (the output's bf16 rounding of P, carried into D =
rowsum(dO O)).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.kernels.decode_attention import decode, paged, prefill_paged
from repro_torch.kernels.flash_attention import flash
from repro_torch.kernels.ssm_scan import scan
from repro_torch.models import attention as attention_mod
from repro_torch.models.attention import repeat_kv
from repro_torch.models.flash import _flash_fwd
from repro_torch.models.model import get_model
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.train_step import loss_and_grads

from test_torch_kernel_emulation import (  # noqa: F401  (fixtures)
    TOL, _case, _dense, cuda_path_on_cpu, emulated)
from test_torch_stream_scan_emulation import _check_trips
from torch_one_thread import _one_thread  # noqa: F401  (autouse)

L_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-4}


def _ids(c):
    return "-".join(str(x).replace("torch.", "") for x in c)


# (B, S, T, H, KV, D, causal, dtype) at D = 64: qwen2's 14 over 2 heads
# (G = 7), causal, S = 100 (700 flattened rows: a ragged last 128-row
# tile; two 64-position k/v tiles, the last ragged); non-causal S != T;
# MHA (G = 1) causal over ragged tiles; the f32 body at G = 7 and G = 1
LSE_CASES = [(1, 100, 100, 14, 2, 64, True, torch.bfloat16),
             (1, 45, 70, 14, 2, 64, False, torch.bfloat16),
             (2, 70, 70, 2, 2, 64, True, torch.bfloat16),
             (1, 37, 37, 14, 2, 64, True, torch.float32),
             (2, 70, 90, 2, 2, 64, False, torch.float32)]


@pytest.mark.parametrize("case", LSE_CASES, ids=_ids)
def test_emulated_flash_writes_lse(case, cuda_path_on_cpu):
    B, S, T, H, KV, D, causal, dtype = case
    q, k, v = _dense(S * H + T, B, S, T, H, KV, D, dtype)
    n0 = flash.KERNEL.launches
    out, lse = flash.run(q, k, v, causal, with_lse=True)
    plain, _ = flash.run(q, k, v, causal)
    assert flash.KERNEL.launches == n0 + 2
    assert torch.equal(out, plain)                   # the serving body's
    want_out, want_L = _flash_fwd(q, repeat_kv(k, H), repeat_kv(v, H),
                                  causal, S, T)
    assert lse.shape == (B, S, H) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want_L, rtol=0, atol=L_TOL[dtype])
    torch.testing.assert_close(out.float(), want_out.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("case", LSE_CASES, ids=_ids)
def test_trip_model_of_flash_with_lse(case, emulated, cuda_path_on_cpu):
    B, S, T, H, KV, D, causal, dtype = case
    q, k, v = _dense(S + T, B, S, T, H, KV, D, dtype)
    model = flash.trip_model(B, S, T, H, KV, D, causal, dtype, with_lse=True)
    assert model[0].function.startswith(
        "flash_attention_tc_lse_kernel" if dtype == torch.bfloat16
        else "flash_attention_lse_kernel")
    assert model[0].io_bytes == flash.trip_model(
        B, S, T, H, KV, D, causal, dtype)[0].io_bytes + 4 * B * S * H
    _check_trips(emulated, model,
                 lambda: flash.run(q, k, v, causal, with_lse=True))


def _grad_err(got, want):
    """(max abs error / max abs, relative norm error)."""
    got, want = got.float(), want.float()
    return (float((got - want).abs().max() / want.abs().max()),
            float((got - want).norm() / want.norm()))


@pytest.mark.parametrize("case", [
    (1, 96, 14, 2, 64, 32, torch.float32),
    (2, 64, 4, 1, 64, 16, torch.float32),
    (1, 96, 14, 2, 64, 32, torch.bfloat16)], ids=_ids)
def test_emulated_attention_grads_on_the_kernel_route(case,
                                                      cuda_path_on_cpu):
    """``attention`` under autograd takes ``FlashAttention`` (one launch,
    L saved) on the kernel route; its gradients against the plain route's
    (the chunked reference's custom backward, or direct attention), k and
    v unrepeated."""
    B, S, H, KV, D, chunk, dtype = case
    q, k, v = _dense(S + H, B, S, S, H, KV, D, dtype)
    dout = _dense(S + H + 1, B, S, S, H, KV, D, dtype)[0]
    grads = []
    for plain in (False, True):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        n0 = flash.KERNEL.launches
        out = attention_mod.attention(*xs, True, chunk, chunk, plain=plain)
        assert flash.KERNEL.launches == n0 + (not plain)
        assert out.grad_fn is not None
        out.backward(dout)
        grads.append([x.grad for x in xs])
    for got, want in zip(*grads):
        worst, rel = _grad_err(got, want)
        if dtype == torch.float32:
            assert worst <= 1e-4, worst
        else:
            assert rel <= 2e-2, rel


def test_emulated_model_loss_on_the_kernel_route(cuda_path_on_cpu):
    """qwen2-0.5b reduced in f32 with heads of 64 (G = 2), S = 96: the
    kernel route's loss and every gradient leaf against the plain
    route's, and the flash kernel launched twice a layer (the forward and
    the remat recompute)."""
    cfg = dataclasses.replace(tconfigs.get("qwen2-0.5b").reduced(),
                              dtype="float32", d_head=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 97))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    n0 = flash.KERNEL.launches
    loss, grads = loss_and_grads(get_model(cfg), params, batch)
    assert flash.KERNEL.launches - n0 == 2 * cfg.n_layers
    want_loss, want = loss_and_grads(get_model(cfg, plain_attention=True),
                                     params, batch)
    assert flash.KERNEL.launches - n0 == 2 * cfg.n_layers
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-4)
    for got, w in zip(tree_leaves(grads), tree_leaves(want)):
        if w.abs().max() > 0:
            assert _grad_err(got, w)[0] <= 1e-4
        else:
            assert torch.equal(got, w)


def _decode_call(needs_grad):
    q, k, v = _dense(5, 2, 1, 24, 4, 2, 16, torch.float32)
    q.requires_grad_(needs_grad)
    return lambda: decode.decode_attention(q, k, v, 20), decode.KERNEL


def _paged_inputs(needs_grad):
    q, kp, vp, tbl, base, new, layer, _, _ = _case(
        7, 2, 6, 4, 2, 16, 8, 3, 2, torch.float32, False)
    kp.requires_grad_(needs_grad)
    return q, kp, vp, tbl, base, new, layer


def _paged_decode_call(needs_grad):
    q, kp, vp, tbl, base, new, layer = _paged_inputs(needs_grad)
    return (lambda: paged.paged_decode_attention(
        q[:, :1].contiguous(), kp, vp, tbl, torch.clamp(new, min=1),
        layer), paged.KERNEL)


def _paged_prefill_call(needs_grad):
    q, kp, vp, tbl, base, new, layer = _paged_inputs(needs_grad)
    return (lambda: prefill_paged.paged_prefill_attention(
        q, kp, vp, tbl, base, new, layer), prefill_paged.KERNEL)


GUARDED = {"decode": _decode_call, "paged_decode": _paged_decode_call,
           "paged_prefill": _paged_prefill_call}


@pytest.mark.parametrize("name", sorted(GUARDED))
def test_emulated_kernel_without_backward_refuses_grad(name,
                                                       cuda_path_on_cpu):
    """A kernel with no backward raises, before it launches, when an input
    needs a gradient and grad mode is on; under ``torch.no_grad()``, and
    on inputs that need none, it launches as before."""
    call, kernel = GUARDED[name](True)
    n0 = kernel.launches
    with pytest.raises(NotImplementedError, match="no backward"):
        call()
    assert kernel.launches == n0
    with torch.no_grad():
        call()
    plain_call, _ = GUARDED[name](False)
    plain_call()
    assert kernel.launches == n0 + 2


def test_emulated_scan_under_autograd_keeps_its_gradient(cuda_path_on_cpu):
    """The selective scan has a backward: a call whose inputs need a
    gradient launches the kernel once and returns y with a ``grad_fn``
    that reaches dt."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 9, 32), np.float32))
    dt = torch.full((1, 9, 32), 0.1, requires_grad=True)
    A = -torch.ones(32, 8)
    Bc = torch.from_numpy(rng.standard_normal((1, 9, 8), np.float32))
    Cc = torch.from_numpy(rng.standard_normal((1, 9, 8), np.float32))
    n0 = scan.KERNEL.launches
    y, h = scan.selective_scan(x, dt, A, Bc, Cc)
    assert scan.KERNEL.launches == n0 + 1
    assert y.grad_fn is not None and not h.requires_grad
    y.sum().backward()
    assert dt.grad is not None and dt.grad.abs().max() > 0
