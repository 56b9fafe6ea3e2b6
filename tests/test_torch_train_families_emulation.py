"""The non-dense families' kernel route under autograd, on the CUDA
sources compiled for the CPU as ``test_torch_kernel_emulation`` compiles
them (its fixtures).

  * ``SelectiveScan``: under autograd the scan launches the kernel once a
    forward and returns y with a ``grad_fn`` (the final state takes none);
    its gradients in x, dt, A_log and the x_proj output whose strided
    column views are B and C equal the plain route's bit for bit (its
    backward recomputes the plain scan from the saved inputs), in f32 and
    bf16.
  * ``Model.loss`` and every gradient leaf on the kernel route against the
    plain route for three reduced archs in f32: falcon-mamba (the scan
    launched twice a layer: the forward and the remat recompute), whisper
    with heads of 64 (flash with L at G = 1, D = 64: the encoder's
    non-causal S = T, the decoder's causal self-attention and its
    non-causal cross-attention over S != T; 2 x (encoder + 2 x decoder
    layers) launches) and zamba2 with heads of 112 (flash with L at
    G = 1, D = 112, twice per application of the shared block).

Tolerances: f32 gradients within 1e-4 of each leaf's max abs and the
loss within rtol = atol = 1e-4, as the dense family's kernel route is
held in ``test_torch_train_emulation.py`` (the kernel's forward sums in
another order than the plain version; the backward is the same plain
code on both routes).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.kernels.flash_attention import flash
from repro_torch.kernels.ssm_scan import scan
from repro_torch.models.model import get_model
from repro_torch.models.params import init_params
from repro_torch.models.ssm import mamba1_scan
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.train_step import loss_and_grads

from test_torch_kernel_emulation import (  # noqa: F401  (fixtures)
    cuda_path_on_cpu, emulated)
from torch_one_thread import _one_thread  # noqa: F401  (autouse)


def _scan_leaves(seed, B, S, d_in, N, dtype):
    """Leaves as the Mamba1 block makes them: x and dt (B, S, d_in), A_log
    (d_in, N) f32, and the x_proj output (B, S, 4 + 2N) whose column
    slices are B and C."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((B, S, d_in), np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, d_in), np.float32)) * 0.5 - 1.0)
    A_log = torch.from_numpy(rng.standard_normal((d_in, N), np.float32)) * 0.3
    dbc = torch.from_numpy(rng.standard_normal((B, S, 4 + 2 * N),
                                               np.float32))
    dy = torch.from_numpy(rng.standard_normal((B, S, d_in), np.float32))
    return [x.to(dtype), dt.to(dtype), A_log, dbc.to(dtype)], dy.to(dtype)


def _scan_grads(fn, leaves, dy, N):
    ts = [t.clone().requires_grad_() for t in leaves]
    x, dt, A_log, dbc = ts
    y, h = fn(x, dt, -torch.exp(A_log), dbc[..., 4:4 + N], dbc[..., 4 + N:])
    y.backward(dy)
    return y, h, [t.grad for t in ts]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_emulated_selective_scan_under_autograd(dtype, cuda_path_on_cpu):
    B, S, d_in, N = 2, 37, 64, 16
    leaves, dy = _scan_leaves(4, B, S, d_in, N, dtype)
    n0 = scan.KERNEL.launches
    y, h, got = _scan_grads(scan.selective_scan, leaves, dy, N)
    assert scan.KERNEL.launches == n0 + 1
    assert y.grad_fn is not None and not h.requires_grad
    _, _, want = _scan_grads(mamba1_scan, leaves, dy, N)
    assert scan.KERNEL.launches == n0 + 1
    for name, g, w in zip(("x", "dt", "A_log", "dbc"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
        assert g.abs().max() > 0, name


def test_emulated_scan_final_state_takes_no_gradient(cuda_path_on_cpu):
    """h_final is marked non-differentiable: a loss of it alone has
    nothing to differentiate."""
    leaves, _ = _scan_leaves(5, 1, 9, 32, 8, torch.float32)
    x, dt, A_log, dbc = [t.clone().requires_grad_() for t in leaves]
    _, h = scan.selective_scan(x, dt, -torch.exp(A_log), dbc[..., 4:12],
                               dbc[..., 12:])
    with pytest.raises(RuntimeError, match="does not require grad"):
        h.sum().backward()


def _grad_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _route_case(arch, seed, **kw):
    cfg = dataclasses.replace(tconfigs.get(arch).reduced(), dtype="float32",
                              **kw)
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, params


def _tokens(rng, cfg, B, S):
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S + 1))
                            .astype(np.int32))
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


def _hold_routes(cfg, params, batch, kernel, want_launches):
    """The kernel route's loss and grads against the plain route's; the
    kernel launched ``want_launches`` times by the kernel route alone."""
    n0 = kernel.launches
    loss, grads = loss_and_grads(get_model(cfg), params, batch)
    assert kernel.launches - n0 == want_launches
    want_loss, want = loss_and_grads(get_model(cfg, plain_attention=True),
                                     params, batch)
    assert kernel.launches - n0 == want_launches
    torch.testing.assert_close(loss, want_loss, rtol=1e-4, atol=1e-4)
    for got, w in zip(tree_leaves(grads), tree_leaves(want)):
        if w.abs().max() > 0:
            assert _grad_err(got, w) <= 1e-4
        else:
            assert torch.equal(got, w)


def test_emulated_falcon_mamba_loss_on_the_kernel_route(cuda_path_on_cpu):
    """falcon-mamba reduced (2 layers, d_in 128, N 8), S 40, B 2."""
    cfg, params = _route_case("falcon-mamba-7b", 0)
    batch = _tokens(np.random.default_rng(0), cfg, 2, 40)
    _hold_routes(cfg, params, batch, scan.KERNEL, 2 * cfg.n_layers)


def test_emulated_whisper_loss_on_the_kernel_route(cuda_path_on_cpu):
    """whisper reduced with 4 heads of 64 (G = 1): 64 frames, 32 decoder
    tokens, B 2."""
    cfg, params = _route_case("whisper-large-v3", 1, d_head=64,
                              n_kv_heads=4)
    rng = np.random.default_rng(1)
    batch = _tokens(rng, cfg, 2, 32)
    batch["frames"] = torch.from_numpy(
        rng.standard_normal((2, 64, cfg.d_model), np.float32))
    assert cfg.head_dim == 64 and cfg.n_kv_heads == cfg.n_heads
    _hold_routes(cfg, params, batch, flash.KERNEL,
                 2 * (cfg.encoder_layers + 2 * cfg.n_layers))


def test_emulated_zamba2_loss_on_the_kernel_route(cuda_path_on_cpu):
    """zamba2 reduced with 4/4 heads of 112 (G = 1), 7 layers (one group
    and a tail layer), S 64, B 2."""
    cfg, params = _route_case("zamba2-7b", 2, d_head=112, n_kv_heads=4,
                              n_layers=7)
    batch = _tokens(np.random.default_rng(2), cfg, 2, 64)
    G = cfg.n_layers // cfg.attn_every
    _hold_routes(cfg, params, batch, flash.KERNEL, 2 * G)
