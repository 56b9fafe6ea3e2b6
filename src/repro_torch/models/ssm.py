"""Mamba1 (falcon-mamba) blocks: the depthwise causal conv, the selective
scan and its single-step recurrence, and the mixer that joins them.

Port of the Mamba1 half of ``repro/models/ssm.py``, with the same dtype
discipline: the state math runs in f32 whatever the activation dtype.
The Mamba2/SSD half waits for the hybrid family.

One difference in what the block returns: the JAX ``mamba1_block``
computes the prompt's final scan state and returns ``None`` for the
state of a full-sequence call.  Here it returns the state that stepping
``mamba1_block`` over the same tokens from a zero state would leave —
the scan's final state and the last K-1 conv inputs — so that decode
can start from the prompt.

``plain=False`` (the serving path) runs the scan through the
selective-scan kernel wrapper, which launches the CUDA kernel for CUDA
tensors and runs ``mamba1_scan`` for CPU tensors; ``plain=True`` runs
``mamba1_scan`` on any device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, S, C); w (C, K) depthwise causal; returns (B, S, C)."""
    S = x.shape[1]
    K = w.shape[1]
    out = x * w[:, K - 1]
    for i in range(K - 1):
        shift = K - 1 - i
        xs = F.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xs * w[:, i]
    if b is not None:
        out = out + b
    return out


def conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step.  x_t (B, C); conv_state (B, K-1, C) holds the
    previous K-1 inputs (oldest first).  Returns (y (B, C), new state)."""
    full = torch.cat([conv_state, x_t[:, None]], dim=1)   # (B, K, C)
    y = torch.einsum("bkc,ck->bc", full, w)
    if b is not None:
        y = y + b
    return y, full[:, 1:]


def conv_tail(x: torch.Tensor, K: int) -> torch.Tensor:
    """The conv state after stepping over x (B, S, C) from a zero state:
    its last K-1 rows, zero-padded at the front when S < K-1 — a fresh
    (B, K-1, C) tensor, so the prefill's activations are not kept."""
    tail = x[:, max(0, x.shape[1] - (K - 1)):]
    return F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))


class Mamba1State(NamedTuple):
    conv: torch.Tensor               # (B, K-1, d_in)
    ssm: torch.Tensor                # (B, d_in, N) f32


def mamba1_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain selective scan from a zero state, one step per token in
    f32, for any S: h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,
    y_t = h_t . C_t.  x, dt (B, S, d_in); A (d_in, N); Bc, Cc (B, S, N).
    Returns (y (B, S, d_in) in x's dtype, h_final (B, d_in, N) f32).  The
    JAX oracle's ``chunk`` argument sizes nothing in its sequential loop,
    and no caller passes its ``h0``: both are dropped."""
    B, S, d_in = x.shape
    N = A.shape[1]
    h = torch.zeros((B, d_in, N), dtype=torch.float32, device=x.device)
    A32 = A.to(torch.float32)
    x32, dt32 = x.to(torch.float32), dt.to(torch.float32)
    B32, C32 = Bc.to(torch.float32), Cc.to(torch.float32)
    ys = []
    for t in range(S):
        dt_t = dt32[:, t]
        dA = torch.exp(dt_t[..., None] * A32)                 # (B, d_in, N)
        h = dA * h + (dt_t * x32[:, t])[..., None] * B32[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def mamba1_step(x_t, dt_t, A, B_t, C_t, h):
    """Single decode step: x_t, dt_t (B, d_in); B_t, C_t (B, N);
    h (B, d_in, N) f32 -> (y (B, d_in) in x_t's dtype, h')."""
    f32 = torch.float32
    dA = torch.exp(dt_t.to(f32)[..., None] * A.to(f32))
    dBx = (dt_t * x_t).to(f32)[..., None] * B_t.to(f32)[:, None, :]
    h_new = dA * h + dBx
    y = torch.einsum("bdn,bn->bd", h_new, C_t.to(f32))
    return y.to(x_t.dtype), h_new


def _dbc_split(dbc, dt_rank: int, N: int):
    return (dbc[..., :dt_rank], dbc[..., dt_rank:dt_rank + N],
            dbc[..., dt_rank + N:])


def mamba1_block(x: torch.Tensor, p: dict, cfg: ArchConfig,
                 state: Optional[Mamba1State] = None, plain: bool = False
                 ) -> Tuple[torch.Tensor, Mamba1State]:
    """Full Mamba1 mixer.  x (B, S, d) prefill (state None) or (B, 1, d)
    decode with state.  Returns (out, state): for a prefill the state
    stepping over x from zero would leave (see the module docstring), for
    a decode step the updated state."""
    from repro_torch.kernels.ssm_scan import selective_scan
    d = x.shape[-1]
    N, K = cfg.ssm_state, cfg.ssm_conv
    dt_rank = max(1, d // 16)

    xz = dense(x, p["in_proj"])                      # (B, S, 2*d_in)
    xr, z = xz.chunk(2, dim=-1)
    A = -torch.exp(p["A_log"].to(torch.float32))

    if state is None:
        tail = conv_tail(xr, K)
        xr = F.silu(causal_conv(xr, p["conv_w"], p["conv_b"]))
        # Bc and Cc stay strided views of dbc, as the JAX slices are
        dt_r, Bc, Cc = _dbc_split(dense(xr, p["x_proj"]), dt_rank, N)
        dt = F.softplus(dense(dt_r, p["dt_proj"]) + p["dt_bias"])
        scan = mamba1_scan if plain else selective_scan
        y, h_fin = scan(xr, dt, A, Bc, Cc)
        y = y + xr * p["D"]
        out = dense(y * F.silu(z), p["out_proj"])
        return out, Mamba1State(conv=tail, ssm=h_fin)

    x_t, new_conv = conv_step(xr[:, 0], state.conv, p["conv_w"], p["conv_b"])
    x_t = F.silu(x_t)
    dt_r, B_t, C_t = _dbc_split(dense(x_t, p["x_proj"]), dt_rank, N)
    dt_t = F.softplus(dense(dt_r, p["dt_proj"]) + p["dt_bias"])
    y, h_new = mamba1_step(x_t, dt_t, A, B_t, C_t, state.ssm)
    y = y + x_t * p["D"]
    out = dense(y * F.silu(z[:, 0]), p["out_proj"])[:, None]
    return out, Mamba1State(conv=new_conv, ssm=h_new)
