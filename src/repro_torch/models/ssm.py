"""State-space blocks: Mamba1 (falcon-mamba) and Mamba2/SSD (zamba2's
trunk) — the depthwise causal conv, the scans and their single-step
recurrences, and the mixers that join them.

Port of ``repro/models/ssm.py``, with the same dtype discipline: the
state math runs in f32 whatever the activation dtype.

One difference in what the blocks return: the JAX ``mamba1_block`` and
``mamba2_block`` compute the prompt's final scan state and return
``None`` for the state of a full-sequence call.  Here they return the
state that stepping the block over the same tokens from a zero state
would leave — the scan's final state and the last K-1 conv inputs — so
that decode can start from the prompt.

``plain=False`` (the serving path) runs the Mamba1 scan through the
selective-scan kernel wrapper, which launches the CUDA kernel for CUDA
tensors and runs ``mamba1_scan`` for CPU tensors; under autograd the
kernel's training route (``SelectiveScan``: the kernel forward, the plain
scan's backward) keeps y differentiable.  ``plain=True`` runs
``mamba1_scan`` on any device.  The SSD scan is plain PyTorch on both
routes, differentiated by autograd: the JAX package's is plain jnp too,
no Pallas kernel.

Under a device mesh (the block's activations DTensors, ``dist.sharding``)
the depthwise conv and each scan run on the local shards of their inputs,
inside an ``island`` (``_on_local_shards``): the kernel takes raw device
pointers, the SSD scan's chunk loop (dozens of ops a chunk, its masks
local tensors) pays no DTensor dispatch there, and the conv's shifts
(``F.pad``) need no DTensor backward.  The projections, ``D`` and the
gate stay on DTensors.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding
from repro_torch.models.layers import (
    dense, merge_heads, rmsnorm, split_heads)


def _on_local_shards(fn, x, args, arg_dims, out_dims):
    """``fn(x, *args)`` on each rank's local shards, inside an ``island``.
    x (B, S, C, ...) is placed as the JAX ``in_proj`` / ``w_zx`` leave it:
    rows (dim 0) over the batch axes, channels C (dim 2: d_in, or the SSD
    heads) over the model axis, each replicated where its axes do not
    divide it.  Each of ``args`` and of the outputs follows x by its
    (rows dim, channels dim) in ``arg_dims`` / ``out_dims``, None where
    it has no such dim (replicated there).  The channels of the depthwise
    conv and of the scans are independent of each other and the rows of
    one another, so the split is exact; an argument replicated where x is
    split (A over the batch axes; Bc and Cc, shared by every channel,
    over the model axis) takes a Partial gradient, each rank's share,
    summed by the reader (``island``)."""
    from torch.distributed.tensor import Replicate, Shard
    x = sharding.constrain(x, "batch", None, "model",
                           *[None] * (x.dim() - 3))
    x_pl = tuple(x.placements)

    def pl(rows, chans):
        return tuple(Shard(rows) if p == Shard(0) and rows is not None
                     else Shard(chans) if p == Shard(2) and chans is not None
                     else Replicate() for p in x_pl)

    outs = tuple(pl(*d) for d in out_dims)
    return sharding.island(fn, sharding.current_mesh(), (x, *args),
                           (x_pl, *[pl(*d) for d in arg_dims]),
                           outs[0] if len(outs) == 1 else outs)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, S, C); w (C, K) depthwise causal; returns (B, S, C).  Under
    a mesh on local shards (``_on_local_shards``: w and b by channels)."""
    if sharding.on_mesh(x, w):
        return _on_local_shards(causal_conv, x, (w, b),
                                ((None, 0), (None, 0)), ((0, 2),))
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
    (B, K-1, C) tensor, so the prefill's activations are not kept.
    Under a mesh on local shards, rows and channels as x (torch 2.11's
    DTensor cannot plan ``F.pad``'s redistribution)."""
    if sharding.on_mesh(x):
        return _on_local_shards(lambda t: conv_tail(t, K), x, (), (),
                                ((0, 2),))
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


def _mesh_scan(scan, x, dt, A, Bc, Cc):
    """``scan(x, dt, A, Bc, Cc) -> (y, h_final)`` on local shards
    (``_on_local_shards``): x (B, S, C, ...) and dt (B, S, C) by rows and
    channels, A (C, ...) by channels, Bc and Cc (B, S, N) by rows and
    replicated over the model axis; y placed as x, h_final (B, C, ...)
    by rows and channels."""
    def local(x, dt, A, Bc, Cc):
        # a shard of the channel dim is a strided view, and the kernel
        # takes contiguous x, dt and A
        return scan(x.contiguous(), dt.contiguous(), A.contiguous(), Bc, Cc)

    return _on_local_shards(local, x, (dt, A, Bc, Cc),
                           ((0, 2), (None, 0), (0, None), (0, None)),
                           ((0, 2), (0, 1)))


def _dbc_split(dbc, dt_rank: int, N: int):
    return (dbc[..., :dt_rank], dbc[..., dt_rank:dt_rank + N],
            dbc[..., dt_rank + N:])


def _dt(dt: torch.Tensor, *rows) -> torch.Tensor:
    """``dt_proj``'s output, its channels placed over the model axis (a
    Partial sum reduced) before the bias adds: torch 2.11's DTensor
    cannot make the bias Partial to match."""
    return sharding.constrain(dt, *rows, "model")


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
        dt = F.softplus(_dt(dense(dt_r, p["dt_proj"]), "batch", None)
                        + p["dt_bias"])
        scan = mamba1_scan if plain else selective_scan
        if sharding.on_mesh(xr, dt, A, Bc, Cc):
            y, h_fin = _mesh_scan(scan, xr, dt, A, Bc, Cc)
        else:
            y, h_fin = scan(xr, dt, A, Bc, Cc)
        y = y + xr * p["D"]
        out = dense(y * F.silu(z), p["out_proj"])
        return out, Mamba1State(conv=tail, ssm=h_fin)

    x_t, new_conv = conv_step(xr[:, 0], state.conv, p["conv_w"], p["conv_b"])
    x_t = F.silu(x_t)
    dt_r, B_t, C_t = _dbc_split(dense(x_t, p["x_proj"]), dt_rank, N)
    dt_t = F.softplus(_dt(dense(dt_r, p["dt_proj"]), "batch") + p["dt_bias"])
    y, h_new = mamba1_step(x_t, dt_t, A, B_t, C_t, state.ssm)
    y = y + x_t * p["D"]
    out = dense(y * F.silu(z[:, 0]), p["out_proj"])[:, None]
    return out, Mamba1State(conv=new_conv, ssm=h_new)


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

class Mamba2State(NamedTuple):
    conv: torch.Tensor               # (B, K-1, d_in)
    ssm: torch.Tensor                # (B, H, hd, N) f32


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bc: torch.Tensor, Cc: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD chunked algorithm (Mamba2), in f32: within a chunk the
    attention-like form (the decay matrix L), across chunks the state
    recurrence.  x (B, S, H, hd); dt (B, S, H) (post-softplus); A (H,)
    negative; Bc, Cc (B, S, N), shared across heads (ngroups == 1).
    Returns (y (B, S, H, hd) in x's dtype, h_final (B, H, hd, N) f32).

    Chunks are ``min(chunk, S)`` steps, as in the JAX function, which
    asserts that they divide S; here the last chunk may be shorter.  The
    chunked form is exact for any split of the sequence, so a ragged S
    changes only the rounding; where JAX runs, the chunks and so the sums
    are the same."""
    B, S, H, hd = x.shape
    N = Bc.shape[-1]
    c = min(chunk, S)
    f32 = torch.float32
    h = torch.zeros((B, H, hd, N), dtype=f32, device=x.device) \
        if h0 is None else h0
    xf, dtf = x.to(f32), dt.to(f32)
    Bf, Cf = Bc.to(f32), Cc.to(f32)
    A32 = A.to(f32)
    neg = torch.tensor(-torch.inf, dtype=f32, device=x.device)
    ys = []
    for s0 in range(0, S, c):
        xc, dtc = xf[:, s0:s0 + c], dtf[:, s0:s0 + c]
        bc, cc = Bf[:, s0:s0 + c], Cf[:, s0:s0 + c]
        n = xc.shape[1]
        # per-step log decay a_t = dt_t A (negative)
        cum = torch.cumsum(dtc * A32, dim=1)                 # (B, n, H)
        # L[t, j] = exp(cum_t - cum_j) for j <= t else 0.  Mask BEFORE
        # exp: above the diagonal the differences are positive and would
        # overflow (inf * 0 = NaN)
        diff = cum[:, :, None, :] - cum[:, None, :, :]        # (B, n, n, H)
        tri = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                    device=x.device))
        Lm = torch.exp(torch.where(tri[None, :, :, None], diff, neg))
        # within the chunk: scores[t, j] = (C_t . B_j) L[t, j] dt_j
        cb = torch.einsum("btn,bjn->btj", cc, bc)            # (B, n, n)
        scores = cb[..., None] * Lm * dtc[:, None]           # (B, n, n, H)
        y_diag = torch.einsum("btjh,bjhd->bthd", scores, xc)
        # the chunk's exit decay, and each step's decay to the chunk end
        total = cum[:, -1]                                   # (B, H)
        dec_j = torch.exp(total[:, None] - cum)              # (B, n, H)
        dBx = torch.einsum("bjh,bjn,bjhd->bhdn", dec_j * dtc, bc, xc)
        # across chunks: y_t += C_t . (exp(cum_t) h_in)
        y_off = torch.einsum("btn,bhdn,bth->bthd", cc, h, torch.exp(cum))
        h = torch.exp(total)[..., None, None] * h + dBx
        ys.append(y_diag + y_off)
    return torch.cat(ys, dim=1).to(x.dtype), h


def ssd_step(x_t, dt_t, A, B_t, C_t, h):
    """Single decode step: x_t (B, H, hd); dt_t (B, H); B_t, C_t (B, N);
    h (B, H, hd, N) f32 -> (y (B, H, hd) in x_t's dtype, h')."""
    f32 = torch.float32
    a = torch.exp(dt_t.to(f32) * A.to(f32))                  # (B, H)
    dBx = torch.einsum("bh,bn,bhd->bhdn", dt_t.to(f32), B_t.to(f32),
                       x_t.to(f32))
    h_new = a[..., None, None] * h + dBx
    y = torch.einsum("bhdn,bn->bhd", h_new, C_t.to(f32))
    return y.to(x_t.dtype), h_new


def mamba2_block(x: torch.Tensor, p: dict, cfg: ArchConfig,
                 state: Optional[Mamba2State] = None
                 ) -> Tuple[torch.Tensor, Mamba2State]:
    """Mamba2 mixer: the projections stored apart (``w_zx``, ``w_bc``,
    ``w_dt``), a scalar decay per head, and an rmsnorm over d_in gated by
    silu(z).  x (B, S, d) prefill (state None) or (B, 1, d) decode with
    state.  Returns (out, state): for a prefill the state stepping over
    x from zero would leave (see the module docstring), for a decode step
    the updated state."""
    d = x.shape[-1]
    d_in = d * cfg.ssm_expand
    hd = cfg.ssm_head_dim
    H = d_in // hd

    z, xr = dense(x, p["w_zx"]).chunk(2, dim=-1)      # (B, S, d_in) each
    B_c, C_c = dense(x, p["w_bc"]).chunk(2, dim=-1)   # (B, S, N) each
    dt_raw = dense(x, p["w_dt"])                      # (B, S, H)
    A = -torch.exp(p["A_log"].to(torch.float32))      # (H,)

    if state is None:
        tail = conv_tail(xr, cfg.ssm_conv)
        xr = F.silu(causal_conv(xr, p["conv_w"], p["conv_b"]))
        dt = F.softplus(dt_raw + p["dt_bias"])
        xh = split_heads(xr, H, hd)
        if sharding.on_mesh(xh, dt, A, B_c, C_c):
            y, h_fin = _mesh_scan(
                functools.partial(ssd_scan, chunk=cfg.ssm_chunk),
                xh, dt, A, B_c, C_c)
        else:
            y, h_fin = ssd_scan(xh, dt, A, B_c, C_c, cfg.ssm_chunk)
        y = merge_heads(y + xh * p["D"][None, None, :, None])
        y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
        return dense(y, p["out_proj"]), Mamba2State(conv=tail, ssm=h_fin)

    x_t, new_conv = conv_step(xr[:, 0], state.conv, p["conv_w"], p["conv_b"])
    x_t = F.silu(x_t)
    dt_t = F.softplus(dt_raw[:, 0] + p["dt_bias"])
    xh = split_heads(x_t, H, hd)
    y, h_new = ssd_step(xh, dt_t, A, B_c[:, 0], C_c[:, 0], state.ssm)
    y = merge_heads(y + xh * p["D"][None, :, None])
    y = rmsnorm(y * F.silu(z[:, 0]), p["norm"], cfg.norm_eps)
    out = dense(y, p["out_proj"])[:, None]
    return out, Mamba2State(conv=new_conv, ssm=h_new)
