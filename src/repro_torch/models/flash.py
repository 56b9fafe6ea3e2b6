"""Chunked flash attention in plain PyTorch with its custom backward —
port of ``repro/models/flash.py::flash_attention_ref`` and its custom VJP.

Causal blocks are enumerated statically as a triangular (i, j) list, so
fully masked blocks are never computed: the saving is structural, as in
the JAX function and in the flash kernel's skip of blocks past the
diagonal.  Each q chunk runs an online softmax over its live kv chunks
and is written out when its last one is done, with its rows' softmax
normalizers L = m + log(max(l, 1e-30)).

The backward (``flash_bwd``, the JAX function's ``bwd_impl``) saves only
(q, k, v, out, L) and recomputes each block's scores: p = exp(s - L),
dp = dO V^T, ds = p (dp - D) / sqrt(D) with D = rowsum(dO * O), then
dq += ds K, dk += ds^T Q and dv += p^T dO.  The JAX function runs it as
two passes (dq over i-ordered blocks, dk/dv over j-ordered ones) so that
each carries one chunk's accumulator through a scan; here one pass over
the i-ordered blocks adds into full-size f32 accumulators, which gives
every accumulator its terms in the same order as the two passes with
half the score recomputation.  The flash kernel's training route
(``kernels/flash_attention/flash.py``) runs the same backward on the L
the kernel writes.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from repro_torch import spans

NEG_INF = -1e30


def _pairs_by_i(nq: int, nk: int, causal: bool, cq: int,
                ck: int) -> List[Tuple[int, int]]:
    """The live (q chunk, kv chunk) blocks in q-major order: under causal
    masking a block whose first key lies past its last query is left
    out."""
    return [(i, j) for i in range(nq) for j in range(nk)
            if not (causal and j * ck > i * cq + cq - 1)]


def _flash_fwd(q, k, v, causal: bool, cq: int, ck: int):
    """Returns (out (B, S, H, D) in q's dtype, L (B, S, H) f32)."""
    B, S, H, D = q.shape
    T = k.shape[1]
    nq, nk = S // cq, T // ck
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    out = torch.empty_like(q)
    L = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    m = l = acc = None
    pairs = _pairs_by_i(nq, nk, causal, cq, ck)
    for t, (i, j) in enumerate(pairs):
        if t == 0 or pairs[t - 1][0] != i:       # first block of chunk i
            m = torch.full((B, cq, H), NEG_INF, dtype=torch.float32,
                           device=dev)
            l = torch.zeros((B, cq, H), dtype=torch.float32, device=dev)
            acc = torch.zeros((B, cq, H, D), dtype=torch.float32, device=dev)
        qb = q[:, i * cq:(i + 1) * cq].to(torch.float32)
        kb = k[:, j * ck:(j + 1) * ck].to(torch.float32)
        vb = v[:, j * ck:(j + 1) * ck].to(torch.float32)
        s = torch.einsum("bshd,bthd->bsht", qb, kb) * scale
        if causal:
            qpos = i * cq + torch.arange(cq, device=dev)
            kpos = j * ck + torch.arange(ck, device=dev)
            keep = qpos[:, None] >= kpos[None, :]
            s = torch.where(keep[None, :, None, :], s,
                            torch.tensor(NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bsht,bthd->bshd", p, vb)
        m = m_new
        if t == len(pairs) - 1 or pairs[t + 1][0] != i:   # last block
            lsafe = torch.clamp(l, min=1e-30)
            out[:, i * cq:(i + 1) * cq] = (acc / lsafe[..., None]).to(q.dtype)
            L[:, i * cq:(i + 1) * cq] = m + torch.log(lsafe)
    return out, L


def flash_bwd(q, k, v, out, L, dout, causal: bool, cq: int, ck: int):
    """The backward of causal or full attention from the forward's (q, k,
    v, out, L): q, out, dout (B, S, H, D); k, v (B, T, H, D) (kv heads
    repeated to H); L (B, S, H) f32.  Chunks of cq query rows and ck
    positions; a ragged last chunk is taken as it is (the JAX function
    asks both to divide).  Returns (dq, dk, dv) in f32, k and v's at H
    heads."""
    B, S, H, D = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    f32 = torch.float32
    # (B, H, rows, D): each block's products are batched matmuls over B H
    qh = q.to(f32).transpose(1, 2)
    kh = k.to(f32).transpose(1, 2)
    vh = v.to(f32).transpose(1, 2)
    doh = dout.to(f32).transpose(1, 2)
    Lh = L.to(f32).transpose(1, 2)                        # (B, H, S)
    Dh = (out.to(f32).transpose(1, 2) * doh).sum(-1)      # rowsum(dO * O)
    dq = torch.zeros((B, H, S, D), dtype=f32, device=dev)
    dk = torch.zeros((B, H, T, D), dtype=f32, device=dev)
    dv = torch.zeros((B, H, T, D), dtype=f32, device=dev)
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    for i in range(-(-S // cq)):
        q0, q1 = i * cq, min(S, (i + 1) * cq)
        qb, dob = qh[:, :, q0:q1], doh[:, :, q0:q1]
        Lb, Db = Lh[:, :, q0:q1, None], Dh[:, :, q0:q1, None]
        for j in range(-(-T // ck)):
            k0, k1 = j * ck, min(T, (j + 1) * ck)
            if causal and k0 > q1 - 1:               # fully masked: skipped
                break
            kb, vb = kh[:, :, k0:k1], vh[:, :, k0:k1]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            if causal:
                keep = (torch.arange(q0, q1, device=dev)[:, None]
                        >= torch.arange(k0, k1, device=dev)[None, :])
                s = torch.where(keep, s, neg)
            p = torch.exp(s - Lb)
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            ds = p * (dp - Db) * scale
            dq[:, :, q0:q1] += torch.matmul(ds, kb)
            dv[:, :, k0:k1] += torch.matmul(p.transpose(-1, -2), dob)
            dk[:, :, k0:k1] += torch.matmul(ds.transpose(-1, -2), qb)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


class _FlashRef(torch.autograd.Function):
    """The chunked reference under its custom backward: saves (q, k, v,
    out, L), nothing of a block's size; the backward is one
    ``flash.backward`` span."""

    @staticmethod
    def forward(ctx, q, k, v, causal, cq, ck):
        out, L = _flash_fwd(q, k, v, causal, cq, ck)
        ctx.save_for_backward(q, k, v, out, L)
        ctx.causal, ctx.cq, ctx.ck = causal, cq, ck
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, L = ctx.saved_tensors
        with spans.span("flash.backward", S=q.shape[1], T=k.shape[1]):
            dq, dk, dv = flash_bwd(q, k, v, out, L, dout, ctx.causal,
                                   ctx.cq, ctx.ck)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, chunk_q: int = 1024,
                        chunk_kv: int = 1024) -> torch.Tensor:
    """Public entry: q (B, S, H, D); k, v (B, T, H, D) with H == q heads
    (kv heads already repeated).  The chunks must divide S and T.
    Differentiable through the custom backward."""
    B, S, H, D = q.shape
    T = k.shape[1]
    cq = min(chunk_q, S)
    ck = min(chunk_kv, T)
    assert S % cq == 0 and T % ck == 0, (S, cq, T, ck)
    return _FlashRef.apply(q, k, v, bool(causal), cq, ck)
