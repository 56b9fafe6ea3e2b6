"""Chunked flash attention in plain PyTorch, forward only — port of the
forward of ``repro/models/flash.py::flash_attention_ref``.

Causal blocks are enumerated statically as a triangular (i, j) list, so
fully masked blocks are never computed: the saving is structural, as in
the JAX function and in the flash kernel's skip of blocks past the
diagonal.  Each q chunk runs an online softmax over its live kv chunks
and is written out when its last one is done.

The JAX function's custom VJP (score recomputation in a two-pass
backward) belongs to the training slice and is not ported; autograd
through this forward is correct but keeps every block's probabilities.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

NEG_INF = -1e30


def _pairs_by_i(nq: int, nk: int, causal: bool, cq: int,
                ck: int) -> List[Tuple[int, int]]:
    """The live (q chunk, kv chunk) blocks in q-major order: under causal
    masking a block whose first key lies past its last query is left
    out."""
    return [(i, j) for i in range(nq) for j in range(nk)
            if not (causal and j * ck > i * cq + cq - 1)]


def _flash_fwd(q, k, v, causal: bool, cq: int, ck: int) -> torch.Tensor:
    B, S, H, D = q.shape
    T = k.shape[1]
    nq, nk = S // cq, T // ck
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    out = torch.empty_like(q)
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
    return out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, chunk_q: int = 1024,
                        chunk_kv: int = 1024) -> torch.Tensor:
    """Public entry: q (B, S, H, D); k, v (B, T, H, D) with H == q heads
    (kv heads already repeated).  The chunks must divide S and T."""
    B, S, H, D = q.shape
    T = k.shape[1]
    cq = min(chunk_q, S)
    ck = min(chunk_kv, T)
    assert S % cq == 0 and T % ck == 0, (S, cq, T, ck)
    return _flash_fwd(q, k, v, bool(causal), cq, ck)
