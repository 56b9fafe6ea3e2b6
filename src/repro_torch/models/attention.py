"""Attention — port of ``repro/models/attention.py``: GQA/MQA multi-head
attention with a direct (materialized-score) path for decode and short
shapes, the chunked online-softmax reference for long ones, and the
dispatch between them and the flash kernel.

Layout: q (B, S, H, D); k, v (B, T, KV, D).  ``direct_attention`` never
repeats KV heads: q is grouped to (B, S, KV, G, D) and the einsums run
per group.  Masked scores take the finite ``NEG_INF`` (not -inf), so a
fully masked row softmaxes to uniform instead of NaN, exactly as in the
JAX package.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, KV, D) -> (B, T, H, D), each kv head repeated H / KV times
    in place (head h reads kv head h // (H / KV))."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=2)


def direct_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool,
                     q_offset: Union[None, int, torch.Tensor] = None,
                     kv_len: Union[None, int, torch.Tensor] = None,
                     kv_start: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``q_offset``: absolute position of q[0] — a scalar, or a (B,) vector
    of per-slot offsets (slot b's row t sits at q_offset[b] + t).
    ``kv_len``: cache positions >= kv_len are masked — a scalar or a (B,)
    vector.  ``kv_start`` (B,): cache positions < kv_start[b] are masked
    (the per-slot window of the whole-batch cache)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qg = q.reshape(B, S, KV, G, D)
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                     k.to(torch.float32)) * scale
    tpos = torch.arange(T, device=dev)
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    if causal:
        qpos = torch.arange(S, device=dev)
        if isinstance(q_offset, torch.Tensor) and q_offset.ndim == 1:
            qpos = qpos[None, :] + q_offset.to(dev)[:, None]      # (B, S)
            mask = qpos[:, :, None] >= tpos[None, None, :]        # (B, S, T)
            s = torch.where(mask[:, None, None], s, neg)
        else:
            if q_offset is not None:
                qpos = qpos + q_offset
            mask = qpos[:, None] >= tpos[None, :]
            s = torch.where(mask[None, None, None], s, neg)
    if kv_len is not None:
        kvl = torch.as_tensor(kv_len, device=dev)
        if kvl.ndim == 0:
            s = torch.where((tpos < kvl)[None, None, None, None], s, neg)
        else:                                    # per-slot (B,) lengths
            live = tpos[None, :] < kvl[:, None]              # (B, T)
            s = torch.where(live[:, None, None, None], s, neg)
    if kv_start is not None:
        live = tpos[None, :] >= kv_start.to(dev)[:, None]    # (B, T)
        s = torch.where(live[:, None, None, None], s, neg)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(B, S, H, D).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, chunk_q: int = 1024,
                      chunk_kv: int = 1024) -> torch.Tensor:
    """Two-level online softmax over (chunk_q x chunk_kv) blocks.  Every
    block is computed and masked: the causal skip belongs to
    ``models/flash.py`` and the flash kernel."""
    B, S, H, D = q.shape
    T = k.shape[1]
    k = repeat_kv(k, H)
    v = repeat_kv(v, H)
    cq = min(chunk_q, S)
    ck = min(chunk_kv, T)
    assert S % cq == 0 and T % ck == 0, (S, cq, T, ck)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    out = torch.empty_like(q)
    for i in range(S // cq):
        qb = q[:, i * cq:(i + 1) * cq].to(torch.float32)
        m = torch.full((B, H, cq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, cq, H, D), dtype=torch.float32, device=dev)
        for j in range(T // ck):
            kb = k[:, j * ck:(j + 1) * ck].to(torch.float32)
            vb = v[:, j * ck:(j + 1) * ck].to(torch.float32)
            s = torch.einsum("bshd,bthd->bhst", qb, kb) * scale
            if causal:
                qpos = i * cq + torch.arange(cq, device=dev)
                kpos = j * ck + torch.arange(ck, device=dev)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask[None, None], s,
                                torch.tensor(NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhst,bthd->bshd", p, vb)
            acc = acc * corr.transpose(1, 2)[..., None] + pv
            m = m_new
        out[:, i * cq:(i + 1) * cq] = (
            acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
        ).to(q.dtype)
    return out


def on_card(q: torch.Tensor) -> bool:
    """The kernel route's test: does q lie on a CUDA device?"""
    return q.device.type == "cuda"


def check_reference_shape(S: int, T: int, chunk_q: int,
                          chunk_kv: int) -> None:
    """Raises the reference dispatch's AssertionError for an (S, T) it
    refuses: it runs direct attention when S * T <= chunk_q * chunk_kv,
    else the chunked flash reference, whose chunks min(chunk_q, S) and
    min(chunk_kv, T) must divide S and T."""
    cq, ck = min(chunk_q, S), min(chunk_kv, T)
    if S * T > chunk_q * chunk_kv and (S % cq or T % ck):
        raise AssertionError((S, cq, T, ck))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, chunk_q: int = 1024, chunk_kv: int = 1024,
              q_offset: Union[None, int, torch.Tensor] = None,
              kv_len: Union[None, int, torch.Tensor] = None,
              plain: bool = False) -> torch.Tensor:
    """Dispatch.  The kernel route — CUDA tensors, ``plain`` False, S > 1
    and no ``kv_len`` — launches the flash kernel on unrepeated k and v
    (the JAX package's ``impl == "pallas"`` branch) for every (S, T) the
    reference dispatch serves, and refuses the rest as it does.  The
    kernel masks its own ragged tiles, so the Pallas wrapper's 512-block
    contract is not applied here.  Otherwise the JAX reference dispatch:
    decode and small shapes -> direct; long -> the chunked flash
    reference on repeated kv heads.  Under autograd the kernel route is
    the kernel's training route (its forward with L, the chunked
    reference's backward) and the chunked reference takes its custom
    backward; direct attention is differentiated by autograd, as in the
    JAX package."""
    B, S, H, D = q.shape
    T = k.shape[1]
    if not plain and on_card(q) and S > 1 and kv_len is None:
        from repro_torch.kernels.flash_attention import flash
        check_reference_shape(S, T, chunk_q, chunk_kv)
        return flash.launch(q, k, v, causal)
    if S == 1 or (S * T <= chunk_q * chunk_kv) or kv_len is not None:
        return direct_attention(q, k, v, causal, q_offset, kv_len)
    from repro_torch.models.flash import flash_attention_ref
    return flash_attention_ref(q, repeat_kv(k, H), repeat_kv(v, H),
                               causal, chunk_q, chunk_kv)
