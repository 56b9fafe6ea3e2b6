"""Direct (materialized-score) GQA attention — port of
``repro/models/attention.py::direct_attention``, the arithmetic under the
paged gather oracles.

Layout: q (B, S, H, D); k, v (B, T, KV, D).  KV heads are never repeated:
q is grouped to (B, S, KV, G, D) and the einsums run per group.  Masked
scores take the finite ``NEG_INF`` (not -inf), so a fully masked row
softmaxes to uniform instead of NaN, exactly as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Union

import torch

NEG_INF = -1e30


def direct_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool,
                     q_offset: Union[None, int, torch.Tensor] = None,
                     kv_len: Union[None, int, torch.Tensor] = None
                     ) -> torch.Tensor:
    """``q_offset``: absolute position of q[0] — a scalar, or a (B,) vector
    of per-slot offsets (slot b's row t sits at q_offset[b] + t).
    ``kv_len``: cache positions >= kv_len are masked — a scalar or a (B,)
    vector.  (The JAX function's ``kv_start`` window belongs to the dense
    whole-batch cache, which is not ported yet.)"""
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
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return out.reshape(B, S, H, D).to(q.dtype)
