"""Attention — port of ``repro/models/attention.py``: GQA/MQA multi-head
attention with a direct (materialized-score) path for decode and short
shapes, the chunked online-softmax reference for long ones, and the
dispatch between them and the flash kernel.

Under a device mesh (q a DTensor, ``dist.sharding``) ``attention`` runs
on each rank's local shards, inside an ``island``: the rows of its batch
shard, the heads of its model-axis shard with the kv heads they read (or,
where the model axis does not divide the heads, its group's heads, as
GSPMD splits them: ``head_groups``) — the flash kernel takes raw device
pointers, and the plain path's masks are local tensors.

A whole-batch decode step under a mesh attends a cache sharded over
its sequence (the dry run's ``cache_seq`` axes) in another island
(``mesh_decode_attention``): each rank writes the new row where it falls
in its slice of the cache, attends its slice, and the ranks combine
their softmax partials (max, sum, weighted values) over the sequence
axes, as GSPMD partitions the JAX decode's softmax.

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

from repro_torch.dist import sharding

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
    if sharding.on_mesh(q, k, v):
        if kv_len is not None or q_offset is not None:
            raise NotImplementedError(
                "attention under a device mesh takes no kv_len or q_offset "
                "(the whole-batch decode's self-attention runs in "
                "mesh_decode_attention); the port serves on one device, as "
                "the JAX launcher does")
        return _mesh_attention(q, k, v, causal, chunk_q, chunk_kv, plain)
    if not plain and on_card(q) and S > 1 and kv_len is None:
        from repro_torch.kernels.flash_attention import flash
        check_reference_shape(S, T, chunk_q, chunk_kv)
        return flash.launch(q, k, v, causal)
    if S == 1 or (S * T <= chunk_q * chunk_kv) or kv_len is not None:
        return direct_attention(q, k, v, causal, q_offset, kv_len)
    from repro_torch.models.flash import flash_attention_ref
    return flash_attention_ref(q, repeat_kv(k, H), repeat_kv(v, H),
                               causal, chunk_q, chunk_kv)


def head_groups(H: int, D: int, mesh) -> tuple:
    """(mesh dims of the model axis, M their ranks, f) for q heads that
    the model axis does not divide: GSPMD splits the q projection's
    H * D features M ways and reshapes them as f ways over the heads, f =
    gcd(H, M), and M / f ways over the head dim (when it divides D), so
    the attention runs on H / f heads a rank, each group of heads
    replicated on M / f ranks.  f is 1 where no such split exists."""
    rules = sharding.active_rules()
    names = list(mesh.mesh_dim_names)
    axes = sharding.entry_axes(rules.resolve("model"))
    dims = [names.index(a) for a in axes if a in names]
    M = math.prod(mesh.size(m) for m in dims)
    f = math.gcd(H, M)
    if H % M == 0 or f == 1 or D % (M // f):
        return dims, M, 1
    return dims, M, f


def _mesh_attention(q, k, v, causal: bool, chunk_q: int, chunk_kv: int,
                    plain: bool):
    """``attention`` on the local shards of q (B, S, H, D) and k, v (B,
    T, KV, D), placed as the JAX ``_qkv`` constrains them: the batch dim
    over the batch axes, q's heads over the model axis, k and v
    replicated over it.  Each rank attends its rows and heads against
    the kv heads they read (a slice when its heads cover whole groups,
    else one kv head gathered per q head); the kv gradients of a rank
    cover its slice and sum over the model axis.  Where the model axis
    does not divide the heads, q stays replicated over it and the ranks
    split the heads in ``head_groups`` as GSPMD does: each rank attends
    its group's H / f heads, one rank of each group writes them into an
    output that is zero elsewhere, and the output is the Partial sum of
    those (exact: each element is one group's value plus zeros), its
    gradients Partial over the model axis the same way."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = sharding.current_mesh()
    q = sharding.constrain(q, "batch", None, "model", None)
    k = sharding.constrain(k, "batch", None, None, None)
    v = sharding.constrain(v, "batch", None, None, None)
    q_pl = tuple(q.placements)
    head_dims = [m for m, p in enumerate(q_pl) if p == Shard(2)]
    kv_pl = tuple(Replicate() if m in head_dims else p
                  for m, p in enumerate(q_pl))
    H, D = q.shape[2], q.shape[3]
    G = H // k.shape[2]
    group_dims, M, f = head_groups(H, D, mesh)
    if head_dims or f == 1:
        group_dims = []

    def heads(ql, kl, vl, h0, Hl):
        if Hl % G == 0:
            return (ql, kl[:, :, h0 // G:(h0 + Hl) // G],
                    vl[:, :, h0 // G:(h0 + Hl) // G])
        idx = torch.arange(h0, h0 + Hl, device=kl.device) // G
        return ql, kl.index_select(2, idx), vl.index_select(2, idx)

    def local(ql, kl, vl):
        if head_dims:
            Hl = ql.shape[2]
            h0 = sharding.mesh_coordinate(mesh, head_dims) * Hl
            return attention(*heads(ql, kl, vl, h0, Hl), causal, chunk_q,
                             chunk_kv, plain=plain)
        if not group_dims:
            return attention(ql, kl, vl, causal, chunk_q, chunk_kv,
                             plain=plain)
        g, replica = divmod(sharding.mesh_coordinate(mesh, group_dims),
                            M // f)
        Hl = H // f
        h0 = g * Hl
        o = attention(*heads(ql[:, :, h0:h0 + Hl], kl, vl, h0, Hl), causal,
                      chunk_q, chunk_kv, plain=plain)
        if replica:
            o = torch.where(torch.zeros((), dtype=torch.bool,
                                        device=o.device), o, 0)
        zeros = o.new_zeros
        return torch.cat([zeros(*o.shape[:2], h0, D), o,
                          zeros(*o.shape[:2], H - h0 - Hl, D)], dim=2)

    out_pl = tuple(Partial() if m in group_dims else p
                   for m, p in enumerate(q_pl))
    return sharding.island(local, mesh, (q, k, v), (q_pl, kv_pl, kv_pl),
                           out_pl, split_dims=group_dims)


def _decode_partial(q, k, v, tpos, pos, start):
    """One decode row's attention over a slice of the cache, unnormalized:
    q (B, 1, H, D), k and v (B, Tl, KV, D) at global positions ``tpos``
    (Tl,); positions after ``pos`` or before ``start[b]`` masked.  Returns
    (o (B, 1, H, D) f32, m (B, 1, H) the slice's max score, l (B, 1, H)
    its sum of exp(s - m))."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bskgt", qg, k.to(torch.float32)) \
        / math.sqrt(D)
    live = (tpos <= pos)[None]
    if start is not None:
        live = live & (tpos[None] >= start[:, None])
    s = torch.where(live[:, None, None, None],
                    s, torch.tensor(NEG_INF, device=s.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bskgt,btkd->bskgd", p, v.to(torch.float32))
    return (o.reshape(B, S, H, D), m.reshape(B, S, H),
            p.sum(dim=-1).reshape(B, S, H))


def _combine(o, m, l_, mesh, seq_dims):
    """The ranks' softmax partials of ``_decode_partial`` combined over
    the mesh dims ``seq_dims`` that split the cache's sequence: the
    normalized attention output (B, 1, H, D) f32."""
    import torch.distributed._functional_collectives as funcol
    for d in seq_dims:
        group = (mesh, d)
        mx = funcol.all_reduce(m, "max", group)
        w = torch.exp(m - mx)
        l_ = funcol.all_reduce(l_ * w, "sum", group)
        o = funcol.all_reduce(o * w[..., None], "sum", group)
        m = mx
    return o / l_[..., None]


def _seq_sharded(k_cache, v_cache):
    """The caches (B, T, KV, D) constrained by batch and ``cache_seq``:
    (k_cache, v_cache, their placements, the mesh dims that split the
    sequence, the placements of one row: the cache's, those dims
    replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    k_cache = sharding.constrain(k_cache, "batch", "cache_seq", None, None)
    v_cache = sharding.constrain(v_cache, "batch", "cache_seq", None, None)
    c_pl = tuple(k_cache.placements)
    seq_dims = [i for i, p in enumerate(c_pl) if p == Shard(1)]
    row_pl = tuple(Replicate() if i in seq_dims else p
                   for i, p in enumerate(c_pl))
    return k_cache, v_cache, c_pl, seq_dims, row_pl


def mesh_decode_attention(q, k, v, k_cache, v_cache, pos, start=None):
    """Whole-batch decode under a mesh (see the module doc): q (B, 1, H,
    D) and this step's k, v (B, 1, KV, D); the caches (B, T, KV, D)
    placed by batch and ``cache_seq``, written IN PLACE at row ``pos``
    (clamped into the cache, as ``dynamic_update_slice`` clamps); pos a
    replicated 0-d int, start (B,) or None.  Returns the attention output
    (B, 1, H, D) in q's dtype, placed as q."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = sharding.current_mesh()
    k_cache, v_cache, c_pl, seq_dims, row_pl = _seq_sharded(k_cache, v_cache)
    rep = tuple(Replicate() for _ in c_pl)
    q = sharding.constrain(q, "batch", None, None, None)
    k = sharding.constrain(k, "batch", None, None, None)
    v = sharding.constrain(v, "batch", None, None, None)
    T = k_cache.shape[1]
    args = [q, k, v, k_cache, v_cache, pos]
    pls = [row_pl] * 3 + [c_pl, c_pl, rep]
    if start is not None:
        args.append(sharding.constrain(start, "batch"))
        pls.append(tuple(Shard(0) if p == Shard(0) else Replicate()
                         for p in row_pl))

    def local(ql, kl, vl, kc, vc, p, st=None):
        Tl = kc.shape[1]
        t0 = sharding.mesh_coordinate(mesh, seq_dims) * Tl
        row = torch.clamp(p, 0, T - 1) - t0
        r = torch.clamp(row, 0, Tl - 1).reshape(1).long()
        inside = (row == r)
        for c, new in ((kc, kl), (vc, vl)):
            keep = c.index_select(1, r)
            c.index_copy_(1, r, torch.where(inside, new.to(c.dtype), keep))
        tpos = t0 + torch.arange(Tl, device=kc.device)
        return _combine(*_decode_partial(ql, kc, vc, tpos, p, st), mesh,
                        seq_dims).to(ql.dtype)

    return sharding.island(local, mesh, tuple(args), tuple(pls), row_pl)


def mesh_cross_attention(q, k_cache, v_cache):
    """A decode step's cross-attention under a mesh: q (B, 1, H, D) over
    every row of the read-only cross cache (B, T, KV, D), placed by batch
    and ``cache_seq`` as the self cache.  q is replicated over the model
    axis, so each rank attends all H heads over its T / m rows (GSPMD's
    split of the JAX decode's ``direct_attention``); the padding rows take
    part in the softmax, as there.  Returns (B, 1, H, D) in q's dtype,
    placed by batch."""
    from torch.distributed.tensor import Shard
    mesh = sharding.current_mesh()
    if sharding.active_rules() is None or not sharding.on_mesh(k_cache):
        raise RuntimeError("mesh_cross_attention takes a DTensor cross "
                           "cache under the active mesh (sharding.use_mesh)")
    split = Shard(1) in k_cache.placements
    k_cache, v_cache, c_pl, seq_dims, row_pl = _seq_sharded(k_cache, v_cache)
    if split and not seq_dims:
        raise RuntimeError(
            f"the cross cache's {k_cache.shape[1]} rows do not divide the "
            "cache_seq axes; the decode does not gather them")
    q = sharding.constrain(q, "batch", None, None, None)
    T = k_cache.shape[1]

    def local(ql, kc, vc):
        Tl = kc.shape[1]
        t0 = sharding.mesh_coordinate(mesh, seq_dims) * Tl
        tpos = t0 + torch.arange(Tl, device=kc.device)
        return _combine(*_decode_partial(ql, kc, vc, tpos, T - 1, None),
                        mesh, seq_dims).to(ql.dtype)

    return sharding.island(local, mesh, (q, k_cache, v_cache),
                           (row_pl, c_pl, c_pl), row_pl)
