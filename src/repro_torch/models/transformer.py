"""The decoder-only LM (dense or MoE FFN; token ids, or a VLM's
precomputed embeddings with M-RoPE), the pure-SSM LM (Mamba1,
falcon-mamba), the hybrid (zamba2: a Mamba2 trunk with one shared
attention block after every ``attn_every`` layers) and the
encoder-decoder (whisper): schema, the whole-batch forward
(``lm_forward``: train / prefill / hidden) and decode step
(``lm_decode``) over a (L, B, T, KV, hd) cache, the SSM family's
per-layer (conv, ssm) state or the hybrid's states and per-application
attention caches, the two paged attention paths (decode and ragged
prefill), the FFN (swiglu, the gelu MLP, or routed through
``models/moe.py``), the paged forward passes, and whisper's encoder,
forward and decode step (``whisper_*``).

Port of ``repro/models/transformer.py``.  The ``lax.scan`` over stacked layers
becomes a Python loop over the layer index; caches and pools are
updated IN PLACE where the JAX functions return updated copies, so the
returned cache holds the same tensors it was given.  The JAX sharding
constraints stand at the same points, by the same logical names
(``dist.sharding.constrain``): no-ops on plain tensors, a DTensor
``redistribute`` under a device mesh, where the schema's ``axes`` place
the parameters (``train.elastic.reshard``).  Remat is
kept where it acts, in a training pass (``remat_on``), with
``torch.utils.checkpoint`` (non-reentrant), where the JAX package puts
its ``jax.checkpoint``: the dense family's ``lm_forward`` checkpoints
each block (``cfg.remat`` "block" or "full") or each group of
``cfg.remat_group`` layers; the SSM family each layer; the hybrid each
group of ``attn_every`` Mamba2 layers with its application of the shared
block (the tail layers are not checkpointed); whisper each encoder layer
and each decoder layer (self-attention, the cross K/V of the encoder
output and cross-attention).  The backward recomputes each checkpointed
layer once from its saved input; the values and gradients are those of
the pass without it, bit for bit.

Attention: ``plain=False`` (the default, and the serving path) calls the
kernel wrappers, which launch the CUDA kernels for CUDA tensors and run
the plain version for CPU tensors (for the flash kernel, ``attention``
keeps the JAX reference dispatch on the CPU).  ``plain=True`` calls the
plain versions on any device — the reference that ``chip_smoke.py``
holds the kernel path against on the card.  The same switch picks the
selective-scan kernel or its plain version in the SSM family's prefill;
the hybrid's shared block takes flash and dense decode as the dense
family does, and its SSD scan is plain PyTorch on both routes.
Whisper's encoder and cross-attention are non-causal flash calls on the
kernel route; a decode step's cross-attention (one query row) takes the
direct path, as the reference dispatch does.

One difference from the JAX package, in the SSM and hybrid families:
its ``lm_forward(mode="prefill")`` returns no SSM cache parts, so its
``ServingEngine`` decodes from a zero state as if the prompt had never
been seen.  Here the prefill returns each layer's final scan state and
conv tail — the state the JAX package's own ``lm_decode`` leaves after
stepping over the prompt — and decode starts from it.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.sharding import constrain, is_dtensor, place
from repro_torch.kernels.decode_attention import (
    decode_attention, paged_decode_attention, paged_prefill_attention)
from repro_torch.kernels.decode_attention.ref import (
    paged_decode_attention_ref, paged_prefill_attention_ref)
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import (
    attention, direct_attention, mesh_decode_attention)
from repro_torch.models.kv_quant import quantize_rows
from repro_torch.models.layers import (
    apply_rope, dense, embed, gelu_mlp, layernorm, mrope_angles, rmsnorm,
    rope_angles, sinusoidal_positions, swiglu, unembed)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import ParamDecl, map_schema, stacked


def check_supported(cfg: ArchConfig, paged: bool = False) -> None:
    """Refuses what the port does not run: the two SSM layouts that the
    JAX package's decode cannot run either (Mamba2 blocks outside the
    hybrid family, and a hybrid of Mamba1 blocks or without attention
    groups), and on the paged path the SSM, hybrid and encoder-decoder
    archs, which the JAX package's ``PagedEngine`` refuses too.  Every
    other family runs: dense, MoE, Mamba1, the zamba2 hybrid (Mamba2
    with ``attn_every`` > 0), the VLM (M-RoPE, embedding inputs) and
    whisper (encoder-decoder, layernorm, the gelu MLP)."""
    if cfg.mamba_version == 2 and cfg.family != "hybrid":
        raise NotImplementedError(
            f"Mamba2 blocks outside the hybrid family are not ported yet "
            f"({cfg.name}): the JAX package's cache_decls lays out the "
            f"{cfg.family!r} family's ssm state for Mamba1, (L, B, d_in, "
            f"N), so its decode of such an arch fails")
    if cfg.family == "hybrid" and (cfg.mamba_version != 2
                                   or cfg.attn_every <= 0):
        raise NotImplementedError(
            f"a hybrid of Mamba{cfg.mamba_version} blocks with attn_every "
            f"{cfg.attn_every} is not ported yet ({cfg.name}): the JAX "
            f"package's hybrid decode builds a Mamba2State for every layer "
            f"and a group for every attn_every > 0 of them")
    if paged and (cfg.mamba_version or cfg.is_encoder_decoder):
        why = (f"SSM and hybrid archs: a slot that joins would inherit the "
               f"previous occupant's state.  Serve {cfg.name} whole-batch "
               f"(ServingEngine, launch.serve --whole-batch)"
               if cfg.mamba_version else
               f"encoder-decoder archs: each request would need its own "
               f"cross cache.  {cfg.name} runs at the Model level "
               f"(Model.prefill with frames and tokens, decode_step, "
               f"decode_many)")
        raise ValueError(
            f"paged serving requires a decoder-only attention LM (per-slot "
            f"page tables), as in the JAX package, whose PagedEngine refuses "
            f"{why}")


def apply_norm(h, p, cfg: ArchConfig):
    """The arch's norm with its parameters ``p`` ({"scale", "bias"})."""
    if cfg.norm_kind == "layernorm":
        return layernorm(h, p["scale"], p["bias"], cfg.norm_eps)
    return rmsnorm(h, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# schema
# ---------------------------------------------------------------------------

def _norm_decl(d: int) -> Dict[str, ParamDecl]:
    return {"scale": ParamDecl((d,), (None,), "ones"),
            "bias": ParamDecl((d,), (None,), "zeros")}


def _attn_decls(cfg: ArchConfig) -> Dict[str, ParamDecl]:
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    decls = {
        "wq": ParamDecl((d, H * hd), ("fsdp", "model")),
        "wk": ParamDecl((d, KV * hd), ("fsdp", None)),
        "wv": ParamDecl((d, KV * hd), ("fsdp", None)),
        "wo": ParamDecl((H * hd, d), ("model", "fsdp")),
    }
    if cfg.qkv_bias:
        decls["bq"] = ParamDecl((H * hd,), ("model",), "zeros")
        decls["bk"] = ParamDecl((KV * hd,), (None,), "zeros")
        decls["bv"] = ParamDecl((KV * hd,), (None,), "zeros")
    return decls


def _ffn_decls(cfg: ArchConfig) -> Dict[str, ParamDecl]:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.ffn_kind == "swiglu":
        return {"w_gate": ParamDecl((d, ff), ("fsdp", "model")),
                "w_up": ParamDecl((d, ff), ("fsdp", "model")),
                "w_down": ParamDecl((ff, d), ("model", "fsdp"))}
    return {"w_up": ParamDecl((d, ff), ("fsdp", "model")),
            "b_up": ParamDecl((ff,), ("model",), "zeros"),
            "w_down": ParamDecl((ff, d), ("model", "fsdp")),
            "b_down": ParamDecl((d,), (None,), "zeros")}


def _moe_decls(cfg: ArchConfig) -> Dict[str, ParamDecl]:
    """The router and the (G, d, ffp) expert blocks (``models/moe.py``),
    the blocks sharded over the ep axes; gelu experts have no ``w3``."""
    d, ff, E, G = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.ep_shards
    ffp = E * ff // G
    decls = {"router": ParamDecl((d, E), ("fsdp", None)),
             "w1": ParamDecl((G, d, ffp), ("ep", "moe_fsdp", None)),
             "w2": ParamDecl((G, ffp, d), ("ep", None, "moe_fsdp"))}
    if cfg.ffn_kind == "swiglu":
        decls["w3"] = ParamDecl((G, d, ffp), ("ep", "moe_fsdp", None))
    return decls


def _mamba_decls(cfg: ArchConfig) -> Dict[str, ParamDecl]:
    """The Mamba1 mixer's parameters, or Mamba2's: the projections apart
    (z and x, B and C, dt), and a scalar A, D and dt bias per head."""
    d = cfg.d_model
    d_in = d * cfg.ssm_expand
    N, K = cfg.ssm_state, cfg.ssm_conv
    if cfg.mamba_version == 1:
        dt_rank = max(1, d // 16)
        return {
            "in_proj": ParamDecl((d, 2 * d_in), ("fsdp", "model")),
            "conv_w": ParamDecl((d_in, K), ("model", None)),
            "conv_b": ParamDecl((d_in,), ("model",), "zeros"),
            "x_proj": ParamDecl((d_in, dt_rank + 2 * N), ("model", None)),
            "dt_proj": ParamDecl((dt_rank, d_in), (None, "model")),
            "dt_bias": ParamDecl((d_in,), ("model",), "ssm_dt"),
            "A_log": ParamDecl((d_in, N), ("model", None), "ssm_a"),
            "D": ParamDecl((d_in,), ("model",), "ones"),
            "out_proj": ParamDecl((d_in, d), ("model", "fsdp")),
        }
    H = d_in // cfg.ssm_head_dim
    return {
        "w_zx": ParamDecl((d, 2 * d_in), ("fsdp", "model")),
        "w_bc": ParamDecl((d, 2 * N), ("fsdp", None)),
        "w_dt": ParamDecl((d, H), ("fsdp", "model")),
        "conv_w": ParamDecl((d_in, K), ("model", None)),
        "conv_b": ParamDecl((d_in,), ("model",), "zeros"),
        "dt_bias": ParamDecl((H,), ("model",), "ssm_dt"),
        "A_log": ParamDecl((H,), ("model",), "ssm_a_scalar"),
        "D": ParamDecl((H,), ("model",), "ones"),
        "norm": ParamDecl((d_in,), ("model",), "ones"),
        "out_proj": ParamDecl((d_in, d), ("model", "fsdp")),
    }


def schema(cfg: ArchConfig) -> Dict[str, Any]:
    """The parameter tree of a decoder-only LM (dense or MoE FFN), a
    Mamba1 LM, the hybrid or the encoder-decoder, leaf for leaf the JAX
    package's ``schema`` (stacked (L, ...) block parameters; the hybrid's
    ``shared_attn``, attention and FFN, is one weight set, not stacked).
    The token embedding is always there: the stub-frontend archs decode
    text tokens through it."""
    check_supported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    sch: Dict[str, Any] = {
        "embed": ParamDecl((V, d), ("model", "fsdp"), "embed")}
    if not cfg.tie_embeddings:
        sch["unembed"] = ParamDecl((V, d), ("model", "fsdp"), "embed")
    sch["ln_f"] = _norm_decl(d)
    if cfg.is_encoder_decoder:
        enc = {"ln1": _norm_decl(d), "ln2": _norm_decl(d),
               "attn": _attn_decls(cfg), "ffn": _ffn_decls(cfg)}
        dec = {"ln1": _norm_decl(d), "ln2": _norm_decl(d),
               "ln3": _norm_decl(d), "attn": _attn_decls(cfg),
               "cross": _attn_decls(cfg), "ffn": _ffn_decls(cfg)}
        sch["encoder"] = map_schema(
            lambda x: stacked(x, cfg.encoder_layers), enc)
        sch["decoder"] = map_schema(lambda x: stacked(x, cfg.n_layers), dec)
        sch["ln_enc"] = _norm_decl(d)
        return sch
    if cfg.mamba_version:
        block = {"ln1": _norm_decl(d), "mixer": _mamba_decls(cfg)}
    else:
        block = {"ln1": _norm_decl(d), "ln2": _norm_decl(d),
                 "attn": _attn_decls(cfg)}
        if cfg.n_experts:
            block["moe"] = _moe_decls(cfg)
        else:
            block["ffn"] = _ffn_decls(cfg)
    sch["blocks"] = map_schema(lambda x: stacked(x, cfg.n_layers), block)
    if cfg.family == "hybrid":
        sch["shared_attn"] = {"ln1": _norm_decl(d), "ln2": _norm_decl(d),
                              "attn": _attn_decls(cfg),
                              "ffn": _ffn_decls(cfg)}
    return sch


def cache_decls(cfg: ArchConfig, batch: int, max_seq: int
                ) -> Dict[str, Any]:
    """Whole-batch decode cache: the shared position ``pos`` (the row the
    next token is written to, and its rope position), the per-slot window
    base ``start`` (0 for whole-batch generation: slot b attends
    [start[b], pos]) and, for the dense family, (L, batch, max_seq, KV,
    hd) k/v caches in the param dtype; for the SSM family, the state of
    every layer instead: (L, batch, K-1, d_in) conv inputs in the param
    dtype and (L, batch, d_in, N) f32 scan states.  The hybrid has the
    conv inputs, (L, batch, H, hd, N) f32 SSD states and (G, batch,
    max_seq, KV, hd) ``attn_k``/``attn_v``, one per application of the
    shared block.  The encoder-decoder adds (L, batch, max_seq, KV, hd)
    ``cross_k``/``cross_v``, which its decode attends row for row (see
    ``whisper_decode``)."""
    check_supported(cfg)
    hd, KV, L = cfg.head_dim, cfg.n_kv_heads, cfg.n_layers
    # KV caches are sequence-sharded over the "cache_seq" axes, as in the
    # JAX package (flash-decoding style)
    kv_axes = (None, "batch", "cache_seq", None, None)
    decls = {"pos": ParamDecl((), (), "zeros", torch.int32),
             "start": ParamDecl((batch,), ("batch",), "zeros", torch.int32)}
    if cfg.mamba_version:
        d_in = cfg.d_model * cfg.ssm_expand
        decls["conv"] = ParamDecl((L, batch, cfg.ssm_conv - 1, d_in),
                                  (None, "batch", None, "model"), "zeros")
        if cfg.family != "hybrid":
            decls["ssm"] = ParamDecl((L, batch, d_in, cfg.ssm_state),
                                     (None, "batch", "model", None),
                                     "zeros", torch.float32)
            return decls
        sh = cfg.ssm_head_dim
        decls["ssm"] = ParamDecl((L, batch, d_in // sh, sh, cfg.ssm_state),
                                 (None, "batch", "model", None, None),
                                 "zeros", torch.float32)
        G = cfg.n_layers // cfg.attn_every
        for name in ("attn_k", "attn_v"):
            decls[name] = ParamDecl((G, batch, max_seq, KV, hd), kv_axes,
                                    "zeros")
        return decls
    names = ("k", "v", "cross_k", "cross_v") if cfg.is_encoder_decoder \
        else ("k", "v")
    for name in names:
        decls[name] = ParamDecl((L, batch, max_seq, KV, hd), kv_axes,
                                "zeros")
    return decls


def paged_cache_decls(cfg: ArchConfig, batch: int, max_blocks: int,
                      page_size: int, num_pages: int) -> Dict[str, Any]:
    """Paged decode cache: (L, num_pages, page, KV, hd) k/v pools (page 0
    is the null page), a (batch, max_blocks) int32 block table and (batch,)
    int32 lengths.  int8 pools add (L, num_pages, page, KV) f32 scales."""
    check_supported(cfg, paged=True)
    hd, KV, L = cfg.head_dim, cfg.n_kv_heads, cfg.n_layers
    pool_dt = torch.int8 if cfg.kv_quantized else cfg.param_dtype
    # the pool is sharded over its page axis ("cache_seq"), as in the JAX
    # package
    pool_axes = (None, "cache_seq", None, None, None)
    decls = {
        "k": ParamDecl((L, num_pages, page_size, KV, hd), pool_axes, "zeros",
                       pool_dt),
        "v": ParamDecl((L, num_pages, page_size, KV, hd), pool_axes, "zeros",
                       pool_dt),
        "table": ParamDecl((batch, max_blocks), ("batch", None), "zeros",
                           torch.int32),
        "length": ParamDecl((batch,), ("batch",), "zeros", torch.int32),
    }
    if cfg.kv_quantized:
        for name in ("k_scale", "v_scale"):
            decls[name] = ParamDecl((L, num_pages, page_size, KV),
                                    (None, "cache_seq", None, None), "zeros",
                                    torch.float32)
    return decls


def layer_params(blocks, li: int):
    """Layer ``li``'s slice (views) of the stacked block parameters."""
    if isinstance(blocks, torch.Tensor):
        return blocks[li]
    return {k: layer_params(v, li) for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# attention block application
# ---------------------------------------------------------------------------

def _rope(cfg: ArchConfig, positions) -> Optional[Tuple]:
    """(cos, sin) of ``positions``: (B, S), or (3, B, S) streams for an
    M-RoPE arch; None for an arch without rotary positions."""
    if not cfg.rope_theta:
        return None
    positions = _whole(positions)      # a placed batch's (3, B, S) streams
    if cfg.mrope_sections:
        cos, sin = mrope_angles(positions, cfg.head_dim, cfg.rope_theta,
                                cfg.mrope_sections)
    else:
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    # under a mesh, placed over the batch axes as q and k are
    return (place(cos, "batch", None, None), place(sin, "batch", None, None))


def _whole(x):
    """A DTensor (the decode cache's replicated position, a placed
    batch's M-RoPE streams) as the whole plain tensor, for the rope
    tables that ``_rope`` places over the batch axes; a plain tensor as
    it is."""
    return x.full_tensor() if is_dtensor(x) else x


def _streams(cfg: ArchConfig, positions):
    """(B, S) positions as an M-RoPE arch's three equal (3, B, S) streams,
    as the JAX decode and paged paths broadcast them; unchanged for any
    other arch."""
    if cfg.mrope_sections:
        return positions[None].expand(3, *positions.shape)
    return positions


def split_heads(x, n: int, hd: int):
    """x (B, S, n * hd) as (B, S, n, hd).  Under a mesh DTensor unflattens
    a sharded feature dim only when its split falls on whole heads; where
    the mesh dims that split it do not divide n (qwen2-0.5b's 14 heads
    over a model axis of 16) the dim is replicated first, as GSPMD
    reshards it there in the JAX package."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last = x.dim() - 1
        on = [isinstance(p, Shard) and p.dim == last for p in x.placements]
        split = 1
        for i, o in enumerate(on):
            split *= x.device_mesh.size(i) if o else 1
        if n % split:
            x = x.redistribute(x.device_mesh, [
                Replicate() if o else p for p, o in zip(x.placements, on)])
    return x.reshape(*x.shape[:-1], n, hd)


class _MergeHeads(torch.autograd.Function):
    """(B, S, n, hd) -> (B, S, n * hd), whose backward splits the gradient
    with ``split_heads``: the gradient that comes back from the output
    projection may be split over the model axis where n is not."""

    @staticmethod
    def forward(ctx, x):
        ctx.n, ctx.hd = x.shape[-2], x.shape[-1]
        return x.reshape(*x.shape[:-2], ctx.n * ctx.hd)

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.n, ctx.hd)


def merge_heads(x):
    """(B, S, n, hd) -> (B, S, n * hd); under a mesh through
    ``_MergeHeads``, a plain reshape otherwise."""
    if is_dtensor(x):
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], -1)


def _qkv(hn, p, cfg: ArchConfig, rope, decode: bool = False):
    """q (B, S, H, hd), k and v (B, S, KV, hd), rope applied; q sharded
    over its heads on the model axis (replicated there in a decode or
    paged step, which attends a sequence-sharded cache), k and v
    replicated over it."""
    hd = cfg.head_dim
    q = split_heads(dense(hn, p["wq"], p.get("bq")), cfg.n_heads, hd)
    k = split_heads(dense(hn, p["wk"], p.get("bk")), cfg.n_kv_heads, hd)
    v = split_heads(dense(hn, p["wv"], p.get("bv")), cfg.n_kv_heads, hd)
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if decode:
        q = constrain(q, "batch", None, None, None)
    else:
        q = constrain(q, "batch", None, "model", None)
    k = constrain(k, "batch", None, None, None)
    v = constrain(v, "batch", None, None, None)
    return q, k, v


def _last_writer(phys, off, page: int):
    """For each of n scattered rows, the index of the last row with the
    same (page, row) address.  Rows that carry no request all land on the
    null page 0 and collide there; a CUDA ``index_put_`` lands one of the
    colliding rows unspecified, so each row writes the last colliding
    row's values instead: the null page then holds what a sequential
    scatter leaves (the CPU's, and the JAX package's on the CPU), the same
    in every run.  It matters for MoE: rows without a request read the
    null page, route, and take capacity from real rows."""
    key = phys * page + off
    n = key.shape[0]
    same = key[:, None] == key[None, :]
    order = torch.arange(1, n + 1, device=key.device)
    return torch.argmax(same * order[None, :], dim=1)


def _write_rows(cache, layer: int, phys, off, k, v,
                settle: bool = False) -> None:
    """Scatter K/V rows (n, KV, hd) to (layer, phys[i], off[i]) in place;
    int8 pools store the quantized rows and their scales at the same
    address.  With ``settle`` (MoE archs, where the null page reaches
    real rows) colliding rows all write the last one's values
    (``_last_writer``); a dense arch's real rows never read the null
    page."""
    if settle:
        last = _last_writer(phys, off, cache["k"].shape[2])
        k, v = k[last], v[last]
    if "k_scale" in cache:
        kq, ks = quantize_rows(k)
        vq, vs = quantize_rows(v)
        cache["k"][layer, phys, off] = kq
        cache["v"][layer, phys, off] = vq
        cache["k_scale"][layer, phys, off] = ks
        cache["v_scale"][layer, phys, off] = vs
        cache["k_scale"] = constrain(cache["k_scale"], None, "cache_seq",
                                     None, None)
        cache["v_scale"] = constrain(cache["v_scale"], None, "cache_seq",
                                     None, None)
    else:
        cache["k"][layer, phys, off] = k.to(cache["k"].dtype)
        cache["v"][layer, phys, off] = v.to(cache["v"].dtype)
    # keep the pool page-sharded through the in-place update
    cache["k"] = constrain(cache["k"], None, "cache_seq", None, None, None)
    cache["v"] = constrain(cache["v"], None, "cache_seq", None, None, None)


def attn_apply(h, p, cfg: ArchConfig, rope, causal: bool = True,
               plain: bool = False):
    """Train/prefill attention over the whole sequence: h (B, S, d); p is
    the block's parameters (ln1 + attn).  Returns (out, (k, v)) — k and v
    (B, S, KV, hd) after rope, for the prefill cache."""
    hn = apply_norm(h, p["ln1"], cfg)
    a = p["attn"]
    q, k, v = _qkv(hn, a, cfg, rope)
    out = attention(q, k, v, causal=causal, chunk_q=cfg.attn_chunk_q,
                    chunk_kv=cfg.attn_chunk_kv, plain=plain)
    out = dense(merge_heads(out), a["wo"])
    return constrain(out, "batch", None, None), (k, v)


def attn_decode(h, p, cfg: ArchConfig, rope, k_cache, v_cache, pos,
                start=None, plain: bool = False):
    """Whole-batch decode: h (B, 1, d); k_cache, v_cache (B, T, KV, hd),
    one layer's contiguous view of the stacked cache; pos a 0-d int
    tensor.  Writes this step's K/V IN PLACE at row ``pos`` (clamped into
    the cache, as ``dynamic_update_slice`` clamps) and attends over
    [start[b], pos] (``start`` None -> 0).  Returns (out, k_cache,
    v_cache)."""
    hn = apply_norm(h, p["ln1"], cfg)
    a = p["attn"]
    q, k, v = _qkv(hn, a, cfg, rope, decode=True)
    if is_dtensor(k_cache):
        out = mesh_decode_attention(q, k, v, k_cache, v_cache, pos, start)
        return dense(out.reshape(h.shape[0], 1, -1), a["wo"]), k_cache, \
            v_cache
    row = torch.clamp(pos, 0, k_cache.shape[1] - 1).reshape(1).long()
    k_cache.index_copy_(1, row, k.to(k_cache.dtype))
    v_cache.index_copy_(1, row, v.to(v_cache.dtype))
    if plain:
        out = direct_attention(q, k_cache, v_cache, causal=True,
                               q_offset=pos, kv_len=pos + 1, kv_start=start)
    else:
        out = decode_attention(q, k_cache, v_cache, kv_len=pos + 1,
                               kv_start=start)
    B = h.shape[0]
    return dense(out.reshape(B, 1, -1), a["wo"]), k_cache, v_cache


def attn_decode_paged(h, p, cfg: ArchConfig, rope, cache, layer: int,
                      lengths, active, plain: bool = False):
    """Decode over the paged pool: h (B, 1, d); cache holds the stacked
    pools, "table" (B, max_blocks) and the lengths (B,) int32; active (B,)
    bool.  Appends this step's K/V at each slot's own position (page
    ``table[b, lengths[b] // page]``, row ``lengths[b] % page``; inactive
    slots write the null page 0) and attends positions [0, lengths[b]]."""
    hn = apply_norm(h, p["ln1"], cfg)
    a = p["attn"]
    q, k, v = _qkv(hn, a, cfg, rope, decode=True)
    B = h.shape[0]
    table = cache["table"]
    page, nb = cache["k"].shape[2], table.shape[1]
    blk = torch.clamp(lengths // page, max=nb - 1).long()
    rows = torch.arange(B, device=h.device)
    phys = torch.where(active, table[rows, blk], 0).long()
    off = (lengths % page).long()
    _write_rows(cache, layer, phys, off, k[:, 0], v[:, 0],
                settle=bool(cfg.n_experts))
    kv_len = lengths + 1
    attend = paged_decode_attention_ref if plain else paged_decode_attention
    kw = {} if plain else {"pages_per_step": cfg.pages_per_step}
    out = attend(q, cache["k"], cache["v"], table, kv_len, layer,
                 k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                 **kw)
    return dense(out.reshape(B, 1, -1), a["wo"])


def attn_prefill_paged(h, p, cfg: ArchConfig, rope, cache, layer: int,
                       base, new_len, plain: bool = False):
    """Ragged chunked prefill over the paged pool: h (B, T, d); base (B,)
    tokens resident before the chunk; new_len (B,) = base + granted
    tokens.  Scatters all the chunk's granted K/V rows (rows past the
    grant land on the null page), then attends causally: row t sees
    positions <= base[b] + t and < new_len[b]."""
    hn = apply_norm(h, p["ln1"], cfg)
    a = p["attn"]
    q, k, v = _qkv(hn, a, cfg, rope, decode=True)
    B, T, _ = h.shape
    table = cache["table"]
    page, nb = cache["k"].shape[2], table.shape[1]
    tok_pos = base[:, None] + torch.arange(T, dtype=torch.int32,
                                           device=h.device)[None, :]
    blk = torch.clamp(tok_pos // page, max=nb - 1).long()
    live = tok_pos < new_len[:, None]
    phys = torch.where(live, torch.gather(table, 1, blk), 0).reshape(B * T)
    off = (tok_pos % page).reshape(B * T)
    KV, hd = k.shape[2], k.shape[3]
    _write_rows(cache, layer, phys.long(), off.long(),
                k.reshape(B * T, KV, hd), v.reshape(B * T, KV, hd),
                settle=bool(cfg.n_experts))
    attend = paged_prefill_attention_ref if plain else paged_prefill_attention
    kw = {} if plain else {"pages_per_step": cfg.pages_per_step}
    out = attend(q, cache["k"], cache["v"], table, base, new_len, layer,
                 k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                 **kw)
    return dense(out.reshape(B, T, -1), a["wo"])


def ffn_apply(h, p, cfg: ArchConfig):
    hn = apply_norm(h, p["ln2"], cfg)
    f = p["ffn"]
    if cfg.ffn_kind == "swiglu":
        out = swiglu(hn, f["w_gate"], f["w_up"], f["w_down"])
    else:
        out = gelu_mlp(hn, f["w_up"], f["b_up"], f["w_down"], f["b_down"])
    return constrain(out, "batch", None, None)


def moe_apply(h, p, cfg: ArchConfig):
    """The routed FFN of an MoE block: (out, aux)."""
    hn = apply_norm(h, p["ln2"], cfg)
    m = p["moe"]
    return moe_ffn(hn, m["router"], m["w1"], m["w2"], m.get("w3"), cfg)


def decode_ffn(h, p, cfg: ArchConfig):
    """The post-attention residual of a decode or prefill step: the
    routed MoE FFN (aux dropped: no load-balance loss at inference) or
    the dense FFN.  Shared by the dense decode, paged decode and paged
    prefill passes, as in the JAX package."""
    if cfg.n_experts:
        return h + moe_apply(h, p, cfg)[0]
    return h + ffn_apply(h, p, cfg)


def dense_block(h, p, cfg: ArchConfig, rope, plain: bool = False):
    """One attention block over the whole sequence.  Returns (h, aux, (k,
    v)); aux is the MoE load-balance loss, 0 for the dense FFN."""
    out, kv = attn_apply(h, p, cfg, rope, causal=cfg.causal, plain=plain)
    h = h + out
    if cfg.n_experts:
        out, aux = moe_apply(h, p, cfg)
        h = h + out
    else:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        h = h + ffn_apply(h, p, cfg)
    return constrain(h, "batch", None, None), aux, kv


def mamba_block_apply(h, p, cfg: ArchConfig, state=None,
                      plain: bool = False):
    """Residual Mamba1 or Mamba2 block: h (B, S, d) and no state
    (prefill), or (B, 1, d) and its layer's state (decode).  Returns (h,
    state)."""
    hn = apply_norm(h, p["ln1"], cfg)
    if cfg.mamba_version == 1:
        out, new_state = ssm_mod.mamba1_block(hn, p["mixer"], cfg, state,
                                              plain)
    else:
        out, new_state = ssm_mod.mamba2_block(hn, p["mixer"], cfg, state)
    return constrain(h + out, "batch", None, None), new_state


def shared_attn_block(h, p, cfg: ArchConfig, rope, plain: bool = False):
    """The hybrid's shared block over the whole sequence: causal
    attention, then the FFN.  Returns (h, (k, v))."""
    out, kv = attn_apply(h, p, cfg, rope, causal=True, plain=plain)
    h = h + out
    return constrain(h + ffn_apply(h, p, cfg), "batch", None, None), kv


def shared_attn_decode(h, p, cfg: ArchConfig, rope, k_c, v_c, pos,
                       start=None, plain: bool = False):
    """The shared block's decode step over its application's cache (K/V
    written in place at row ``pos``, as ``attn_decode`` does)."""
    out, _, _ = attn_decode(h, p, cfg, rope, k_c, v_c, pos, start, plain)
    h = h + out
    return h + ffn_apply(h, p, cfg)


def _embed_in(params, cfg: ArchConfig, inputs):
    """Token ids (B, S) through the embedding table, or for a stub-frontend
    arch (``embed_inputs`` False) the precomputed (B, S, d) embeddings
    themselves; either in the param dtype."""
    if cfg.embed_inputs:
        h = embed(inputs, params["embed"]).to(cfg.param_dtype)
    else:
        h = inputs.to(cfg.param_dtype)
    return constrain(h, "batch", None, None)


def _logits_exact(params, cfg: ArchConfig, h):
    """f32 unembed for the positions whose logits decide a token."""
    h = apply_norm(h, params["ln_f"], cfg)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = unembed(h.to(torch.float32), table.to(torch.float32))
    return constrain(logits, "batch", None, "model")


def _logits(params, cfg: ArchConfig, h):
    """Logits in the activation dtype (training's full-sequence logits)."""
    h = apply_norm(h, params["ln_f"], cfg)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return constrain(unembed(h, table), "batch", None, "model")


# ---------------------------------------------------------------------------
# whole-batch forward passes
# ---------------------------------------------------------------------------

def lm_forward(params, cfg: ArchConfig, inputs, positions,
               mode: str = "train", plain: bool = False):
    """inputs: tokens (B, S) int, or (B, S, d) embeddings for a
    stub-frontend arch; positions (B, S), or (3, B, S) streams for an
    M-RoPE arch.  mode: train | prefill | hidden — hidden returns the post-ln_f hidden states; prefill returns
    only the LAST position's logits, (B, 1, V) at f32, and the cache parts:
    {"k", "v"}, (L, B, S, KV, hd) stacks of every layer's K/V, for the
    dense family; {"conv" (L, B, K-1, d_in), "ssm" (L, B, d_in, N) f32},
    every layer's state after the prompt, for the SSM family (the JAX
    package returns None there; see the module docstring); for the
    hybrid {"attn_k", "attn_v"} (G, B, S, KV, hd), as the JAX package
    returns them, and every layer's "conv" and "ssm" (L, B, H, hd, N) f32
    state, which it does not.  Returns (logits_or_hidden, aux,
    cache_parts or None)."""
    assert mode in ("train", "prefill", "hidden")
    check_supported(cfg)
    h = _embed_in(params, cfg, inputs)
    if cfg.family == "hybrid":
        return _hybrid_forward(params, cfg, h, _rope(cfg, positions), mode,
                               plain)
    if cfg.mamba_version:
        return _ssm_forward(params, cfg, h, mode, plain)
    rope = _rope(cfg, positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    ks, vs = [], []

    def layers(h, aux, l0: int, l1: int):
        for li in range(l0, l1):
            p = layer_params(params["blocks"], li)
            h, aux_i, (k, v) = dense_block(h, p, cfg, rope, plain)
            aux = aux + aux_i
            if mode == "prefill":
                ks.append(k)
                vs.append(v)
        return h, aux

    g = remat_span(cfg, mode, params["blocks"])
    if g:
        for l0 in range(0, cfg.n_layers, g):
            h, aux = checkpoint(layers, h, aux, l0, l0 + g,
                                use_reentrant=False)
    else:
        h, aux = layers(h, aux, 0, cfg.n_layers)
    if mode == "hidden":
        return apply_norm(h, params["ln_f"], cfg), aux, None
    if mode == "prefill":
        return (_logits_exact(params, cfg, h[:, -1:]), aux,
                {"k": torch.stack(ks), "v": torch.stack(vs)})
    return _logits(params, cfg, h), aux, None


def _needs_grad(tree) -> bool:
    if isinstance(tree, torch.Tensor):
        return tree.requires_grad
    return any(_needs_grad(v) for v in tree.values())


def remat_on(cfg: ArchConfig, mode: str, *trees) -> bool:
    """Whether a pass checkpoints its layers: a training pass (grad mode
    on, parameters in ``trees`` that need a gradient, not a prefill) with
    ``cfg.remat`` "block" or "full".  Serving passes run without it."""
    return (torch.is_grad_enabled() and mode != "prefill"
            and cfg.remat in ("block", "full")
            and any(_needs_grad(t) for t in trees))


def remat_span(cfg: ArchConfig, mode: str, blocks) -> int:
    """Layers per checkpoint of the dense family's ``lm_forward``: 0 (no
    remat) where ``remat_on`` says so; else ``remat_group`` where it
    divides the layers (the JAX package's layer-grouped remat, the dense
    family's alone), else 1 (per block)."""
    if not remat_on(cfg, mode, blocks):
        return 0
    g = cfg.remat_group
    return g if g > 1 and cfg.n_layers % g == 0 else 1


def _run(remat: bool, fn, *args):
    """``fn(*args)``, checkpointed (non-reentrant) when ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _ssm_forward(params, cfg: ArchConfig, h, mode: str, plain: bool):
    """``lm_forward`` of the SSM family (h the embedded inputs); a
    training pass checkpoints each layer."""
    convs, ssms = [], []
    remat = remat_on(cfg, mode, params["blocks"])

    def layer(h, li: int):
        h, state = mamba_block_apply(h, layer_params(params["blocks"], li),
                                     cfg, plain=plain)
        if mode == "prefill":
            convs.append(state.conv)
            ssms.append(state.ssm)
        return h

    for li in range(cfg.n_layers):
        h = _run(remat, layer, h, li)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if mode == "hidden":
        return apply_norm(h, params["ln_f"], cfg), aux, None
    if mode == "prefill":
        return (_logits_exact(params, cfg, h[:, -1:]), aux,
                {"conv": torch.stack(convs), "ssm": torch.stack(ssms)})
    return _logits(params, cfg, h), aux, None


def lm_decode(params, cfg: ArchConfig, tokens, cache, plain: bool = False):
    """tokens (B, 1) int; cache from ``cache_decls``: {"pos", "start",
    "k", "v"} (dense), {"pos", "start", "conv", "ssm"} (SSM) or those and
    "attn_k", "attn_v" (hybrid).  ``pos`` is both the cache ROW the new
    token is written to and its rope position (whole-batch generation
    never rebases rows); the SSM family only advances it.  Returns
    (logits (B, V) f32, cache) — the k/v caches or the layer states
    updated in place, "pos" advanced by one."""
    check_supported(cfg)
    B = tokens.shape[0]
    pos = cache["pos"]
    if cfg.mamba_version == 1:
        h = _embed_in(params, cfg, tokens)
        for li in range(cfg.n_layers):
            p = layer_params(params["blocks"], li)
            state = ssm_mod.Mamba1State(conv=cache["conv"][li],
                                        ssm=cache["ssm"][li])
            h, new = mamba_block_apply(h, p, cfg, state, plain)
            cache["conv"][li].copy_(new.conv)
            cache["ssm"][li].copy_(new.ssm)
        cache["pos"] = pos + 1
        return _logits_exact(params, cfg, h)[:, 0], cache
    positions = _whole(pos).to(torch.int32).reshape(1, 1).expand(B, 1)
    rope = _rope(cfg, _streams(cfg, positions))
    h = _embed_in(params, cfg, tokens)
    if cfg.family == "hybrid":
        return _hybrid_decode(params, cfg, h, rope, cache, plain)
    start = cache.get("start")
    for li in range(cfg.n_layers):
        p = layer_params(params["blocks"], li)
        out, _, _ = attn_decode(h, p, cfg, rope, cache["k"][li],
                                cache["v"][li], pos, start, plain)
        for name in ("k", "v"):
            cache[name] = constrain(cache[name], None, "batch", "cache_seq",
                                    None, None)
        h = decode_ffn(h + out, p, cfg)
    cache["pos"] = pos + 1
    return _logits_exact(params, cfg, h)[:, 0], cache


# ---------------------------------------------------------------------------
# the zamba2 hybrid: attn_every Mamba2 layers, then the shared block
# ---------------------------------------------------------------------------

def _hybrid_trunk(cfg: ArchConfig, h, mamba, attn, remat: bool = False):
    """The hybrid trunk in order, as the JAX ``_hybrid_split`` cuts the
    stack: G = L // k groups of k = ``attn_every`` Mamba2 layers, each
    followed by the g-th application of the shared block (``attn(h, g)``,
    g its attention cache's index) and checkpointed with it when
    ``remat``; then the R = L - G k tail layers, never checkpointed.
    ``mamba(h, li)`` takes each layer's absolute index (the conv and ssm
    states' index)."""
    k = cfg.attn_every
    G = cfg.n_layers // k

    def group(h, g: int):
        for li in range(g * k, g * k + k):
            h = mamba(h, li)
        return attn(h, g)

    for g in range(G):
        h = _run(remat, group, h, g)
    for li in range(G * k, cfg.n_layers):
        h = mamba(h, li)
    return h


def _hybrid_forward(params, cfg: ArchConfig, h, rope, mode: str,
                    plain: bool):
    """``lm_forward`` of the hybrid (h the embedded inputs); a training
    pass checkpoints each group of ``attn_every`` Mamba2 layers with its
    application of the shared block, and not the tail layers, as the JAX
    function does."""
    parts = {"attn_k": [], "attn_v": [], "conv": [], "ssm": []}

    def mamba(h, li: int):
        h, state = mamba_block_apply(h, layer_params(params["blocks"], li),
                                     cfg)
        if mode == "prefill":
            parts["conv"].append(state.conv)
            parts["ssm"].append(state.ssm)
        return h

    def attn(h, g: int):
        h, (attn_k, attn_v) = shared_attn_block(h, params["shared_attn"],
                                                cfg, rope, plain)
        if mode == "prefill":
            parts["attn_k"].append(attn_k)
            parts["attn_v"].append(attn_v)
        return h

    h = _hybrid_trunk(cfg, h, mamba, attn, remat_on(
        cfg, mode, params["blocks"], params["shared_attn"]))
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if mode == "hidden":
        return apply_norm(h, params["ln_f"], cfg), aux, None
    if mode == "prefill":
        return (_logits_exact(params, cfg, h[:, -1:]), aux,
                {name: torch.stack(ts) for name, ts in parts.items()})
    return _logits(params, cfg, h), aux, None


def _hybrid_decode(params, cfg: ArchConfig, h, rope, cache, plain: bool):
    """``lm_decode`` of the hybrid: every layer's state and every
    application's cache updated in place."""
    pos, start = cache["pos"], cache.get("start")

    def mamba(h, li: int):
        state = ssm_mod.Mamba2State(conv=cache["conv"][li],
                                    ssm=cache["ssm"][li])
        h, new = mamba_block_apply(h, layer_params(params["blocks"], li),
                                   cfg, state)
        cache["conv"][li].copy_(new.conv)
        cache["ssm"][li].copy_(new.ssm)
        return h

    def attn(h, g: int):
        return shared_attn_decode(h, params["shared_attn"], cfg, rope,
                                  cache["attn_k"][g], cache["attn_v"][g],
                                  pos, start, plain)

    h = _hybrid_trunk(cfg, h, mamba, attn)
    cache["pos"] = pos + 1
    return _logits_exact(params, cfg, h)[:, 0], cache


# ---------------------------------------------------------------------------
# paged forward passes
# ---------------------------------------------------------------------------

def lm_decode_paged(params, cfg: ArchConfig, tokens, cache, active,
                    plain: bool = False):
    """tokens (B, 1) int; cache {"k"/"v" pools, "table", "length"};
    active (B,) bool.  Every slot advances at its own length (rope
    positions are request-relative); inactive slots write only the null
    page and do not advance.  Returns (logits (B, V) f32, cache) — the
    pools updated in place, "length" advanced by ``active``."""
    check_supported(cfg, paged=True)
    lengths = cache["length"]
    rope = _rope(cfg, _streams(cfg, lengths[:, None]))
    h = _embed_in(params, cfg, tokens)
    for li in range(cfg.n_layers):
        p = layer_params(params["blocks"], li)
        h = h + attn_decode_paged(h, p, cfg, rope, cache, li, lengths,
                                  active, plain)
        h = decode_ffn(h, p, cfg)
    cache["length"] = lengths + active.to(torch.int32)
    return _logits_exact(params, cfg, h)[:, 0], cache


def lm_prefill_paged(params, cfg: ArchConfig, tokens, cache, grants,
                     plain: bool = False, unembed_all: bool = False):
    """Ragged multi-token paged prefill: tokens (B, T) int — each slot's
    next prompt chunk (row i's first ``grants[i]`` entries are real);
    grants (B,) int32 (0 = slot idle).  Returns (logits (B, V) f32 at each
    slot's last granted position, cache) — the pools updated in place,
    "length" advanced by ``grants``.  With ``unembed_all`` every chunk
    position is unembedded instead: logits (B, T, V) f32, what a
    speculative verify decides its tokens from."""
    check_supported(cfg, paged=True)
    lengths = cache["length"]
    B, T = tokens.shape
    grants = grants.to(torch.int32)
    new_len = lengths + grants
    positions = lengths[:, None] + torch.arange(
        T, dtype=torch.int32, device=tokens.device)[None, :]
    rope = _rope(cfg, _streams(cfg, positions))
    h = _embed_in(params, cfg, tokens)
    for li in range(cfg.n_layers):
        p = layer_params(params["blocks"], li)
        h = h + attn_prefill_paged(h, p, cfg, rope, cache, li, lengths,
                                   new_len, plain)
        h = decode_ffn(h, p, cfg)
    cache["length"] = new_len
    if unembed_all:
        return _logits_exact(params, cfg, h), cache          # (B, T, V)
    # last granted position per slot (grants == 0 -> row 0; caller ignores)
    last = torch.clamp(grants - 1, min=0).long()
    h_last = h[torch.arange(B, device=h.device), last][:, None]
    return _logits_exact(params, cfg, h_last)[:, 0], cache


def lm_verify_paged(params, cfg: ArchConfig, tokens, cache, grants,
                    plain: bool = False):
    """Speculative verify on the prefill lane: tokens (B, T) — row i holds
    [feed, p_1 .. p_{g-1}, pad], the slot's next input token and the
    draft's proposals (``grants[i]`` = g rows real, 0 = slot idle).  The
    ragged chunk of ``lm_prefill_paged`` with every position unembedded
    at f32; ``greedy[b, t]`` is position t's argmax, and proposal
    ``tokens[b, t + 1]`` is accepted iff every earlier one was and it
    equals ``greedy[b, t]``.  All on the device.  Returns (greedy (B, T)
    int32, accept (B,) int32 in [0, g - 1], cache with "length" advanced
    by the whole grant: the caller truncates the rejected rows)."""
    T = tokens.shape[1]
    grants = grants.to(torch.int32)
    logits, cache = lm_prefill_paged(params, cfg, tokens, cache, grants,
                                     plain, unembed_all=True)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    # leading run of matching proposals, masked to the g - 1 proposals
    prop_ok = greedy[:, :T - 1] == tokens[:, 1:].to(torch.int32)
    in_grant = torch.arange(T - 1, dtype=torch.int32,
                            device=tokens.device)[None, :] \
        < (grants - 1)[:, None]
    run = torch.cumprod((prop_ok & in_grant).to(torch.int32), dim=1)
    accept = torch.minimum(run.sum(dim=1, dtype=torch.int32),
                           torch.clamp(grants - 1, min=0))
    return greedy, accept, cache


# ---------------------------------------------------------------------------
# whisper: the encoder-decoder
# ---------------------------------------------------------------------------

def whisper_encode(params, cfg: ArchConfig, frames, plain: bool = False,
                   remat: bool = False):
    """frames (B, S, d): the frontend's precomputed frame embeddings.
    Adds sinusoidal positions and runs the encoder stack (non-causal
    attention, the gelu MLP); returns the ``ln_enc``-normed (B, S, d).
    With ``remat`` (a training pass of ``whisper_forward``, ``remat_on``)
    each layer is checkpointed."""
    S = frames.shape[1]
    pos = torch.arange(S, device=frames.device)[None]
    # under a mesh, a replicated DTensor, as frames are DTensors there
    table = place(sinusoidal_positions(pos, cfg.d_model).to(cfg.param_dtype),
                  None, None, None)
    h = constrain(frames.to(cfg.param_dtype) + table, "batch", None, None)

    def layer(h, li: int):
        p = layer_params(params["encoder"], li)
        h = h + attn_apply(h, p, cfg, None, causal=False, plain=plain)[0]
        return constrain(h + ffn_apply(h, p, cfg), "batch", None, None)

    for li in range(cfg.encoder_layers):
        h = _run(remat, layer, h, li)
    return apply_norm(h, params["ln_enc"], cfg)


def _cross_kv(enc_out, p, cfg: ArchConfig):
    """One decoder layer's cross K/V (B, S, KV, hd) from the encoder
    output (no biases, as in the JAX function)."""
    hd = cfg.head_dim
    k = split_heads(dense(enc_out, p["wk"]), cfg.n_kv_heads, hd)
    v = split_heads(dense(enc_out, p["wv"]), cfg.n_kv_heads, hd)
    return k, v


def _cross_attend(h, p, cfg: ArchConfig, k, v, plain: bool = False):
    """Non-causal attention of the decoder rows over every row of k and v:
    no ``kv_len``, so a zero-padded cross cache takes part in the softmax
    (the JAX function's behaviour, kept)."""
    hn = apply_norm(h, p["ln3"], cfg)
    q = split_heads(dense(hn, p["cross"]["wq"]), cfg.n_heads, cfg.head_dim)
    out = attention(q, k, v, causal=False, chunk_q=cfg.attn_chunk_q,
                    chunk_kv=cfg.attn_chunk_kv, plain=plain)
    # reduced over the model axis as the self-attention's output is: left
    # Partial, DTensor reduce-scatters it over the sequence at the next
    # norm, and a later matmul cannot take that strided split
    return constrain(dense(merge_heads(out), p["cross"]["wo"]), "batch",
                     None, None)


def whisper_forward(params, cfg: ArchConfig, frames, tokens,
                    mode: str = "train", plain: bool = False):
    """frames (B, S_enc, d), tokens (B, S) int.  The encoder, then the
    decoder: sinusoidal positions, causal self-attention, cross-attention
    over the encoder output, the gelu MLP.  Returns (logits_or_hidden,
    aux (0), cache_parts or None); prefill returns the last position's
    logits (B, 1, V) at f32 and {"k", "v" (L, B, S, KV, hd), "cross_k",
    "cross_v" (L, B, S_enc, KV, hd)}.  A training pass checkpoints each
    encoder and each decoder layer, the decoder's closing over the
    encoder output."""
    assert mode in ("train", "prefill", "hidden")
    check_supported(cfg)
    enc = whisper_encode(params, cfg, frames, plain,
                         remat_on(cfg, mode, params["encoder"]))
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)[None]
    h = embed(tokens, params["embed"]).to(cfg.param_dtype)
    h = h + place(sinusoidal_positions(pos, cfg.d_model).to(cfg.param_dtype),
                  None, None, None)
    h = constrain(h, "batch", None, None)
    parts = {"k": [], "v": [], "cross_k": [], "cross_v": []}
    remat = remat_on(cfg, mode, params["decoder"])

    def layer(h, li: int):
        p = layer_params(params["decoder"], li)
        out, (k, v) = attn_apply(h, p, cfg, None, causal=True, plain=plain)
        h = h + out
        ck, cv = _cross_kv(enc, p["cross"], cfg)
        h = h + _cross_attend(h, p, cfg, ck, cv, plain)
        h = constrain(h + ffn_apply(h, p, cfg), "batch", None, None)
        if mode == "prefill":
            for name, t in zip(parts, (k, v, ck, cv)):
                parts[name].append(t)
        return h

    for li in range(cfg.n_layers):
        h = _run(remat, layer, h, li)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if mode == "hidden":
        return apply_norm(h, params["ln_f"], cfg), aux, None
    if mode == "prefill":
        return (_logits_exact(params, cfg, h[:, -1:]), aux,
                {name: torch.stack(ts) for name, ts in parts.items()})
    return _logits(params, cfg, h), aux, None


def whisper_decode(params, cfg: ArchConfig, tokens, cache,
                   plain: bool = False):
    """tokens (B, 1) int; cache from ``cache_decls`` with the prefill's
    parts copied in.  Self-attention over [start[b], pos] as in
    ``lm_decode`` (rows written in place); cross-attention over every row
    of ``cross_k``/``cross_v``, padding included.  Returns (logits (B, V)
    f32, cache) with "pos" advanced by one."""
    check_supported(cfg)
    pos = cache["pos"]
    start = cache.get("start")
    B = tokens.shape[0]
    h = embed(tokens, params["embed"]).to(cfg.param_dtype)
    positions = _whole(pos).to(torch.int32).reshape(1, 1).expand(B, 1)
    h = h + place(sinusoidal_positions(positions, cfg.d_model).to(
        cfg.param_dtype), "batch", None, None)
    for li in range(cfg.n_layers):
        p = layer_params(params["decoder"], li)
        out, _, _ = attn_decode(h, p, cfg, None, cache["k"][li],
                                cache["v"][li], pos, start, plain)
        h = h + out
        h = h + _cross_attend(h, p, cfg, cache["cross_k"][li],
                              cache["cross_v"][li], plain)
        h = h + ffn_apply(h, p, cfg)
    cache["pos"] = pos + 1
    return _logits_exact(params, cfg, h)[:, 0], cache
