"""Model facade — port of ``repro/models/model.py`` (every family: dense,
MoE, VLM, Mamba1, the Mamba2 hybrid and the encoder-decoder).

``Model(cfg)`` exposes init, the abstract parameter tree and its
partition specs, the training loss (``loss``, through the fused unembed
cross-entropy) and ``model_flops``, the whole-batch cache and its steps
(``prefill``, ``decode_step``, ``decode_many``), the paged cache and its
steps, and each cache's abstract tree and specs, with ``input_specs``
and ``batch_pspecs`` for a step's inputs.  The abstract trees are
tensors on the ``meta`` device (shapes and dtypes, no storage).  The
JAX cells are ``lax.scan``s jitted with donated caches; here they are
Python loops over steps, updating the cache in place, with sampling on
the device.  Randomness comes from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.dist.sharding import MeshRules, P
from repro_torch.models import transformer as T
from repro_torch.models.losses import fused_unembed_xent
from repro_torch.models.params import (
    abstract_params, init_from_schema, init_params, param_pspecs)


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 temperature: float) -> torch.Tensor:
    """Greedy (temperature 0) or temperature sampling: (B, V) -> (B,)
    int32.  The one sampler of the fused decode loop, the prefill lane
    and the engine, so the three consume the generator identically."""
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        # exponential race: argmax p / E with E ~ Exp(1) draws from p
        race = torch.empty_like(probs).exponential_(generator=generator)
        tok = torch.argmax(probs / race, dim=-1)
    else:
        tok = torch.argmax(logits, dim=-1)
    return tok.to(torch.int32)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """logits (B, S, V); labels (B, S) int.  Mean NLL in f32."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


@functools.lru_cache(maxsize=None)
def text_cfg(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` with ``embed_inputs`` forced on: the decode and paged steps
    of a stub-frontend arch take token ids through the embedding table,
    as the JAX ``Model`` forces them."""
    if cfg.embed_inputs:
        return cfg
    return dataclasses.replace(cfg, embed_inputs=True)


@dataclasses.dataclass
class Model:
    """``plain_attention=True`` routes every kernel call (attention, and
    the SSM family's selective scan) through the plain PyTorch versions
    on every device: the reference the kernel path is held against on the
    card.  Serving leaves it False."""
    cfg: ArchConfig
    plain_attention: bool = False

    def init(self, generator: torch.Generator, device="cuda"):
        return init_params(self.cfg, generator, device)

    # -- parameters and caches, abstract and as specs -------------------

    def schema(self):
        return T.schema(self.cfg)

    def abstract_params(self):
        return abstract_params(self.schema(), self.cfg.param_dtype)

    def param_pspecs(self, rules: MeshRules):
        return param_pspecs(self.schema(), rules)

    def abstract_cache(self, batch: int, max_seq: int):
        return abstract_params(self.cache_decls(batch, max_seq),
                               self.cfg.param_dtype)

    def cache_pspecs(self, batch: int, max_seq: int, rules: MeshRules):
        return param_pspecs(self.cache_decls(batch, max_seq), rules)

    def paged_cache_decls(self, batch: int, max_blocks: int, page_size: int,
                          num_pages: int):
        return T.paged_cache_decls(self.cfg, batch, max_blocks, page_size,
                                   num_pages)

    def abstract_paged_cache(self, batch: int, max_blocks: int,
                             page_size: int, num_pages: int):
        return abstract_params(
            self.paged_cache_decls(batch, max_blocks, page_size, num_pages),
            self.cfg.param_dtype)

    def paged_cache_pspecs(self, batch: int, max_blocks: int, page_size: int,
                           num_pages: int, rules: MeshRules):
        return param_pspecs(
            self.paged_cache_decls(batch, max_blocks, page_size, num_pages),
            rules)

    def prefill_cache_pspecs(self, shape: ShapeConfig, rules: MeshRules):
        """Specs of the cache parts ``prefill`` returns: the JAX
        package's (k/v, whisper's cross k/v, the hybrid's attention
        caches) and the SSM and hybrid families' per-layer states, which
        the port's prefill returns too (see ``models/transformer.py``)."""
        full = self.cache_pspecs(shape.global_batch, shape.seq_len, rules)
        cfg = self.cfg
        if cfg.family == "hybrid":
            keys = ["attn_k", "attn_v", "conv", "ssm"]
        elif cfg.mamba_version:
            keys = ["conv", "ssm"]
        else:
            keys = ["k", "v"]
            if cfg.is_encoder_decoder:
                keys += ["cross_k", "cross_v"]
        return {k: full[k] for k in keys}

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Meta tensors standing in for every step input (no storage)."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32, bf = torch.int32, cfg.param_dtype

        def sds(shp, dt):
            return torch.empty(shp, dtype=dt, device="meta")

        if shape.kind in ("train", "prefill"):
            batch: Dict[str, Any] = {"labels": sds((B, S), i32)}
            if cfg.is_encoder_decoder:
                batch["frames"] = sds((B, S, cfg.d_model), bf)
                batch["tokens"] = sds((B, S), i32)
            elif cfg.embed_inputs:
                batch["tokens"] = sds((B, S), i32)
            else:
                batch["embeds"] = sds((B, S, cfg.d_model), bf)
                if cfg.mrope_sections:
                    batch["positions"] = sds((3, B, S), i32)
            if shape.kind == "prefill":
                batch.pop("labels")
            return batch
        return {"tokens": sds((B, 1), i32),
                "cache": self.abstract_cache(B, S)}

    def batch_pspecs(self, shape: ShapeConfig, rules: MeshRules):
        cfg = self.cfg
        specs: Dict[str, Any] = {}
        b = rules.resolve("batch")
        if shape.kind in ("train", "prefill"):
            if shape.kind == "train":
                specs["labels"] = P(b, None)
            if cfg.is_encoder_decoder:
                specs["frames"] = P(b, None, None)
                specs["tokens"] = P(b, None)
            elif cfg.embed_inputs:
                specs["tokens"] = P(b, None)
            else:
                specs["embeds"] = P(b, None, None)
                if cfg.mrope_sections:
                    specs["positions"] = P(None, b, None)
            return specs
        return {"tokens": P(b, None),
                "cache": self.cache_pspecs(shape.global_batch, shape.seq_len,
                                           rules)}

    # -- training -------------------------------------------------------

    def loss(self, params, batch: Dict[str, Any]) -> torch.Tensor:
        """batch: "tokens" (B, S) int (or "embeds" (B, S, d) for a
        stub-frontend arch, and "frames" for the encoder-decoder),
        "labels" (B, S) int, optional "positions" (``arange(S)`` per row
        when absent).  The hidden states of ``lm_forward(mode="hidden")``
        through the fused unembed cross-entropy against the tied or
        untied table, plus ``router_aux_weight`` x the MoE load-balance
        loss.  Under a device mesh (DTensor parameters) the loss is a
        replicated 0-d DTensor."""
        cfg = self.cfg
        labels = batch["labels"]
        if cfg.is_encoder_decoder:
            hidden, aux, _ = T.whisper_forward(
                params, cfg, batch["frames"], batch["tokens"], mode="hidden",
                plain=self.plain_attention)
        else:
            inputs = batch["tokens"] if cfg.embed_inputs else batch["embeds"]
            positions = batch.get("positions")
            if positions is None:      # three equal streams for M-RoPE,
                B, S = labels.shape     # as ``prefill`` builds them
                positions = torch.arange(S, device=labels.device)[None]\
                    .expand(B, S)
                if cfg.mrope_sections:
                    positions = positions[None].expand(3, B, S)
            hidden, aux, _ = T.lm_forward(params, cfg, inputs, positions,
                                          mode="hidden",
                                          plain=self.plain_attention)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        ce = fused_unembed_xent(hidden, table, labels)
        return ce + cfg.router_aux_weight * aux

    def model_flops(self, shape: ShapeConfig) -> float:
        """Algorithmic FLOPs of one step: 6 N_active D for train, 2
        N_active D for prefill/decode forward (D = processed tokens)."""
        n_active = self.cfg.active_params()
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        mult = 6.0 if shape.kind == "train" else 2.0
        return mult * n_active * tokens

    # -- whole-batch cache and steps ------------------------------------

    def cache_decls(self, batch: int, max_seq: int):
        return T.cache_decls(self.cfg, batch, max_seq)

    def init_cache(self, batch: int, max_seq: int,
                   device="cuda") -> Dict[str, Any]:
        """Zeros of ``cache_decls``, each leaf in its declared dtype (the
        SSM and hybrid families' ``ssm`` states in f32), else the param
        dtype."""
        return init_from_schema(self.cache_decls(batch, max_seq), None,
                                device, self.cfg.param_dtype)

    def prefill(self, params, batch: Dict[str, Any]):
        """batch {"tokens": (B, S) int, "positions": optional (B, S)}; a
        stub-frontend arch takes {"embeds": (B, S, d), "positions":
        optional (3, B, S) for M-RoPE} instead, and the encoder-decoder
        {"frames": (B, S_enc, d), "tokens": (B, S)}.  Missing positions
        are ``arange(S)``: one (B, S) stream, or three equal ones for an
        M-RoPE arch.  Returns (last-position logits (B, V) f32, cache
        parts): {"k", "v"} (L, B, S, KV, hd) for the attention families
        (whisper adds {"cross_k", "cross_v"} (L, B, S_enc, KV, hd)); for
        the SSM family {"conv" (L, B, K-1, d_in), "ssm" (L, B, d_in, N)
        f32}, every layer's state after the prompt (the JAX package
        returns None); for the hybrid {"attn_k", "attn_v"} (G, B, S, KV,
        hd), as the JAX package returns them, plus every layer's "conv"
        and "ssm" (L, B, H, hd, N) f32 state."""
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            logits, _, cache = T.whisper_forward(
                params, cfg, batch["frames"], batch["tokens"],
                mode="prefill", plain=self.plain_attention)
            return logits[:, -1], cache
        inputs = batch["tokens"] if cfg.embed_inputs else batch["embeds"]
        positions = batch.get("positions")
        if positions is None:
            B, S = inputs.shape[:2]
            positions = torch.arange(S, device=inputs.device)[None].expand(
                B, S)
            if cfg.mrope_sections:
                positions = positions[None].expand(3, B, S)
        logits, _, cache = T.lm_forward(params, cfg, inputs, positions,
                                        mode="prefill",
                                        plain=self.plain_attention)
        return logits[:, -1], cache

    def decode_step(self, params, tokens, cache):
        """tokens (B, 1) int (token ids for every arch: a stub-frontend
        arch decodes text through its embedding table); returns (logits
        (B, V) f32, cache)."""
        if self.cfg.is_encoder_decoder:
            return T.whisper_decode(params, self.cfg, tokens, cache,
                                    self.plain_attention)
        return T.lm_decode(params, text_cfg(self.cfg), tokens, cache,
                           self.plain_attention)

    def decode_many(self, params, tokens, cache, generator, num_steps: int,
                    temperature: float = 0.0, eos_id: int = -1,
                    pad_id: int = 0):
        """``num_steps`` lockstep decode steps with sampling on the device:
        tokens (B, 1) — the last sampled token per slot.  ``eos_id < 0``
        disables stop conditions; a finished slot keeps advancing the
        cache but emits ``pad_id``.  Returns (out_tokens (num_steps, B)
        int32, cache, done (B,) bool)."""
        B = tokens.shape[0]
        done = (tokens[:, 0] == eos_id) if eos_id >= 0 else torch.zeros(
            B, dtype=torch.bool, device=tokens.device)
        pad = torch.tensor(pad_id, dtype=torch.int32, device=tokens.device)
        tok, out = tokens, []
        for _ in range(num_steps):
            logits, cache = self.decode_step(params, tok, cache)
            nxt = sample_token(logits, generator, temperature)
            nxt = torch.where(done, pad, nxt)
            if eos_id >= 0:
                done = done | (nxt == eos_id)
            tok = nxt[:, None]
            out.append(nxt)
        toks = torch.stack(out) if out else torch.zeros(
            (0, B), dtype=torch.int32, device=tokens.device)
        return toks, cache, done

    # -- paged cache and steps ------------------------------------------

    def init_paged_cache(self, batch: int, max_blocks: int, page_size: int,
                         num_pages: int, device="cuda") -> Dict[str, Any]:
        return init_from_schema(
            self.paged_cache_decls(batch, max_blocks, page_size, num_pages),
            None, device, self.cfg.param_dtype)

    def decode_step_paged(self, params, tokens, cache, active=None):
        """One non-lockstep decode step: tokens (B, 1); active (B,) bool
        (None: every slot).  Returns (logits (B, V), cache)."""
        if active is None:
            active = torch.ones(tokens.shape[0], dtype=torch.bool,
                                device=tokens.device)
        return T.lm_decode_paged(params, text_cfg(self.cfg), tokens, cache,
                                 active, self.plain_attention)

    def prefill_step_paged(self, params, tokens, cache, grants):
        """One ragged prefill chunk: tokens (B, T), grants (B,) int32.
        Returns (logits (B, V) at each slot's last granted position,
        cache)."""
        return T.lm_prefill_paged(params, text_cfg(self.cfg), tokens, cache,
                                  grants, self.plain_attention)

    def prefill_many_paged(self, params, tokens, cache, generator, grants,
                           *, temperature: float = 0.0):
        """The engine's prefill-lane cell: one ``prefill_step_paged`` and
        the one token it samples per slot (the next prompt token's
        prediction, discarded, or the first output when the grant drains
        the prompt).  Returns (next_tok (B,) int32, cache)."""
        logits, cache = self.prefill_step_paged(params, tokens, cache,
                                                grants)
        return sample_token(logits, generator, temperature), cache

    def verify_many_paged(self, params, tokens, cache, grants):
        """The engine's speculative verify cell (greedy only, no
        randomness): tokens (B, T) = [feed, p_1 .. p_{g-1}] per slot,
        grants (B,) int32 = 1 + proposals (0 = idle).  Returns (greedy
        (B, T) int32, accept (B,) int32, cache with "length" advanced by
        the whole grant)."""
        return T.lm_verify_paged(params, text_cfg(self.cfg), tokens, cache,
                                 grants, self.plain_attention)

    def decode_many_paged(self, params, tokens, cache, generator, active,
                          forced_tok=None, forced_mask=None, *,
                          num_steps: int, temperature: float = 0.0):
        """``num_steps`` decode steps with sampling on the device: tokens
        (B, 1) — each slot's last token.  ``active`` takes the JAX cell's
        three forms: (num_steps, B) bool, a per-step mask; (B,) bool, the
        same mask every step; or (B,) int grants, slot i active for its
        first ``active[i]`` steps (the mask built step by step on the
        device, the engine's form).  ``forced_tok`` / ``forced_mask``
        (num_steps, B): where the mask is set the step's token is
        overridden by the forced one (prompts fed through the decode
        loop); None forces nothing and builds nothing.  Within a step:
        sample, then the override, then an inactive slot keeps its last
        token.  An inactive slot writes the null page and does not
        advance.  Returns (tokens (num_steps, B) int32, cache)."""
        active = active.to(tokens.device)
        grants = None if active.dtype == torch.bool else active
        if grants is None and active.dim() == 1:
            active = active[None].expand(num_steps, -1)
        tok = tokens[:, 0].to(torch.int32)
        out = []
        for s in range(num_steps):
            act = grants > s if grants is not None else active[s]
            logits, cache = self.decode_step_paged(params, tok[:, None],
                                                   cache, act)
            nxt = sample_token(logits, generator, temperature)
            if forced_tok is not None:
                nxt = torch.where(forced_mask[s], forced_tok[s], nxt)
            tok = torch.where(act, nxt, tok)
            out.append(tok)
        return torch.stack(out), cache


def get_model(cfg: ArchConfig, plain_attention: bool = False) -> Model:
    return Model(cfg, plain_attention)
