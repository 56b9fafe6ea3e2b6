"""The plain reference of a dense GQA decoder (granite-8b, qwen2-0.5b):
its forward pass and logits, and its training loss, in float32 with
TF32 off, written from the published description and the configuration
file alone.  It imports nothing of the program.

The layer: RMSNorm (eps from the file) -> q, k, v projections (with bias
where ``qkv_bias``) -> rotary positions (rotate-half, theta from the
file) -> causal softmax attention, each group of H / KV query heads on
one key/value head, scaled by 1/sqrt(head size) -> output projection ->
residual; RMSNorm -> SwiGLU FFN (silu(x W_gate) * (x W_up)) W_down ->
residual.  A final RMSNorm and the unembedding (the embedding table when
tied).  Weights come as the benchmark made them, a tree of tensors keyed
as the port's parameter tree is (the layout, not the values, is the
program's), stacked over layers; each layer is taken to float32 when it
is used.

``precision="fp8"`` is the control, the step below the configuration's
bf16: every weight product's operands are rounded to float8 before the
float32 product, as fp8 training runs it -- e4m3 in the forward
(per-row scales of the activations, per-column scales of the weights),
and in the backward the incoming gradient in e5m2 and the saved
operands in e4m3, each with one scale.  The correctness check must fail
it.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List

import torch
import torch.nn.functional as F

FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim=None, dtype=torch.float8_e4m3fn):
    """x rounded to ``dtype`` with one scale per slice along ``dim`` (one
    for the whole tensor when None), back in float32."""
    a = x.abs()
    amax = (a.amax() if dim is None else a.amax(dim=dim, keepdim=True))
    s = amax.clamp(min=1e-30) / FP8[dtype]
    return (x / s).to(dtype).to(torch.float32) * s


class _Fp8Matmul(torch.autograd.Function):
    """x (m, k) @ w (k, n) with fp8 operands in both passes."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x, -1), _fp8(w, 0)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        g8 = _fp8(g, None, torch.float8_e5m2)
        return g8 @ _fp8(wq).T, _fp8(xq).T @ g8


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., k) @ w (k, n) in float32; operands in fp8 for the
    control."""
    if precision == "fp8":
        lead = x.shape[:-1]
        return _Fp8Matmul.apply(x.reshape(-1, x.shape[-1]), w).reshape(
            *lead, w.shape[-1])
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, n, hd) rotated by position (rotate-half convention)."""
    half = x.shape[-1] // 2
    exps = -torch.arange(half, dtype=torch.float64, device=x.device) / half
    inv = torch.pow(torch.tensor(theta, dtype=torch.float64,
                                 device=x.device), exps).to(torch.float32)
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _layer(blocks: Dict, li: int) -> Dict:
    return {k: (_layer(v, li) if isinstance(v, dict)
                else v[li].to(torch.float32)) for k, v in blocks.items()}


def block(h: torch.Tensor, p: Dict, cfg: Dict, pos: torch.Tensor,
          precision: str) -> torch.Tensor:
    """One decoder layer on h (S, d), f32."""
    S, d = h.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // H
    eps = cfg["rms_norm_eps"]
    a = p["attn"]
    x = rmsnorm(h, p["ln1"]["scale"], eps)
    q = matmul(x, a["wq"], precision)
    k = matmul(x, a["wk"], precision)
    v = matmul(x, a["wv"], precision)
    if cfg.get("qkv_bias"):
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    q = rope(q.view(S, H, hd), pos, cfg["rope_theta"])
    k = rope(k.view(S, KV, hd), pos, cfg["rope_theta"])
    v = v.view(S, KV, hd)
    G = H // KV
    q = q.view(S, KV, G, hd).permute(1, 2, 0, 3)          # (KV, G, S, hd)
    k = k.permute(1, 0, 2)[:, None]                      # (KV, 1, S, hd)
    v = v.permute(1, 0, 2)[:, None]
    s = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    s = s.masked_fill(mask, float("-inf"))
    o = torch.softmax(s, dim=-1) @ v                     # (KV, G, S, hd)
    o = o.permute(2, 0, 1, 3).reshape(S, H * hd)
    h = h + matmul(o, a["wo"], precision)
    f = p["ffn"]
    x = rmsnorm(h, p["ln2"]["scale"], eps)
    u = F.silu(matmul(x, f["w_gate"], precision)) \
        * matmul(x, f["w_up"], precision)
    return h + matmul(u, f["w_down"], precision)


def _table(weights: Dict, cfg: Dict) -> torch.Tensor:
    return weights["embed"] if cfg.get("tie_word_embeddings") \
        else weights["unembed"]


def hidden(weights: Dict, cfg: Dict, tokens: torch.Tensor,
           precision: str = "f32") -> torch.Tensor:
    """The final-normed hidden states (S, d) f32 of one sequence."""
    h = weights["embed"][tokens.long()].to(torch.float32)
    pos = torch.arange(tokens.shape[0], device=h.device)
    for li in range(cfg["num_hidden_layers"]):
        h = block(h, _layer(weights["blocks"], li), cfg, pos, precision)
    return rmsnorm(h, weights["ln_f"]["scale"].to(torch.float32),
                   cfg["rms_norm_eps"])


def logits_at(weights: Dict, cfg: Dict, tokens: torch.Tensor,
              rows: Iterable[int], precision: str = "f32") -> torch.Tensor:
    """Logits (len(rows), V) f32 at positions ``rows`` of one sequence."""
    h = hidden(weights, cfg, tokens, precision)[list(rows)]
    table = _table(weights, cfg).to(torch.float32)
    return matmul(h, table.T, precision)


def served_gaps(weights: Dict, cfg: Dict, prompt: List[int],
                served: List[int], control: bool = False) -> float:
    """The widest gap by which a served token's reference logit lies
    below the reference's best at its position, over the served tokens
    of one request (prompt + served fed back, teacher-forced).  With
    ``control``: the gap of the token that the fp8 reference puts first
    at each of those positions instead."""
    seq = torch.tensor(list(prompt) + list(served[:-1]), dtype=torch.long,
                       device=weights["embed"].device)
    rows = range(len(prompt) - 1, len(prompt) - 1 + len(served))
    with torch.no_grad():
        ref = logits_at(weights, cfg, seq, rows)
        if control:
            tok = torch.argmax(logits_at(weights, cfg, seq, rows, "fp8"),
                               dim=-1)
        else:
            tok = torch.tensor(served, dtype=torch.long, device=ref.device)
        best = ref.max(dim=-1).values
        got = ref.gather(1, tok[:, None])[:, 0]
        return float((best - got).max())


def row_loss_sum(weights: Dict, cfg: Dict, tokens: torch.Tensor,
                 labels: torch.Tensor, precision: str = "f32",
                 remat: bool = True) -> torch.Tensor:
    """The summed next-token NLL of one row, each layer recomputed in the
    backward (``torch.utils.checkpoint``) so that a 4096-token row fits."""
    from torch.utils.checkpoint import checkpoint
    h = weights["embed"][tokens.long()]
    pos = torch.arange(tokens.shape[0], device=h.device)
    for li in range(cfg["num_hidden_layers"]):
        p = _layer(weights["blocks"], li)
        if remat:
            h = checkpoint(block, h, p, cfg, pos, precision,
                           use_reentrant=False)
        else:
            h = block(h, p, cfg, pos, precision)
    x = rmsnorm(h, weights["ln_f"]["scale"], cfg["rms_norm_eps"])
    logits = matmul(x, _table(weights, cfg).T, precision)
    return F.cross_entropy(logits, labels.long(), reduction="sum")
