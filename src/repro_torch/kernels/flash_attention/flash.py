"""Flash attention on the card: the CUDA kernel ``csrc/flash_attention.cu``
(replacing the Pallas kernel
``repro/kernels/flash_attention/flash.py::flash_attention_fwd`` and its
jitted wrapper ``ops.py::flash_attention``) and its wrapper.

k and v come unrepeated, (B, T, KV, D) with KV dividing H: query head h
reads kv head h // (H / KV); KV == H is the JAX signature.  The wrapper
refuses the shapes the JAX wrapper's asserts refuse (a block size of
min(512, S) that does not divide S, likewise for T), though the kernel's
own tiles would take them; ``launch``, the model's route, takes any S and
T.  For CPU tensors it takes the plain version —
the chunked flash reference on repeated kv heads, at the JAX wrapper's
block sizes; for CUDA tensors it launches the kernel on the current
stream or raises.  bf16 runs on the tensor cores (``csrc/attention_tc.cuh``:
bf16 mma.sync, p rounded to bf16 before p @ v); f32 on the CUDA cores in
f32, the parity path.

Under autograd (grad mode on and an input that needs a gradient) a CUDA
call goes through ``FlashAttention``, the JAX wrapper's custom VJP: its
forward launches the kernel's training instantiation, which also writes
each row's softmax normalizer L, and saves (q, k, v, out, L); its
backward is the chunked reference's backward (``models.flash.flash_bwd``,
plain PyTorch, as the JAX wrapper differentiates the jnp reference) at
the JAX wrapper's block sizes, on k and v repeated to H heads, with each
group of H / KV heads' dk and dv summed back to its kv head (the
transpose of ``repeat_kv``).
"""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from repro_torch.kernels.build import DTYPE_CODES, Kernel, on_cpu
from repro_torch.kernels.decode_attention.decode import check_dense
from repro_torch.kernels.decode_attention.prefill_paged import (
    tc_attend_trips, tc_tiles)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.trips import Launch, strided, warps_of
from repro_torch.models.attention import repeat_kv
from repro_torch.models.flash import flash_bwd

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = Kernel("flash_attention", [_P] * 4 + [_I] * 8 + [_P, _P])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 512,
                    block_kv: int = 512) -> torch.Tensor:
    """q (B, S, H, D); k, v (B, T, KV, D), KV dividing H; causal masking is
    top-left aligned (row s sees positions <= s).  ``block_q`` and
    ``block_kv`` are the JAX wrapper's: they decide which shapes are taken
    and the plain version's chunks, not the kernel's tiles.  Returns
    (B, S, H, D) in q's dtype."""
    S, T, H = q.shape[1], k.shape[1], q.shape[2]
    bq, bkv = min(block_q, S), min(block_kv, T)
    if bq < 1 or bkv < 1 or S % bq or T % bkv:
        raise ValueError(f"flash attention: blocks of min({block_q}, S) and "
                         f"min({block_kv}, T) must divide S = {S} and T = "
                         f"{T}, as in the JAX wrapper")
    if on_cpu(q, k, v):
        return flash_attention_ref(q, repeat_kv(k, H), repeat_kv(v, H),
                                   causal, bq, bkv)
    return launch(q, k, v, causal, bq, bkv)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, block_q: int = 512,
           block_kv: int = 512) -> torch.Tensor:
    """The kernel on CUDA tensors at any S and T: its tiles mask the
    ragged edges, so no block size need divide them.  The route of
    ``models.attention.attention``, which applies the reference
    dispatch's own shape rule instead of the JAX wrapper's; raises on what
    the kernel does not take.  Under autograd the call is differentiable
    (``FlashAttention``); ``block_q`` and ``block_kv`` are then its
    backward's chunks (ragged last chunks allowed)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, bool(causal), block_q,
                                    block_kv)
    return run(q, k, v, causal)[0]


def run(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
        with_lse: bool = False):
    """One launch: (out (B, S, H, D) in q's dtype, and with ``with_lse``
    each row's L = m + log(max(l, 1e-30)), (B, S, H) f32, from the
    training instantiation; else None)."""
    B, S, T, H, KV, D = check_dense("flash", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, S, H), dtype=torch.float32,
                      device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        KERNEL(out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
               B, S, T, H, KV, D, int(bool(causal)), DTYPE_CODES[q.dtype],
               torch.cuda.current_stream(q.device).cuda_stream,
               None if lse is None else lse.data_ptr())
    return out, lse


class FlashAttention(torch.autograd.Function):
    """The kernel's training route: the forward with L, the plain
    chunked backward.  Saves (q, k, v, out, L), k and v unrepeated."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv):
        out, lse = run(q, k, v, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.blocks = causal, (block_q, block_kv)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        B, S, H, D = q.shape
        T, KV = k.shape[1], k.shape[2]
        dq, dk, dv = flash_bwd(q, repeat_kv(k, H), repeat_kv(v, H), out,
                               lse, dout, ctx.causal,
                               min(ctx.blocks[0], S), min(ctx.blocks[1], T))
        G = H // KV                              # repeat_kv's transpose
        dk = dk.reshape(B, T, KV, G, D).sum(3)
        dv = dv.reshape(B, T, KV, G, D).sum(3)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


TC_WARPS, TC_MT = 4, 2          # csrc/flash_attention.cu: kTcWarps, kTcMT
TC_ROWS = 16 * TC_MT * TC_WARPS


def trip_model(B: int, S: int, T: int, H: int, KV: int, D: int,
               causal: bool, dtype=torch.bfloat16,
               with_lse: bool = False) -> List[Launch]:
    """The launch of one ``launch`` call with its per-warp trips and
    bytes: q read, out written, and the K/V rows some query sees (the
    first min(S, T) under the causal mask); ``with_lse``: the training
    instantiation, the same trips and L (B, S, H) f32 written.  bf16: the
    tensor-core kernel; f32: ``cuda_core_trip_model``."""
    if dtype == torch.float32:
        return cuda_core_trip_model(B, S, T, H, KV, D, causal, with_lse)
    G = H // KV
    gy = -(-S * G // TC_ROWS)
    r0 = (gy - 1 - np.arange(gy)) * TC_ROWS
    tiles = tc_tiles(r0, S * G, G, np.zeros(1, np.int64),
                     np.full(1, T, np.int64), causal, TC_ROWS)   # (gy,)
    n_tiles = np.broadcast_to(tiles[:, None], (gy, B * KV)).ravel()
    seen = min(S, T) if causal else T
    name = "flash_attention_tc_lse_kernel" if with_lse else \
        "flash_attention_tc_kernel"
    la = Launch(function=rf"{name}ILi{D}E",
                grid=(B * KV, gy, 1), threads=32 * TC_WARPS,
                io_bytes=2 * 2 * B * S * H * D + 2 * 2 * B * seen * KV * D
                + 4 * B * S * H * with_lse)
    tc_attend_trips(la, n_tiles, D, TC_MT, False)
    return [la]


CC_THREADS, CC_BQ, CC_BK = 256, 64, 32     # flash_attention_kernel's tiles


def cuda_core_trip_model(B: int, S: int, T: int, H: int, KV: int, D: int,
                         causal: bool, with_lse: bool = False
                         ) -> List[Launch]:
    """The f32 parity kernel (csrc/flash_attention.cu,
    flash_attention_kernel): a block of 256 threads per (sequence, query
    head) and 64 query rows, walking the key tiles of 32 below the
    tile's causal limit."""
    gy = -(-S // CC_BQ)
    q0 = (gy - 1 - np.arange(gy)) * CC_BQ
    t_end = np.minimum(T, np.minimum(q0 + CC_BQ, S)) if causal else \
        np.full(gy, T)
    tiles = np.repeat(np.where(t_end > 0, -(-t_end // CC_BK), 0), B * H)
    seen = min(S, T) if causal else T
    name = "flash_attention_lse_kernel" if with_lse else \
        "flash_attention_kernel"
    la = Launch(function=rf"{name}IfLi{D}E",
                grid=(B * H, gy, 1), threads=CC_THREADS,
                io_bytes=2 * 4 * B * S * H * D + 2 * 4 * B * seen * KV * D
                + 4 * B * S * H * with_lse)
    per = la.warps_per_block
    all_w, w_in = warps_of(np.arange(B * H * gy), per)
    warp_tiles = np.repeat(tiles, per)
    rows = strided(CC_BQ, CC_THREADS, CC_THREADS)[w_in]
    la.add("flash_q_load", all_w,
           strided(CC_BQ * D, CC_THREADS, CC_THREADS)[w_in])
    la.add("flash_ml_init", all_w, rows)
    la.add("flash_tiles", all_w, warp_tiles)
    la.add("flash_kv_load", all_w,
           strided(CC_BK * D, CC_THREADS, CC_THREADS)[w_in], warp_tiles)
    la.add("flash_qk", all_w, D, warp_tiles)
    la.add("flash_rows", all_w, rows, warp_tiles)
    for m in ("flash_row_max", "flash_row_exp"):
        la.add(m, all_w, CC_BK, warp_tiles * rows)
    la.add("flash_pv", all_w, CC_BK, warp_tiles)
    return [la]
