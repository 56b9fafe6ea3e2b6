"""Flash-attention forward: the CUDA kernel ``csrc/flash_attention.cu``
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

Forward only.  The JAX wrapper's backward (autograd through the chunked
reference under a custom VJP) belongs to the training slice, so a CUDA
call that would need a gradient raises instead of returning a detached
result.
"""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from repro_torch.kernels.build import DTYPE_CODES, Kernel
from repro_torch.kernels.decode_attention.decode import check_dense
from repro_torch.kernels.decode_attention.paged import on_cpu
from repro_torch.kernels.decode_attention.prefill_paged import (
    tc_attend_trips, tc_tiles)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.trips import Launch, strided, warps_of
from repro_torch.models.attention import repeat_kv

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = Kernel("flash_attention", [_P] * 4 + [_I] * 8 + [_P])


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
    return launch(q, k, v, causal)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    """The kernel on CUDA tensors at any S and T: its tiles mask the
    ragged edges, so no block size need divide them.  The route of
    ``models.attention.attention``, which applies the reference
    dispatch's own shape rule instead of the JAX wrapper's; raises on what
    the kernel does not take and on a call that would need a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention on the card is forward only: its backward "
            "comes with the training slice of the port")
    B, S, T, H, KV, D = check_dense("flash", q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNEL(out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
               B, S, T, H, KV, D, int(bool(causal)), DTYPE_CODES[q.dtype],
               torch.cuda.current_stream(q.device).cuda_stream)
    return out


TC_WARPS, TC_MT = 4, 2          # csrc/flash_attention.cu: kTcWarps, kTcMT
TC_ROWS = 16 * TC_MT * TC_WARPS


def trip_model(B: int, S: int, T: int, H: int, KV: int, D: int,
               causal: bool, dtype=torch.bfloat16) -> List[Launch]:
    """The launch of one ``launch`` call with its per-warp trips and
    bytes: q read, out written, and the K/V rows some query sees (the
    first min(S, T) under the causal mask).  bf16: the tensor-core
    kernel; f32: ``cuda_core_trip_model``."""
    if dtype == torch.float32:
        return cuda_core_trip_model(B, S, T, H, KV, D, causal)
    G = H // KV
    gy = -(-S * G // TC_ROWS)
    r0 = (gy - 1 - np.arange(gy)) * TC_ROWS
    tiles = tc_tiles(r0, S * G, G, np.zeros(1, np.int64),
                     np.full(1, T, np.int64), causal, TC_ROWS)   # (gy,)
    n_tiles = np.broadcast_to(tiles[:, None], (gy, B * KV)).ravel()
    seen = min(S, T) if causal else T
    la = Launch(function=rf"flash_attention_tc_kernelILi{D}E",
                grid=(B * KV, gy, 1), threads=32 * TC_WARPS,
                io_bytes=2 * 2 * B * S * H * D + 2 * 2 * B * seen * KV * D)
    tc_attend_trips(la, n_tiles, D, TC_MT, False)
    return [la]


CC_THREADS, CC_BQ, CC_BK = 256, 64, 32     # flash_attention_kernel's tiles


def cuda_core_trip_model(B: int, S: int, T: int, H: int, KV: int, D: int,
                         causal: bool) -> List[Launch]:
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
    la = Launch(function=rf"flash_attention_kernelIfLi{D}E",
                grid=(B * H, gy, 1), threads=CC_THREADS,
                io_bytes=2 * 4 * B * S * H * D + 2 * 4 * B * seen * KV * D)
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
