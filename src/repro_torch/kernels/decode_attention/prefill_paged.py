"""Ragged multi-token paged prefill attention: the CUDA kernel
``csrc/paged_prefill.cu`` (replacing the Pallas kernel
``repro/kernels/decode_attention/prefill_paged.py::
paged_prefill_attention_fwd``) and its wrapper.

The wrapper takes the plain version (``ref.paged_prefill_attention_ref``)
only when every tensor lies on the CPU.  For CUDA tensors it checks the
arguments, launches the kernel on the current stream, or raises.  The one
place the two differ by design: a slot with ``new_len == 0`` gives exact
zeros from the kernel (as from the Pallas kernel) and a uniform softmax
from the plain version (as from the JAX oracle).

bf16 q runs the tensor-core kernel (``csrc/attention_tc.cuh``), one block
per (32-row tile, kv head, slot), with shared memory independent of the
page size; f32 q runs the CUDA-core kernel of ``csrc/paged_attention.cuh``,
one block per (kv head, slot).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import DTYPE_CODES, Kernel
from repro_torch.kernels.decode_attention.paged import (
    TC_ROWS, check_args, on_cpu, promote, ptr)
from repro_torch.kernels.decode_attention.ref import (
    paged_prefill_attention_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = Kernel("paged_prefill_attention",
                [_P] * 9 + [_I] * 11 + [_P])


def grid_blocks(B: int, T: int, H: int, KV: int, dtype) -> int:
    """Thread blocks of one launch: bf16 q runs the tensor-core kernel, one
    block per (32-row tile of the T * G rows, kv head, slot); f32 q the
    CUDA-core kernel, one block per (kv head, slot)."""
    if dtype == torch.bfloat16:
        return -(-T * (H // KV) // TC_ROWS) * KV * B
    return KV * B


def paged_prefill_attention(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_table: torch.Tensor,
                            base_len: torch.Tensor, new_len: torch.Tensor,
                            layer: int = 0, *,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            pages_per_step: int = 1) -> torch.Tensor:
    """q (B, T, H, D), the chunk's queries (its K/V rows already in the
    pool); pools, block_table, layer, scales and pages_per_step as in
    ``paged_decode_attention``; base_len (B,) int32 tokens resident
    before the chunk; new_len (B,) int32 = base_len + granted tokens.
    Returns (B, T, H, D) in q's dtype."""
    if pages_per_step < 1:
        raise ValueError("pages_per_step must be >= 1")
    if on_cpu(q, k_pool, v_pool, block_table, base_len, new_len, k_scale,
              v_scale):
        return paged_prefill_attention_ref(q, k_pool, v_pool, block_table,
                                           base_len, new_len, layer,
                                           k_scale, v_scale)
    k_pool, v_pool, k_scale, v_scale = promote(k_pool, v_pool, k_scale,
                                               v_scale)
    B, T, H, KV, D, num_pages, page, NB = check_args(
        "prefill", q, k_pool, v_pool, block_table, (base_len, new_len),
        layer, k_scale, v_scale)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNEL(out.data_ptr(), q.data_ptr(), k_pool.data_ptr(),
               v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
               block_table.data_ptr(), base_len.data_ptr(),
               new_len.data_ptr(), B, T, H, KV, D, num_pages, page, NB,
               int(layer), DTYPE_CODES[q.dtype], DTYPE_CODES[k_pool.dtype],
               torch.cuda.current_stream(q.device).cuda_stream)
    return out
