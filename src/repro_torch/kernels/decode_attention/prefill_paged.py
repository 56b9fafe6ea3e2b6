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
from typing import List, Optional

import numpy as np
import torch

from repro_torch.kernels.build import (
    DTYPE_CODES, Kernel, on_cpu, refuse_grad)
from repro_torch.kernels.decode_attention.paged import (
    KV_TILE, PREFILL_ROWS, TC_ROWS, check_args, promote, ptr)
from repro_torch.kernels.trips import (
    Launch, cdiv, mangled, strided, warps_of)
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
    refuse_grad("paged prefill attention", q, k_pool, v_pool, k_scale,
                v_scale)
    k_pool, v_pool, k_scale, v_scale = promote(k_pool, v_pool, k_scale,
                                               v_scale)
    B, T, H, KV, D, num_pages, page, NB = check_args(
        "prefill", q, k_pool, v_pool, block_table, (base_len, new_len),
        layer, k_scale, v_scale)
    if KERNEL.record is not None:        # the trip model's arguments
        KERNEL.record.append(dict(
            B=B, T=T, H=H, KV=KV, D=D, page=page, NB=NB, layer=int(layer),
            base_len=base_len.cpu().numpy(), new_len=new_len.cpu().numpy(),
            q_dtype=q.dtype, kv_dtype=k_pool.dtype))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        KERNEL(out.data_ptr(), q.data_ptr(), k_pool.data_ptr(),
               v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
               block_table.data_ptr(), base_len.data_ptr(),
               new_len.data_ptr(), B, T, H, KV, D, num_pages, page, NB,
               int(layer), DTYPE_CODES[q.dtype], DTYPE_CODES[k_pool.dtype],
               torch.cuda.current_stream(q.device).cuda_stream)
    return out


# --- trip and byte models (core/sass_counters.py counts by them) ----------

TC_MARKED = ("tc_q_copy", "tc_kv_copy", "tc_kv_copy_i8", "tc_scale_copy",
             "tc_dequant")                # strided over the block's threads


def tc_attend_trips(launch: Launch, n_tiles: np.ndarray, D: int, MT: int,
                    int8: bool) -> None:
    """The marked loops of ``tc::attend`` (csrc/attention_tc.cuh) in every
    block of ``launch`` (WARPS warps of 16 MT rows), block b visiting
    ``n_tiles[b]`` tiles of 64 positions."""
    threads = launch.threads
    R, CH = 16 * MT * (threads // 32), D // 8
    all_w, w_in = warps_of(np.arange(len(n_tiles)), launch.warps_per_block)
    tiles = np.repeat(n_tiles, launch.warps_per_block)
    launch.steps.update({m: threads for m in TC_MARKED})
    launch.add("tc_q_copy", all_w, strided(R * CH, threads, threads)[w_in])
    # one load a tile: tile 0 ahead of the loop, tile i + 1 inside it
    if int8:
        launch.add("tc_kv_copy_i8", all_w,
                   strided(KV_TILE * D // 16, threads, threads)[w_in], tiles)
        launch.add("tc_scale_copy", all_w,
                   strided(KV_TILE, threads, threads)[w_in], tiles)
        launch.add("tc_dequant", all_w,
                   strided(KV_TILE * D, threads, threads)[w_in], tiles)
    else:
        launch.add("tc_kv_copy", all_w,
                   strided(KV_TILE * CH, threads, threads)[w_in], tiles)
    launch.add("tc_tiles", all_w, tiles)
    launch.add("tc_out", all_w, cdiv(16 * MT * CH, 32))


def tc_tiles(r0: np.ndarray, nrows: int, G: int, base: np.ndarray,
             kv_end: np.ndarray, causal: bool, rows: int) -> np.ndarray:
    """Tiles a tensor-core block visits: up to its last row's causal
    limit (csrc/attention_tc.cuh, t_end)."""
    last = np.minimum(r0 + rows, nrows) - 1
    t_end = np.minimum(kv_end, base + last // G + 1) if causal else kv_end
    return np.where(t_end > 0, -(-t_end // KV_TILE), 0)


def trip_model(B: int, T: int, H: int, KV: int, D: int, page: int, NB: int,
               base_len, new_len, kv_dtype, q_dtype=torch.bfloat16
               ) -> List[Launch]:
    """The launch of one ``paged_prefill_attention`` call with its
    per-warp trips and bytes: q read and out written, the K/V rows below
    each slot's last causal limit (and their int8 scales), their
    block-table entries and the two lengths.  bf16 q: the tensor-core
    kernel; f32 q: ``cuda_core_trip_model``."""
    if q_dtype == torch.float32:
        return cuda_core_trip_model(B, T, H, KV, D, page, NB, base_len,
                                    new_len, kv_dtype)
    G = H // KV
    gx = -(-T * G // TC_ROWS)
    base = np.asarray(base_len, dtype=np.int64)
    end = np.minimum(np.asarray(new_len, dtype=np.int64), NB * page)
    r0 = (gx - 1 - np.arange(gx)) * TC_ROWS
    tiles = tc_tiles(r0[None, :], T * G, G, base[:, None], end[:, None],
                     True, TC_ROWS)                      # (B, gx)
    n_tiles = np.broadcast_to(tiles[:, None, :], (B, KV, gx)).ravel()
    kvsize = torch.empty((), dtype=kv_dtype).element_size()
    pos = np.maximum(np.minimum(end, base + T), 0)       # positions read
    rows = int(pos.sum()) * KV
    la = Launch(
        function=rf"paged_prefill_tc_kernelI{mangled(kv_dtype)}Li{D}E",
        grid=(gx, KV, B), threads=TC_ROWS * 2,
        io_bytes=2 * 2 * B * T * H * D + 2 * rows * D * kvsize
        + (8 * rows if kv_dtype == torch.int8 else 0)
        + 4 * int((-(-pos // page)).sum()) + 8 * B)
    tc_attend_trips(la, n_tiles, D, 1, kv_dtype == torch.int8)
    return [la]


def cuda_core_trip_model(B: int, T: int, H: int, KV: int, D: int, page: int,
                         NB: int, base_len, new_len, kv_dtype
                         ) -> List[Launch]:
    """The f32 parity kernel (csrc/paged_attention.cuh): one block of 128
    threads per (kv head, slot), the T G rows in tiles of 64, each tile
    sweeping whole pages up to its last row's causal limit.  Its bytes
    count those pages whole, as the kernel reads them."""
    G, TG, threads = H // KV, T * H // KV, 128
    base = np.asarray(base_len, dtype=np.int64)
    new = np.asarray(new_len, dtype=np.int64)
    live = np.where(new > 0, np.minimum(NB, -(-new // page)), 0)     # (B,)
    r0 = np.arange(0, TG, PREFILL_ROWS)
    qmax = base[:, None] + (np.minimum(r0 + PREFILL_ROWS, TG) - 1)[None] \
        // G
    pages = np.where(qmax < 0, 0, np.minimum(live[:, None],
                                             qmax // page + 1))      # (B, rt)
    kvsize = torch.empty((), dtype=kv_dtype).element_size()
    rows = int(pages.max(axis=1).sum()) * page * KV
    la = Launch(
        function=rf"paged_prefill_kernelIf{mangled(kv_dtype)}Li{D}E",
        grid=(KV, B, 1), threads=threads,
        io_bytes=2 * 4 * B * T * H * D + 2 * rows * D * kvsize
        + (8 * rows if kv_dtype == torch.int8 else 0)
        + 4 * int(pages.max(axis=1).sum()) + 8 * B,
        steps={"paged_row_tiles": PREFILL_ROWS})
    per = la.warps_per_block
    blocks = np.arange(KV * B).reshape(B, KV)
    all_w, w_in = warps_of(blocks.ravel(), per)
    st = {n: strided(n_el, threads, threads) for n, n_el in (
        ("q", PREFILL_ROWS * D), ("ml", PREFILL_ROWS), ("kv", page * D),
        ("sc", PREFILL_ROWS * page))}
    n_pages = np.repeat(np.repeat(pages, KV, axis=0), per, axis=0)  # warps
    la.add("paged_row_tiles", all_w, len(r0))
    for k in range(len(r0)):
        la.add("paged_q_load", all_w, st["q"][w_in])
        la.add("paged_ml_init", all_w, st["ml"][w_in])
        np_k = n_pages[:, k]
        la.add("paged_pages", all_w, np_k)
        la.add("paged_kv_load", all_w, st["kv"][w_in], np_k)
        la.add("paged_scores", all_w, st["sc"][w_in], np_k)
        la.add("paged_rows", all_w, st["ml"][w_in], np_k)
        for m in ("paged_row_max", "paged_row_exp"):
            la.add(m, all_w, page, np_k * st["ml"][w_in])
        la.add("paged_pv", all_w, page, np_k)
    return [la]
