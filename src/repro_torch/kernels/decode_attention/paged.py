"""Paged single-token decode attention: the CUDA kernel
``csrc/paged_decode.cu`` (replacing the Pallas kernel
``repro/kernels/decode_attention/paged.py::paged_decode_attention_fwd``)
and its wrapper.

The wrapper takes the plain version (``ref.paged_decode_attention_ref``)
only when every tensor lies on the CPU.  For CUDA tensors it checks the
arguments, launches the kernel on the current stream, or raises — it
never falls back.  The kernel splits each slot's live pages across
``splits(NB, B, KV)`` blocks per kv head and merges their partials in a
second launch of the same C call; the wrapper allocates the partials'
scratch and reads nothing back from the card (no host sync), so a decode
step that calls it can be captured in a CUDA graph.  A slot with
``kv_len == 0`` gives exact zeros from the kernel and a uniform softmax
from the plain version.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import (
    DTYPE_CODES, Kernel, on_cpu, refuse_dtensors, refuse_grad)
from repro_torch.kernels.trips import (
    Launch, cdiv, mangled, strided, warps_of)
from repro_torch.kernels.decode_attention.ref import (
    paged_decode_attention_ref)

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = Kernel("paged_decode_attention",
                [_P] * 9 + [_I] * 11 + [_P])

HEAD_DIMS = (16, 32, 64, 128)   # the head dims the paged kernels are built for
SMEM_LIMIT = 232448                 # bytes of shared memory a block may use
PREFILL_ROWS = 64     # f32 prefill, CUDA-core body: rows per tile (kRows)
TC_ROWS = 32          # bf16 prefill, tensor-core body: rows per block
KV_TILE, KV_PAD = 64, 8   # its K/V positions per tile, bf16 row padding
# the split decode body (csrc/split_decode.cuh): positions per tile, tiles
# in the cp.async ring, query rows per row tile
SPLIT_TILE, SPLIT_STAGES, SPLIT_ROWS = 32, 3, 16
TARGET_BLOCKS = 2 * 132    # about two blocks on each of the H100's SMs


def splits(NB: int, B: int, KV: int) -> int:
    """Blocks per (slot, kv head) of the paged decode kernel: enough for
    ``TARGET_BLOCKS`` in all, at most one per page of the table.  A
    function of the static shape only, so that the launch does not depend
    on the device's lengths."""
    return max(1, min(NB, TARGET_BLOCKS // (B * KV)))


def smem_bytes(D: int, rows: int, page: int) -> int:
    """Dynamic shared memory of one block of the CUDA-core body (csrc:
    paged::smem_bytes): prefill with f32 q."""
    return 4 * (rows * D + page * (D + 1) + page * D + rows * page + 3 * rows)


def decode_smem_bytes(D: int, G: int, kv_dtype) -> int:
    """Dynamic shared memory of one block of the split decode kernel (csrc:
    splitkv::smem_bytes): the K/V ring of 16-byte padded rows (and the
    int8 rows' scales), the query rows, their probabilities and
    corrections.  Independent of the page."""
    e = torch.empty((), dtype=kv_dtype).element_size()
    ring = e * SPLIT_STAGES * 2 * SPLIT_TILE * (D + 16 // e)
    scales = 4 * SPLIT_STAGES * 2 * SPLIT_TILE if e == 1 else 0
    rows = min(G, SPLIT_ROWS)
    return ring + scales + 4 * (rows * D + rows * SPLIT_TILE + rows)


def tc_smem_bytes(D: int, rows: int, int8: bool) -> int:
    """Dynamic shared memory of one block of the tensor-core body (csrc:
    tc::smem_bytes): prefill with bf16 q.  Independent of the page."""
    n = 2 * (rows * (D + KV_PAD) + 4 * KV_TILE * (D + KV_PAD))
    return n + (4 * KV_TILE * D + 16 * KV_TILE if int8 else 0)


def block_smem_bytes(kind: str, q_dtype, kv_dtype, D: int, page: int,
                     G: int) -> int:
    """Dynamic shared memory of one block of the kernel a call launches."""
    if kind == "decode":
        return decode_smem_bytes(D, G, kv_dtype)
    if q_dtype == torch.bfloat16:
        return tc_smem_bytes(D, TC_ROWS, kv_dtype == torch.int8)
    return smem_bytes(D, PREFILL_ROWS, page)


def promote(k_pool, v_pool, k_scale, v_scale):
    """A 4D single-layer pool (and its scales) becomes a 1-layer stack."""
    if k_pool.ndim == 4:
        k_pool, v_pool = k_pool[None], v_pool[None]
        if k_scale is not None:
            k_scale, v_scale = k_scale[None], v_scale[None]
    return k_pool, v_pool, k_scale, v_scale


def check_args(kind: str, q, k_pool, v_pool, block_table, lens,
               layer: int, k_scale=None, v_scale=None
               ) -> Tuple[int, ...]:
    """Validate a kernel call: every tensor on q's CUDA device, and the
    layout ``check_layout`` wants.  Returns (B, T, H, KV, D, num_pages,
    page, NB).  Raises ValueError on anything the kernel does not take."""
    tensors = [t for t in (q, k_pool, v_pool, block_table, *lens, k_scale,
                           v_scale) if t is not None]
    refuse_dtensors(kind, *tensors)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"{kind}: all tensors must lie on one CUDA device "
                         f"(got {sorted({str(t.device) for t in tensors})})")
    return check_layout(kind, q, k_pool, v_pool, block_table, lens, layer,
                        k_scale, v_scale)


def check_layout(kind: str, q, k_pool, v_pool, block_table, lens,
                 layer: int, k_scale=None, v_scale=None
                 ) -> Tuple[int, ...]:
    """The device-independent part of ``check_args``: shapes, dtypes,
    contiguity, head dim, layer range and shared memory."""
    tensors = [q, k_pool, v_pool, block_table, *lens, k_scale, v_scale]
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{kind}: tensors must be contiguous")
    if q.ndim != 4 or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kind}: q must be (B, T, H, D) f32 or bf16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    B, T, H, D = q.shape
    if k_pool.ndim != 5 or k_pool.shape != v_pool.shape \
            or k_pool.dtype != v_pool.dtype:
        raise ValueError(f"{kind}: k/v pools must be equal "
                         f"(L, num_pages, page, KV, D) stacks")
    L, num_pages, page, KV, Dk = k_pool.shape
    if Dk != D or H % KV:
        raise ValueError(f"{kind}: pool (KV={KV}, D={Dk}) does not match "
                         f"q (H={H}, D={D})")
    if D not in HEAD_DIMS:
        raise ValueError(f"{kind}: head dim {D} not in {HEAD_DIMS}")
    quantized = k_pool.dtype == torch.int8
    if not quantized and k_pool.dtype != q.dtype:
        raise ValueError(f"{kind}: pool dtype {k_pool.dtype} must be q's "
                         f"({q.dtype}) or int8")
    if quantized != (k_scale is not None) or (k_scale is None) != \
            (v_scale is None):
        raise ValueError(f"{kind}: int8 pools need k_scale and v_scale, "
                         f"other pools take none")
    if quantized and any(s.shape != k_pool.shape[:4]
                         or s.dtype != torch.float32
                         for s in (k_scale, v_scale)):
        raise ValueError(f"{kind}: scales must be f32 (L, num_pages, page, "
                         f"KV)")
    if block_table.ndim != 2 or block_table.shape[0] != B \
            or block_table.dtype != torch.int32:
        raise ValueError(f"{kind}: block_table must be (B, NB) int32")
    for n in lens:
        if n.shape != (B,) or n.dtype != torch.int32:
            raise ValueError(f"{kind}: lengths must be (B,) int32")
    if not 0 <= int(layer) < L:
        raise ValueError(f"{kind}: layer {layer} outside [0, {L})")
    if block_smem_bytes(kind, q.dtype, k_pool.dtype, D, page,
                        H // KV) > SMEM_LIMIT:
        raise ValueError(f"{kind}: page {page} needs more shared memory "
                         f"than a block has")
    return B, T, H, KV, D, num_pages, page, block_table.shape[1]


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           kv_len: torch.Tensor, layer: int = 0, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           pages_per_step: int = 1) -> torch.Tensor:
    """q (B, 1, H, D); k_pool, v_pool (L, num_pages, page, KV, D) stacked
    pools (4D single-layer pools are promoted); block_table (B, NB) int32
    physical page ids (0 = the null page); kv_len (B,) int32; layer — the
    pool layer; k_scale, v_scale — (L, num_pages, page, KV) f32 row scales
    of int8 pools; pages_per_step — accepted, changes nothing (see
    csrc/paged_decode.cu).  Returns (B, 1, H, D) in q's dtype.  On the
    card q and the pools must start on a 16-byte boundary (the kernel
    copies 16 bytes at a time); torch's allocations always do."""
    if pages_per_step < 1:
        raise ValueError("pages_per_step must be >= 1")
    if on_cpu(q, k_pool, v_pool, block_table, kv_len, k_scale, v_scale):
        return paged_decode_attention_ref(q, k_pool, v_pool, block_table,
                                          kv_len, layer, k_scale, v_scale)
    refuse_grad("paged decode attention", q, k_pool, v_pool, k_scale,
                v_scale)
    k_pool, v_pool, k_scale, v_scale = promote(k_pool, v_pool, k_scale,
                                               v_scale)
    B, T, H, KV, D, num_pages, page, NB = check_args(
        "decode", q, k_pool, v_pool, block_table, (kv_len,), layer,
        k_scale, v_scale)
    if T != 1:
        raise ValueError("paged decode takes one query token per slot")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged decode: q and the pools must be 16-byte "
                         "aligned (the kernel copies 16 bytes at a time)")
    n = splits(NB, B, KV)
    if KERNEL.record is not None:        # the trip model's arguments
        KERNEL.record.append(dict(
            B=B, H=H, KV=KV, D=D, page=page, NB=NB, layer=int(layer),
            splits=n, kv_len=kv_len.cpu().numpy(), q_dtype=q.dtype,
            kv_dtype=k_pool.dtype))
    out = torch.empty_like(q)
    part = torch.empty(B * H * n * (D + 2), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        KERNEL(out.data_ptr(), q.data_ptr(), k_pool.data_ptr(),
               v_pool.data_ptr(), ptr(k_scale), ptr(v_scale),
               block_table.data_ptr(), kv_len.data_ptr(), part.data_ptr(),
               B, H, KV, D, num_pages, page, NB, int(layer), n,
               DTYPE_CODES[q.dtype], DTYPE_CODES[k_pool.dtype],
               torch.cuda.current_stream(q.device).cuda_stream)
    return out


# --- trip and byte models (core/sass_counters.py counts by them) ----------

SPLIT_THREADS, COMBINE_THREADS = 128, 512    # splitkv::kThreads, kCombine...


def split_attend_trips(launch: Launch, n_tiles: np.ndarray, G: int, D: int,
                       kv_dtype) -> None:
    """The marked loops of ``splitkv::attend`` (csrc/split_decode.cuh) in
    every block of ``launch``, block b attending over ``n_tiles[b]``
    tiles of 32 positions."""
    e = torch.empty((), dtype=kv_dtype).element_size()
    int8 = kv_dtype == torch.int8
    nb = len(n_tiles)
    wpb = launch.warps_per_block
    all_w, w_in = warps_of(np.arange(nb), wpb)
    tiles = np.repeat(n_tiles, wpb)
    copy = strided(SPLIT_TILE * D * e // 16, SPLIT_THREADS, SPLIT_THREADS)
    scale = strided(SPLIT_TILE, SPLIT_THREADS, SPLIT_THREADS)
    units = cdiv(SPLIT_ROWS * D // 4, SPLIT_THREADS)
    launch.add("split_row_tiles", all_w, cdiv(G, SPLIT_ROWS))
    for r0 in range(0, G, SPLIT_ROWS):
        R = min(SPLIT_ROWS, G - r0)
        # one load a tile: the ring's first kStages - 1 ahead of the loop,
        # the rest inside it, kStages - 1 tiles ahead
        loads = tiles
        launch.add("split_kv_copy", all_w, copy[w_in], loads)
        if int8:
            launch.add("split_scale_copy", all_w, scale[w_in], loads)
        launch.add("split_q_load", all_w,
                   strided(R * D, SPLIT_THREADS, SPLIT_THREADS)[w_in])
        launch.add("split_kv_tiles", all_w, tiles)
        # p @ v: a warp takes unit u while one of its lanes has an
        # output, e = tid + u kThreads < R D / 4
        u_live = np.array([sum(32 * w + SPLIT_THREADS * u < R * D // 4
                               for u in range(units)) for w in range(wpb)])
        launch.add("split_pv", all_w, SPLIT_TILE // 4, tiles * u_live[w_in])


def combine_launch(tu: str, q_dtype, B: int, H: int, KV: int, D: int,
                   splits: int) -> Launch:
    """The combine (split_decode.cuh) of a split decode call: grid (KV, B)
    of 512 threads, reading the pieces' partials and writing out."""
    G = H // KV
    qsize = torch.empty((), dtype=q_dtype).element_size()
    la = Launch(function=rf"_{tu}_.*decode_attention_combine_kernelI"
                         rf"{mangled(q_dtype)}E",
                grid=(KV, B, 1), threads=COMBINE_THREADS,
                io_bytes=B * H * D * qsize,
                scratch_bytes=4 * B * H * splits * (D + 2))
    all_w, w_in = warps_of(np.arange(KV * B), la.warps_per_block)
    rows = strided(G, COMBINE_THREADS, COMBINE_THREADS)[w_in]
    outs = strided(G * D, COMBINE_THREADS, COMBINE_THREADS)[w_in]
    la.add("combine_ml_load", all_w,
           strided(splits * G, COMBINE_THREADS, COMBINE_THREADS)[w_in])
    la.add("combine_rows", all_w, rows)
    for m in ("combine_max", "combine_weights", "combine_norm"):
        la.add(m, all_w, splits, rows)
    la.add("combine_out", all_w, outs)
    la.add("combine_sum", all_w, splits, outs)
    return la


def pieces(NB: int, B: int, KV: int, page: int, kv_len
           ) -> Tuple[np.ndarray, np.ndarray]:
    """(s0, s1), each (B, splits): the positions [s0, s1) block (s, h, b)
    of the split kernel attends over, whole pages of [0, kv_len[b])
    (csrc/paged_decode.cu); the same for every kv head."""
    n = np.clip(np.asarray(kv_len, dtype=np.int64), 0, NB * page)
    sp = splits(NB, B, KV)
    per = -(-(-(-n // page)) // sp) * page               # (B,)
    s0 = np.arange(sp)[None, :] * per[:, None]
    return s0, np.minimum(s0 + per[:, None], n[:, None])


def trip_model(B: int, H: int, KV: int, D: int, page: int, NB: int,
               kv_len, q_dtype, kv_dtype) -> List[Launch]:
    """The launches of one ``paged_decode_attention`` call (split kernel
    and combine) with their per-warp trips and bytes, from the host's
    lengths ``kv_len`` (B,).  The split kernel's bytes: q, the live K/V
    rows of each kv head (and their int8 scales), the live block-table
    entries and the lengths read, the partials written; the combine's:
    the partials read, out written."""
    n = np.clip(np.asarray(kv_len, dtype=np.int64), 0, NB * page)
    sp = splits(NB, B, KV)
    G = H // KV
    live_pages = -(-n // page)
    s0, s1 = pieces(NB, B, KV, page, kv_len)
    tiles = np.where(s1 > s0, -(-(s1 - s0) // SPLIT_TILE), 0)
    n_tiles = np.broadcast_to(tiles[:, None, :], (B, KV, sp)).ravel()
    qsize = torch.empty((), dtype=q_dtype).element_size()
    kvsize = torch.empty((), dtype=kv_dtype).element_size()
    rows = int(n.sum()) * KV
    kv_bytes = 2 * rows * D * kvsize + (8 * rows if kv_dtype == torch.int8
                                        else 0)
    kv = mangled(kv_dtype)
    if q_dtype == kv_dtype == torch.bfloat16:
        kv = "S1_"                                      # the repeated type
    split = Launch(
        function=rf"paged_decode_kernelI{mangled(q_dtype)}{kv}Li{D}E",
        grid=(sp, KV, B), threads=SPLIT_THREADS,
        io_bytes=B * H * D * qsize + kv_bytes + 4 * int(live_pages.sum())
        + 4 * B,
        scratch_bytes=4 * B * H * sp * (D + 2))
    split_attend_trips(split, n_tiles, G, D, kv_dtype)
    return [split, combine_launch("paged_decode_cu", q_dtype, B, H, KV, D,
                                  sp)]
