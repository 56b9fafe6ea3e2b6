"""Dense single-token decode attention over the whole-batch cache: the
CUDA kernel ``csrc/decode_attention.cu`` (replacing the Pallas kernel
``repro/kernels/decode_attention/decode.py::decode_attention_fwd``) and
its wrapper.

The wrapper takes the plain version (``ref.decode_attention_ref``) only
when every tensor lies on the CPU.  For CUDA tensors it checks the
arguments, launches the kernel on the current stream, or raises — it
never falls back.  The kernel splits each slot's window across
``splits(T, B, KV)`` blocks per kv head and merges their partials in a
second launch of the same C call; the wrapper allocates the partials'
scratch and reads nothing back from the card (no host sync), so a decode
step that calls it can be captured in a CUDA graph.  The one place the
two differ by design: a slot whose window is empty (kv_start[b] >=
kv_len) gives exact zeros from the kernel and a uniform softmax from the
plain version.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.build import (
    DTYPE_CODES, Kernel, on_cpu, refuse_dtensors, refuse_grad)
from repro_torch.kernels.decode_attention.paged import (
    SPLIT_THREADS, SPLIT_TILE, TARGET_BLOCKS, combine_launch,
    split_attend_trips)
from repro_torch.kernels.trips import Launch, mangled
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = Kernel("decode_attention", [_P] * 7 + [_I] * 7 + [_P])

# the head dims the dense kernels (this one and flash) are built for: the
# paged kernels' and zamba2's 112 (3584 / 32 heads)
HEAD_DIMS = (16, 32, 64, 112, 128)


def splits(T: int, B: int, KV: int) -> int:
    """Blocks per (slot, kv head): enough for ``TARGET_BLOCKS`` in all,
    at most one per tile of the cache.  A function of the static shape
    only, so that the launch does not depend on the device's lengths."""
    return max(1, min(-(-T // SPLIT_TILE), TARGET_BLOCKS // (B * KV)))


def grid_blocks(B: int, T: int, KV: int) -> int:
    """Blocks of the split kernel's grid (splits, KV, B)."""
    return splits(T, B, KV) * KV * B


def dense_layout(kind: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> Tuple[int, int, int, int, int, int]:
    """q (B, S, H, D) and k, v (B, T, KV, D): contiguous, one dtype (f32
    or bf16), KV dividing H, a head dim the kernels are built for, and
    nothing empty.  Returns (B, S, T, H, KV, D); raises ValueError."""
    if q.ndim != 4 or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kind}: q must be (B, S, H, D) f32 or bf16, got "
                         f"{tuple(q.shape)} {q.dtype}")
    if k.ndim != 4 or k.shape != v.shape or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{kind}: k and v must be equal (B, T, KV, D) "
                         f"tensors of q's dtype")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"{kind}: tensors must be contiguous")
    B, S, H, D = q.shape
    Bk, T, KV, Dk = k.shape
    if Bk != B or Dk != D or KV == 0 or H % KV:
        raise ValueError(f"{kind}: k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (KV must divide H)")
    if D not in HEAD_DIMS:
        raise ValueError(f"{kind}: head dim {D} not in {HEAD_DIMS}")
    if 0 in (B, S, T, H):
        raise ValueError(f"{kind}: empty q or cache")
    return B, S, T, H, KV, D


def check_dense(kind: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> Tuple[int, int, int, int, int, int]:
    """``dense_layout``, with every tensor on q's CUDA device."""
    ts = (q, k, v)
    refuse_dtensors(kind, *ts)
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{kind}: all tensors must lie on one CUDA device "
                         f"(got {sorted({str(t.device) for t in ts})})")
    return dense_layout(kind, q, k, v)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Union[int, torch.Tensor],
                     kv_start: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """q (B, 1, H, D); k, v (B, T, KV, D) (a layer of the whole-batch
    cache); kv_len a scalar int or 0-d int tensor (positions >= kv_len
    masked); kv_start (B,) int tensor or None (positions < kv_start[b]
    masked).  Returns (B, 1, H, D) in q's dtype."""
    lens = [t for t in (kv_len, kv_start) if isinstance(t, torch.Tensor)]
    if on_cpu(q, k, v, *lens):
        return decode_attention_ref(q, k, v, kv_len, kv_start)
    refuse_grad("decode attention", q, k, v)
    B, S, T, H, KV, D = check_dense("decode", q, k, v)
    if S != 1:
        raise ValueError("decode attention takes one query token per slot")
    kvl = torch.as_tensor(kv_len, dtype=torch.int32,
                          device=q.device).reshape(-1)
    if kvl.numel() != 1:
        raise ValueError("decode attention: kv_len must be a scalar")
    if kv_start is None:
        start = torch.zeros((B,), dtype=torch.int32, device=q.device)
    else:
        start = kv_start.to(device=q.device, dtype=torch.int32).contiguous()
        if start.shape != (B,):
            raise ValueError("decode attention: kv_start must be (B,)")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode attention: q, k and v must be 16-byte "
                         "aligned (the kernel copies 16 bytes at a time)")
    n = splits(T, B, KV)
    out = torch.empty_like(q)
    part = torch.empty(B * H * n * (D + 2), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        KERNEL(out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
               kvl.data_ptr(), start.data_ptr(), part.data_ptr(), B, T, H,
               KV, D, n, DTYPE_CODES[q.dtype],
               torch.cuda.current_stream(q.device).cuda_stream)
    return out


def trip_model(B: int, T: int, H: int, KV: int, D: int, kv_len: int,
               kv_start, dtype) -> List[Launch]:
    """The launches of one ``decode_attention`` call (split kernel and
    combine) with their per-warp trips and bytes: slot b attends over
    [max(kv_start[b], 0), min(kv_len, T)), cut into ``splits`` pieces of
    whole tiles.  The split kernel's bytes: q, the window's K/V rows and
    the lengths read, the partials written; the combine's: the partials
    read, out written."""
    sp = splits(T, B, KV)
    lo = np.maximum(np.asarray(kv_start, dtype=np.int64), 0)
    hi = min(int(kv_len), T)
    n = np.maximum(hi - lo, 0)
    per = -(-(-(-n // sp)) // SPLIT_TILE) * SPLIT_TILE          # (B,)
    s0 = lo[:, None] + np.arange(sp)[None, :] * per[:, None]
    s1 = np.minimum(s0 + per[:, None], hi)
    tiles = np.where(s1 > s0, -(-(s1 - s0) // SPLIT_TILE), 0)
    n_tiles = np.broadcast_to(tiles[:, None, :], (B, KV, sp)).ravel()
    e = torch.empty((), dtype=dtype).element_size()
    split = Launch(
        function=rf"decode_attention_kernelI{mangled(dtype)}Li{D}E",
        grid=(sp, KV, B), threads=SPLIT_THREADS,
        io_bytes=B * H * D * e + 2 * int(n.sum()) * KV * D * e + 4 + 4 * B,
        scratch_bytes=4 * B * H * sp * (D + 2))
    split_attend_trips(split, n_tiles, H // KV, D, dtype)
    return [split, combine_launch("decode_attention_cu", dtype, B, H, KV, D,
                                  sp)]
