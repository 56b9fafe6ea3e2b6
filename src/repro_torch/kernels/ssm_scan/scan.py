"""The Mamba1 selective scan: the CUDA kernel ``csrc/selective_scan.cu``
(replacing the Pallas kernel
``repro/kernels/ssm_scan/scan.py::selective_scan_fwd`` and its jitted
wrapper ``ops.py::selective_scan``) and its wrapper.

The wrapper takes the plain version (``ref.mamba1_scan``) only when every
tensor lies on the CPU.  For CUDA tensors it checks the arguments,
launches the kernel on the current stream, or raises — it never falls
back.  Unlike the Pallas kernel it takes any S >= 1 and any d_in (the
Pallas block plan needs S % chunk == 0 and d_in % block_d == 0, which is
TPU tiling), and B and C may be strided views with unit stride along N —
the model passes column slices of the x_proj output.

Under autograd (grad mode on and an input that needs a gradient) a CUDA
call goes through ``SelectiveScan``, the design the JAX wrapper states
(its forward the kernel, its backward the plain sequential scan's
autodiff): the forward launches the kernel and saves its inputs; the
backward recomputes ``mamba1_scan`` from them and takes its
vector-Jacobian product.  The final state ``h_fin`` is not
differentiated: training reads only ``y``.  The plain scan steps over
the tokens from the host, so this backward is slow; a CUDA backward is
later work.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.kernels.build import (
    DTYPE_CODES, Kernel, on_cpu, refuse_dtensors)
from repro_torch.kernels.ssm_scan.ref import mamba1_scan
from repro_torch.kernels.trips import (
    Launch, cdiv, mangled, strided, warps_of)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

KERNEL = Kernel("selective_scan",
                [_P] * 7 + [_I] * 4 + [_L] * 4 + [_I] * 3 + [_P])

STATE_SIZES = (8, 16)               # N the kernel is instantiated for
# lanes of a warp that share each channel's N states, of the 1, 2 and 4
# the kernel is instantiated for: on the H100 1 and 2 run within a few per
# cent of each other and 4 a quarter slower (scripts/
# torch_kernel_profile.py); the result does not depend on it beyond the
# order of y's sum over the states
LANES = 2


def scan_layout(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor
                ) -> Tuple[int, int, int, int]:
    """x, dt (B, S, d_in) contiguous, one dtype (f32 or bf16); A (d_in, N)
    f32 contiguous with N in ``STATE_SIZES``; Bc, Cc (B, S, N) of x's
    dtype with unit stride along N; nothing empty.  Returns (B, S, d_in,
    N); raises ValueError."""
    if x.ndim != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"selective scan: x must be (B, S, d_in) f32 or "
                         f"bf16, got {tuple(x.shape)} {x.dtype}")
    B, S, d_in = x.shape
    if dt.shape != x.shape or dt.dtype != x.dtype:
        raise ValueError("selective scan: dt must match x in shape and dtype")
    if not (x.is_contiguous() and dt.is_contiguous()):
        raise ValueError("selective scan: x and dt must be contiguous")
    if A.ndim != 2 or A.shape[0] != d_in or A.dtype != torch.float32 \
            or not A.is_contiguous():
        raise ValueError(f"selective scan: A must be a contiguous (d_in, N) "
                         f"f32 tensor, got {tuple(A.shape)} {A.dtype}")
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"selective scan: state size {N} not in "
                         f"{STATE_SIZES}")
    for name, t in (("Bc", Bc), ("Cc", Cc)):
        if t.shape != (B, S, N) or t.dtype != x.dtype or t.stride(-1) != 1:
            raise ValueError(f"selective scan: {name} must be (B, S, N) of "
                             f"x's dtype with unit stride along N, got "
                             f"{tuple(t.shape)} {t.dtype} strides "
                             f"{t.stride()}")
    if 0 in (B, S, d_in):
        raise ValueError("selective scan: empty input")
    return B, S, d_in, N


def check_scan(x, dt, A, Bc, Cc) -> Tuple[int, int, int, int]:
    """``scan_layout``, with every tensor on x's CUDA device."""
    ts = (x, dt, A, Bc, Cc)
    refuse_dtensors("selective scan", *ts)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError(f"selective scan: all tensors must lie on one CUDA "
                         f"device (got {sorted({str(t.device) for t in ts})})")
    return scan_layout(x, dt, A, Bc, Cc)


def copies_16_bytes(x: torch.Tensor, dt: torch.Tensor) -> bool:
    """Whether the kernel copies x's and dt's tiles 16 bytes at a time:
    both start on a 16-byte boundary and a row of d_in elements is a
    multiple of 16 bytes.  Otherwise it reads them with plain loads."""
    return (x.shape[-1] * x.element_size()) % 16 == 0 and \
        x.data_ptr() % 16 == 0 and dt.data_ptr() % 16 == 0


def selective_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bc: torch.Tensor, Cc: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt (B, S, d_in); A (d_in, N); Bc, Cc (B, S, N).  Returns (y
    (B, S, d_in) in x's dtype, h_final (B, d_in, N) f32), as
    ``mamba1_scan`` from a zero state.  Under autograd on the card the
    call is differentiable in y (``SelectiveScan``); h_final never is."""
    if on_cpu(x, dt, A, Bc, Cc):
        return mamba1_scan(x, dt, A, Bc, Cc)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, Bc, Cc)):
        return SelectiveScan.apply(x, dt, A, Bc, Cc)
    return run(x, dt, A, Bc, Cc)


def run(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        Bc: torch.Tensor, Cc: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel: (y, h_final)."""
    B, S, d_in, N = check_scan(x, dt, A, Bc, Cc)
    y = torch.empty_like(x)
    h = torch.empty((B, d_in, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        KERNEL(y.data_ptr(), h.data_ptr(), x.data_ptr(), dt.data_ptr(),
               A.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), B, S, d_in, N,
               Bc.stride(0), Bc.stride(1), Cc.stride(0), Cc.stride(1),
               LANES, int(copies_16_bytes(x, dt)), DTYPE_CODES[x.dtype],
               torch.cuda.current_stream(x.device).cuda_stream)
    return y, h


class SelectiveScan(torch.autograd.Function):
    """The kernel's training route: the kernel forward, the plain scan's
    backward.  Saves (x, dt, A, Bc, Cc) as given (Bc and Cc strided views
    of the x_proj output, so their gradients reach it); h_final is marked
    non-differentiable."""

    @staticmethod
    def forward(ctx, x, dt, A, Bc, Cc):
        y, h = run(x, dt, A, Bc, Cc)
        ctx.save_for_backward(x, dt, A, Bc, Cc)
        ctx.mark_non_differentiable(h)
        return y, h

    @staticmethod
    def backward(ctx, dy, _dh):
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wrt = [t for t in ins if t.requires_grad]
        with torch.enable_grad():
            y, _ = mamba1_scan(*ins)
            got = iter(torch.autograd.grad(y, wrt, dy))
        return tuple(next(got) if t.requires_grad else None for t in ins)


THREADS, STEPS_A_TILE = 128, 32          # csrc/selective_scan.cu: kThreads, kT


def hbm_bytes(B: int, S: int, d_in: int, N: int, dtype) -> int:
    """What one call reads and writes in device memory, each tensor once:
    x, dt and y (B, S, d_in), B and C (B, S, N) in x's dtype, A (d_in, N)
    and the final state (B, d_in, N) in f32."""
    e = torch.empty((), dtype=dtype).element_size()
    return B * S * (3 * d_in + 2 * N) * e + d_in * N * 4 + B * d_in * N * 4


def trip_model(B: int, S: int, d_in: int, N: int, dtype, lanes: int = LANES,
               vec: bool = True) -> List[Launch]:
    """The launch of one ``selective_scan`` call with its per-warp trips
    and bytes (``hbm_bytes``): every warp walks all S steps, tile by
    tile, the last tile ragged (S = 454: 14 tiles of 32 and one of 6);
    ``vec``: x's and dt's tiles arrive by 16-byte copies, else by plain
    loads (``copies_16_bytes``)."""
    kC = THREADS // lanes
    e = torch.empty((), dtype=dtype).element_size()
    gx = cdiv(d_in, kC)
    la = Launch(function=rf"selective_scan_kernelI{mangled(dtype)}Li{N}ELi"
                         rf"{lanes}E",
                grid=(gx, B, 1), threads=THREADS,
                io_bytes=hbm_bytes(B, S, d_in, N, dtype))
    all_w, w_in = warps_of(np.arange(gx * B), la.warps_per_block)
    n_tiles = cdiv(S, STEPS_A_TILE)
    # one load a tile, by the path ``vec`` takes (the other's loop is
    # reached no time)
    la.add("scan_xdt_copy", all_w,
           strided(STEPS_A_TILE * kC * e // 16, THREADS, THREADS)[w_in],
           n_tiles if vec else 0)
    la.add("scan_xdt_load", all_w,
           strided(STEPS_A_TILE * kC, THREADS, THREADS)[w_in],
           0 if vec else n_tiles)
    la.add("scan_tiles", all_w, n_tiles)
    la.add("scan_steps", all_w, STEPS_A_TILE, n_tiles - 1)
    la.add("scan_steps", all_w, S - STEPS_A_TILE * (n_tiles - 1))
    return [la]
