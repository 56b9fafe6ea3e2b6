"""BabelStream's five kernels: the CUDA kernels ``csrc/stream.cu``
(replacing the Pallas kernels ``copy``, ``mul``, ``add``, ``triad`` and
``dot`` of ``repro/kernels/stream/stream.py``) and their wrappers.

    copy : c = a
    mul  : b = s * c
    add  : c = a + b
    triad: a = b + s * c
    dot  : sum(a * b), in f32

Every wrapper takes 2-D ``(rows, cols)`` f32 or bf16 tensors of any shape,
as the JAX kernels do, and the scalar 0.4 by default.  ``out=`` names the
tensor to write, which may be one of the inputs (BabelStream's in-place
chain); without it a new tensor is returned, as in JAX.  The plain
version (``ref.py``) is taken only when every tensor lies on the CPU; for
CUDA tensors the wrapper launches the kernel on the current stream or
raises — it never falls back.

On the card every kernel loads and stores 16 bytes at a time: copy,
mul, add and triad one 16-byte vector of each input a thread in blocks
of 1024 threads, dot 32 elements a thread in blocks of 256.  So their
tensors (inputs and ``out=``) must start on a 16-byte boundary: every
tensor PyTorch allocates does, while a view that starts elsewhere
(``base.view(-1)[1:n + 1]``) raises ValueError.  On the CPU every view
is taken.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels.build import (
    DTYPE_CODES, Kernel, on_cpu, refuse_dtensors)
from repro_torch.kernels.stream import ref

_P, _I, _N, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float

COPY = Kernel("stream_copy", [_P, _P, _N, _I, _P])
MUL = Kernel("stream_mul", [_P, _P, _F, _N, _I, _P])
ADD = Kernel("stream_add", [_P, _P, _P, _N, _I, _P])
TRIAD = Kernel("stream_triad", [_P, _P, _P, _F, _N, _I, _P])
DOT = Kernel("stream_dot", [_P, _P, _P, _N, _I, _P])
SUM = Kernel("stream_sum", [_P, _P, _N, _P])
KERNELS = {"copy": COPY, "mul": MUL, "add": ADD, "triad": TRIAD, "dot": DOT,
           "sum": SUM}                   # the C entry points

VEC_THREADS = 1024                  # copy, mul, add, triad: threads ...
VEC_PER_THREAD = 1                  # ... and 16-byte vectors a thread
DOT_THREADS = 256                   # dot and sum: threads per block ...
DOT_PER_THREAD = 32                 # ... and elements a thread (kPer)
DTYPES = (torch.float32, torch.bfloat16)
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_layout(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Every tensor 2-D, contiguous, of one shape and one dtype (f32 or
    bf16), and not empty.  Raises ValueError."""
    ts = [t for t in tensors if t is not None]
    first = ts[0]
    if first.ndim != 2 or first.dtype not in DTYPES:
        raise ValueError(f"{name}: arrays must be 2-D (rows, cols) f32 or "
                         f"bf16, got {tuple(first.shape)} {first.dtype}")
    for t in ts:
        if t.shape != first.shape or t.dtype != first.dtype:
            raise ValueError(f"{name}: arrays must share shape and dtype, "
                             f"got {tuple(t.shape)} {t.dtype} beside "
                             f"{tuple(first.shape)} {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: arrays must be contiguous")
    if first.numel() == 0:
        raise ValueError(f"{name}: arrays must not be empty")


def check_device(name: str, *tensors: Optional[torch.Tensor]) -> None:
    ts = [t for t in tensors if t is not None]
    refuse_dtensors(name, *ts)
    if ts[0].device.type != "cuda" or any(t.device != ts[0].device
                                          for t in ts):
        raise ValueError(f"{name}: all arrays must lie on one CUDA device "
                         f"(got {sorted({str(t.device) for t in ts})})")


def launch_counts() -> Dict[str, int]:
    """Launches of each of the five functions: dot's are its products'
    pass and the sum passes over its partials."""
    n = {name: k.launches for name, k in KERNELS.items()}
    n["dot"] += n.pop("sum")
    return n


def block_elements(name: str, dtype: torch.dtype) -> int:
    """Elements one block of ``name``'s first launch covers:
    ``VEC_THREADS`` x ``VEC_PER_THREAD`` 16-byte vectors for copy, mul,
    add and triad (4096 f32, 8192 bf16), 8192 for dot."""
    if name == "dot":
        return DOT_THREADS * DOT_PER_THREAD
    return VEC_THREADS * VEC_PER_THREAD * 16 // dtype.itemsize


def dot_blocks(n: int) -> int:
    """Blocks of one pass of dot over ``n`` elements: ``DOT_THREADS``
    threads of ``DOT_PER_THREAD`` elements (8192 to a block)."""
    return -(-n // (DOT_THREADS * DOT_PER_THREAD))


def dot_passes(n: int) -> List[int]:
    """Elements summed by each launch of ``dot``: the products of all
    ``n``, then the block partials again until one is left
    (2**25 -> [2**25, 4096])."""
    passes = [n]
    while dot_blocks(passes[-1]) > 1:
        passes.append(dot_blocks(passes[-1]))
    return passes


def launches(name: str, dtype: torch.dtype, n: int
             ) -> List[Tuple[str, int, int]]:
    """(compiled kernel, blocks, threads per block) of every launch one
    call of ``name`` makes over ``n`` elements of ``dtype``: the launch
    geometry the instruction census is multiplied by."""
    own = f"stream_{name}_{SUFFIX[dtype]}"
    if name != "dot":
        return [(own, -(-n // block_elements(name, dtype)), VEC_THREADS)]
    first, *rest = dot_passes(n)
    return [(own, dot_blocks(first), DOT_THREADS)] + [
        ("stream_sum_f32", dot_blocks(m), DOT_THREADS) for m in rest]


def _put(result: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        return result
    out.copy_(result)
    return out


def _launch(kernel: Kernel, like: torch.Tensor, *args) -> None:
    with torch.cuda.device(like.device):
        kernel(*args, torch.cuda.current_stream(like.device).cuda_stream)


def _cuda_out(name: str, out: Optional[torch.Tensor],
              *inputs: torch.Tensor) -> torch.Tensor:
    check_device(name, *inputs, out)
    return torch.empty_like(inputs[0]) if out is None else out


def copy(a: torch.Tensor, out: Optional[torch.Tensor] = None
         ) -> torch.Tensor:
    """c = a."""
    check_layout("copy", a, out)
    if on_cpu(a, out):
        return _put(ref.copy(a), out)
    out = _cuda_out("copy", out, a)
    check_aligned("copy", a, out)
    _launch(COPY, a, a.data_ptr(), out.data_ptr(), a.numel(),
            DTYPE_CODES[a.dtype])
    return out


def mul(c: torch.Tensor, scalar: float = ref.SCALAR,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """b = scalar * c, the scalar rounded to c's dtype."""
    check_layout("mul", c, out)
    if on_cpu(c, out):
        return _put(ref.mul(c, scalar), out)
    out = _cuda_out("mul", out, c)
    check_aligned("mul", c, out)
    _launch(MUL, c, c.data_ptr(), out.data_ptr(),
            ref.scalar_in(c.dtype, scalar), c.numel(), DTYPE_CODES[c.dtype])
    return out


def add(a: torch.Tensor, b: torch.Tensor,
        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """c = a + b."""
    check_layout("add", a, b, out)
    if on_cpu(a, b, out):
        return _put(ref.add(a, b), out)
    out = _cuda_out("add", out, a, b)
    check_aligned("add", a, b, out)
    _launch(ADD, a, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
            DTYPE_CODES[a.dtype])
    return out


def triad(b: torch.Tensor, c: torch.Tensor, scalar: float = ref.SCALAR,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a = b + scalar * c, rounding the product before the sum."""
    check_layout("triad", b, c, out)
    if on_cpu(b, c, out):
        return _put(ref.triad(b, c, scalar), out)
    out = _cuda_out("triad", out, b, c)
    check_aligned("triad", b, c, out)
    _launch(TRIAD, b, b.data_ptr(), c.data_ptr(), out.data_ptr(),
            ref.scalar_in(b.dtype, scalar), b.numel(), DTYPE_CODES[b.dtype])
    return out


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor's data 16-byte aligned, as the kernel's vector loads
    need.  Raises ValueError."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: arrays must be 16-byte aligned (the "
                             f"kernel loads 16 bytes at a time), got one at "
                             f"{t.data_ptr() % 16} bytes past a boundary")


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) as an f32 scalar (0-dim tensor).  On the card: one
    launch of per-block sums of the f32 products, 16-byte loads of 32
    elements a thread, then ``stream_sum`` over the f32 partials,
    relaunched until one value is left — no atomics and no host sum, so
    the result is the same on every run.  The arrays must be 16-byte
    aligned there."""
    check_layout("dot", a, b)
    if on_cpu(a, b):
        return ref.dot(a, b)
    check_device("dot", a, b)
    check_aligned("dot", a, b)
    first, *rest = dot_passes(a.numel())
    x = torch.empty(dot_blocks(first), dtype=torch.float32, device=a.device)
    _launch(DOT, a, a.data_ptr(), b.data_ptr(), x.data_ptr(), first,
            DTYPE_CODES[a.dtype])
    for n in rest:
        part = torch.empty(dot_blocks(n), dtype=torch.float32,
                           device=a.device)
        _launch(SUM, a, x.data_ptr(), part.data_ptr(), n)
        x = part
    return x.reshape(())
