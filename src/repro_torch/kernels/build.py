"""Builds the port's CUDA kernels and binds their C entry points.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together), linked into one shared library with a
plain C interface, and loaded with ``ctypes``.  The library is built at
first use from the repository's sources only and cached under
``build/repro_torch/<hash>/`` by a hash of the sources and flags, so an
edited kernel rebuilds and an unchanged one loads at once.  Nothing here
runs at import time: the package imports, and its CPU paths run, on a
machine without ``nvcc`` or a GPU.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -lineinfo: the SASS keeps each instruction's source line (read by the
# instruction census to tie loops to their source; no change to the code)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (csrc/paged_attention.cuh: paged::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit on a machine with an H100 "
                       "(set CUDA_HOME or put nvcc on PATH)")


def compile_commands(compiler: str, out_dir: Path) -> List[List[str]]:
    """One ``nvcc -c`` per source, then the link into libkernels.so."""
    objs = [out_dir / (src.stem + ".o") for src in sources()]
    cmds = [[compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources(), objs)]
    cmds.append([compiler, "-shared", "-gencode",
                 "arch=compute_90a,code=sm_90a", "-o",
                 str(out_dir / "libkernels.so"), *map(str, objs)])
    return cmds


def build() -> Path:
    """Path of the built library, building it first if the cache misses.
    The compiler's output (``-Xptxas -v``: registers, shared memory and
    spills of every kernel) is kept beside it in ``build.log``."""
    out = BUILD_ROOT / source_hash()
    lib = out / "libkernels.so"
    if lib.exists():
        return lib
    compiler = nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        *compiles, link = compile_commands(compiler, tmp)
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in compiles]
        logs = [p.communicate()[0] for p in procs]
        for cmd, p, log in zip(compiles, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                   f"{' '.join(cmd)}\n{log}")
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"link failed: {' '.join(link)}\n{res.stdout}")
        (tmp / "build.log").write_text("\n".join(logs) + res.stdout)
        try:
            os.replace(tmp, out)             # atomic publish of the cache
        except OSError:
            if not lib.exists():             # a concurrent build won: fine
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    return ctypes.CDLL(str(build()))


def refuse_grad(kind: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raises where a kernel that has no backward is asked for a
    gradient: it writes its output through a raw pointer, so under
    autograd it would return a result with no ``grad_fn`` and the
    gradient would be dropped without a word."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kind} on the card has no backward: a call whose inputs need "
            f"a gradient would return a detached result (run it under "
            f"torch.no_grad(), or take the plain route)")


class Kernel:
    """One C entry point of the library, with a count of its launches.

    ``launches`` goes up by one for each launch the C function reports as
    made (its return value, the launch's ``cudaGetLastError()``, is 0);
    any other return value raises.  Pointers and the stream travel as
    ``c_void_p``, the rest as ``c_int``.  ``record``: None (the default),
    or a list to which the paged wrappers append each call's shapes and
    the host's copy of its lengths — reads that wait for the card, for an
    untimed pass that the instruction census sums over."""

    def __init__(self, symbol: str, argtypes: Sequence):
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.record: Optional[List[dict]] = None
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: launch failed with "
                               f"cudaError_t {err}")
        self.launches += 1
