"""Instruction census of the port's compiled CUDA kernels, from their SASS.

The Hopper counterpart of ``repro/core/hlo_counters.py``: where the JAX
package counts the operations of XLA's compiled HLO text, this counts the
machine instructions of the port's own ``libkernels.so``, as
``cuobjdump -sass`` lists them.  Hardware counters (Nsight Compute) are
not used: the instruction roofline needs only the instructions a warp
issues, and for a kernel in which every warp runs one straight-line path
that is the length of the listing, up to the padding after its last
``EXIT``.

    census = census_library(build.build(), select=r"stream_")
    census["stream_copy_f32"].warp_insts_per_warp      # path length

A warp issues every instruction of such a kernel once, predicated ones
included, so ``path length x warps launched`` is the kernel's count of
warp instructions — exactly, when no forward branch is taken (every
thread of the warp in range of the bounds guard; ``forward_branches``
says how many the kernel has).  A backward branch means a loop, whose trip
count the listing cannot give: ``count_function`` raises ``LoopError`` on
one rather than return a number that is not the kernel's.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CLASSES = ("global_ldst", "shared_ldst", "fp", "int", "shuffle", "barrier",
           "control", "other")

_GLOBAL = {"LDG", "STG", "LD", "ST", "ATOM", "ATOMG", "RED", "LDGSTS",
           "UTMALDG", "UTMASTG", "UBLKCP"}
_SHARED = {"LDS", "STS", "LDSM", "STSM", "ATOMS"}
_FP = {"FADD", "FMUL", "FFMA", "FMNMX", "FSET", "FSETP", "FSEL", "FCHK",
       "FRND", "FSWZADD", "MUFU", "HADD2", "HMUL2", "HFMA2", "HSET2",
       "HSETP2", "HMNMX2", "DADD", "DMUL", "DFMA", "DSETP", "F2F", "F2FP",
       "F2I", "I2F", "I2FP"}
_INT = {"IADD3", "IADD", "IMAD", "IMUL", "IMNMX", "IABS", "ISETP", "LEA",
        "LOP3", "LOP", "SHF", "SHL", "SHR", "SEL", "PRMT", "POPC", "FLO",
        "BREV", "BMSK", "SGXT", "VIADD", "VIMNMX", "VIADDMNMX", "IDP",
        "IDP4A", "PLOP3", "PSETP", "P2R", "R2P"}
_SHUFFLE = {"SHFL"}
_BARRIER = {"BAR", "MEMBAR", "DEPBAR", "WARPSYNC", "ERRBAR", "CCTL", "FENCE",
            "SYNCS"}
_CONTROL = {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "EXIT", "BSSY",
            "BSYNC", "YIELD", "BPT", "KILL", "NANOSLEEP"}
_BRANCHES = {"BRA", "JMP"}                # direct jumps with a target
_INDIRECT = {"BRX", "JMX"}                # targets unknown to the listing

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)", re.M)
_INSTRUCTION = re.compile(r"^\s*/\*([0-9a-fA-F]+)\*/\s+([^;]*?)\s*;",
                          re.M)
_PREDICATE = re.compile(r"^@!?U?P(?:T|\d+)\s+")
_TARGET = re.compile(r"\b0x([0-9a-fA-F]+)\b")


class LoopError(ValueError):
    """The kernel has a backward (or indirect) branch: its instruction
    count depends on trip counts the SASS listing does not hold."""


@dataclasses.dataclass(frozen=True)
class KernelCensus:
    """One compiled kernel's straight-line path, counted by class."""

    name: str
    warp_insts_per_warp: int          # instructions one warp issues
    counts: Dict[str, int]            # by class, over CLASSES
    forward_branches: int


def opcode_class(base: str) -> str:
    if base in _GLOBAL:
        return "global_ldst"
    if base in _SHARED:
        return "shared_ldst"
    if base in _FP:
        return "fp"
    if base in _INT or (base.startswith("U") and base[1:] in _INT):
        return "int"
    if base in _SHUFFLE:
        return "shuffle"
    if base in _BARRIER:
        return "barrier"
    if base in _CONTROL:
        return "control"
    return "other"


def split_functions(listing: str) -> Dict[str, List[Tuple[int, str]]]:
    """{function name: [(address, instruction text without ';'), ...]}
    for every ``Function :`` section of a ``cuobjdump -sass`` listing."""
    heads = list(_FUNCTION.finditer(listing))
    out: Dict[str, List[Tuple[int, str]]] = {}
    for k, m in enumerate(heads):
        end = heads[k + 1].start() if k + 1 < len(heads) else len(listing)
        body = listing[m.end():end]
        out[m.group(1)] = [(int(a, 16), text) for a, text in
                           _INSTRUCTION.findall(body)]
    return out


def _base(text: str) -> Tuple[str, str]:
    """(base opcode, instruction without its predicate)."""
    ins = _PREDICATE.sub("", text.strip())
    return ins.split()[0].split(".")[0], ins


def strip_padding(insts: List[Tuple[int, str]]) -> List[Tuple[int, str]]:
    """Drop what follows the last EXIT: the self-branch and the NOPs that
    pad a function to its alignment, which no warp executes."""
    last = max((k for k, (_, text) in enumerate(insts)
                if _base(text)[0] == "EXIT"), default=None)
    if last is None:
        raise ValueError("function has no EXIT")
    return insts[:last + 1]


def count_function(name: str, insts: List[Tuple[int, str]]) -> KernelCensus:
    """The census of one function's listing; raises LoopError on a
    backward or indirect branch."""
    body = strip_padding(insts)
    counts = {c: 0 for c in CLASSES}
    forward = 0
    for addr, text in body:
        base, ins = _base(text)
        counts[opcode_class(base)] += 1
        if base in _INDIRECT:
            raise LoopError(f"{name}: indirect branch at {addr:#x} ({ins})")
        if base in _BRANCHES:
            m = _TARGET.search(ins)
            if m is None:
                raise LoopError(f"{name}: branch target not found at "
                                f"{addr:#x} ({ins})")
            if int(m.group(1), 16) <= addr:
                raise LoopError(f"{name}: backward branch at {addr:#x} "
                                f"({ins}): a loop, whose trip count the "
                                f"census cannot give")
            forward += 1
    return KernelCensus(name=name, warp_insts_per_warp=len(body),
                        counts=counts, forward_branches=forward)


def census_text(listing: str, select: Optional[str] = None
                ) -> Dict[str, KernelCensus]:
    """The census of every function of ``listing`` whose name matches the
    regular expression ``select`` (all when None)."""
    pat = re.compile(select) if select else None
    return {name: count_function(name, insts)
            for name, insts in split_functions(listing).items()
            if pat is None or pat.search(name)}


def find_cuobjdump() -> str:
    """``cuobjdump`` from ``$CUDA_HOME/bin``, then ``PATH``, then the CUDA
    toolkit's default place, then the copy Triton's package carries under
    ``triton/backends/nvidia/bin/``.  Raises when there is none."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                          "cuobjdump"),
             shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(str(Path(spec.origin).parent / "backends" / "nvidia"
                         / "bin" / "cuobjdump"))
    for cand in cands:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("cuobjdump not found (CUDA_HOME, PATH, "
                       "/usr/local/cuda/bin, triton/backends/nvidia/bin): "
                       "the SASS census needs the CUDA toolkit's binary "
                       "tools")


def sass_listing(library: Path) -> str:
    return subprocess.run([find_cuobjdump(), "-sass", str(library)],
                          check=True, capture_output=True,
                          text=True).stdout


def census_library(library: Path, select: Optional[str] = None
                   ) -> Dict[str, KernelCensus]:
    """``census_text`` of the SASS of a built library."""
    return census_text(sass_listing(library), select)
