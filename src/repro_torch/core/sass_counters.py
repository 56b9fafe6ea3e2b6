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

A kernel with loops is counted by ``loop_census``, the counterpart of
``hlo_counters``' scaling of ``while`` bodies by their trip counts: its
basic blocks and natural loops, each loop tied by the source line of its
test (a build with ``-lineinfo``; ``line_info`` reads the lines with
``nvdisasm -g``) to the loop of ``csrc/`` whose body opens with
``REPRO_TRIP(name)``, its unroll factor read from the listing, and its
instructions per iteration on the shortest and the longest path through
its body.  ``LoopCensus.count`` scales them by the per-warp trip counts
of one launch (the wrappers' ``trip_model``s) into an interval [lo, hi]
of warp instructions.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

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


def _find_tool(name: str) -> str:
    """A CUDA binary tool from ``$CUDA_HOME/bin``, then ``PATH``, then the
    CUDA toolkit's default place, then the copy Triton's package carries
    under ``triton/backends/nvidia/bin/``.  Raises when there is none."""
    cands = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", name),
             shutil.which(name), f"/usr/local/cuda/bin/{name}"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(str(Path(spec.origin).parent / "backends" / "nvidia"
                         / "bin" / name))
    for cand in cands:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(f"{name} not found (CUDA_HOME, PATH, "
                       f"/usr/local/cuda/bin, triton/backends/nvidia/bin): "
                       f"the SASS census needs the CUDA toolkit's binary "
                       f"tools")


def find_cuobjdump() -> str:
    return _find_tool("cuobjdump")


def find_nvdisasm() -> str:
    return _find_tool("nvdisasm")


def sass_listing(library: Path) -> str:
    return subprocess.run([find_cuobjdump(), "-sass", str(library)],
                          check=True, capture_output=True,
                          text=True).stdout


def census_library(library: Path, select: Optional[str] = None
                   ) -> Dict[str, KernelCensus]:
    """``census_text`` of the SASS of a built library."""
    return census_text(sass_listing(library), select)


# ---------------------------------------------------------------------------
# Kernels with loops: the census scaled by the launch's trip counts
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "csrc"

_MARKER = re.compile(r"\bREPRO_TRIP\((\w+)\)\s*;")
_PRAGMA = re.compile(r"^\s*#\s*pragma\s+unroll(?:\s+(\d+))?\s*$")
_CONSTEXPR = re.compile(r"\bconstexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;")
_FILE_LINE = re.compile(r'//## File "([^"]+)", line (\d+)')
_NVD_FUNCTION = re.compile(r"^\.text\.(\S+):\s*$")
_NVD_ADDRESS = re.compile(r"^\s*/\*([0-9a-fA-F]+)\*/")
_IMMEDIATE = re.compile(r"^-?0x[0-9a-fA-F]+$")
_REGISTER = re.compile(r"^U?R\d+$")
# operations a copy of a loop body repeats and no copy can share: memory
# accesses, special functions, shuffles and tensor-core products
_WORK = {"LDG", "STG", "LDS", "STS", "LDSM", "LDGSTS", "MUFU", "SHFL",
         "HMMA", "ATOM", "ATOMS", "RED"}


@dataclasses.dataclass(frozen=True)
class SourceLoop:
    """A loop of the CUDA sources whose body opens with REPRO_TRIP(name)."""

    name: str
    file: str                  # the source's file name
    line: int                  # line of its ``for``
    end: int                   # line of its closing brace
    step: Optional[int]        # the induction step, where the header says
    pragma: Optional[int]      # N of a ``#pragma unroll N`` above it (0:
                               # a bare ``#pragma unroll``)


def _blank_comments(text: str) -> str:
    """``text`` with the characters of every comment blanked, newlines
    kept, so that offsets and line numbers stay as they were."""
    out, i, n = [], 0, len(text)
    while i < n:
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
        else:
            j = i + 1
            while j < n and text[j] not in "/":
                j += 1
            out.append(text[i:j])
            i = j
            continue
        out.append(re.sub(r"[^\n]", " ", text[i:j]))
        i = j
    return "".join(out)


def _back(code: str, i: int) -> int:
    while i >= 0 and code[i].isspace():
        i -= 1
    return i


def _step(header: str, consts: Dict[str, int]) -> Optional[int]:
    """The increment of a ``for`` header, where it is a literal or a
    ``constexpr int`` of the file."""
    parts, depth, cur = [], 0, ""
    for ch in header:
        depth += ch == "("
        depth -= ch == ")"
        if ch == ";" and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    inc = cur.replace(" ", "")
    if len(parts) != 2:
        return None
    if re.fullmatch(r"\+\+\w+|\w+\+\+", inc):
        return 1
    m = re.fullmatch(r"\w+\+=(\w+)", inc)
    if m is None:
        return None
    return int(m.group(1)) if m.group(1).isdigit() else consts.get(m.group(1))


def parse_source_loops(fname: str, text: str) -> List[SourceLoop]:
    """Every loop of one source whose body opens with ``REPRO_TRIP(name);``
    — the marker must be the body's first statement, after the brace of a
    ``for``.  Raises ValueError on a marker anywhere else."""
    code = _blank_comments(text)
    lines = text.split("\n")
    consts = {k: int(v) for k, v in _CONSTEXPR.findall(code)}
    out = []
    for m in _MARKER.finditer(code):
        where = f"{fname}:{code.count(chr(10), 0, m.start()) + 1}"
        brace = _back(code, m.start() - 1)
        close = _back(code, brace - 1)
        if brace < 0 or code[brace] != "{" or code[close] != ")":
            raise ValueError(f"{where}: REPRO_TRIP({m.group(1)}) must be "
                             f"the first statement of a loop's braced body")
        i, depth = close, 0
        while i >= 0:
            depth += (code[i] == ")") - (code[i] == "(")
            if depth == 0:
                break
            i -= 1
        kw = re.search(r"\bfor\s*$", code[:i])
        if kw is None:
            raise ValueError(f"{where}: REPRO_TRIP({m.group(1)}) opens no "
                             f"for loop's body")
        j, depth = brace, 0
        while j < len(code):
            depth += (code[j] == "{") - (code[j] == "}")
            if depth == 0:
                break
            j += 1
        line = code.count("\n", 0, kw.start()) + 1
        pm = _PRAGMA.match(lines[line - 2]) if line >= 2 else None
        out.append(SourceLoop(
            name=m.group(1), file=fname, line=line,
            end=code.count("\n", 0, j) + 1,
            step=_step(code[i + 1:close], consts),
            pragma=None if pm is None else int(pm.group(1) or 0)))
    return out


def source_loops(csrc: Optional[Path] = None) -> Dict[str, SourceLoop]:
    """{marker name: SourceLoop} over every ``*.cu`` and ``*.cuh`` of
    ``csrc`` (the port's sources by default).  Names are unique."""
    out: Dict[str, SourceLoop] = {}
    for f in sorted(Path(csrc or CSRC).glob("*.cu*")):
        for loop in parse_source_loops(f.name, f.read_text()):
            if loop.name in out:
                raise ValueError(f"REPRO_TRIP({loop.name}) marks two loops")
            out[loop.name] = loop
    return out


def parse_line_info(text: str) -> Dict[str, Dict[int, Tuple[str, int]]]:
    """{function: {address: (file name, line)}} from ``nvdisasm -g``: the
    source line of every instruction of a build with ``-lineinfo``."""
    out: Dict[str, Dict[int, Tuple[str, int]]] = {}
    fn, cur = None, None
    for ln in text.splitlines():
        m = _NVD_FUNCTION.match(ln)
        if m:
            fn, cur = m.group(1), None
            out[fn] = {}
            continue
        m = _FILE_LINE.search(ln)
        if m:
            cur = (os.path.basename(m.group(1)), int(m.group(2)))
            continue
        m = _NVD_ADDRESS.match(ln)
        if m and fn is not None and cur is not None:
            out[fn][int(m.group(1), 16)] = cur
    return out


def line_info(library: Path) -> Dict[str, Dict[int, Tuple[str, int]]]:
    """``parse_line_info`` over every cubin of a built library
    (``cuobjdump -xelf all``, then ``nvdisasm -g -c`` on each)."""
    out: Dict[str, Dict[int, Tuple[str, int]]] = {}
    with tempfile.TemporaryDirectory() as d:
        subprocess.run([find_cuobjdump(), "-xelf", "all",
                        str(Path(library).resolve())], cwd=d, check=True,
                       capture_output=True)
        for cubin in sorted(Path(d).glob("*.cubin")):
            out.update(parse_line_info(subprocess.run(
                [find_nvdisasm(), "-g", "-c", str(cubin)], check=True,
                capture_output=True, text=True).stdout))
    return out


@dataclasses.dataclass(frozen=True)
class _Inst:
    addr: int
    text: str                       # without its predicate
    base: str
    cls: str
    guard: Optional[str]            # e.g. "!P0"; None when unpredicated
    target: Optional[int]           # of a direct branch


def _inst(addr: int, text: str) -> _Inst:
    t = text.strip()
    m = _PREDICATE.match(t)
    guard = m.group(0).strip()[1:] if m else None
    if guard == "PT":
        guard = None
    base, ins = _base(t)
    target = None
    if base in _BRANCHES:
        hexes = re.findall(r"\b0x([0-9a-fA-F]+)\b", ins)
        if not hexes:
            raise LoopError(f"branch target not found at {addr:#x} ({ins})")
        target = int(hexes[-1], 16)
    return _Inst(addr, ins, base, opcode_class(base), guard, target)


def _operands(ins: str) -> List[str]:
    parts = ins.split(None, 1)
    return [o.strip().replace(".reuse", "") for o in parts[1].split(",")] \
        if len(parts) > 1 else []


def _conditional(i: _Inst) -> bool:
    """A branch that may fall through: predicated, or with an operand
    besides its target (``BRA.DIV UR4, 0x...``)."""
    return i.guard is not None or len(_operands(i.text)) > 1


@dataclasses.dataclass(frozen=True)
class Loop:
    """One loop of a kernel's SASS, tied to its source loop."""

    header: int                     # address of its first instruction
    back_edges: Tuple[int, ...]     # addresses of its backward branches
    source: str                     # the REPRO_TRIP name of its source loop
    where: str                      # "file:line" of its control
    unroll: int                     # source iterations per SASS iteration
    parent: Optional[int]           # header of the enclosing SASS loop
    lo: Dict[str, int]              # instructions per iteration by class:
    hi: Dict[str, int]              # shortest and longest path


def _add(a: Dict[str, int], b: Dict[str, int], k: int = 1) -> Dict[str, int]:
    return {c: a[c] + k * b[c] for c in CLASSES}


def _total(d: Dict[str, int]) -> int:
    return sum(d.values())


@dataclasses.dataclass(frozen=True)
class LoopCensus:
    """The census of a kernel with loops: its straight-line part (the path
    outside every loop, per warp) and each loop's cost per iteration; the
    counts follow from the launch's trip counts (``count``)."""

    name: str
    top_lo: Dict[str, int]
    top_hi: Dict[str, int]
    loops: Tuple[Loop, ...]

    def sources(self) -> List[str]:
        return sorted({lp.source for lp in self.loops})

    def count(self, trips: Dict[str, Sequence[int]], warps: int
              ) -> Tuple[Dict[str, int], Dict[str, int]]:
        """(lo, hi) warp instructions by class over ``warps`` warps whose
        source loops ran the per-warp trip counts ``trips``: {marker name:
        every entry's iterations, over all the warps, zeros included}, or
        {marker name: (iterations, times each was entered)}.
        A source loop's SASS loops split its iterations by their unroll
        factors, largest first: a loop unrolled by 4 runs n // 4 times
        and its remainder loop n % 4 (a remainder nvcc peeled into
        straight-line code is on the paths of the enclosing code)."""
        lo = {c: warps * v for c, v in self.top_lo.items()}
        hi = {c: warps * v for c, v in self.top_hi.items()}
        for src in self.sources():
            if src not in trips:
                raise KeyError(f"{self.name}: no trip counts for the loop "
                               f"REPRO_TRIP({src})")
            t = trips[src]
            n, times = (t if isinstance(t, tuple) else (t, 1))
            n = np.asarray(n, dtype=np.int64)
            times = np.broadcast_to(np.asarray(times, dtype=np.int64),
                                    n.shape)
            rem = n
            mine = [lp for lp in self.loops if lp.source == src]
            for u in sorted({lp.unroll for lp in mine}, reverse=True):
                same = [lp for lp in mine if lp.unroll == u]
                iters = int(((rem // u) * times).sum())
                rem = rem % u
                lo = _add(lo, min((lp.lo for lp in same), key=_total), iters)
                hi = _add(hi, max((lp.hi for lp in same), key=_total), iters)
        return lo, hi


def _blocks(name: str, insts: List[_Inst]):
    """Basic blocks: (first, last + 1) index ranges, their successors
    (block ids), over the instructions reachable from the entry."""
    index = {i.addr: k for k, i in enumerate(insts)}
    leaders = {0}
    for k, i in enumerate(insts):
        if i.base in _INDIRECT:
            leaders.add(k + 1)
        elif i.base in _BRANCHES:
            if i.target not in index:
                raise LoopError(f"{name}: branch at {i.addr:#x} to "
                                f"{i.target:#x}, no instruction there")
            leaders.update((index[i.target], k + 1))
        elif i.base in ("EXIT", "RET", "KILL"):
            leaders.add(k + 1)
    starts = sorted(x for x in leaders if x < len(insts))
    ranges = [(a, b) for a, b in zip(starts, starts[1:] + [len(insts)])]
    block_of = {a: b for b, (a, _) in enumerate(ranges)}
    succ: List[List[int]] = []
    for a, b in ranges:
        last = insts[b - 1]
        nxt = [block_of[b]] if b < len(insts) else []
        if last.base in _INDIRECT:
            succ.append([])
        elif last.base in _BRANCHES:
            tgt = [block_of[index[last.target]]]
            succ.append(tgt + nxt if _conditional(last) else tgt)
        elif last.base in ("EXIT", "RET", "KILL"):
            succ.append(nxt if last.guard is not None else [])
        else:
            succ.append(nxt)
    seen, stack = {0}, [0]
    while stack:
        for s in succ[stack.pop()]:
            if s not in seen:
                seen.add(s)
                stack.append(s)
    for bid in seen:
        last = insts[ranges[bid][1] - 1]
        if last.base in _INDIRECT:
            raise LoopError(f"{name}: indirect branch at {last.addr:#x} "
                            f"({last.text}): its targets are not in the "
                            f"listing")
    return ranges, succ, seen


def _dominators(succ, nodes, entry=0):
    order, seen = [], set()

    def post(n):                     # iterative post-order
        stack = [(n, iter(succ[n]))]
        seen.add(n)
        while stack:
            node, it = stack[-1]
            for s in it:
                if s in nodes and s not in seen:
                    seen.add(s)
                    stack.append((s, iter(succ[s])))
                    break
            else:
                order.append(node)
                stack.pop()
    post(entry)
    rpo = order[::-1]
    num = {n: k for k, n in enumerate(rpo)}
    preds = {n: [] for n in rpo}
    for n in rpo:
        for s in succ[n]:
            if s in num:
                preds[s].append(n)
    idom = {entry: entry}

    def meet(a, b):
        while a != b:
            while num[a] > num[b]:
                a = idom[a]
            while num[b] > num[a]:
                b = idom[b]
        return a
    changed = True
    while changed:
        changed = False
        for n in rpo[1:]:
            ps = [p for p in preds[n] if p in idom]
            new = ps[0]
            for p in ps[1:]:
                new = meet(p, new)
            if idom.get(n) != new:
                idom[n] = new
                changed = True
    return idom, num


def _dominates(idom, a, b):
    while True:
        if a == b:
            return True
        if idom[b] == b:
            return False
        b = idom[b]


def _path(nodes, succ, start, weight, ends):
    """Shortest and longest path (by total instructions, with its counts
    by class) from ``start`` over the acyclic ``succ`` restricted to
    ``nodes``, ending where ``ends(node)`` allows (True: a path may stop
    after the node)."""
    order, seen = [], {start}
    stack = [(start, iter(succ[start]))]
    while stack:
        node, it = stack[-1]
        for s in it:
            if s in nodes and s not in seen:
                seen.add(s)
                stack.append((s, iter(succ[s])))
                break
        else:
            order.append(node)
            stack.pop()
    inf = (float("inf"), None)
    best_lo, best_hi = {}, {}
    for n in order:                   # successors first
        w = weight(n)
        cand_lo = [(0, None)] if ends(n) else []
        cand_hi = list(cand_lo)
        for s in succ[n]:
            if s in best_lo and best_lo[s][0] != inf[0]:
                cand_lo.append(best_lo[s])
                cand_hi.append(best_hi[s])
        if not cand_lo:
            best_lo[n] = best_hi[n] = inf
            continue
        lo = min(cand_lo, key=lambda x: x[0])
        hi = max(cand_hi, key=lambda x: x[0])
        best_lo[n] = (lo[0] + _total(w), _add(w, lo[1]) if lo[1] else w)
        best_hi[n] = (hi[0] + _total(w), _add(w, hi[1]) if hi[1] else w)
    if best_lo[start][0] == inf[0]:
        return None
    return best_lo[start][1], best_hi[start][1]


def _dest(i: _Inst) -> Optional[str]:
    ops = _operands(i.text)
    return ops[0] if ops else None


def _signed(imm: str) -> int:
    v = int(imm, 16) if not imm.startswith("-") else -int(imm[1:], 16)
    return v - (1 << 32) if v >= 1 << 31 else v


def _add_imm(i: _Inst) -> Optional[Tuple[str, int]]:
    """(source register, immediate) of ``dst = src + imm`` (VIADD, IADD3,
    UIADD3) or of a copy ``dst = src`` (MOV, UMOV, IMAD.MOV.U32), else
    None."""
    ops = _operands(i.text)[1:]
    op = i.text.split()[0]
    zero = {"RZ", "URZ"}
    regs = [o for o in ops if _REGISTER.match(o)]
    imms = [o for o in ops if _IMMEDIATE.match(o)]
    if len(regs) + len(imms) + sum(o in zero for o in ops) != len(ops) \
            or len(regs) != 1:
        return None
    if op.split(".")[0] in ("VIADD", "IADD3", "UIADD3") and len(imms) == 1:
        return regs[0], _signed(imms[0])
    if op in ("MOV", "UMOV", "IMAD.MOV.U32") and not imms:
        return regs[0], 0
    return None


def _def_of(reg: str, k: int, ins, ranges, preds, loop, own
            ) -> Optional[int]:
    """Index of the definition of ``reg`` that reaches instruction ``k``:
    the last writer before it in its block or in the chain of single
    predecessors above it inside the loop; failing that, the register's
    one definition in the loop's own code (carried round the back edge).
    None when there is no single such definition."""
    b = next(b for b, (a, e) in enumerate(ranges) if a <= k < e)
    end = k
    while True:
        for j in range(end - 1, ranges[b][0] - 1, -1):
            if _dest(ins[j]) == reg:
                return j
        ps = preds[b]
        if len(ps) != 1 or ps[0] not in loop:
            break
        b = ps[0]
        end = ranges[b][1]
    defs = [j for j in own if _dest(ins[j]) == reg]
    return defs[0] if len(defs) == 1 else None


def _induction(k: int, ins, ranges, preds, loop, own
               ) -> Optional[Tuple[int, bool, set]]:
    """The induction variable of the loop branch at index ``k``: (its step,
    whether it counts trips down to zero, the registers of its cycle),
    from the compare that sets the branch's predicate and the chain of
    add-immediates and copies that carries one of its operands round the
    loop back to itself.  None where there is no such chain."""
    br = ins[k]
    p = (br.guard or "").lstrip("!")
    w = _def_of(p, k, ins, ranges, preds, loop, own) if p else None
    for _ in range(2):                   # through a copy of a predicate
        ops = _operands(ins[w].text) if w is not None else []
        src = [o.lstrip("!") for o in ops[1:] if re.fullmatch(
            r"!?U?P\d+", o)]
        if w is None or ins[w].base != "PLOP3" or len(src) != 1:
            break
        w = _def_of(src[0], w, ins, ranges, preds, loop, own)
    if w is None or not ins[w].base.endswith("ISETP"):
        return None
    ops = _operands(ins[w].text)
    for reg in ops[2:4]:
        if not _REGISTER.match(reg):
            continue
        chain, cur, at = [], reg, w
        for _ in range(8):
            d = _def_of(cur, at, ins, ranges, preds, loop, own)
            step = _add_imm(ins[d]) if d is not None else None
            if step is None:
                break
            if d in [x for x, _, _ in chain]:
                cyc = chain[[x for x, _, _ in chain].index(d):]
                total = sum(c for _, c, _ in cyc)
                if total:
                    counter = ins[w].text.split()[0].split(".")[1] == "NE" \
                        and {"RZ", "URZ"} & set(ops[2:4])
                    return total, bool(counter), {r for _, _, r in cyc} | {
                        _dest(ins[x]) for x, _, _ in cyc}
                break
            chain.append((d, step[1], step[0]))
            cur, at = step[0], d
    return None


def _work(own: List[int], ins, lines, src: SourceLoop
          ) -> Dict[Tuple[int, str], int]:
    """{(line, opcode): count} of the operations of ``_WORK`` on the lines
    of the source loop's body in one iteration of a SASS loop."""
    counts: Dict[Tuple[int, str], int] = {}
    for k in own:
        fl = lines.get(ins[k].addr)
        if ins[k].base in _WORK and fl and fl[0] == src.file and \
                src.line < fl[1] <= src.end:
            key = (fl[1], ins[k].base)
            counts[key] = counts.get(key, 0) + 1
    return counts


def _copies(mine: Dict[Tuple[int, str], int],
            single: Dict[Tuple[int, str], int]) -> Optional[int]:
    """Copies of the body in a SASS loop, against a loop of the same
    source that holds one (its remainder loop): the common ratio of their
    counts of each operation on each line of the body.  None where there
    is nothing to count or the ratios differ (code hoisted out of one)."""
    if not single or set(mine) != set(single):
        return None
    ratios = {mine[k] / single[k] for k in mine}
    r = ratios.pop() if len(ratios) == 1 else 0
    return int(r) if r >= 1 and r == int(r) else None


def loop_census(name: str, insts: List[Tuple[int, str]],
                lines: Dict[int, Tuple[str, int]],
                sources: Dict[str, SourceLoop],
                steps: Optional[Dict[str, int]] = None) -> LoopCensus:
    """The census of one kernel that may loop: its basic blocks and their
    natural loops (a back edge and the blocks it dominates that reach
    it), each tied by its control's source line (``lines``, from
    ``line_info``) to the innermost loop marked ``REPRO_TRIP`` around that
    line (``sources``), with its unroll factor read from the listing, and
    each loop's instructions per iteration on the shortest and on the
    longest path through its body.  Raises LoopError on an indirect
    branch, an irreducible loop, a loop tied to no marked source loop, and
    an unroll factor that cannot be read or is read two ways.  ``steps``
    gives the induction step of a marked loop whose header names a
    template's constant (the launch's threads per block, say)."""
    ins = [_inst(a, t) for a, t in insts]
    ranges, succ, reach = _blocks(name, ins)
    idom, _ = _dominators(succ, reach)
    preds: Dict[int, List[int]] = {b: [] for b in reach}
    for b in reach:
        for s in succ[b]:
            preds[s].append(b)

    latches: Dict[int, List[int]] = {}
    color = {0: 1}
    stack = [(0, iter(succ[0]))]
    while stack:                         # retreating edges of a DFS
        node, it = stack[-1]
        for s in it:
            if color.get(s) == 1:
                if not _dominates(idom, s, node):
                    a = ins[ranges[node][1] - 1].addr
                    raise LoopError(
                        f"{name}: irreducible loop: the branch at {a:#x} "
                        f"goes back to {ins[ranges[s][0]].addr:#x}, which "
                        f"does not dominate it")
                latches.setdefault(s, []).append(node)
            elif s not in color:
                color[s] = 1
                stack.append((s, iter(succ[s])))
                break
        else:
            color[node] = 2
            stack.pop()

    body: Dict[int, set] = {}
    for h, ls in latches.items():
        b, work = {h}, [x for x in ls if x != h]
        b.update(work)
        while work:
            for p in preds[work.pop()]:
                if p not in b:
                    b.add(p)
                    work.append(p)
        body[h] = b
    parent: Dict[int, Optional[int]] = {}
    for h in body:
        outer = [g for g in body if g != h and body[h] <= body[g]]
        for g in body:
            if g != h and body[h] & body[g] and not (
                    body[h] <= body[g] or body[g] <= body[h]):
                raise LoopError(f"{name}: loops at "
                                f"{ins[ranges[h][0]].addr:#x} and "
                                f"{ins[ranges[g][0]].addr:#x} overlap")
        parent[h] = min(outer, key=lambda g: len(body[g])) if outer else None
    inner: Dict[int, int] = {}
    for h in sorted(body, key=lambda g: -len(body[g])):
        for b in body[h]:
            inner[b] = h

    zero = {c: 0 for c in CLASSES}
    weights = {}
    for b in reach:
        w = dict(zero)
        for i in ins[ranges[b][0]:ranges[b][1]]:
            w[i.cls] += 1
        weights[b] = w

    def node(b, h):
        if inner.get(b) == h:
            return b
        c = inner[b]
        while parent[c] != h:
            c = parent[c]
        return ("L", c)

    def region(h):
        """The DAG of loop h's body (of the function outside loops when h
        is None): own blocks and child loops as nodes; which nodes end an
        iteration at the back edge, which leave the loop."""
        own = [b for b in reach if inner.get(b) == h]
        kids = [c for c in body if parent[c] == h]
        dag, back_end, exit_end = {}, set(), set()
        members = [(b, [b]) for b in own] + [(("L", c), sorted(body[c]))
                                             for c in kids]
        for n, blocks in members:
            dag[n] = []
            for b in blocks:
                for s in succ[b]:
                    if n != b and s in body[n[1]]:
                        continue
                    if h is not None and s not in body[h]:
                        exit_end.add(n)
                    elif h is not None and s == h:
                        back_end.add(n)
                    else:
                        dag[n].append(node(s, h))
        return own, dag, back_end, exit_end

    def weight(n):
        return zero if isinstance(n, tuple) else weights[n]

    index = {id(i): k for k, i in enumerate(ins)}
    loops = []
    for h in sorted(body, key=lambda g: ranges[g][0]):
        own, dag, back_end, exit_end = region(h)
        paths = _path(set(dag), dag, h, weight,
                      lambda n: n in back_end or n in exit_end)
        if paths is None:
            raise LoopError(f"{name}: the loop at {ins[ranges[h][0]].addr:#x}"
                            f" has no path through its body")
        controls = []
        for lt in latches[h]:
            br = ins[ranges[lt][1] - 1]
            if br.base in _BRANCHES and _conditional(br):
                controls.append(br)
        if not controls:                  # unconditional back edge: the
            for b in own:                 # tests that leave the loop
                last = ins[ranges[b][1] - 1]
                if any(s not in body[h] for s in succ[b]) and \
                        last.base in _BRANCHES and _conditional(last):
                    controls.append(last)
        if not controls:
            raise LoopError(f"{name}: the loop at "
                            f"{ins[ranges[h][0]].addr:#x} has no test")
        ties = set()
        for c in controls:
            fl = lines.get(c.addr)
            if fl is None:
                raise LoopError(f"{name}: no source line for the branch at "
                                f"{c.addr:#x}: build with -lineinfo")
            around = [s for s in sources.values() if s.file == fl[0]
                      and s.line <= fl[1] <= s.end]
            if not around:
                raise LoopError(f"{name}: the loop branch at {c.addr:#x} "
                                f"({fl[0]}:{fl[1]}) lies in no loop marked "
                                f"REPRO_TRIP")
            ties.add((max(around, key=lambda s: s.line).name,
                      f"{fl[0]}:{fl[1]}"))
        if len({t[0] for t in ties}) != 1:
            raise LoopError(f"{name}: the loop at "
                            f"{ins[ranges[h][0]].addr:#x} is tied to "
                            f"several source loops: {sorted(ties)}")
        src, where = sorted(ties)[0]
        own_idx = [k for b in own for k in range(*ranges[b])]
        step = None
        for c in controls:               # the induction variable's step
            iv = _induction(index[id(c)], ins, ranges, preds, body[h],
                            own_idx)
            if iv is None:
                continue
            step = (abs(iv[0]), iv[1])
            break
        loops.append(dict(h=h, src=src, where=where, step=step,
                          work=_work(own_idx, ins, lines, sources[src]),
                          lo=paths[0], hi=paths[1]))

    for lp in loops:
        s_step = (steps or {}).get(lp["src"], sources[lp["src"]].step)
        lp["induction"] = None
        if lp["step"] is not None:
            mag, counter = lp["step"]
            if s_step and mag % abs(s_step) == 0:
                lp["induction"] = mag // abs(s_step)
            elif counter:
                lp["induction"] = mag
    out = []
    for lp in loops:
        s = sources[lp["src"]]
        mine = [x for x in loops if x["src"] == lp["src"]]
        known = [x["induction"] for x in mine if x["induction"]]
        readings = {}
        if lp["induction"]:
            readings["induction step"] = lp["induction"]
        single = [x for x in mine if x is not lp and x["induction"] == 1]
        copies = _copies(lp["work"], single[0]["work"]) if single and \
            lp["induction"] != 1 else None
        if copies:
            readings["copies of the body"] = copies
        if s.pragma == 0:
            raise LoopError(f"{name}: {s.file}:{s.line} is marked for full "
                            f"unrolling, yet the SASS loops at "
                            f"{ins[ranges[lp['h']][0]].addr:#x}")
        if s.pragma and (lp["induction"] is None
                         or lp["induction"] == max(known)):
            readings["#pragma unroll"] = s.pragma
        addr = ins[ranges[lp["h"]][0]].addr
        vals = set(readings.values())
        if not vals:
            raise LoopError(f"{name}: no reading of the unroll factor of the "
                            f"loop at {addr:#x} ({lp['where']}, "
                            f"REPRO_TRIP({lp['src']}))")
        if len(vals) != 1:
            raise LoopError(f"{name}: the unroll factor of the loop at "
                            f"{addr:#x} ({lp['where']}, REPRO_TRIP("
                            f"{lp['src']})) is read two ways: {readings}")
        par = parent[lp["h"]]
        out.append(Loop(
            header=addr,
            back_edges=tuple(ins[ranges[x][1] - 1].addr
                             for x in latches[lp["h"]]),
            source=lp["src"], where=lp["where"], unroll=vals.pop(),
            parent=None if par is None else ins[ranges[par][0]].addr,
            lo=lp["lo"], hi=lp["hi"]))

    _, dag, _, _ = region(None)
    top = _path(set(dag), dag, node(0, None), weight,
                lambda n: not isinstance(n, tuple)
                and ins[ranges[n][1] - 1].base == "EXIT")
    if top is None:
        raise ValueError(f"{name}: no path from the entry reaches an EXIT")
    return LoopCensus(name=name, top_lo=top[0], top_hi=top[1],
                      loops=tuple(out))


def count_looped(name: str, insts: List[Tuple[int, str]],
                 trips: Dict[str, Sequence[int]], warps: int = 1, *,
                 lines: Optional[Dict[int, Tuple[str, int]]] = None,
                 sources: Optional[Dict[str, SourceLoop]] = None
                 ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """(lo, hi) warp instructions by class of one kernel over ``warps``
    warps whose loops ran ``trips`` (``LoopCensus.count``).  ``lo == hi``
    where no forward branch inside a loop, or in the code around the
    loops, is taken on one path and not on the other; a predicated-off
    instruction still issues, so it counts."""
    census = loop_census(name, insts, lines or {},
                         sources if sources is not None else source_loops())
    return census.count(trips, warps)
