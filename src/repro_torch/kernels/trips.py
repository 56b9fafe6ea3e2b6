"""Trip models of the port's looped kernels: what one call launches and
how often each warp runs each marked loop.

A loop whose trip count the instruction census scales by opens its body
with ``REPRO_TRIP(name)`` in ``csrc/`` (``core/sass_counters.py`` ties the
SASS loops to those names).  For one call with given arguments, a
wrapper's trip model gives every CUDA launch as a ``Launch``: the SASS
function of the instantiation, the grid, the threads per block, and for
every marked loop the trip count of each time a warp reaches it.  A warp
iterates while any of its lanes does, so a loop strided over the block's
threads, ``for (e = tid; e < n; e += threads)``, runs as often as its
warp's lowest thread: ``strided``.  Beside the trips, the launch's bytes
in device memory: its inputs read once and outputs written once
(``io_bytes``), and the scratch it writes or reads between the launches
of one call (``scratch_bytes``: the split kernels' partials).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

WARP = 32


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def strided(n: int, stride: int, threads: int) -> np.ndarray:
    """Per-warp trips of ``for (e = tid; e < n; e += stride)`` over a
    block of ``threads``: warp w runs as often as its thread 32 w."""
    first = np.arange(0, threads, WARP)
    return np.maximum(0, -((first - n) // stride)).astype(np.int64)


@dataclasses.dataclass
class Launch:
    """One CUDA launch: ``function``, a regular expression that matches
    the instantiation's SASS name; ``grid`` and ``threads``; ``trips``,
    {marker: (warp ids, trips)}, one pair for each time a warp reaches the
    loop (warp id = block id x warps a block + warp, block id = x + gx (y
    + gy z)); ``steps``, the induction step of a marked loop whose header
    names a template constant; the bytes in device memory."""

    function: str
    grid: tuple
    threads: int
    io_bytes: int = 0
    scratch_bytes: int = 0
    steps: Dict[str, int] = dataclasses.field(default_factory=dict)
    trips: Dict[str, List[np.ndarray]] = dataclasses.field(
        default_factory=dict)       # marker: [(warp ids, trips, times)]

    @property
    def warps_per_block(self) -> int:
        return cdiv(self.threads, WARP)

    @property
    def warps(self) -> int:
        return int(np.prod(self.grid)) * self.warps_per_block

    @property
    def bytes(self) -> int:
        return self.io_bytes + self.scratch_bytes

    def add(self, marker: str, warps, n, times=1) -> None:
        """Warps ``warps`` each reach loop ``marker`` ``times`` times and
        run it ``n`` times on each (``n`` and ``times`` broadcast against
        ``warps``)."""
        warps = np.asarray(warps, dtype=np.int64).ravel()
        n = np.broadcast_to(np.asarray(n, dtype=np.int64), warps.shape)
        t = np.broadcast_to(np.asarray(times, dtype=np.int64), warps.shape)
        self.trips.setdefault(marker, []).append(np.stack([warps, n, t]))

    def entries(self) -> Dict[str, tuple]:
        """{marker: (trips, times)} over all warps: how many times a warp
        reached the loop with each trip count, what the census scales its
        loops by."""
        out = {}
        for k, v in self.trips.items():
            a = np.concatenate(v, axis=1)
            out[k] = (a[1], a[2])
        return out

    def per_warp(self) -> Dict[str, np.ndarray]:
        """{marker: each warp's iterations in all}: what the emulated
        kernels count through REPRO_TRIP."""
        out = {}
        for k, v in self.trips.items():
            a = np.concatenate(v, axis=1)
            out[k] = np.bincount(a[0], weights=a[1] * a[2],
                                 minlength=self.warps).astype(np.int64)
        return out


def warps_of(blocks, per_block: int):
    """(warp ids, warp index within its block) of every warp of
    ``blocks``, block by block."""
    blocks = np.asarray(blocks, dtype=np.int64).ravel()
    w = np.arange(per_block)
    return ((blocks[:, None] * per_block + w).ravel(),
            np.tile(w, len(blocks)))


# the mangled type names of the kernels' template arguments
MANGLED = {"float32": "f", "bfloat16": "13__nv_bfloat16", "int8": "a"}


def mangled(dtype) -> str:
    return MANGLED[str(dtype).replace("torch.", "")]
