"""The operations and bytes an attention kernel's call needs, from its
shapes and lengths, and the least time the card could take for them.

Frozen copies, kept with the benchmark so that no change to the program
moves its yardstick: ``bound_s`` is ``chip_smoke.py::bound_ms``; the
byte models are those of the port's trip models
(``kernels/decode_attention/paged.py``, ``prefill_paged.py`` and
``kernels/flash_attention/flash.py``: q read once, out written once, the
K/V rows attended read once, the live block-table entries and the
lengths), and the operations are ``chip_smoke.py::work``'s, 4 x the
(query, key) pairs attended x heads x head size (QK and PV), causal
pairs counted once.  Where the trip models count a slot the call was
given but does not need (a paged decode slot that is inactive this step,
a prefill row past its grant), the needed work leaves it out.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np


def bound_s(nbytes: float, flops: float, peaks: Dict) -> float:
    """Least seconds for ``nbytes`` moved and ``flops`` done in bf16: the
    larger of the two times."""
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["bf16_flops_per_s"])


def paged_decode(kv_len: np.ndarray, active: np.ndarray, H: int, KV: int,
                 D: int, page: int, elt: int = 2) -> Tuple[int, int]:
    """One call of the paged decode kernel (and its combine) for one
    layer: slot b attends kv_len[b] rows where ``active[b]``.  Returns
    (bytes, flops)."""
    n = np.where(active, kv_len, 0).astype(np.int64)
    live = int(np.count_nonzero(active))
    rows = int(n.sum())
    nbytes = (2 * live * H * D * elt              # q read, out written
              + 2 * rows * KV * D * elt            # K and V rows
              + 4 * int((-(-n // page)).sum())     # live table entries
              + 4 * live)                          # lengths
    return nbytes, 4 * rows * H * D


def paged_prefill(base: np.ndarray, grants: np.ndarray, H: int, KV: int,
                  D: int, page: int, elt: int = 2) -> Tuple[int, int]:
    """One call of the paged prefill kernel for one layer: slot b's
    ``grants[b]`` query rows at positions base[b] .. base[b] + g - 1, each
    attending causally over [0, its position].  Returns (bytes, flops)."""
    g = np.asarray(grants, dtype=np.int64)
    b0 = np.asarray(base, dtype=np.int64)
    end = b0 + g                                   # rows read per slot
    end = np.where(g > 0, end, 0)
    # (query, key) pairs: sum over t < g of (b0 + t + 1)
    pairs = int((g * b0 + g * (g + 1) // 2).sum())
    nbytes = (2 * int(g.sum()) * H * D * elt
              + 2 * int(end.sum()) * KV * D * elt
              + 4 * int((-(-end // page)).sum())
              + 8 * int(np.count_nonzero(g)))
    return nbytes, 4 * pairs * H * D


def flash(B: int, S: int, T: int, H: int, KV: int, D: int, causal: bool,
          with_lse: bool, elt: int = 2) -> Tuple[int, int]:
    """One call of the flash forward kernel (with L for training): top-left
    causal masking, row s sees keys <= s.  Returns (bytes, flops)."""
    seen = min(S, T) if causal else T
    if causal:
        pairs = S * (S + 1) // 2 if S <= T else \
            T * (T + 1) // 2 + (S - T) * T
    else:
        pairs = S * T
    nbytes = (2 * B * S * H * D * elt + 2 * B * seen * KV * D * elt
              + 4 * B * S * H * with_lse)
    return nbytes, 4 * B * pairs * H * D


def roofline_pct(works: Iterable[Tuple[int, int]], device_s: float,
                 peaks: Dict):
    """100 x (least time for the calls' needed work) / (their summed
    device time); None where no call or no time was seen."""
    need = sum(bound_s(b, f, peaks) for b, f in works)
    if device_s <= 0 or need <= 0:
        return None
    return 100.0 * need / device_s
