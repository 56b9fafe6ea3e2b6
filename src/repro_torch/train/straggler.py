"""Straggler detection: per-step wall-time EWMA with outlier flagging — a
copy of ``repro/train/straggler.py``, which uses no JAX.

The trainer feeds each step's host time in; across hosts, those whose
EWMA exceeds ``threshold`` x the fleet median for ``patience``
consecutive windows get their data shard re-assigned to a hot spare (see
``data.pipeline.SyntheticTokenPipeline.reassign``) and are queued for
drain/replacement; training never blocks on a single host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerConfig:
    alpha: float = 0.2               # EWMA smoothing
    threshold: float = 1.5           # x fleet median
    patience: int = 3


class StragglerMonitor:
    def __init__(self, n_hosts: int, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.ewma: Dict[int, Optional[float]] = {h: None
                                                 for h in range(n_hosts)}
        self.strikes: Dict[int, int] = {h: 0 for h in range(n_hosts)}

    def update(self, times: Dict[int, float]) -> List[int]:
        """Feed one step's per-host wall times; returns hosts flagged as
        stragglers this step."""
        a = self.cfg.alpha
        for h, t in times.items():
            prev = self.ewma[h]
            self.ewma[h] = t if prev is None else (1 - a) * prev + a * t
        vals = sorted(v for v in self.ewma.values() if v is not None)
        if not vals:
            return []
        median = vals[len(vals) // 2]
        flagged = []
        for h, v in self.ewma.items():
            if v is not None and v > self.cfg.threshold * median:
                self.strikes[h] += 1
                if self.strikes[h] >= self.cfg.patience:
                    flagged.append(h)
            else:
                self.strikes[h] = 0
        return flagged

    def reset(self, host: int) -> None:
        self.ewma[host] = None
        self.strikes[host] = 0
