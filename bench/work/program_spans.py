"""Reading the port's own spans (``repro_torch.spans``), which its engine
and trainer record while a ``torch.profiler`` session is live: in a
``--trace 1`` run, the traced ticks or steps.  A checkout whose port has
no span recorder gives no spans, and its readers no number."""
from __future__ import annotations

from typing import List, Tuple

WAITS = ("engine.upload", "engine.readback")


def _recorder():
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans


def named(name: str) -> list:
    """The finished spans named ``name``."""
    spans = _recorder()
    return [s for s in spans.take() if s.name == name] if spans else []


def roots(name: str) -> List[Tuple[object, list]]:
    """(root, its descendants) for each root span named ``name`` that ran
    on a CUDA device: those whose synchronizing calls the recorder
    counted (``syncs`` is None where no CUDA was in use, and an upload or
    a read back waits for no device)."""
    spans = _recorder()
    if spans is None:
        return []
    return [(r, kids) for r, kids in spans.trees(spans.take(), name)
            if r.syncs is not None]


def wait_ms(records: list) -> float:
    """The ms that the waits for the device among ``records`` take."""
    return sum(s.ms for s in records if s.name in WAITS)
