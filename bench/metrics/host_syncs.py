"""Synchronizing CUDA calls a tick or a step: over the traced span's root
spans (``engine.tick``, ``train.step``), the mean of the calls that the
port's span recorder counted in each root's subtree; shared by
``host_syncs.chat``, ``.rag`` and ``.train``.  None where nothing was
counted (no CUDA)."""
from work import program_spans as ps


def read(rec):
    counts = [r.n_syncs + sum(k.n_syncs for k in kids)
              for name in ("engine.tick", "train.step")
              for r, kids in ps.roots(name)]
    return sum(counts) / len(counts) if counts else None
