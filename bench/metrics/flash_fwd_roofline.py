"""The flash forward kernel with L (training's instantiation, forward
and remat recompute) against its roof: the least time for the traced
step's calls' needed work (``work/attention.py::flash``, causal pairs
counted once) over the kernel's summed device time."""
from work import attention


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["flash_work"]:
        return None
    return attention.roofline_pct(tr["flash_work"], tr["flash_kernel_s"],
                                  rec["peaks"])
