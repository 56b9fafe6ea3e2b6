"""The paged prefill kernel against its roof: the least time for the
traced calls' needed bytes and operations (each granted row attending
causally, counted once; ``work/attention.py::paged_prefill``) over the
kernel's summed device time."""
from work import attention


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["prefill_work"]:
        return None
    return attention.roofline_pct(tr["prefill_work"], tr["prefill_kernel_s"],
                                  rec["peaks"])
