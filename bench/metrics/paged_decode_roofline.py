"""The paged decode kernel and its combine against their roof: the least
time the card needs for the bytes and operations of the traced calls
(each active slot's K/V rows at its length at that step,
``work/attention.py::paged_decode``) over the kernels' summed device
time."""
from work import attention


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["decode_work"]:
        return None
    return attention.roofline_pct(tr["decode_work"], tr["decode_kernel_s"],
                                  rec["peaks"])
