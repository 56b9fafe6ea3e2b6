"""Device time of the kernels launched inside the decode loop's range
(``Model.decode_many_paged``) in the traced ticks, per decode step."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["decode_steps"] or not tr["parts"]["decode loop"]:
        return None
    return 1e3 * tr["parts"]["decode loop"] / tr["decode_steps"]
