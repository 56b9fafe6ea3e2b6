"""Device time of the kernels launched inside the prefill lane's range
(``Model.prefill_many_paged``) in the traced ticks, per thousand prompt
tokens granted there."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["prefill_tokens"] or not tr["parts"]["prefill lane"]:
        return None
    return 1e3 * tr["parts"]["prefill lane"] / (tr["prefill_tokens"] / 1e3)
