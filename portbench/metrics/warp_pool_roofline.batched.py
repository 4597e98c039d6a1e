"""The pool warp kernel's share of its roofline in the traced window: the
least time its launches could take (``yardstick.pool_warp_bound_s`` on the
reference's operands of the cell's calls) over the device time of the
operations named ``warp_pool_kernel``."""


def read(r):
    if r.trace is None or not r.warp_bound_s_per_call:
        return None
    seconds, launches = r.trace.seconds_of("warp_pool_kernel")
    if not launches:
        return None
    return r.warp_bound_s_per_call / r.warp_launches_per_call * launches / seconds * 100.0
