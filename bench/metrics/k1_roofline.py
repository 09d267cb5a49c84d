"""Kernel K1 (``stats_update_live_kernel``, the in-place round close over
page-locked host banks): the host-link bound of the live rows' bytes
over the kernel's time, in %, summed over the round closes of the
profiled cycles."""
from peaks import k1_link_bound_s


def read(trace):
    times = [d for name, ds in trace.kernels.items()
             if "stats_update_live" in name for d in ds]
    if not times or len(times) != len(trace.closes):
        return None
    bound = sum(k1_link_bound_s(live, trace.grid) for live in trace.closes)
    return 100.0 * bound / sum(times)
