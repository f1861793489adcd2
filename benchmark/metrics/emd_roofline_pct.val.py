"""The EMD kernel's share of its roofline: the least time for the pairs it
scored (counts.pair_bound_s: each pair's n x n distances once at the float32
peak, or its clouds read once, the larger) over its device time in the
trace. The count is of the problem, not of the algorithm's iterations."""

import counts
import readers

PATTERN = r"emd_hybrid_kernel"  # B5, csrc/emd_hybrid.cu
POINTS = 2048


def read(info):
    seconds, launches = readers.kernel_time(info, PATTERN)
    pairs = info.traced_counts.get("pairs")
    if not launches or not pairs:
        return None
    return 100.0 * pairs * counts.pair_bound_s(POINTS)[0] / seconds
