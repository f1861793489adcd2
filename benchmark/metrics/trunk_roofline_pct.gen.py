"""The trunk kernel's share of its roofline in generation: the least time
of one launch (counts.trunk_bound_s: operations at the bf16 peak against
bytes at HBM's rate) over the mean launch's device time in the trace."""

import counts
import readers

PATTERN = r"fused_core_kernel"  # B1, csrc/trunk.cuh through csrc/fused_core.cu


def read(info):
    seconds, launches = readers.kernel_time(info, PATTERN)
    if not launches:
        return None
    bound, _ = counts.trunk_bound_s(info.config["model"], info.traffic["batch"])
    return 100.0 * bound / (seconds / launches)
