"""The pairwise sweep and host metrics per 1000 scored pairs: the host
wall of ``evaluate_gen`` in the traced window (FPS, Chamfer, the EMD
sweep, the copies and the host metrics; the generation of the set is
outside it), less the EMD kernel's device time in the trace."""

import readers

PATTERN = r"emd_hybrid_kernel"


def read(info):
    pairs = info.traced_counts.get("pairs")
    wall = sum(e - s for name, s, e in info.traced_spans if name == "evaluate_gen")
    if not pairs or not wall:
        return None
    seconds, _ = readers.kernel_time(info, PATTERN)
    return 1e3 * (wall - seconds) / (pairs / 1e3)
