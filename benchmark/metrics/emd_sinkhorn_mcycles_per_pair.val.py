"""The EMD kernel's Sinkhorn warm start in millions of clock cycles a pair:
the program's ``emd.sinkhorn_cycles`` (each pair's SM clock cycles from the
start to the end of the kernel's Sinkhorn phase, summed over its pairs) over
its ``emd.pairs``, both counted in the traced window. Beside the kernel's
time, it tells the Sinkhorn from the auction. Read from the program's
recorder; a program that does not count the cycles gives nothing."""


def read(info):
    if not info.traced_s:
        return None
    try:
        from difffacto_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()
    pairs, cycles = counts.get("emd.pairs"), counts.get("emd.sinkhorn_cycles")
    if not pairs or not cycles:
        return None
    return cycles / pairs / 1e6
