"""The EMD auction's bids a pair: the program's ``emd.bids`` (the unassigned
rows of every round, and the rows force-assigned at the end, summed over the
kernel's pairs) over its ``emd.pairs``, both counted in the traced window.
Read from the program's recorder; a program without one gives nothing."""


def read(info):
    if not info.traced_s:
        return None
    try:
        from difffacto_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()
    pairs = counts.get("emd.pairs")
    if not pairs:
        return None
    return counts.get("emd.bids", 0) / pairs
