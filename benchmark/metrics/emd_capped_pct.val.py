"""The share of EMD pairs whose auction reached its round cap, after which
the rows left are force-assigned: the program's ``emd.capped_pairs`` over its
``emd.pairs``, both counted in the traced window (a pair that finished on
the last round counts too). Read from the program's recorder; a program
without one gives nothing."""


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
    return 100.0 * counts.get("emd.capped_pairs", 0) / pairs
