"""The host work of ``evaluate_gen`` a protocol: the wall of the program's
``evaluate_gen`` spans in the traced window less the walls of their
``resample`` and ``sweep`` children (the normalisation, the cache key's
hash, the arrays, ``knn`` and ``lgan_mmd_cov``), over the traced protocols.
Read from the program's recorder; a program without one gives nothing."""

CHILDREN = ("resample", "sweep")


def read(info):
    protocols = info.traced_counts.get("protocols")
    if not info.traced_s or not protocols:
        return None
    try:
        from difffacto_torch.utils import trace
    except ImportError:
        return None
    spans = trace.spans()
    roots = {i for i, s in enumerate(spans) if s.name == "evaluate_gen" and s.end is not None}
    if not roots:
        return None
    wall = sum(spans[i].end - spans[i].start for i in roots)
    covered = sum(s.end - s.start for s in spans
                  if s.parent in roots and s.name in CHILDREN and s.end is not None)
    return 1e3 * (wall - covered) / protocols
