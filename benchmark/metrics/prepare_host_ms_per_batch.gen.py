"""The host wall of the latents a batch: the program's ``prepare_generation``
spans (the flow prior, the CIMLE aligner, the gather) in the traced window,
over the traced batches. Read from the program's recorder; a program without
one gives nothing."""


def read(info):
    batches = info.traced_counts.get("batches")
    if not info.traced_s or not batches:
        return None
    try:
        from difffacto_torch.utils import trace
    except ImportError:
        return None
    walls = [s.end - s.start for s in trace.spans()
             if s.name == "prepare_generation" and s.end is not None]
    if not walls:
        return None
    return 1e3 * sum(walls) / batches
