"""The FPS of the protocol's sets, with their copies in and out: the wall of
the program's ``resample`` spans in the traced window over the traced
protocols. Read from the program's recorder; a program without one gives
nothing."""


def read(info):
    protocols = info.traced_counts.get("protocols")
    if not info.traced_s or not protocols:
        return None
    try:
        from difffacto_torch.utils import trace
    except ImportError:
        return None
    walls = [s.end - s.start for s in trace.spans() if s.name == "resample" and s.end is not None]
    if not walls:
        return None
    return 1e3 * sum(walls) / protocols
