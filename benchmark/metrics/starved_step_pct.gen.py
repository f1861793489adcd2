"""The share of the chain's steps that the host began with the card's stream
already drained: the program's ``chain.starved_steps`` over its
``chain.steps``, both counted in the traced window. Read from the program's
recorder; a program without one gives nothing."""


def read(info):
    if not info.traced_s:
        return None
    try:
        from difffacto_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()
    steps = counts.get("chain.steps")
    if not steps:
        return None
    return 100.0 * counts.get("chain.starved_steps", 0) / steps
