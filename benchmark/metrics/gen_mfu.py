"""The whole generation's share of the card's bf16 peak: the model's
operations a shape (counts.generation_flops_per_shape, from the
configuration's widths) times the shapes the window completed, over the
window."""

import counts


def read(info):
    shapes = info.counts.get("shapes")
    if not shapes:
        return None
    flops = shapes * counts.generation_flops_per_shape(info.config["model"])
    return 100.0 * flops / info.window_s / counts.PEAK_BF16_FLOPS
