"""The protocol's share of the card's peak: the least time of the window's
counted work (counts.protocol_bound_s: the generation at the bf16 peak,
every scored pair's distances once for Chamfer and for EMD at the float32
peak, the inputs read once) over the window. Both sets hold the
configuration's ``val_gen_shapes`` clouds of the model's ``npoints``."""

import counts


def read(info):
    protocols = info.counts.get("protocols")
    if not protocols:
        return None
    model, shapes = info.config["model"], info.config["val_gen_shapes"]
    least = protocols * counts.protocol_bound_s(model, shapes, shapes, model["npoints"])
    return 100.0 * least / info.window_s
