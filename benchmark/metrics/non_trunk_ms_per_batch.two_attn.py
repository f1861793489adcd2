"""Device time a batch in every operation but the two-attention trunk
kernel's: the latents, the chain's arithmetic, the denoiser around its trunk
(both attentions' K and V among them), the draws."""

import readers

PATTERN = r"fused_core_two_attn_kernel"


def read(info):
    batches = info.traced_counts.get("batches")
    if not batches or not info.kernels:
        return None
    return 1e3 * readers.other_time(info, PATTERN) / batches
