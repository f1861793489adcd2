"""The share of the chain's steps whose denoiser took the two-attention trunk
kernel: the launches of ``fused_core_two_attn_kernel`` over the program's
``chain.steps``, both in the traced window. It reads 100 where every step
takes the kernel. The steps are the program's recorder's; the launches are
read from the trace, because the recorder's ``fused_core_two_attn.launches``
counts the set-up's and the untraced units' too. A program without the
recorder, or whose steps never took the kernel, gives nothing."""

import readers

PATTERN = r"fused_core_two_attn_kernel"


def read(info):
    if not info.traced_s:
        return None
    _, launches = readers.kernel_time(info, PATTERN)
    if not launches:
        return None
    try:
        from difffacto_torch.utils import trace
    except ImportError:
        return None
    steps = trace.counters().get("chain.steps")
    if not steps:
        return None
    return 100.0 * launches / steps
