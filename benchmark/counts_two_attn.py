"""The yardstick's arithmetic for two-attention blocks (``single_attn=False``):
``counts.py``'s counts of the single-attention block plus the first
attention's terms, counted from a configuration's widths.

The first attention of a denoiser block costs, a point token, its q- and
out-projections (2 D^2 multiply-adds) and its scores and weighted sum over
the K part tokens (2 K D); its weights (Wq1, Wout1 bf16, bout1 and norm1's
scale and bias) and its K1 and V1 (bf16, B x K x D a block) are read once.
In the aligner (no context) it is a self-attention over the K part tokens:
q, k, v and out-projections (4 A^2) and 2 K A a token.
"""

from __future__ import annotations

import counts


def attn1_terms(model: dict, B: int) -> tuple:
    """(multiply-adds a point token, bytes a launch) that the first attention
    adds to one trunk launch over B shapes."""
    net = counts._net(model)
    D, depth, K = net["n_heads"] * net["d_head"], net["depth"], model["num_anchors"]
    macs = depth * (2 * D * D + 2 * K * D)
    # bf16: Wq1, Wout1, norm1's scale and bias, K1 and V1; f32: bout1
    nbytes = 2 * depth * (2 * D * D + 2 * D + 2 * B * K * D) + 4 * depth * D
    return macs, nbytes


def trunk_flops_bytes(model: dict, B: int, attn1=None) -> tuple:
    """(operations, bytes) of one launch of the two-attention trunk over B
    shapes: ``counts.trunk_bound_s``'s (proj_in and the single-attention
    blocks, every operand read once, the bf16 hidden state written once)
    plus ``attn1`` = (multiply-adds a token, bytes), the first attention's
    ``attn1_terms`` where None."""
    net = counts._net(model)
    D, depth, N, K = net["n_heads"] * net["d_head"], net["depth"], model["npoints"], model["num_anchors"]
    FF, C = counts.FF_MULT * D, counts._in_channels(model)
    macs1, bytes1 = attn1_terms(model, B) if attn1 is None else attn1
    flops = 2.0 * B * N * (C * D + depth * counts._block_macs(model) + macs1)
    # counts.trunk_bound_s's bytes
    bf16 = (B * N * C + C * D + 2 * depth * B * K * D + 4 * D
            + depth * (4 * D + 2 * D * D + D * 2 * FF + FF * D))
    f32 = D + B * K + depth * (D + 2 * FF + D)
    nbytes = 2 * bf16 + 4 * f32 + 2 * B * N * D + bytes1
    return flops, nbytes


def trunk_bound_s(model: dict, B: int, attn1=None) -> tuple:
    """The least time of one two-attention trunk launch over B shapes: its
    operations at the bf16 peak against its bytes at HBM's rate.
    (seconds, "operations" or "bytes")."""
    flops, nbytes = trunk_flops_bytes(model, B, attn1)
    t_ops, t_bytes = flops / counts.PEAK_BF16_FLOPS, nbytes / counts.PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def generation_flops_per_shape(model: dict) -> float:
    """``counts.generation_flops_per_shape`` plus the first attention of
    every block: in the denoiser a point token's ``attn1_terms`` and the K
    part tokens' K1 and V1 at every step, in the aligner a self-attention
    over the K part tokens once a shape."""
    net = counts._net(model)
    D, K = net["n_heads"] * net["d_head"], model["num_anchors"]
    al = model["encoder"]["part_aligner"]
    A = al["n_heads"] * al["d_head"]
    per_step = (model["npoints"] * attn1_terms(model, 1)[0]
                + net["depth"] * 2 * K * counts.context_width(model) * D)
    aligner = K * al["depth"] * (4 * A * A + 2 * K * A)
    return counts.generation_flops_per_shape(model) + 2.0 * (
        aligner + model["num_timesteps"] * per_step)
