"""The yardstick's arithmetic: published peaks of the card, and the
operations and bytes of the work, counted from a configuration's widths.

Peaks are NVIDIA's data sheet for the H100 SXM5 (dense, no sparsity) at its
700 W limit.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3
# A point distance |a - b|: 3 subtractions, 3 products, 2 additions.
DISTANCE_FLOPS = 8
FF_MULT = 4  # the GEGLU feed-forward's inner width over the model width
T_EMBED = 256  # the denoiser's time embedding


def _net(model: dict) -> dict:
    return model["diffusion"]["net"]


def _in_channels(model: dict) -> int:
    net = _net(model)
    return net["in_channels"] + 6 * bool(net.get("cat_params_to_x")) + (
        net.get("n_class", 4) * bool(net.get("cat_class_to_x")))


def _block_macs(model: dict) -> int:
    """One trunk block a point token: query and output projections, the
    attention to the K part tokens (scores, weighted sum), the GEGLU
    feed-forward (D -> 2 FF, FF -> D)."""
    net = _net(model)
    D = net["n_heads"] * net["d_head"]
    return 2 * D * D + 2 * model["num_anchors"] * D + 3 * D * FF_MULT * D


def trunk_macs_per_token(model: dict) -> int:
    """The denoiser's multiply-adds a point token: proj_in, the blocks and
    proj_out."""
    net = _net(model)
    D = net["n_heads"] * net["d_head"]
    return _in_channels(model) * D + net["depth"] * _block_macs(model) + D * net["out_channels"]


def context_width(model: dict) -> int:
    net = _net(model)
    cls = net.get("n_class", 4) if net.get("class_cond") and not net.get("add_class_cond") else 0
    return net["context_dim"] + cls + T_EMBED


def denoiser_macs_per_call_shape(model: dict) -> int:
    """One denoiser call for one shape: every point token's trunk, the K
    part tokens' K and V in every block, and the time embedding's GEGLU."""
    net = _net(model)
    D = net["n_heads"] * net["d_head"]
    kv = net["depth"] * 2 * model["num_anchors"] * context_width(model) * D
    temb = T_EMBED * 2 * FF_MULT * T_EMBED + FF_MULT * T_EMBED * T_EMBED
    return model["npoints"] * trunk_macs_per_token(model) + kv + temb


def latent_macs_per_shape(model: dict) -> int:
    """The flow prior (each part's coupling layers) and the aligner over
    the K part tokens, once a shape."""
    enc = model["encoder"]
    z, h = enc["encoder"]["zdim"], enc["latent_flow_hidden_dim"]
    half = z - z // 2
    K = model["num_anchors"]
    flow = K * enc["latent_flow_depth"] * (half * h + h * h + h * 2 * (z - half))
    al = enc["part_aligner"]
    A = al["n_heads"] * al["d_head"]
    in_ch = al["in_channels"] + al.get("noise_dim", 32)
    block = 4 * A * A + 2 * K * A + 3 * A * FF_MULT * A
    aligner = K * (in_ch * A + al["depth"] * block + A * al["out_channels"])
    return flow + aligner


def generation_flops_per_shape(model: dict) -> float:
    """The model's floating-point operations to generate one shape: the
    latents once and T denoiser calls (2 operations a multiply-add)."""
    return 2.0 * (latent_macs_per_shape(model)
                  + model["num_timesteps"] * denoiser_macs_per_call_shape(model))


def trunk_bound_s(model: dict, B: int) -> tuple:
    """The least time of one trunk launch (proj_in, the blocks, no proj_out)
    over B shapes: its operations at the bf16 peak against its bytes at
    HBM's rate, every operand read once (bf16 tokens, weights, K and V; f32
    biases and mask) and the bf16 hidden state written once.
    (seconds, "operations" or "bytes")."""
    net = _net(model)
    D, depth, N, K = net["n_heads"] * net["d_head"], net["depth"], model["npoints"], model["num_anchors"]
    FF, C = FF_MULT * D, _in_channels(model)
    t_ops = 2.0 * B * N * (C * D + depth * _block_macs(model)) / PEAK_BF16_FLOPS
    bf16 = (B * N * C + C * D + 2 * depth * B * K * D + 4 * D
            + depth * (4 * D + 2 * D * D + D * 2 * FF + FF * D))
    f32 = D + B * K + depth * (D + 2 * FF + D)
    nbytes = 2 * bf16 + 4 * f32 + 2 * B * N * D
    t_bytes = nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def pair_bound_s(n: int) -> tuple:
    """The least time for one pair of n-point clouds: the n x n point
    distances once at the float32 peak against the two clouds read and one
    number written at HBM's rate. (seconds, bound by)."""
    t_ops = n * n * DISTANCE_FLOPS / PEAK_F32_FLOPS
    t_bytes = (2 * n * 3 * 4 + 4) / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def protocol_bound_s(model: dict, shapes: int, refs: int, ref_points: int,
                     points: int = 2048) -> float:
    """The least time of one val_gen protocol: the generation at the bf16
    peak, every scored pair's distances once for Chamfer and once for EMD at
    the float32 peak, and its inputs (the generated and the reference clouds)
    read once, each part at the larger of its two bounds."""
    gen = shapes * generation_flops_per_shape(model) / PEAK_BF16_FLOPS
    pairs = shapes * refs + shapes * (shapes - 1) // 2
    t_pairs = 2 * pairs * pair_bound_s(points)[0]
    t_in = (shapes * model["npoints"] + refs * ref_points) * 3 * 4 / PEAK_BYTES
    return gen + max(t_pairs, t_in)
