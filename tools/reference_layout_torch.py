"""Torch modules in the reference DiffFacto's layout, and a ``.pth`` of them.

The reference's PointNetV2 part encoder with grouped per-part heads
(pointnet.py:124-213), its part aligner at the gen_chair configuration with
the pre_norm it builds and skips (part_encoders.py:20-143), its per-part
coupling flows (flow.py:7-79) and its TransformerNet denoiser with the GEGLU
time embedding (attention.py:50-440), written in plain torch with the
reference's module names, so that their ``state_dict`` has the key layout of
``pretrained/<category>.pth``. The same modules as the JAX package's ingestion
tests build (``tests/test_torch_ingest.py``, ``tests/test_full_ingest.py``),
without JAX: the port's tests and ``chip_smoke.py`` load what they write with
``difffacto_torch/utils/torch_ingest.py`` and hold the port's modules against
these.

    import reference_layout_torch as ref
    mods = ref.build_modules(seed=0)
    ref.save_pth(mods, "gen_chair_reference_layout.pth")
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as F

K = 4  # parts
ZDIM = 256
NOISE_DIM = 32


class TorchPointNetV2(tnn.Module):
    """pointnet.py:124-213 with per_part_mlp=True."""

    def __init__(self, zdim=ZDIM, num_anchors=K):
        super().__init__()
        self.zdim, self.num_anchors = zdim, num_anchors
        self.conv1 = tnn.Conv1d(3, 128, 1)
        self.conv2 = tnn.Conv1d(128, 128, 1)
        self.conv3 = tnn.Conv1d(128, 256, 1)
        self.conv4 = tnn.Conv1d(256, 512, 1)
        self.bn1 = tnn.BatchNorm1d(128)
        self.bn2 = tnn.BatchNorm1d(128)
        self.bn3 = tnn.BatchNorm1d(256)
        self.bn4 = tnn.BatchNorm1d(512)
        g = num_anchors

        def head():
            return tnn.Sequential(
                tnn.Conv1d(512 * g, 256 * g, 1, groups=g),
                tnn.BatchNorm1d(256 * g),
                tnn.ReLU(),
                tnn.Conv1d(256 * g, 128 * g, 1, groups=g),
                tnn.BatchNorm1d(128 * g),
                tnn.ReLU(),
                tnn.Conv1d(128 * g, zdim * g, 1, groups=g),
            )

        self.mlp_m = head()
        self.mlp_v = head()

    def forward(self, x, attn_weight):
        B = x.shape[0]
        x = x.transpose(1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = self.bn4(self.conv4(x))
        weighted = x.unsqueeze(-1) * attn_weight.unsqueeze(1) * self.num_anchors
        x = torch.max(weighted, 2)[0].view(B, 512, self.num_anchors)
        x = x.transpose(1, 2).reshape(B, -1, 1)
        m = self.mlp_m(x).reshape(B, self.num_anchors, -1)
        v = self.mlp_v(x).reshape(B, self.num_anchors, -1)
        return m, v


class TorchGEGLU(tnn.Module):
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = tnn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class TorchFF(tnn.Module):
    def __init__(self, dim, mult=4):
        super().__init__()
        self.net = tnn.Sequential(TorchGEGLU(dim, dim * mult), tnn.Identity(),
                                  tnn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class TorchCrossAttention(tnn.Module):
    """attention.py:161-204."""

    def __init__(self, query_dim, context_dim=None, heads=2, dim_head=8):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.scale = dim_head**-0.5
        self.heads = heads
        self.dim_head = dim_head
        self.to_q = tnn.Linear(query_dim, inner, bias=False)
        self.to_k = tnn.Linear(context_dim, inner, bias=False)
        self.to_v = tnn.Linear(context_dim, inner, bias=False)
        self.to_out = tnn.Sequential(tnn.Linear(inner, query_dim), tnn.Identity())

    def forward(self, x, context=None, mask=None):
        h, d = self.heads, self.dim_head
        ctx = x if context is None else context
        B, N, _ = x.shape
        M = ctx.shape[1]
        q = self.to_q(x).reshape(B, N, h, d)
        k = self.to_k(ctx).reshape(B, M, h, d)
        v = self.to_v(ctx).reshape(B, M, h, d)
        sim = torch.einsum("bnhd,bmhd->bhnm", q, k) * self.scale
        if mask is not None:
            sim = sim.masked_fill(~mask[:, None, None, :].bool(), -torch.finfo(sim.dtype).max)
        attn = sim.softmax(dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(B, N, h * d)
        return self.to_out(out)


class TorchBlock(tnn.Module):
    """BasicTransformerBlock with a single attention (attention.py:259-306)."""

    def __init__(self, dim, heads, dim_head, context_dim=None):
        super().__init__()
        self.attn2 = TorchCrossAttention(dim, context_dim, heads, dim_head)
        self.ff = TorchFF(dim)
        self.norm2 = tnn.LayerNorm(dim, eps=1e-6)
        self.norm3 = tnn.LayerNorm(dim, eps=1e-6)

    def forward(self, x, context=None, mask=None):
        x = self.attn2(self.norm2(x), context, mask) + x
        return self.ff(self.norm3(x)) + x


class TorchCoupling(tnn.Module):
    """flow.py:7-47."""

    def __init__(self, d, hidden, swap):
        super().__init__()
        self.d = d - d // 2
        self.swap = swap
        self.net_s_t = tnn.Sequential(
            tnn.Linear(self.d, hidden), tnn.ReLU(), tnn.Linear(hidden, hidden),
            tnn.ReLU(), tnn.Linear(hidden, (d - self.d) * 2),
        )

    def forward(self, x, reverse=False):
        if self.swap:
            x = torch.cat([x[:, self.d:], x[:, : self.d]], 1)
        out_dim = x.shape[1] - self.d
        s_t = self.net_s_t(x[:, : self.d])
        scale = torch.sigmoid(s_t[:, :out_dim] + 2.0)
        shift = s_t[:, out_dim:]
        y1 = (x[:, self.d:] - shift) / scale if reverse else x[:, self.d:] * scale + shift
        return (torch.cat([x[:, : self.d], y1], 1) if not self.swap
                else torch.cat([y1, x[:, : self.d]], 1))


class TorchChainFlow(tnn.Module):
    def __init__(self, dim=ZDIM, hidden=ZDIM, depth=14):
        super().__init__()
        self.chain = tnn.ModuleList(
            [TorchCoupling(dim, hidden, swap=(i % 2 == 0)) for i in range(depth)])

    def forward(self, x, reverse=False):
        inds = range(len(self.chain) - 1, -1, -1) if reverse else range(len(self.chain))
        for i in inds:
            x = self.chain[i](x, reverse=reverse)
        return x


def t_embed_np(t, dim=256):
    """The reference's timestep_embedding (utils/misc.py:83-100), [cos | sin]."""
    half = dim // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half, dtype=np.float32) / half)
    args = np.asarray(t, np.float32)[:, None] * freqs[None]
    return np.concatenate([np.cos(args), np.sin(args)], -1).astype(np.float32)


class TorchAlignerGenChair(tnn.Module):
    """part_encoders.py:20-143 at the gen_chair configuration: in 256, inner
    8 x 32 = 256, depth 5, the class embedding added after proj_in, CIMLE
    noise of type 0 concatenated; pre_norm built and skipped."""

    def __init__(self, zdim=ZDIM, heads=8, dh=32, depth=5, noise_scale=100.0):
        super().__init__()
        inner = heads * dh
        self.noise_scale = noise_scale
        self.proj_in = tnn.Linear(zdim + NOISE_DIM, inner)
        self.class_emb = tnn.Embedding(K, inner)
        self.pre_norm = tnn.LayerNorm(inner)  # in the checkpoint, never applied
        self.post_norm = tnn.LayerNorm(inner)
        self.transformer_blocks = tnn.ModuleList(
            [TorchBlock(inner, heads, dh, None) for _ in range(depth)])
        self.proj_out = tnn.Linear(inner, 6)

    def forward(self, part_code, mask, noise):  # channel-last (B, K, zdim)
        n = (noise * self.noise_scale).unsqueeze(1).expand(-1, K, -1)
        h = self.proj_in(torch.cat([part_code, n], -1))
        h = h + self.class_emb.weight.unsqueeze(0)
        for blk in self.transformer_blocks:
            h = blk(h, None, mask)
        h = self.proj_out(self.post_norm(h))
        return h[..., :3], h[..., 3:6]


class TorchDenoiserGenChair(tnn.Module):
    """attention.py:309-440 at the gen_chair configuration: in 3 + 6 + 4 = 13,
    inner 8 x 16 = 128, depth 5, the part tokens (zdim + 6) with the class eye
    and the 256-wide time embedding appended; no residual (13 in, 3 out)."""

    def __init__(self, heads=8, dh=16, depth=5, raw_ctx=ZDIM + 6):
        super().__init__()
        inner = heads * dh
        ctx_dim = raw_ctx + K + 256
        self.proj_in = tnn.Linear(3 + 6 + K, inner)
        self.pre_norm = tnn.LayerNorm(inner)
        self.post_norm = tnn.LayerNorm(inner)
        self.time_embed = TorchFF(256)
        self.transformer_blocks = tnn.ModuleList(
            [TorchBlock(inner, heads, dh, ctx_dim) for _ in range(depth)])
        self.proj_out = tnn.Linear(inner, 3)

    def forward(self, x, t, ctx, anchors, variances, seg_mask, valid_id):
        B = x.shape[0]
        eye = torch.eye(K).to(x).unsqueeze(0).expand(B, -1, -1)
        ctx = torch.cat([ctx, eye], -1)
        temb = self.time_embed(torch.from_numpy(t_embed_np(t.cpu().numpy())).to(x))
        ctx = torch.cat([ctx, temb.unsqueeze(1).expand(-1, K, -1)], -1)
        onehot = F.one_hot(seg_mask.long(), K).to(x)
        h = self.pre_norm(self.proj_in(torch.cat([x, anchors, variances, onehot], -1)))
        for blk in self.transformer_blocks:
            h = blk(h, ctx, valid_id)
        return self.proj_out(self.post_norm(h))


def build_modules(seed: int = 0, zdim: int = ZDIM, flow_depth: int = 14,
                  aligner_depth: int = 5, denoiser_depth: int = 5, noise_scale: float = 100.0):
    """The four modules in eval mode, seeded: BatchNorm running statistics
    made non-trivial, and each coupling layer's last linear scaled by 0.01
    so that the 14-layer inverse stays tame. Returns {"encoder", "aligner",
    "flows", "denoiser"}."""
    torch.manual_seed(seed)
    enc = TorchPointNetV2(zdim=zdim).eval()
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, tnn.BatchNorm1d):
                m.running_mean.normal_(0, 0.02)
                m.running_var.uniform_(0.9, 1.1)
    align = TorchAlignerGenChair(zdim=zdim, depth=aligner_depth, noise_scale=noise_scale).eval()
    flows = tnn.ModuleList([TorchChainFlow(zdim, zdim, flow_depth) for _ in range(K)]).eval()
    with torch.no_grad():
        for coup in flows.modules():
            if isinstance(coup, TorchCoupling):
                coup.net_s_t[4].weight.mul_(0.01)
                coup.net_s_t[4].bias.zero_()
    den = TorchDenoiserGenChair(depth=denoiser_depth, raw_ctx=zdim + 6).eval()
    return {"encoder": enc, "aligner": align, "flows": flows, "denoiser": den}


PREFIXES = {"encoder": "encoder.encoder.", "aligner": "encoder.part_aligner.",
            "flows": "encoder.flow.", "denoiser": "diffusion.model."}


def state_dict(modules) -> dict:
    """The reference ``AnchorDiffAE``'s state dict of these modules."""
    sd = {}
    for name, mod in modules.items():
        sd.update({PREFIXES[name] + k: v.detach().clone() for k, v in mod.state_dict().items()})
    return sd


def save_pth(modules, path: str) -> None:
    """Write the modules as the reference saves a checkpoint, {"model": state_dict}."""
    torch.save({"model": state_dict(modules)}, path)
