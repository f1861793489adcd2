"""Plain PyTorch reference of DiffFacto's unconditional generation.

A frozen copy of the mathematics, written from the published model
(github.com/diffFacto/diffFacto, ICCV 2023: ``models/anchor_gen.py``,
``models/part_aligner.py``, ``models/flow.py``, ``nets/attention.py``,
``models/anchored_diffusion.py``). It imports nothing of the program under
test: it reads a dict of weights under the names of the program's
checkpoint layout and works out everything from them (K and V of every
block, the stacked weights, the schedule's tables).

The path, for one shape:

* flow prior: z (K, zdim) through each part's chain of affine coupling
  layers in reverse, ``y2 = (x2 - shift) / sigmoid(s + 2)``;
* aligner: the part codes with the CIMLE noise (times ``noise_scale``) on
  every token, proj_in plus a class embedding, ``depth`` self-attention
  blocks over the K tokens (absent parts masked as keys), post-LN and
  proj_out to a mean and a log-variance a part (no pre-LN with CIMLE noise of
  type 0, as published);
* the points split equally over the parts (an absent part's share to the
  first present one), each point takes its part's mean and variance;
* the reverse chain: T anchored DDPM steps with an epsilon-predicting
  transformer whose point tokens (x_t, the point's mean and variance, its
  part's one-hot) cross-attend to the K part tokens (code, mean, variance,
  class one-hot, time embedding).

Every product is float32 with TF32 off (``PRECISIONS["float32"]``). The
control computes the same with the operands of every product rounded to
fp8 e4m3 (``PRECISIONS["fp8"]``), the precision below the bf16 the
configuration states for them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def _fp8_weight(w: torch.Tensor) -> torch.Tensor:
    """A weight rounded to e4m3 with one scale for the tensor (its largest
    magnitude maps to FP8_MAX)."""
    s = w.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (w / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _fp8_act(x: torch.Tensor) -> torch.Tensor:
    """An activation rounded to e4m3, saturating at FP8_MAX."""
    return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(torch.float32)


class Precision:
    """How the operands of a product are rounded: not at all (float32), or
    to fp8 e4m3. Sums stay float32 in both."""

    def __init__(self, name: str):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def act(self, x):
        return _fp8_act(x) if self.name == "fp8" else x

    def weight(self, w):
        return _fp8_weight(w) if self.name == "fp8" else w

    def dense(self, x, w, b=None):
        y = self.act(x.float()) @ self.weight(w.float())
        return y if b is None else y + b.float()

    def bmm(self, a, b):
        return self.act(a) @ self.act(b)


PRECISIONS = {name: Precision(name) for name in ("float32", "fp8")}


def layer_norm(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def gelu(x):
    return F.gelu(x, approximate="tanh")


def schedule(T: int, beta_1: float, beta_T: float, device) -> dict:
    """The linear schedule's tables in float64, as float32 tensors."""
    betas = np.linspace(beta_1, beta_T, T, dtype=np.float64)
    acp = np.cumprod(1.0 - betas)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    tables = dict(
        sqrt_recip_acp=np.sqrt(1.0 / acp),
        sqrt_recipm1_acp=np.sqrt(1.0 / acp - 1.0),
        coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
        coef2=(1.0 - acp_prev) * np.sqrt(1.0 - betas) / (1.0 - acp),
        # the anchored chain's coefficient on the anchor
        coef3=1.0 + (np.sqrt(acp) - 1.0) * (np.sqrt(acp_prev) + np.sqrt(1.0 - betas)) / (1.0 - acp),
        post_var=post_var,
    )
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in tables.items()}


def attention(q, k, v, key_mask, heads: int, p: Precision):
    """q (B, N, D), k and v (B, M, D), key_mask (B, M) with 1 = attend:
    per-head softmax over the unmasked keys."""
    B, N, D = q.shape
    M = k.shape[1]
    dh = D // heads
    qh = q.reshape(B, N, heads, dh).transpose(1, 2)
    kh = k.reshape(B, M, heads, dh).transpose(1, 2)
    vh = v.reshape(B, M, heads, dh).transpose(1, 2)
    s = p.bmm(qh, kh.transpose(-1, -2)) * dh ** -0.5
    s = s.masked_fill(key_mask[:, None, None, :] <= 0, float("-inf"))
    w = torch.softmax(s, dim=-1)
    return p.bmm(w, vh).transpose(1, 2).reshape(B, N, D)


class Generation:
    """The reference generation of one configuration's model.

    ``weights`` maps the names of the program's checkpoint layout to float32
    tensors; ``model`` is the configuration's ``model`` dict.
    """

    def __init__(self, weights: dict, model: dict, precision: str = "float32"):
        self.W = weights
        self.p = PRECISIONS[precision]
        enc, diff = model["encoder"], model["diffusion"]
        al, net = enc["part_aligner"], diff["net"]
        supported = (al.get("cimle") and al.get("cond_noise_type", 0) == 0
                     and al.get("class_cond") and al.get("add_class_cond")
                     and al.get("single_attn") and net.get("single_attn")
                     and net.get("class_cond") and not net.get("add_class_cond")
                     and net.get("cat_params_to_x") and net.get("cat_class_to_x")
                     and diff.get("model_mean_type") == "epsilon"
                     and diff.get("model_var_type", "fixed_small") == "fixed_small"
                     and diff.get("learn_variance") and diff.get("mode") == "linear"
                     and not diff.get("guidance") and not diff.get("ddim_sampling")
                     and not diff.get("res") and not diff.get("include_anchors")
                     and enc.get("use_flow") and enc.get("include_part_code")
                     and enc.get("include_params"))
        if not supported:
            raise NotImplementedError("the reference covers the gen_chair family of "
                                      "AnchorDiffAE configurations only")
        self.K = model["num_anchors"]
        self.N = model["npoints"]
        self.T = model["num_timesteps"]
        self.zdim = enc["encoder"]["zdim"]
        self.prior_var = enc.get("prior_var", 1.0)
        self.log_scale_var = math.log(enc.get("scale_var", 1.0))
        self.flow_depth = enc["latent_flow_depth"]
        self.noise_scale = al["noise_scale"]
        self.al_heads, self.al_depth = al["n_heads"], al["depth"]
        self.net_heads, self.net_depth = net["n_heads"], net["depth"]
        self.beta = (diff["beta_1"], diff["beta_T"])

    def w(self, name):
        return self.W[name].float()

    # ------------------------------------------------------------ latents
    def flow_prior(self, z):
        """z (B, K, zdim) -> part codes (B, K, zdim)."""
        x_all = z.float() * math.sqrt(self.prior_var)
        out = []
        for k in range(self.K):
            x = x_all[:, k]
            d = self.zdim - self.zdim // 2
            for i in reversed(range(self.flow_depth)):
                pre = f"encoder_mod.flow.flows.{k}.chain.{i}."
                swap = i % 2 == 0
                if swap:
                    x = torch.cat([x[:, d:], x[:, :d]], dim=1)
                h = torch.relu(self.p.dense(x[:, :d], self.w(pre + "dense0.kernel"),
                                            self.w(pre + "dense0.bias")))
                h = torch.relu(self.p.dense(h, self.w(pre + "dense1.kernel"),
                                            self.w(pre + "dense1.bias")))
                st = self.p.dense(h, self.w(pre + "dense2.kernel"), self.w(pre + "dense2.bias"))
                width = x.shape[1] - d
                y1 = (x[:, d:] - st[:, width:]) / torch.sigmoid(st[:, :width] + 2.0)
                x = torch.cat([y1, x[:, :d]] if swap else [x[:, :d], y1], dim=1)
            out.append(x)
        return torch.stack(out, dim=1)

    def aligner(self, code, valid, noise):
        """code (B, K, zdim), valid (B, K), noise (B, noise_dim) -> mean, logvar (B, K, 3)."""
        B, K, _ = code.shape
        pre = "encoder_mod.aligner."
        x = torch.cat([code, (noise.float() * self.noise_scale)[:, None].expand(B, K, -1)], -1)
        h = self.p.dense(x, self.w(pre + "proj_in.kernel"), self.w(pre + "proj_in.bias"))
        h = h + self.w(pre + "class_emb")[None]
        for i in range(self.al_depth):
            b = f"{pre}blocks.{i}."
            a = layer_norm(h, self.w(b + "norm2_scale"), self.w(b + "norm2_bias"))
            q, k, v = (self.p.dense(a, self.w(b + n)) for n in ("wq", "wk", "wv"))
            o = attention(q, k, v, valid, self.al_heads, self.p)
            h = h + self.p.dense(o, self.w(b + "wout"), self.w(b + "bout"))
            h = h + self._ff(h, b)
        h = layer_norm(h, self.w(pre + "post_norm.scale"), self.w(pre + "post_norm.bias"))
        out = self.p.dense(h, self.w(pre + "proj_out.kernel"), self.w(pre + "proj_out.bias"))
        return out[..., :3], out[..., 3:6]

    def _ff(self, h, b):
        f = layer_norm(h, self.w(b + "ffn_ln_scale"), self.w(b + "ffn_ln_bias"))
        a, g = self.p.dense(f, self.w(b + "ffn_w1"), self.w(b + "ffn_b1")).chunk(2, dim=-1)
        return self.p.dense(a * gelu(g), self.w(b + "ffn_w2"), self.w(b + "ffn_b2"))

    def seg_mask(self, valid):
        """(B, K) presence -> (B, N) part of each point: N / K points a part in
        order, an absent part's share to the first present part."""
        first = torch.argmax(valid, dim=1)[:, None]
        ids = torch.where(valid > 0, torch.arange(self.K, device=valid.device)[None], first)
        return ids.repeat_interleave(self.N // self.K, dim=1)

    def latents(self, z, cimle_noise, valid):
        code = self.flow_prior(z)
        mean, logvar = self.aligner(code, valid.float(), cimle_noise)
        seg = self.seg_mask(valid)
        lv = logvar + self.log_scale_var
        idx = seg[..., None].expand(-1, -1, 3)
        anchors = torch.gather(mean, 1, idx)
        var = torch.exp(torch.gather(lv, 1, idx))
        # the part tokens carry exp(lv + log scale_var): the published model
        # adds the log scale twice
        ctx = torch.cat([code, mean, torch.exp(lv + self.log_scale_var)], dim=-1)
        return ctx, anchors, var, seg

    # ------------------------------------------------------------ denoiser
    def denoiser(self, x, t: int, ctx, anchors, var, seg, valid):
        """The epsilon of x (B, N, 3) at step t."""
        B, N, _ = x.shape
        pre = "net."
        half = 128
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                            device=x.device) / half)
        args = float(t) * freqs
        temb = torch.cat([torch.cos(args), torch.sin(args)])[None].expand(B, -1)
        a, g = self.p.dense(temb, self.w(pre + "time_embed.geglu.dense0.kernel"),
                            self.w(pre + "time_embed.geglu.dense0.bias")).chunk(2, dim=-1)
        temb = self.p.dense(a * gelu(g), self.w(pre + "time_embed.dense0.kernel"),
                            self.w(pre + "time_embed.dense0.bias"))
        eye = torch.eye(self.K, device=x.device)[None].expand(B, -1, -1)
        tokens = torch.cat([ctx, eye, temb[:, None].expand(B, self.K, -1)], dim=-1)
        onehot = F.one_hot(seg.long(), self.K).float()
        h = self.p.dense(torch.cat([x, anchors, var, onehot], dim=-1),
                         self.w(pre + "proj_in.kernel"), self.w(pre + "proj_in.bias"))
        h = layer_norm(h, self.w(pre + "pre_norm.scale"), self.w(pre + "pre_norm.bias"))
        for i in range(self.net_depth):
            b = f"{pre}blocks.{i}."
            k = self.p.dense(tokens, self.w(b + "wk"))
            v = self.p.dense(tokens, self.w(b + "wv"))
            a = layer_norm(h, self.w(b + "norm2_scale"), self.w(b + "norm2_bias"))
            o = attention(self.p.dense(a, self.w(b + "wq")), k, v, valid, self.net_heads, self.p)
            h = h + self.p.dense(o, self.w(b + "wout"), self.w(b + "bout"))
            h = h + self._ff(h, b)
        h = layer_norm(h, self.w(pre + "post_norm.scale"), self.w(pre + "post_norm.bias"))
        return self.p.dense(h, self.w(pre + "proj_out.kernel"), self.w(pre + "proj_out.bias"))

    # --------------------------------------------------------------- chain
    @torch.no_grad()
    def sample(self, z, cimle_noise, valid, noise, step_noise):
        """Shapes (B, N, 3) from the draws: z (B, K, zdim), cimle_noise (B,
        noise_dim), valid (B, K), noise (B, N, 3) = x_T, step_noise (T, B, N, 3)
        in the order the steps run (T-1 first)."""
        ctx, anchors, var, seg = self.latents(z, cimle_noise, valid)
        s = schedule(self.T, *self.beta, z.device)
        x = noise.float()
        L = torch.sqrt(var)
        for i, t in enumerate(reversed(range(self.T))):
            eps = self.denoiser(x, t, ctx, anchors, var, seg, valid.float())
            x0 = s["sqrt_recip_acp"][t] * (x - anchors) + anchors - s["sqrt_recipm1_acp"][t] * L * eps
            mean = s["coef1"][t] * x0 + s["coef2"][t] * x + s["coef3"][t] * anchors
            x = mean + (torch.sqrt(s["post_var"][t] * var) * step_noise[i].float() if t > 0 else 0.0)
        return x
