"""Language components: the LSTM text encoder, latent fusers, losses, tokenizer.

Port of ``difffacto_tpu/models/language.py`` (the reference's
language-editing stack): ``Vocabulary`` and ``tokenizing``; ``LSTM`` (word
embedding, dropout, an LSTM, bilinear word attention over the valid steps);
``MultiHeadCrossAttention``, ``LatentLanguageFuser`` and
``PartLanguageSelector``; ``ZeroMLP`` (every layer zero, so an edit starts
as the identity); ``triplet_loss`` and ``clip_style_loss``.

The LSTM is flax's ``nn.RNN(nn.OptimizedLSTMCell)`` written out: gates
i, f, g, o from separate input kernels (no bias) and hidden kernels (with a
bias), kept under flax's names (``OptimizedLSTMCell_0`` -> ``cell``, then
``ii``, ``if``, ``ig``, ``io``, ``hi``, ... as the JAX tree has them), so the
weight bridge stays a renaming. The JAX module passes ``seq_lengths``, which
this flax version reads only for a returned carry: the outputs are those of
the recurrence run over every step, padding included, and so are these.
``h`` is read at ``max(len - 1, 0)``.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.layers import Dense, LayerNorm, default_generator, dropout, param
from ..utils.device import resolve_device
from ..utils.registry import ENCODERS

VOCAB_SIZE = 2787
PAD_IDX = 0


# ------------------------------------------------------------------- text
class Vocabulary:
    """A word-level vocabulary (``language.py:34-56``): ``<pad>`` 0, ``<unk>`` 1."""

    def __init__(self, words: Optional[Sequence[str]] = None):
        self.word2idx: Dict[str, int] = {"<pad>": PAD_IDX, "<unk>": 1}
        for w in words or []:
            self.add(w)

    def add(self, w: str) -> int:
        if w not in self.word2idx:
            self.word2idx[w] = len(self.word2idx)
        return self.word2idx[w]

    def __len__(self):
        return len(self.word2idx)

    def encode(self, text: str, max_len: int = 24) -> np.ndarray:
        toks = re.findall(r"[a-z']+", text.lower())
        unk = self.word2idx.get("<unk>", 1)
        ids = [self.word2idx.get(t, unk) for t in toks][:max_len]
        out = np.zeros(max_len, np.int32)
        out[: len(ids)] = ids
        return out


_DEFAULT_VOCAB = Vocabulary(
    "a the chair with leg legs seat back arm arms rest four one thick thin "
    "wheel long short straight slanted tall square diamond".split()
)


def tokenizing(text: str, vocab: Optional[Vocabulary] = None, max_len: int = 24) -> np.ndarray:
    return (vocab or _DEFAULT_VOCAB).encode(text, max_len)


# ----------------------------------------------------------------- modules
class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``: c' = f c + i g, h' = o tanh(c'), carry from zeros."""

    GATES = ("i", "f", "g", "o")

    def __init__(self, in_features: int, features: int, *, device="cuda", generator=None):
        super().__init__()
        g = default_generator(generator)
        self.features = features
        for gate in self.GATES:  # flax's DenseParams: the input kernels have no bias
            self.add_module(f"i{gate}", Dense(in_features, features, use_bias=False,
                                              device=device, generator=g))
        for gate in self.GATES:
            self.add_module(f"h{gate}", Dense(features, features, device=device, generator=g))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, L, in) -> the hidden state at every step, (B, L, features)."""
        sub = self._modules
        w_i = torch.cat([sub[f"i{gate}"].kernel for gate in self.GATES], dim=-1)
        w_h = torch.cat([sub[f"h{gate}"].kernel for gate in self.GATES], dim=-1)
        b_h = torch.cat([sub[f"h{gate}"].bias for gate in self.GATES], dim=-1)
        xi = torch.matmul(x, w_i)  # every step's input product at once
        B, L, _ = x.shape
        h = x.new_zeros(B, self.features)
        c = x.new_zeros(B, self.features)
        outs = []
        for t in range(L):
            i, f, gg, o = (torch.matmul(h, w_h) + b_h + xi[:, t]).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1)


@ENCODERS.register_module()
class LSTM(nn.Module):
    """Padding-aware LSTM and bilinear word attention (``language.py:69-107``)."""

    def __init__(self, text_dim: int = 64, embedding_dim: int = 100, vocab_size: int = VOCAB_SIZE,
                 padding_idx: int = PAD_IDX, dropout: float = 0.5, *, dtype=None, device="cuda",
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.padding_idx, self.dropout, self.text_dim = padding_idx, dropout, text_dim
        self.word_embedding = nn.Module()
        # flax's nn.Embed initialises with variance_scaling(1, fan_in, normal)
        self.word_embedding.embedding = param(
            torch.randn(vocab_size, embedding_dim, generator=g), device)
        self.cell = LSTMCell(embedding_dim, text_dim, device=device, generator=g)
        bound = (6.0 / (1 + text_dim)) ** 0.5  # xavier_uniform of (1, text_dim)
        self.w_attn = param((torch.rand(1, text_dim, generator=g) * 2 - 1) * bound, device)

    def forward(self, padded_tokens: torch.Tensor, train: bool = False, generator=None,
                keep: Optional[torch.Tensor] = None):
        """padded_tokens (B, L) int -> (final (B, text_dim), attn (B, L)). With
        ``train`` the embeddings take dropout from ``generator``; ``keep``
        (B, L, embedding_dim) injects its keep mask."""
        return self.sequence(padded_tokens, train, generator, keep)[:2]

    def sequence(self, padded_tokens: torch.Tensor, train: bool = False, generator=None,
                 keep: Optional[torch.Tensor] = None):
        """``forward``'s (final, attn) and the LSTM's output at every step,
        rnn_out (B, L, text_dim)."""
        emb = self.word_embedding.embedding[padded_tokens.long()]
        if train and keep is not None:
            emb = emb * keep.to(emb.dtype) / (1.0 - self.dropout)
        else:
            emb = dropout(emb, self.dropout, train, generator)
        valid = padded_tokens != self.padding_idx
        len_seq = valid.sum(1)
        rnn_out = self.cell(emb)
        idx = (len_seq - 1).clamp_min(0)
        h = rnn_out[torch.arange(rnn_out.shape[0], device=rnn_out.device), idx]
        score = torch.einsum("bld,bd->bl", rnn_out * self.w_attn, h)
        score = torch.where(valid, score, torch.full_like(score, -1e9))
        attn = torch.softmax(score, dim=1)
        final = torch.einsum("bld,bl->bd", rnn_out, attn)
        return final, attn, rnn_out


@ENCODERS.register_module()
class MultiHeadCrossAttention(nn.Module):
    """Text-to-part cross attention with part-indicator slicing
    (``language.py:110-145``). Dropout 0.1 on the attention and the MLP's
    output in training."""

    def __init__(self, src_channel: int, tgt_channel: int, out_channel: int, qk_dim: int = 512,
                 nheads: int = 8, scale: bool = True, *, dtype=None, device="cuda",
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        self.out_channel, self.qk_dim, self.nheads, self.scale = out_channel, qk_dim, nheads, scale
        kw = dict(device=device, generator=g)
        self.Wq = Dense(src_channel, qk_dim, **kw)
        self.Wk = Dense(tgt_channel, qk_dim, **kw)
        self.Wv = Dense(tgt_channel, out_channel, **kw)
        self.linear1 = Dense(out_channel, out_channel * 2, **kw)
        self.linear2 = Dense(out_channel * 2, out_channel, **kw)
        self.norm = LayerNorm(out_channel, device=device)

    def forward(self, src, tgt, part_indicator, train: bool = False, generator=None):
        B, N, _ = src.shape
        M, h = tgt.shape[1], self.nheads
        qk_d, v_d = self.qk_dim // h, self.out_channel // h
        Q = self.Wq(src).reshape(B, N, h, qk_d)
        K = self.Wk(tgt).reshape(B, M, h, qk_d)
        V = self.Wv(tgt).reshape(B, M, h, v_d)
        scale = (1.0 / float(np.sqrt(qk_d))) if self.scale else 1.0
        qk = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", Q, K) * scale, dim=3)
        qk = dropout(qk, 0.1, train, generator)
        qk = (qk * part_indicator.reshape(B, 1, -1, 1)).sum(2, keepdim=True)
        msg = torch.einsum("bhnm,bmhd->bnhd", qk, V).reshape(B, -1, h * v_d)
        m2 = self.linear2(torch.relu(self.linear1(msg)))
        return self.norm(msg + dropout(m2, 0.1, train, generator))


@ENCODERS.register_module()
class LatentLanguageFuser(nn.Module):
    """Fuse a text latent into the referenced part's latent
    (``language.py:148-200``): part_latent (B, K, part_dim), part_indicators
    (B, K), text (B, text_dim) -> (B, 1, K, part_dim)."""

    def __init__(self, text_dim: int, part_dim: int, num_part: int, residual: bool = True,
                 cat_weights: bool = True, mid_dim: int = 1024, normalize_latent: bool = False,
                 regress_weights: bool = False, *, dtype=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        g = default_generator(generator)
        kw = dict(device=device, generator=g)
        self.part_dim, self.residual, self.cat_weights = part_dim, residual, cat_weights
        self.normalize_latent, self.regress_weights = normalize_latent, regress_weights
        if regress_weights:
            self.dense0 = Dense(text_dim, 128, **kw)
            self.dense1 = Dense(128, 128, **kw)
            self.dense2 = Dense(128, num_part, **kw)
        self.fuser0 = Dense(num_part * part_dim, part_dim, **kw)
        self.fuser1 = Dense(part_dim + (num_part if cat_weights else 0), part_dim, **kw)
        self.fuser2 = Dense(text_dim + part_dim, mid_dim, **kw)
        self.fuser3 = Dense(mid_dim, mid_dim, **kw)
        self.fuser4 = Dense(mid_dim, part_dim, **kw)

    def forward(self, part_latent, part_indicators, text_latent):
        B, K, D = part_latent.shape
        if self.regress_weights:
            w = torch.relu(self.dense1(torch.relu(self.dense0(text_latent))))
            weights = torch.sigmoid(self.dense2(w))
        else:
            weights = part_indicators
        fused = torch.relu(self.fuser0(part_latent.reshape(B, -1)))
        if self.cat_weights:
            fused = torch.cat([fused, weights.to(fused.dtype)], -1)
        fused = torch.relu(self.fuser1(fused))
        fused = torch.cat([text_latent, fused], dim=-1)[:, None]
        fused = torch.relu(self.fuser2(fused))
        fused = self.fuser4(torch.relu(self.fuser3(fused)))
        ind = part_indicators.reshape(B, 1, K, 1).to(part_latent.dtype)
        if self.residual:
            edited = part_latent[:, None] + fused[:, :, None, :]
        else:
            edited = fused[:, :, None, :].expand(B, 1, K, self.part_dim)
        out = (1 - ind) * part_latent[:, None] + ind * edited
        if self.normalize_latent:
            out = out / torch.linalg.norm(out, dim=-1, keepdim=True)
        return out


@ENCODERS.register_module()
class PartLanguageSelector(nn.Module):
    """The part latent the indicator names (``language.py:203-214``): tgt
    (B, K, D) -> (B, 1, D)."""

    def __init__(self, text_dim: int = 64, part_dim: int = 256, out_channel: int = 256,
                 *, dtype=None, device="cuda", generator=None):
        super().__init__()

    def forward(self, src, tgt, part_indicator, train: bool = False, generator=None):
        part_id = torch.argmax(part_indicator, dim=1)
        return tgt[torch.arange(tgt.shape[0], device=tgt.device), part_id][:, None]


class ZeroMLP(nn.Module):
    """ReLU MLP with every kernel and bias zero (``language.py:217-236``), so a
    language edit starts as the identity. ``in_features`` is the first
    layer's input width, which flax infers."""

    def __init__(self, in_features: int, features: Sequence[int], *, dtype=None, device="cuda"):
        super().__init__()
        dims = [in_features, *features]
        self.n = len(features)
        for i in range(self.n):
            layer = Dense(dims[i], dims[i + 1], zero_kernel=True, dtype=dtype, device=device)
            setattr(self, f"dense{i}", layer)

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, f"dense{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


# ------------------------------------------------------------------ losses
def triplet_loss(anchor, pos, neg, thresh: float = 0.1):
    """Margin triplet on latent distances (``language.py:240-245``):
    (relu(mean_d(pos_d - neg_d) + thresh) (B,), mean pos_d, mean neg_d)."""
    pos_d = (anchor - pos) ** 2
    neg_d = (anchor - neg) ** 2
    return torch.relu((pos_d - neg_d + thresh).mean(1)), pos_d.mean(), neg_d.mean()


def clip_style_loss(modified, target, distractor):
    """Binary cross entropy of the cosine similarities against (target 1,
    distractor 0) (``language.py:248-252``): (loss, cos (B, 2))."""
    nrm = lambda x: x / torch.linalg.norm(x, dim=1, keepdim=True)
    m = nrm(modified)
    cands = torch.stack([nrm(target), nrm(distractor)], dim=-1)
    cos = (m[..., None] * cands).sum(1)
    label = torch.tensor([[1.0, 0.0]], dtype=cos.dtype, device=cos.device)
    p = torch.sigmoid(cos)
    bce = -(label * torch.log(p + 1e-8) + (1 - label) * torch.log(1 - p + 1e-8)).mean()
    return bce, cos
