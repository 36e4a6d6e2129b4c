"""The CTCLIP fallback towers (port of ``ctpa/models/fallback_transformers.py``):
a rotary text transformer with CLS or causal EOS pooling and a 2-D ViT with
PatchDropout, used where no external BERT or CTViT is given.  Plain torch
ops throughout (none is a Pallas kernel in ctpa).  Parameters keep ctpa's
names: ``token_emb``, ``pos_emb``, ``cls_token``, ``block_i`` (``blocks``),
``attn_norm``, ``to_q``/``to_k``/``to_v``/``to_out``, ``ff_norm``, ``ff_in``,
``ff_out``, ``norm_out``, ``patch_norm_in``, ``patch_proj``,
``patch_norm_out``; LayerNorms are flax's (epsilon 1e-6).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from ctpa_torch.models.layers import AffineLayerNorm, Dense
from ctpa_torch.ops.rotary import apply_rope, rope_frequencies

LN_EPS = 1e-6
ROPE_LEN = 4096


class PatchDropout(nn.Module):
    """Keep a random subset of max(1, int(n (1 - prob))) tokens of each item
    during training; identity when deterministic.  The subsets are drawn
    from ``generator`` (a random permutation per item), so they follow
    ctpa's law, not its bits."""

    def __init__(self, prob: float = 0.5):
        super().__init__()
        self.prob = prob

    def forward(self, x, generator: torch.Generator | None = None, deterministic: bool = True):
        if deterministic or self.prob <= 0.0:
            return x
        b, n, d = x.shape
        keep = max(1, int(n * (1.0 - self.prob)))
        idx = torch.stack([torch.randperm(n, generator=generator, device=x.device)[:keep]
                           for _ in range(b)])
        return torch.gather(x, 1, idx[..., None].expand(b, keep, d))


class _Block(nn.Module):
    """Pre-norm attention (rotary on q and k, optional causal mask, fp32
    scores) and a GELU (exact) feed-forward."""

    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int = 4,
                 causal: bool = False, use_rotary: bool = True, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.causal, self.use_rotary = causal, use_rotary
        self.attn_norm = AffineLayerNorm(dim, eps=LN_EPS, **fk)
        self.to_q = Dense(dim, inner, bias=False, **fk)
        self.to_k = Dense(dim, inner, bias=False, **fk)
        self.to_v = Dense(dim, inner, bias=False, **fk)
        self.to_out = Dense(inner, dim, bias=False, **fk)
        self.ff_norm = AffineLayerNorm(dim, eps=LN_EPS, **fk)
        self.ff_in = Dense(dim, dim * ff_mult, **fk)
        self.ff_out = Dense(dim * ff_mult, dim, **fk)

    def forward(self, x, mask=None, positions=None):
        b, n, _ = x.shape
        h, hd = self.heads, self.dim_head
        y = self.attn_norm(x)
        q, k, v = (proj(y).reshape(b, n, h, hd) for proj in (self.to_q, self.to_k, self.to_v))
        if self.use_rotary:
            cos, sin = rope_frequencies(hd, ROPE_LEN, device=x.device)
            pos = positions if positions is not None else torch.arange(
                n, device=x.device)[None].expand(b, n)
            q, k = apply_rope(q, cos, sin, pos), apply_rope(k, cos, sin, pos)
        sim = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / math.sqrt(hd)
        neg = torch.finfo(torch.float32).min
        if mask is not None:
            sim = sim.masked_fill(~(mask[:, None, None, :] > 0), neg)
        if self.causal:
            causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
            sim = sim.masked_fill(~causal, neg)
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, h * hd)
        x = x + self.to_out(out)
        return x + self.ff_out(F.gelu(self.ff_in(self.ff_norm(x))))


class TextTransformer(nn.Module):
    """Fallback text tower: token and absolute position embeddings, rotary
    blocks, then CLS pooling (a learned token prepended) or, with
    ``causal``, the last real token.  forward(input_ids, attention_mask) ->
    (tokens, pooled)."""

    def __init__(self, dim: int = 512, depth: int = 6, heads: int = 8, dim_head: int = 64,
                 vocab_size: int = 30522, max_len: int = 512, causal: bool = False,
                 device="cuda", dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.causal = causal
        self.token_emb = nn.Embedding(vocab_size, dim, **fk)
        self.pos_emb = nn.Embedding(max_len, dim, **fk)
        if not causal:
            self.cls_token = nn.Parameter(torch.zeros(dim, **fk))
        self.blocks = nn.ModuleList([_Block(dim, heads, dim_head, causal=causal, **fk)
                                     for _ in range(depth)])
        self.norm_out = AffineLayerNorm(dim, eps=LN_EPS, **fk)

    def forward(self, input_ids, attention_mask=None):
        b, n = input_ids.shape
        x = self.token_emb(input_ids) + self.pos_emb(torch.arange(n, device=input_ids.device))[None]
        if not self.causal:
            x = torch.cat([self.cls_token.expand(b, 1, -1), x], dim=1)
            if attention_mask is not None:
                attention_mask = F.pad(attention_mask, (1, 0), value=1)
        for block in self.blocks:
            x = block(x, attention_mask)
        x = self.norm_out(x)
        if not self.causal:
            return x, x[:, 0]
        if attention_mask is None:
            return x, x[:, -1]
        last = torch.clamp(attention_mask.sum(-1) - 1, min=0)
        return x, x[torch.arange(b, device=x.device), last]


class VisionTransformer2D(nn.Module):
    """Fallback 2-D ViT: LayerNorm -> Linear -> LayerNorm patch embed,
    PatchDropout in training, blocks without rotary, mean pooling.
    forward(images (b, c, H, W), deterministic, generator) -> (tokens, pooled)."""

    def __init__(self, dim: int = 512, depth: int = 6, heads: int = 8, dim_head: int = 64,
                 image_size: int = 256, patch_size: int = 32, channels: int = 3,
                 patch_dropout: float = 0.5, device="cuda", dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        patch_dim = channels * patch_size * patch_size
        self.patch_size = patch_size
        self.patch_norm_in = AffineLayerNorm(patch_dim, eps=LN_EPS, **fk)
        self.patch_proj = Dense(patch_dim, dim, **fk)
        self.patch_norm_out = AffineLayerNorm(dim, eps=LN_EPS, **fk)
        self.patch_dropout = PatchDropout(patch_dropout)
        self.blocks = nn.ModuleList([_Block(dim, heads, dim_head, use_rotary=False, **fk)
                                     for _ in range(depth)])
        self.norm_out = AffineLayerNorm(dim, eps=LN_EPS, **fk)

    def forward(self, images, deterministic: bool = True,
                generator: torch.Generator | None = None):
        p = self.patch_size
        x = rearrange(images, "b c (h p1) (w p2) -> b (h w) (c p1 p2)", p1=p, p2=p)
        x = self.patch_norm_out(self.patch_proj(self.patch_norm_in(x)))
        x = self.patch_dropout(x, generator=generator, deterministic=deterministic)
        for block in self.blocks:
            x = block(x)
        x = self.norm_out(x)
        return x, x.mean(dim=1)
