"""BERT text encoder (port of ``ctpa/models/bert.py``), HF BertModel geometry.
Attention is plain scaled dot-product with fp32 scores and softmax; no
hand-written kernel is involved.  Parameters are cast to the compute dtype
at use (``models/layers.py``).  ``remat`` recomputes each layer in the backward, as
ctpa's ``nn.remat``.  LoRA overlays and the MLM head belong to later slices."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ctpa_torch.core.config import BertConfig
from ctpa_torch.models.layers import AffineLayerNorm, Dense, compute_dtype


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **fk)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size, **fk)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size, **fk)
        self.LayerNorm = AffineLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **fk)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[-1], device=input_ids.device)[None]
        # over-long inputs reuse the last position instead of indexing out of range
        position_ids = torch.clamp(position_ids, max=self.cfg.max_position_embeddings - 1)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        dt = compute_dtype(self, self.word_embeddings.weight)
        x = (self.word_embeddings(input_ids).to(dt) + self.position_embeddings(position_ids).to(dt)
             + self.token_type_embeddings(token_type_ids).to(dt))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.heads = cfg.num_heads
        self.query = Dense(cfg.hidden_size, cfg.hidden_size, **fk)
        self.key = Dense(cfg.hidden_size, cfg.hidden_size, **fk)
        self.value = Dense(cfg.hidden_size, cfg.hidden_size, **fk)

    def forward(self, x, attn_bias):
        b, n, hidden = x.shape
        dh = hidden // self.heads
        q, k, v = (t.reshape(b, n, self.heads, dh).transpose(1, 2)
                   for t in (self.query(x), self.key(x), self.value(x)))
        # fp32 scores from the compute-dtype q and k (preferred_element_type)
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh) + attn_bias
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        return torch.matmul(attn, v).transpose(1, 2).reshape(b, n, hidden)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        hs, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention_self = BertSelfAttention(cfg, **fk)
        self.attention_output_dense = Dense(hs, hs, **fk)
        self.attention_output_LayerNorm = AffineLayerNorm(hs, eps=eps, **fk)
        self.intermediate_dense = Dense(hs, cfg.intermediate_size, **fk)
        self.output_dense = Dense(cfg.intermediate_size, hs, **fk)
        self.output_LayerNorm = AffineLayerNorm(hs, eps=eps, **fk)

    def forward(self, x, attn_bias):
        attn_out = self.attention_output_dense(self.attention_self(x, attn_bias))
        x = self.attention_output_LayerNorm(x + attn_out)
        inter = F.gelu(self.intermediate_dense(x))
        return self.output_LayerNorm(x + self.output_dense(inter))


class BertEncoder(nn.Module):
    """forward(input_ids, attention_mask) -> (last_hidden_state, CLS embedding)."""

    def __init__(self, cfg: BertConfig, device="cuda", dtype=torch.float32, remat: bool = False):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.remat = remat
        self.embeddings = BertEmbeddings(cfg, **fk)
        self.layers = nn.ModuleList([BertLayer(cfg, **fk) for _ in range(cfg.num_layers)])

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        neg = torch.finfo(torch.float32).min
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, neg).to(torch.float32)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, bias, use_reentrant=False)
            else:
                x = layer(x, bias)
        return x, x[:, 0]
