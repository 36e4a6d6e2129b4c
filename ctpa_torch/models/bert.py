"""BERT text encoder (port of ``ctpa/models/bert.py``), HF BertModel geometry.
Attention is plain scaled dot-product with fp32 scores and softmax; no
hand-written kernel is involved.  Parameters are cast to the compute dtype
at use (``models/layers.py``).  ``remat`` recomputes each layer in the
backward, as ctpa's ``nn.remat``.  ``lora_rank > 0`` adds LoRA deltas on the
query, key and value projections, ``W x + b + (alpha / rank) (x A) B``, as
ctpa's (the VQA model's peft r=16, alpha=32): A (in, rank) ~ N(0, 1/rank)
and B (rank, out) zero, both fp32, held beside the projections as
``query_lora_a`` / ``query_lora_b`` and so on, ctpa's names, so the HF
import and the converter are unchanged.  The MLM head belongs to a later
slice."""

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
    def __init__(self, cfg: BertConfig, device=None, dtype=None, lora_rank: int = 0,
                 lora_alpha: float = 1.0):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        hs = cfg.hidden_size
        self.heads = cfg.num_heads
        self.lora_rank, self.lora_alpha = lora_rank, lora_alpha
        for name in ("query", "key", "value"):
            setattr(self, name, Dense(hs, hs, **fk))
            if lora_rank > 0:
                setattr(self, f"{name}_lora_a", nn.Parameter(
                    torch.randn(hs, lora_rank, device=device) / lora_rank))
                setattr(self, f"{name}_lora_b", nn.Parameter(
                    torch.zeros(lora_rank, hs, device=device)))

    def _proj(self, x, name: str):
        y = getattr(self, name)(x)
        if self.lora_rank > 0:
            a, b = getattr(self, f"{name}_lora_a"), getattr(self, f"{name}_lora_b")
            y = y + (x @ a.to(x.dtype)) @ b.to(x.dtype) * (self.lora_alpha / self.lora_rank)
        return y

    def forward(self, x, attn_bias):
        b, n, hidden = x.shape
        dh = hidden // self.heads
        q, k, v = (self._proj(x, name).reshape(b, n, self.heads, dh).transpose(1, 2)
                   for name in ("query", "key", "value"))
        # fp32 scores from the compute-dtype q and k (preferred_element_type)
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(dh) + attn_bias
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        return torch.matmul(attn, v).transpose(1, 2).reshape(b, n, hidden)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device=None, dtype=None, lora_rank: int = 0,
                 lora_alpha: float = 1.0):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        hs, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention_self = BertSelfAttention(cfg, **fk, lora_rank=lora_rank,
                                                lora_alpha=lora_alpha)
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

    def __init__(self, cfg: BertConfig, device="cuda", dtype=torch.float32, remat: bool = False,
                 lora_rank: int = 0, lora_alpha: float = 1.0):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.remat = remat
        self.embeddings = BertEmbeddings(cfg, **fk)
        self.layers = nn.ModuleList([BertLayer(cfg, **fk, lora_rank=lora_rank,
                                               lora_alpha=lora_alpha)
                                     for _ in range(cfg.num_layers)])

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


class BertMLMHead(nn.Module):
    """Masked-LM prediction head: dense -> exact GELU -> LayerNorm -> decoder
    to the vocabulary (ctpa's names: ``transform_dense``,
    ``transform_LayerNorm``, ``decoder``)."""

    def __init__(self, cfg: BertConfig, device="cuda", dtype=torch.float32):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.transform_dense = Dense(cfg.hidden_size, cfg.hidden_size, **fk)
        self.transform_LayerNorm = AffineLayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **fk)
        self.decoder = Dense(cfg.hidden_size, cfg.vocab_size, **fk)

    def forward(self, hidden):
        x = F.gelu(self.transform_dense(hidden))
        return self.decoder(self.transform_LayerNorm(x))
