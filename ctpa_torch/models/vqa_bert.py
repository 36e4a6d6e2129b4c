"""BERT-decoder VQA variant (port of ``ctpa/models/vqa_bert.py``).

CXR-BERT encodes the question; the report generator's cross-attention layer
attends the text hidden states to the projected vision feature; a
concat-fusion MLP merges the two streams; an lm_head over the BERT vocab
scores answer tokens, trained with the shifted cross-entropy masked on
padding.  ``lora_rank``/``lora_alpha`` put LoRA deltas on the BERT query,
key and value projections (peft r=16, alpha=32); ``vqa_trainable_mask`` is
ctpa's freeze rule (the BERT base and the CTViT patch trunk frozen, the
adapters and every other module trainable).  ``SimpleVisionFeatureExtractor``
mean-pools the patch embedding.  No hand-written kernel is involved: the
patch embed takes the patchify kernel only where ``vit_cfg.pallas_patchify``
is set, which ctpa's VQA model never sets.

Parameter names follow ctpa's flax tree (``text_encoder``,
``vision_extractor.ctvit.patch_embed``, ``vision_proj``,
``cross_attention``, ``fusion.layers.0`` and ``.2`` for flax's
``fusion/layers_0`` and ``layers_2``, ``lm_head``), so ``ctpa_torch.convert``
carries its weights.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ctpa_torch.core.config import BertConfig, CTViTConfig
from ctpa_torch.models.bert import BertEncoder
from ctpa_torch.models.layers import Dense
from ctpa_torch.models.lora import is_lora
from ctpa_torch.models.report_generator import CrossAttentionLayer, _PatchEmbedOnly
from ctpa_torch.ops.sampling import categorical
from ctpa_torch.train.optim import Optimizer, warmup_cosine_decay


class SimpleVisionFeatureExtractor(nn.Module):
    """Patch-embed -> mean over (t, h, w) -> Linear."""

    def __init__(self, vit_cfg: CTViTConfig, out_dim: int = 512, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.ctvit = _PatchEmbedOnly(vit_cfg, **fk)
        self.proj = Dense(vit_cfg.dim, out_dim, **fk)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        tokens = self.ctvit.patch_embed(video)                  # (b, t, h, w, d)
        return self.proj(tokens.mean(dim=(1, 2, 3)))


class _Fusion(nn.Module):
    """Linear, exact GELU, Linear (ctpa's ``nn.Sequential``)."""

    def __init__(self, hidden: int, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList([Dense(2 * hidden, hidden, **fk), nn.GELU(),
                                     Dense(hidden, hidden, **fk)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class MedicalVQAModel(nn.Module):
    def __init__(self, bert_cfg: BertConfig, vit_cfg: CTViTConfig, vision_dim: int = 512,
                 lora_rank: int = 0, lora_alpha: float = 32.0, device="cuda",
                 dtype=torch.float32):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        h = bert_cfg.hidden_size
        self.bert_cfg = bert_cfg
        self.text_encoder = BertEncoder(bert_cfg, **fk, lora_rank=lora_rank,
                                        lora_alpha=lora_alpha)
        self.vision_extractor = SimpleVisionFeatureExtractor(vit_cfg, vision_dim, **fk)
        self.vision_proj = Dense(vision_dim, h, **fk)
        self.cross_attention = CrossAttentionLayer(h, h, **fk)
        self.fusion = _Fusion(h, **fk)
        self.lm_head = Dense(h, bert_cfg.vocab_size, **fk)

    def forward(self, video, input_ids, attention_mask):
        """(b, n, vocab) logits over answer tokens."""
        hidden, _ = self.text_encoder(input_ids, attention_mask)
        vision = self.vision_proj(self.vision_extractor(video))            # (b, hidden)
        attended = self.cross_attention(hidden, vision)
        fused = self.fusion(torch.cat([attended, vision[:, None].to(attended.dtype)
                                       .expand_as(attended)], dim=-1))
        return self.lm_head(fused)

    def loss(self, video, input_ids, attention_mask, pad_token_id: int = 0):
        """The shifted cross-entropy, masked where the target is a pad."""
        logits = self(video, input_ids, attention_mask)[:, :-1]
        targets = input_ids[:, 1:].long()
        mask = (targets != pad_token_id).float()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    @torch.no_grad()
    def generate(self, video, input_ids, attention_mask, max_new_tokens: int,
                 sep_token_id: int, temperature: float = 0.7,
                 generator: Optional[torch.Generator] = None, greedy: bool = True):
        """Greedy or sampled decoding with a SEP-token stop.  BERT is
        bidirectional, so each step re-encodes the grown sequence in a buffer
        of fixed length (prompt + max_new_tokens), as ctpa's scan does; a
        finished sequence appends pads (id 0, mask 0).  ``generator`` (on the
        model's device) draws the samples.  -> (ids (b, total), lengths (b,))."""
        b, n0 = input_ids.shape
        dev = input_ids.device
        ids = torch.zeros(b, n0 + max_new_tokens, dtype=torch.long, device=dev)
        mask = torch.zeros_like(ids)
        ids[:, :n0], mask[:, :n0] = input_ids, attention_mask
        lengths = attention_mask.sum(-1).long()
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        rows = torch.arange(b, device=dev)
        for _ in range(max_new_tokens):
            last = self(video, ids, mask)[rows, lengths - 1]
            nxt = (torch.argmax(last, dim=-1) if greedy
                   else categorical(last.float() / temperature, generator))
            nxt = torch.where(done, 0, nxt)
            ids[rows, lengths] = nxt
            mask[rows, lengths] = (~done).long()
            lengths = lengths + (~done).long()
            done = done | (nxt == sep_token_id)
        return ids, lengths


def vqa_trainable_mask(model: nn.Module) -> dict[str, bool]:
    """Parameter name -> True for the BERT LoRA adapters and every parameter
    outside the two frozen trunks (the cross-attention, the projections, the
    fusion, the lm_head); False for the BERT base (``text_encoder``) and the
    CTViT patch trunk (``ctvit``), as ctpa's peft freeze."""

    def label(name: str) -> bool:
        if is_lora(name):
            return True
        return not any(part in ("ctvit", "text_encoder") for part in name.split("."))

    return {name: label(name) for name, _ in model.named_parameters()}


def make_vqa_optimizer(model: nn.Module, lr: float = 2e-5, weight_decay: float = 0.01,
                       t_max: int = 10) -> Optimizer:
    """AdamW(lr, weight_decay on every trainable parameter) with a cosine
    decay to 0 over ``t_max`` updates (optax's ``cosine_decay_schedule``),
    over the ``vqa_trainable_mask`` set; the frozen parameters stop requiring
    grad, so they keep no gradient and get no update (ctpa's
    ``set_to_zero``)."""
    mask = vqa_trainable_mask(model)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    params = [p for name, p in model.named_parameters() if mask[name]]
    schedule = warmup_cosine_decay(lr, lr, 0, max(t_max, 1))
    return Optimizer([(params, schedule, weight_decay)])
