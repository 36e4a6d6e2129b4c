"""CTCLIP, serving half (port of ``ctpa/models/ctclip.py``): the BERT text
tower with CLS pooling -> Linear -> l2norm, the CTViT tower with temporal
mean-pool -> flatten -> Linear -> l2norm, and the learned log-temperature.
The losses and the training-time variants belong to the training slice."""

from __future__ import annotations

import torch
from einops import rearrange
from torch import nn

from ctpa_torch.core.config import BertConfig, CTCLIPConfig, CTViTConfig
from ctpa_torch.models.bert import BertEncoder
from ctpa_torch.models.ctvit import CTViT
from ctpa_torch.ops.attention_ops import l2norm
from ctpa_torch.ops.vq import VQState


class CTCLIP(nn.Module):
    def __init__(self, cfg: CTCLIPConfig, vit_cfg: CTViTConfig, bert_cfg: BertConfig,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.text_transformer = BertEncoder(bert_cfg, **fk)
        self.visual_transformer = CTViT(vit_cfg, **fk)
        self.to_text_latent = nn.Linear(cfg.dim_text, cfg.dim_latent, bias=False, **fk)
        # 294,912 -> 512 at the shipped geometry: a plain matrix product
        self.to_visual_latent = nn.Linear(cfg.dim_image, cfg.dim_latent, bias=False, **fk)
        self.temperature = nn.Parameter(torch.tensor(cfg.temperature_init, **fk))

    def encode_text(self, input_ids, attention_mask) -> torch.Tensor:
        """(b, dim_latent) l2-normalised text latent (CLS pooling)."""
        _, cls = self.text_transformer(input_ids, attention_mask)
        return l2norm(self.to_text_latent(cls))

    def encode_image_tokens(self, video, vq_state: VQState | None = None):
        return self.visual_transformer(video, vq_state)

    def pool_image_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Temporal mean-pool then flatten: (b, t, h, w, d) -> (b, h*w*d)."""
        return rearrange(tokens.mean(dim=1), "b h w d -> b (h w d)")

    def encode_image(self, video, vq_state: VQState | None = None):
        """-> ((b, dim_latent) l2-normalised image latent, VQOutput | None)."""
        tokens, vq_out = self.encode_image_tokens(video, vq_state)
        return l2norm(self.to_visual_latent(self.pool_image_tokens(tokens))), vq_out
