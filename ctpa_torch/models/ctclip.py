"""CTCLIP (port of ``ctpa/models/ctclip.py``): the BERT text tower with CLS
pooling -> Linear -> l2norm, the CTViT tower with temporal mean-pool ->
flatten -> Linear -> l2norm, the learned log-temperature, and the
bidirectional InfoNCE loss (optionally decoupled) over the temperature-scaled
similarity.  The FILIP, CLOOB, downsample and MLM variants raise until their
slice lands; so does ``contrastive_loss_sharded``'s data parallelism."""

from __future__ import annotations

from typing import NamedTuple

import torch
from einops import rearrange
from torch import nn

from ctpa_torch.core.config import BertConfig, CTCLIPConfig, CTViTConfig
from ctpa_torch.models.bert import BertEncoder
from ctpa_torch.models.ctvit import CTViT
from ctpa_torch.models.layers import Dense
from ctpa_torch.ops.attention_ops import l2norm
from ctpa_torch.ops.vq import VQState


class CLIPOutput(NamedTuple):
    loss: torch.Tensor | None
    sim: torch.Tensor | None           # similarity logits (temperature-scaled)
    text_latents: torch.Tensor
    image_latents: torch.Tensor
    vq_commit_loss: torch.Tensor | None
    vq_counts: torch.Tensor | None
    vq_sums: torch.Tensor | None


def matrix_diag(t: torch.Tensor) -> torch.Tensor:
    """Diagonal over the last two dims."""
    return torch.diagonal(t, dim1=-2, dim2=-1)


def infonce_directional(sim: torch.Tensor, axis: int, decoupled: bool = False) -> torch.Tensor:
    """One direction of InfoNCE: positives on the diagonal, the denominator
    over ``axis`` (1 = text->image over images, 0 = image->text over texts);
    ``decoupled`` takes the positive out of the denominator."""
    m, n = sim.shape
    if m != n:
        raise ValueError(f"contrastive batch must be square, got {tuple(sim.shape)}")
    pos = matrix_diag(sim)
    if decoupled:
        eye = torch.eye(m, dtype=torch.bool, device=sim.device)
        sim = sim.masked_fill(eye, torch.finfo(sim.dtype).min)
    return (torch.logsumexp(sim, dim=axis) - pos).mean()


def infonce_loss(sim: torch.Tensor, decoupled: bool = False,
                 sim_image_to_text: torch.Tensor | None = None) -> torch.Tensor:
    """Bidirectional InfoNCE over a temperature-scaled (m, m) similarity with
    positives on the diagonal; the image->text direction scores
    ``sim_image_to_text`` when given."""
    t2i = infonce_directional(sim, axis=1, decoupled=decoupled)
    i2t = infonce_directional(sim if sim_image_to_text is None else sim_image_to_text,
                              axis=0, decoupled=decoupled)
    return (t2i + i2t) / 2


class CTCLIP(nn.Module):
    """``dtype`` is the parameters' dtype.  The compute dtype, what ctpa's
    ``CTCLIP(dtype=...)`` names, is set with
    ``models.layers.set_compute_dtype`` (the training step sets it from its
    precision policy); by default the model computes in its parameters'
    dtype."""

    def __init__(self, cfg: CTCLIPConfig, vit_cfg: CTViTConfig, bert_cfg: BertConfig,
                 device="cuda", dtype=torch.float32, remat: bool = False):
        super().__init__()
        unported = [name for name in ("use_all_token_embeds", "extra_latent_projection",
                                      "downsample_image_embeds", "use_mlm")
                    if getattr(cfg, name)]
        if unported:
            raise NotImplementedError(f"CTCLIPConfig {unported} are not ported yet")
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.text_transformer = BertEncoder(bert_cfg, remat=remat, **fk)
        self.visual_transformer = CTViT(vit_cfg, remat=remat, **fk)
        self.to_text_latent = Dense(cfg.dim_text, cfg.dim_latent, bias=False, **fk)
        # 294,912 -> 512 at the shipped geometry: a plain matrix product
        self.to_visual_latent = Dense(cfg.dim_image, cfg.dim_latent, bias=False, **fk)
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

    def forward(self, input_ids, attention_mask, video, vq_state: VQState | None = None,
                return_loss: bool = True) -> CLIPOutput:
        """Both towers and, with ``return_loss``, the InfoNCE loss over the
        (b, b) similarity; without it the elementwise text-image score."""
        temp = torch.exp(self.temperature).float()
        text_lat = self.encode_text(input_ids, attention_mask)
        img_lat, vq_out = self.encode_image(video, vq_state)
        vq = (None, None, None) if vq_out is None else (vq_out.commit_loss, vq_out.counts,
                                                        vq_out.sums)
        # fp32 similarity from the compute-dtype latents (preferred_element_type)
        t, i = text_lat.float(), img_lat.float()
        if not return_loss:
            score = (t * i.expand_as(t)).sum(-1) * temp
            return CLIPOutput(None, score, text_lat, img_lat, *vq)
        sim = torch.matmul(t, i.t()) * temp
        loss = infonce_loss(sim, decoupled=self.cfg.decoupled_contrastive_learning)
        return CLIPOutput(loss, sim, text_lat, img_lat, *vq)
