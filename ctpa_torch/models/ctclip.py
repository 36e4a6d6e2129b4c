"""CTCLIP (port of ``ctpa/models/ctclip.py``): the BERT text tower with CLS
pooling -> Linear -> l2norm, the CTViT tower with temporal mean-pool ->
flatten -> Linear -> l2norm, the learned log-temperature, and the
bidirectional InfoNCE loss (optionally decoupled) over the temperature-scaled
similarity.  The variants of ``CTCLIPConfig``: CLOOB's extra latent
projections for the image->text direction, the stride-2 depthwise
downsample of the pooled token grid, FILIP's all-token similarity, the MLM
head (``mlm_logits``), the visual-SSL embedding and the multi-view loss.

Data parallelism: with a ``mesh``, ``forward`` all-gathers the latents over
its data axis before the similarity (``comms/collectives.py:
all_gather_batch``, a reduce-scatter in the backward), so every rank's loss
is the global batch's InfoNCE, as ctpa's under pjit; a rank's local rows
alone would give the reference repo's local negatives."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from einops import rearrange
from torch import nn

from ctpa_torch.comms.collectives import all_gather_batch
from ctpa_torch.core.config import BertConfig, CTCLIPConfig, CTViTConfig
from ctpa_torch.core.mesh import DATA_AXIS
from ctpa_torch.models.bert import BertEncoder, BertMLMHead
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


def filip_similarity(text_tokens: torch.Tensor, image_tokens: torch.Tensor,
                     text_mask: torch.Tensor) -> torch.Tensor:
    """FILIP's fine-grained (m, n) similarity of l2-normalised token latents
    (m, tt, d) and (n, ti, d) with the (m, tt) text mask (True = real): each
    real text token's best image token, averaged over the real text tokens,
    and each image token's best real text token, averaged over the image
    tokens; the mean of the two.  Sums in fp32."""
    sim = torch.einsum("mtd,nid->mnti", text_tokens.float(), image_tokens.float())
    mask = text_mask.bool()
    masked = sim.masked_fill(~mask[:, None, :, None], torch.finfo(torch.float32).min)
    t2i = masked.amax(-1) * mask[:, None, :].float()              # (m, n, tt)
    t2i = t2i.sum(-1) / torch.clamp(mask.float().sum(-1)[:, None], min=1.0)
    i2t = masked.amax(-2).mean(-1)                                # (m, n)
    return (t2i + i2t) / 2


def infonce_loss(sim: torch.Tensor, decoupled: bool = False,
                 sim_image_to_text: torch.Tensor | None = None) -> torch.Tensor:
    """Bidirectional InfoNCE over a temperature-scaled (m, m) similarity with
    positives on the diagonal; the image->text direction scores
    ``sim_image_to_text`` when given."""
    t2i = infonce_directional(sim, axis=1, decoupled=decoupled)
    i2t = infonce_directional(sim if sim_image_to_text is None else sim_image_to_text,
                              axis=0, decoupled=decoupled)
    return (t2i + i2t) / 2


def contrastive_loss_sharded(text_lat: torch.Tensor, img_lat: torch.Tensor,
                             temp: torch.Tensor, mesh, axis: str = DATA_AXIS,
                             decoupled: bool = False) -> torch.Tensor:
    """InfoNCE over the global batch from this rank's latent rows: both are
    all-gathered over ``axis`` and the global similarity scored; the loss is
    the same on every rank."""
    gt = all_gather_batch(text_lat, mesh, axis).float()
    gi = all_gather_batch(img_lat, mesh, axis).float()
    return infonce_loss(torch.matmul(gt, gi.t()) * temp, decoupled=decoupled)


class CTCLIP(nn.Module):
    """``dtype`` is the parameters' dtype.  The compute dtype, what ctpa's
    ``CTCLIP(dtype=...)`` names, is set with
    ``models.layers.set_compute_dtype`` (the training step sets it from its
    precision policy); by default the model computes in its parameters'
    dtype.  The optional heads are built where ctpa's forward creates their
    parameters: the CLOOB projections only without FILIP, the MLM head with
    ``use_mlm``."""

    def __init__(self, cfg: CTCLIPConfig, vit_cfg: CTViTConfig, bert_cfg: BertConfig,
                 device="cuda", dtype=torch.float32, remat: bool = False):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.text_transformer = BertEncoder(bert_cfg, remat=remat, **fk)
        self.visual_transformer = CTViT(vit_cfg, remat=remat, **fk)
        self.to_text_latent = Dense(cfg.dim_text, cfg.dim_latent, bias=False, **fk)
        # 294,912 -> 512 at the shipped geometry: a plain matrix product; with
        # FILIP it projects each token (dim_image = the token width)
        self.to_visual_latent = Dense(cfg.dim_image, cfg.dim_latent, bias=False, **fk)
        if cfg.extra_latent_projection and not cfg.use_all_token_embeds:
            self.to_text_latent_extra = Dense(cfg.dim_text, cfg.dim_latent, bias=False, **fk)
            self.to_visual_latent_extra = Dense(cfg.dim_image, cfg.dim_latent, bias=False, **fk)
        if cfg.downsample_image_embeds:
            self.downsample_depthwise = nn.Parameter(torch.zeros(4, 4, vit_cfg.dim, **fk))
            self.downsample_pointwise = Dense(vit_cfg.dim, cfg.dim_latent, **fk)
        self.temperature = nn.Parameter(torch.tensor(cfg.temperature_init, **fk))
        if cfg.use_mlm:
            self.mlm_head = BertMLMHead(bert_cfg, **fk)

    def text_latent(self, hidden: torch.Tensor) -> torch.Tensor:
        """The l2-normalised projection of a CLS vector (FILIP: of each token)."""
        return l2norm(self.to_text_latent(hidden))

    def image_latent(self, pooled: torch.Tensor) -> torch.Tensor:
        """The l2-normalised projection of pooled image tokens (FILIP: of each token)."""
        return l2norm(self.to_visual_latent(pooled))

    def encode_text(self, input_ids, attention_mask) -> torch.Tensor:
        """(b, dim_latent) l2-normalised text latent (CLS pooling)."""
        _, cls = self.text_transformer(input_ids, attention_mask)
        return self.text_latent(cls)

    def encode_image_tokens(self, video, vq_state: VQState | None = None):
        return self.visual_transformer(video, vq_state)

    def pool_image_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Temporal mean-pool then flatten: (b, t, h, w, d) -> (b, h*w*d).
        With ``downsample_image_embeds`` a stride-2 4x4 depthwise convolution
        (padding 1, as ctpa's 16 shifted strided sums, in fp32 whatever the
        compute dtype) and a 1x1 convolution to dim_latent shrink the grid
        first, to ceil((h - 1) / 2) x ceil((w - 1) / 2)."""
        pooled = tokens.mean(dim=1)                     # (b, h, w, d)
        if not self.cfg.downsample_image_embeds:
            return rearrange(pooled, "b h w d -> b (h w d)")
        _, h, w, _ = pooled.shape
        xp = F.pad(pooled, (0, 0, 1, 1, 1, 1)).float()
        dw = self.downsample_depthwise.float()
        acc = None
        for i in range(4):
            for j in range(4):
                term = xp[:, i:i + h - 1:2, j:j + w - 1:2, :] * dw[i, j]
                acc = term if acc is None else acc + term
        return rearrange(self.downsample_pointwise(acc), "b h w d -> b (h w d)")

    def encode_image(self, video, vq_state: VQState | None = None):
        """-> ((b, dim_latent) l2-normalised image latent, VQOutput | None)."""
        tokens, vq_out = self.encode_image_tokens(video, vq_state)
        return self.image_latent(self.pool_image_tokens(tokens)), vq_out

    def mlm_logits(self, input_ids, attention_mask) -> torch.Tensor:
        """(b, n, vocab) masked-LM logits over the text tower (``use_mlm``)."""
        hidden, _ = self.text_transformer(input_ids, attention_mask)
        return self.mlm_head(hidden)

    def visual_ssl_embed(self, video) -> torch.Tensor:
        """The pooled, projected, l2-normalised embedding of a view, without
        the VQ bottleneck: what the SimCLR objective compares."""
        tokens, _ = self.visual_transformer(video, None)
        return self.image_latent(self.pool_image_tokens(tokens))

    def _nce(self, text_lat, img_lat, temp) -> torch.Tensor:
        sim = torch.matmul(text_lat.float(), img_lat.float().t()) * temp
        return infonce_loss(sim, decoupled=self.cfg.decoupled_contrastive_learning)

    def multiview_loss(self, input_ids, attention_mask, video, aug_input_ids=None,
                       aug_attention_mask=None, aug_video=None,
                       vq_state: VQState | None = None) -> torch.Tensor:
        """The InfoNCE of the primary pair weighted by (1 - w), plus w times
        the mean over the given augmented views, (aug_text, image) and
        (text, aug_image); w is ``multiview_loss_weight``.  Without views,
        the primary loss."""
        temp = torch.exp(self.temperature).float()
        text_lat = self.encode_text(input_ids, attention_mask)
        img_lat, _ = self.encode_image(video, vq_state)
        loss = self._nce(text_lat, img_lat, temp)
        views = []
        if aug_input_ids is not None:
            views.append(self._nce(self.encode_text(aug_input_ids, aug_attention_mask),
                                   img_lat, temp))
        if aug_video is not None:
            views.append(self._nce(text_lat, self.encode_image(aug_video, vq_state)[0], temp))
        if not views:
            return loss
        w = self.cfg.multiview_loss_weight
        return (1.0 - w) * loss + w * (sum(views) / len(views))

    def forward(self, input_ids, attention_mask, video, vq_state: VQState | None = None,
                return_loss: bool = True, mesh=None, axis: str = DATA_AXIS) -> CLIPOutput:
        """Both towers and, with ``return_loss``, the InfoNCE loss over the
        (b, b) similarity (FILIP's with ``use_all_token_embeds``; CLOOB's
        extra projections score the image->text direction); without it the
        elementwise text-image score.  With ``mesh`` the batch is this
        rank's rows: the latents (FILIP's token latents and text mask) are
        gathered over ``axis`` first, and ``sim`` is the global one; the
        returned latents and VQ statistics are this rank's."""
        cfg = self.cfg
        temp = torch.exp(self.temperature).float()
        text_hidden, text_cls = self.text_transformer(input_ids, attention_mask)
        tokens, vq_out = self.encode_image_tokens(video, vq_state)
        vq = (None, None, None) if vq_out is None else (vq_out.commit_loss, vq_out.counts,
                                                        vq_out.sums)
        gather = ((lambda x: x) if mesh is None or not return_loss
                  else (lambda x: all_gather_batch(x, mesh, axis)))
        if cfg.use_all_token_embeds:
            if not return_loss:
                raise ValueError("FILIP's token latents have no elementwise score")
            text_lat = self.text_latent(text_hidden)
            img_lat = self.image_latent(rearrange(tokens, "b t h w d -> b (t h w) d"))
            sim = filip_similarity(gather(text_lat), gather(img_lat),
                                   gather(attention_mask) > 0) * temp
        else:
            pooled = self.pool_image_tokens(tokens)
            text_lat, img_lat = self.text_latent(text_cls), self.image_latent(pooled)
            # fp32 similarity from the compute-dtype latents (preferred_element_type)
            t, i = text_lat.float(), img_lat.float()
            if not return_loss:
                score = (t * i.expand_as(t)).sum(-1) * temp
                return CLIPOutput(None, score, text_lat, img_lat, *vq)
            sim = torch.matmul(gather(t), gather(i).t()) * temp
        sim_i2t = None
        if cfg.extra_latent_projection and not cfg.use_all_token_embeds:
            text_extra = gather(l2norm(self.to_text_latent_extra(text_cls)).float())
            img_extra = gather(l2norm(self.to_visual_latent_extra(pooled)).float())
            sim_i2t = torch.matmul(text_extra, img_extra.t()) * temp
        loss = infonce_loss(sim, decoupled=cfg.decoupled_contrastive_learning,
                            sim_image_to_text=sim_i2t)
        return CLIPOutput(loss, sim, text_lat, img_lat, *vq)
