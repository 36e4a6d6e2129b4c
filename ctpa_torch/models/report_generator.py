"""Report generation: a CTViT vision feature conditioning the LLM through one
cross-attention layer, decoded with the KV cache (port of
``ctpa/models/report_generator.py``: the vision feature extractor, the
cross-attention, the training forward and its losses, and ``generate``).

``loss`` and ``loss_from_vision`` are ctpa's shifted-label cross-entropy:
position i predicts token i + 1, pads (and, with ``label_mask``, the
prompt) are masked out, the log-softmax is fp32.

``generate`` prefills the right-padded prompts once, then runs one cached
single-token step per new token; it stops when every sequence has emitted
EOS, which costs one read of a device flag per step.  It computes the
lm_head only where ctpa's logits are used: on the cross-attended hidden
state of each sequence's last real prompt token, then once per step.
Speculative decoding waits for a later slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ctpa_torch.core.config import CTViTConfig, LLMConfig, LoRAConfig, ReportGenConfig
from ctpa_torch.models.ctvit import CTViT, PatchEmbed3D
from ctpa_torch.models.layers import AffineLayerNorm, Dense, compute_dtype
from ctpa_torch.models.llm import KVCache, LlamaForCausalLM
from ctpa_torch.ops.sampling import sample_logits

# flax's LayerNorm default epsilon
LN_EPS = 1e-6


class _PatchEmbedOnly(nn.Module):
    """The part of a CTViT the patch-embed-only extractor has parameters for."""

    def __init__(self, cfg: CTViTConfig, device=None, dtype=None):
        super().__init__()
        self.patch_embed = PatchEmbed3D(cfg, device=device, dtype=dtype)


class VisionFeatureExtractor(nn.Module):
    """CTViT tokens -> one (b, out_dim) vision feature: the mean over (h, w),
    then over t, a Linear, a LayerNorm and the exact erf GELU.  With
    ``use_encoder=False`` (the report generator's) the tokens are the patch
    embedding alone, which goes through the patchify kernel when
    ``vit_cfg.pallas_patchify``; with True they are the full axial encode.
    A video that does not fit the configuration raises; there is no random
    fallback."""

    def __init__(self, vit_cfg: CTViTConfig, out_dim: int = 512, use_encoder: bool = False,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.vit_cfg, self.use_encoder = vit_cfg, use_encoder
        self.ctvit = CTViT(vit_cfg, **fk) if use_encoder else _PatchEmbedOnly(vit_cfg, **fk)
        self.proj = Dense(vit_cfg.dim, out_dim, **fk)
        self.norm = AffineLayerNorm(out_dim, eps=LN_EPS, **fk)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        c = self.vit_cfg
        expect = (c.channels, c.temporal_size, c.image_size, c.image_size)
        if video.ndim != 5 or tuple(video.shape[1:]) != expect:
            raise ValueError(f"video {tuple(video.shape)} is not (b, {', '.join(map(str, expect))})")
        tokens = self.ctvit(video)[0] if self.use_encoder else self.ctvit.patch_embed(video)
        pooled = tokens.mean(dim=(2, 3)).mean(dim=1)
        return F.gelu(self.norm(self.proj(pooled)))


class CrossAttentionLayer(nn.Module):
    """Q from the LLM hidden states (b, n, llm_dim), K and V from the one
    vision token (b, vision_dim), 8 heads; residual and LayerNorm.  The
    softmax over a single key is 1; it is computed all the same, as ctpa
    does."""

    def __init__(self, llm_dim: int, vision_dim: int, num_heads: int = 8, device=None,
                 dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.num_heads = num_heads
        self.q = Dense(llm_dim, llm_dim, **fk)
        self.k = Dense(vision_dim, llm_dim, **fk)
        self.v = Dense(vision_dim, llm_dim, **fk)
        self.out = Dense(llm_dim, llm_dim, **fk)
        self.norm = AffineLayerNorm(llm_dim, eps=LN_EPS, **fk)

    def forward(self, hidden: torch.Tensor, vision: torch.Tensor) -> torch.Tensor:
        b, n, d = hidden.shape
        h = self.num_heads
        hd = d // h
        ctx = vision[:, None, :]
        q = self.q(hidden).reshape(b, n, h, hd)
        k = self.k(ctx).reshape(b, 1, h, hd)
        v = self.v(ctx).reshape(b, 1, h, hd)
        sim = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) / math.sqrt(hd)
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, d)
        return self.norm(hidden + self.out(out))


class GenerateResult(NamedTuple):
    tokens: torch.Tensor      # (b, max_new) generated ids, pad_token_id after EOS
    lengths: torch.Tensor     # (b,) real generated tokens (neither pad nor EOS)


class CTReportGenerator(nn.Module):
    """The LLM with vision cross-attention.  ``dtype`` is the parameters'
    dtype; the compute dtype (ctpa's ``dtype``) is set with
    ``models.layers.set_compute_dtype``.  The KV cache is kept in the
    compute dtype (or int8 with ``llm_cfg.kv_quant``)."""

    def __init__(self, llm_cfg: LLMConfig, vit_cfg: CTViTConfig,
                 gen_cfg: ReportGenConfig = ReportGenConfig(), lora: Optional[LoRAConfig] = None,
                 device="cuda", dtype=torch.float32):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.llm_cfg, self.vit_cfg, self.gen_cfg = llm_cfg, vit_cfg, gen_cfg
        self.llm = LlamaForCausalLM(llm_cfg, lora, **fk)
        self.vision_feature_extractor = VisionFeatureExtractor(vit_cfg, gen_cfg.vision_dim, **fk)
        self.cross_attention = CrossAttentionLayer(llm_cfg.hidden_size, gen_cfg.vision_dim, **fk)

    def cache_dtype(self) -> torch.dtype:
        """The trunk's activation dtype, which the float KV cache keeps (a
        quantized lm_head has no float weight to take it from)."""
        return compute_dtype(self.llm.model, self.llm.model.embed_tokens.weight)

    def extract_vision(self, video: torch.Tensor) -> torch.Tensor:
        return self.vision_feature_extractor(video)

    def forward(self, video, input_ids, attention_mask):
        """Training forward: logits (b, n, vocab) with vision conditioning."""
        vision = self.extract_vision(video)
        hidden, _ = self.llm.model(input_ids, attention_mask)
        return self._fused_logits(hidden, vision)

    def _fused_logits(self, hidden, vision):
        return self.llm.apply_lm_head(self.cross_attention(hidden, vision))

    def loss(self, video, input_ids, attention_mask, label_mask=None):
        """The shifted-label cross-entropy of the training forward."""
        return self._ce(self(video, input_ids, attention_mask), input_ids, attention_mask,
                        label_mask)

    def loss_from_vision(self, vision, input_ids, attention_mask, label_mask=None):
        """The same loss over precomputed (b, vision_dim) vision features, so a
        fine-tune with a frozen vision trunk runs the trunk once, outside the
        training step."""
        hidden, _ = self.llm.model(input_ids, attention_mask)
        return self._ce(self._fused_logits(hidden, vision), input_ids, attention_mask,
                        label_mask)

    @staticmethod
    def _ce(logits, input_ids, attention_mask, label_mask=None):
        """Mean negative log-likelihood of tokens 1.. under the logits of
        positions ..n-2, over the positions the masks keep."""
        targets = input_ids[:, 1:].long()
        mask = attention_mask[:, 1:].float()
        if label_mask is not None:
            mask = mask * label_mask[:, 1:].float()
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    @torch.no_grad()
    def generate(self, video, input_ids, attention_mask, max_new_tokens: int, eos_token_id: int,
                 pad_token_id: int = 0, temperature: float = 0.7,
                 generator: Optional[torch.Generator] = None, greedy: bool = False,
                 top_k: Optional[int] = None, top_p: Optional[float] = None) -> GenerateResult:
        """Decode up to ``max_new_tokens`` from (b, n) right-padded prompts;
        each sequence stops at its first EOS and is padded with
        ``pad_token_id`` after it.  ``generator`` (on the model's device)
        draws the samples; ``greedy`` takes the argmax."""
        b, n = input_ids.shape
        dev = input_ids.device
        vision = self.extract_vision(video)
        cache = KVCache.create(self.llm_cfg, b, max_len=n + max_new_tokens,
                               dtype=self.cache_dtype(), device=dev)
        # right-padded prompts prefill slots [0, n) together, so every
        # sequence writes at one shared slot from here on
        hidden, cache = self.llm.model(input_ids, attention_mask, cache, shared_kv_offset=True)
        last = torch.clamp(attention_mask.sum(-1) - 1, min=0).long()
        last_hidden = hidden[torch.arange(b, device=dev), last][:, None]        # (b, 1, d)

        def sample(logits):
            return sample_logits(logits, generator, temperature=temperature, top_k=top_k,
                                 top_p=top_p, greedy=greedy)

        tok = sample(self._fused_logits(last_hidden, vision)[:, 0])
        done = tok == eos_token_id
        out = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.long, device=dev)
        out[:, 0] = torch.where(done, eos_token_id, tok)
        for i in range(1, max_new_tokens):
            if bool(done.all()):           # the one host read of a step
                break
            hidden, cache = self.llm.model(tok[:, None], None, cache, shared_kv_offset=True)
            nxt = torch.where(done, pad_token_id, sample(self._fused_logits(hidden, vision)[:, 0]))
            out[:, i] = nxt
            done = done | (nxt == eos_token_id)
            tok = nxt
        real = (out != pad_token_id) & (out != eos_token_id)
        return GenerateResult(tokens=out, lengths=real.sum(-1))
