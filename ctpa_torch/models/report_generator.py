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

``generate_speculative`` is ctpa's prompt-lookup speculative decode: each
step drafts K tokens per sequence from its own history (``_draft_lookup``),
verifies them in one cached forward over K + 1 positions and keeps the
accepted prefix (``_spec_accept``), rolling the rejected rows back
(``_rollback``).  It is exact: greedy gives ``generate(greedy=True)``'s
tokens, sampling the law of plain sampling.  The serving batcher
(``pipelines/streaming.py``) runs the same verify.
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
from ctpa_torch.ops.sampling import categorical, filter_logits, sample_logits

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


class SpecGenerateResult(NamedTuple):
    tokens: torch.Tensor      # (b, max_new) generated ids, pad_token_id after EOS
    lengths: torch.Tensor     # (b,) real generated tokens
    steps: int                # verify forwards taken (<= max_new - 1)


def _draft_lookup(buf: torch.Tensor, cur_len: torch.Tensor, fallback: torch.Tensor,
                  ngram: int, draft_len: int) -> torch.Tensor:
    """Prompt-lookup drafts for every lane at once -> (b, draft_len): the
    tokens that followed the most recent earlier occurrence of the trailing
    ``ngram``-gram of ``buf[:cur_len]`` (prompt and emitted history), or
    ``fallback`` (the pending token) repeated where there is none.  The
    matched gram and at least one continuation token lie strictly inside
    the history.  Slices are clamped into the buffer as ``dynamic_slice``
    clamps them.  All on the device."""
    b, L = buf.shape
    dev = buf.device
    pos = torch.arange(L, device=dev)
    start = torch.clamp(cur_len.long() - ngram, 0, L - ngram)
    tail = buf.gather(1, start[:, None] + torch.arange(ngram, device=dev))
    match = torch.ones(b, L, dtype=torch.bool, device=dev)
    for i in range(ngram):
        match &= torch.roll(buf, -i, dims=1) == tail[:, i:i + 1]
    match &= pos[None] + ngram <= cur_len[:, None] - 1
    j = torch.where(match, pos[None], -1).amax(1)
    found = j >= 0
    first = torch.clamp(torch.where(found, j + ngram, 0), 0, L - draft_len)
    draft = buf.gather(1, first[:, None] + torch.arange(draft_len, device=dev))
    return torch.where(found[:, None], draft, fallback[:, None].to(buf.dtype))


def _spec_accept(logits_v: torch.Tensor, draft: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *, greedy: bool,
                 temperature: float = 0.7, top_k: Optional[int] = None,
                 top_p: Optional[float] = None):
    """Speculative acceptance of point-mass (prompt-lookup) drafts.  ->
    (e (b, K+1) emission tokens, a (b,) accepted drafts); the step commits
    e[:, :a+1].

    greedy: accept while draft == argmax; the emissions are the argmaxes,
    so the tokens equal greedy decoding's.  Sampling: accept draft i with
    probability p_i(draft_i) (min(1, p/q) with q the point mass), and on the
    first rejection draw from p_i with the draft masked out, renormalized;
    all K accepted -> a bonus draw from p_K.  Each emitted position then has
    exactly the law of sequential sampling from p = softmax(filter_logits),
    the function ``sample_logits`` draws through."""
    b, k1, vocab = logits_v.shape
    K = k1 - 1
    if greedy:
        g = torch.argmax(logits_v, dim=-1)
        match = (draft == g[:, :K]).long()
        return g, torch.cumprod(match, dim=1).sum(1)
    fl = filter_logits(logits_v, temperature=temperature, top_k=top_k, top_p=top_p)
    logp = torch.log_softmax(fl, dim=-1)
    u = torch.rand((b, K), generator=generator, device=logits_v.device)
    p_draft = logp[:, :K].gather(-1, draft[..., None].long())[..., 0].exp()
    a = torch.cumprod((u < p_draft).long(), dim=1).sum(1)                # (b,) in [0, K]
    # the draw at position a: the residual (draft_a masked) if a < K, the
    # full p_K if a == K.  Where the filtered support is {draft_a} alone,
    # p_draft == 1 and rejection cannot happen, so the all -inf row is never
    # drawn from
    fl_a = fl.gather(1, a[:, None, None].expand(b, 1, vocab))[:, 0]
    d_pad = torch.cat([draft, draft[:, :1]], dim=1).long()               # (b, K+1)
    d_a = d_pad.gather(1, a[:, None])[:, 0]
    masked = (a < K)[:, None] & (torch.arange(vocab, device=fl.device)[None] == d_a[:, None])
    t_r = categorical(fl_a.masked_fill(masked, float("-inf")), generator)
    e = torch.where(torch.arange(K + 1, device=fl.device)[None] == a[:, None], t_r[:, None],
                    d_pad)
    return e, a


def _rollback(cache: KVCache, pre_off: torch.Tensor, pre_tl: torch.Tensor, committed,
              draft_len: int) -> KVCache:
    """After a verify over draft_len + 1 rows written at ``pre_off``: keep
    the ``committed`` (b,) rows, invalidate the rejected ones (the next
    verify overwrites them) and set the offsets past the kept rows.  The
    verify lanes never wrap, so slot order is token order.  ``pre_off`` and
    ``pre_tl`` are the offsets before the verify: a forward returns new
    offset tensors, so they are not the verify's."""
    sl = torch.arange(cache.k.shape[3], device=cache.k.device)[None]
    rolled = (sl >= (pre_off + committed)[:, None]) & (sl < (pre_off + draft_len + 1)[:, None])
    return cache._replace(write_offset=(pre_off + committed).to(torch.int32),
                          true_len=(pre_tl + committed).to(torch.int32),
                          valid=cache.valid & ~rolled)


def _scatter_drop(dst: torch.Tensor, index: torch.Tensor, keep: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``dst`` (b, L) with src written at ``index`` where ``keep``; the other
    writes are dropped (``.at[].set(mode="drop")``)."""
    ext = torch.cat([dst, dst[:, :1]], dim=1)
    idx = torch.where(keep, index, dst.shape[1]).long()
    return ext.scatter(1, idx, src.to(dst.dtype))[:, :-1]


class CTReportGenerator(nn.Module):
    """The LLM with vision cross-attention.  ``dtype`` is the parameters'
    dtype; the compute dtype (ctpa's ``dtype``) is set with
    ``models.layers.set_compute_dtype``.  The KV cache is kept in the
    compute dtype (or int8 with ``llm_cfg.kv_quant``).  ``remat``
    recomputes the LLM's blocks in the backward, as ctpa's."""

    def __init__(self, llm_cfg: LLMConfig, vit_cfg: CTViTConfig,
                 gen_cfg: ReportGenConfig = ReportGenConfig(), lora: Optional[LoRAConfig] = None,
                 device="cuda", dtype=torch.float32, remat: bool = False):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.llm_cfg, self.vit_cfg, self.gen_cfg = llm_cfg, vit_cfg, gen_cfg
        self.llm = LlamaForCausalLM(llm_cfg, lora, **fk, remat=remat)
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

    def loss(self, video, input_ids, attention_mask, label_mask=None, mesh=None,
             axis: str = "data"):
        """The shifted-label cross-entropy of the training forward (``mesh``
        as in ``_ce``)."""
        return self._ce(self(video, input_ids, attention_mask), input_ids, attention_mask,
                        label_mask, mesh, axis)

    def loss_from_vision(self, vision, input_ids, attention_mask, label_mask=None, mesh=None,
                         axis: str = "data"):
        """The same loss over precomputed (b, vision_dim) vision features, so a
        fine-tune with a frozen vision trunk runs the trunk once, outside the
        training step."""
        hidden, _ = self.llm.model(input_ids, attention_mask)
        return self._ce(self._fused_logits(hidden, vision), input_ids, attention_mask,
                        label_mask, mesh, axis)

    @staticmethod
    def _ce(logits, input_ids, attention_mask, label_mask=None, mesh=None, axis: str = "data"):
        """Mean negative log-likelihood of tokens 1.. under the logits of
        positions ..n-2, over the positions the masks keep.  With ``mesh``
        the rows are this rank's of a global batch and the mean is the
        global token mean: the kept-token count is summed over ``axis``,
        and this rank returns p times its own sum over it, so the mean over
        ranks of the returned values and of their gradients is the global
        mean and its gradient, whatever each rank's count."""
        targets = input_ids[:, 1:].long()
        mask = attention_mask[:, 1:].float()
        if label_mask is not None:
            mask = mask * label_mask[:, 1:].float()
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        num, den = (nll * mask).sum(), mask.sum()
        if mesh is not None:
            from ctpa_torch.comms.collectives import psum

            num, den = num * mesh.size(axis), psum(den, mesh, axis)
        return num / torch.clamp(den, min=1.0)

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

    @torch.no_grad()
    def generate_speculative(self, video, input_ids, attention_mask, max_new_tokens: int,
                             eos_token_id: int, pad_token_id: int = 0, draft_len: int = 8,
                             ngram: int = 2, greedy: bool = True, temperature: float = 0.7,
                             top_k: Optional[int] = None, top_p: Optional[float] = None,
                             generator: Optional[torch.Generator] = None) -> SpecGenerateResult:
        """Decode with prompt-lookup speculation (ctpa's
        ``generate_speculative``): greedy emits ``generate(greedy=True)``'s
        tokens; sampling has the law of ``generate``'s sampling at the same
        temperature, top-k and top-p.  Each step drafts ``draft_len`` tokens
        per sequence (``_draft_lookup``), runs one cached forward over the
        pending token and the drafts, keeps the accepted prefix and rolls the
        rest back; the cache holds draft_len + 1 slots of slack for that.
        Offsets are per sequence (acceptance differs across lanes).  One
        read of a device flag a step, as ``generate``."""
        b, n = input_ids.shape
        K, dev = draft_len, input_ids.device
        vision = self.extract_vision(video)
        cache = KVCache.create(self.llm_cfg, b, max_len=n + max_new_tokens + K + 1,
                               dtype=self.cache_dtype(), device=dev)
        hidden, cache = self.llm.model(input_ids, attention_mask, cache, shared_kv_offset=True)
        plen = attention_mask.sum(-1).long()
        rows = torch.arange(b, device=dev)
        last_hidden = hidden[rows, torch.clamp(plen - 1, min=0)][:, None]
        tok = sample_logits(self._fused_logits(last_hidden, vision)[:, 0], generator,
                            temperature=temperature, top_k=top_k, top_p=top_p, greedy=greedy)
        done = tok == eos_token_id
        out = torch.full((b, max_new_tokens), pad_token_id, dtype=torch.long, device=dev)
        out[:, 0] = tok
        # the history (prompt and emissions) from slot 0: right-padded prompts
        # keep their real tokens in [0, plen)
        buf = torch.zeros(b, n + max_new_tokens + 1, dtype=torch.long, device=dev)
        buf[:, :n] = input_ids
        buf[rows, plen] = tok
        cur_len, count = plen + 1, torch.ones(b, dtype=torch.long, device=dev)
        idx = torch.arange(K + 1, device=dev)[None]
        steps = 0
        while not bool(done.all()):             # the one host read of a step
            draft = _draft_lookup(buf, cur_len, tok, ngram, K)
            pre_off, pre_tl = cache.write_offset, cache.true_len
            hidden, verified = self.llm.model(torch.cat([tok[:, None], draft], 1), None, cache)
            g, a = _spec_accept(self._fused_logits(hidden, vision), draft, generator,
                                greedy=greedy, temperature=temperature, top_k=top_k, top_p=top_p)
            eos_hit = (g == eos_token_id) & (idx <= a[:, None])
            has_eos = eos_hit.any(1)
            c = torch.where(has_eos, eos_hit.long().argmax(1) + 1, a + 1)
            c = torch.where(done, 0, c)
            emit = torch.minimum(c, max_new_tokens - count)
            keep = (idx < emit[:, None]) & ~done[:, None]
            out = _scatter_drop(out, count[:, None] + idx, keep, g)
            buf = _scatter_drop(buf, cur_len[:, None] + idx, keep, g)
            cache = _rollback(verified, pre_off, pre_tl, c, K)
            nxt = g.gather(1, torch.clamp(c - 1, 0, K)[:, None])[:, 0]
            tok = torch.where(done, tok, nxt)
            count, cur_len = count + emit, cur_len + emit
            done = done | has_eos | (count >= max_new_tokens)
            steps += 1
        real = (out != pad_token_id) & (out != eos_token_id)
        return SpecGenerateResult(tokens=out, lengths=real.sum(-1), steps=steps)
