"""Transformer blocks of the CTViT tower (port of ``ctpa/models/attention.py``):
gamma-only LayerNorm, GEGLU feed-forward, PEG depthwise-conv positional
encoding, QK-l2norm cosine attention with learned scales, the continuous
position bias, pre-norm residual blocks.

Every module takes ``device`` and ``dtype``; parameters live in that dtype
and are cast at use to the compute dtype (``models/layers.py``), as ctpa's
flax modules cast theirs to their ``dtype``: in bf16 the LayerNorm outputs,
the projections, PEG (its kernel and bias too) and the residual stream are
bf16, while the attention scores stay fp32.  ``Transformer(remat=True)``
recomputes each block in the backward (``torch.utils.checkpoint``), as
ctpa's ``nn.remat``.  ``cross_attend`` adds a cross-attention to each
block (a ``context`` input, two learned null key/values), and ``causal``
makes the self-attention causal: ALiBi plus the triangular mask on the
plain path, the flash kernel's causal mask without ALiBi under
``use_flash``, as in ctpa.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ctpa_torch.ops.attention_ops import (
    continuous_position_bias_grid,
    cosine_attention,
    l2norm,
    merge_heads,
    peg_conv3d,
    split_heads,
)
from ctpa_torch.models.layers import AffineLayerNorm, Dense, compute_dtype, layer_norm
from ctpa_torch.ops.flash_attention import flash_attention
from ctpa_torch.parallel.context import context_parallel_attention

# flax's LayerNorm default epsilon, which ctpa's blocks use
LN_EPS = 1e-6


class LayerNorm(nn.Module):
    """LayerNorm with a learned gain and no bias."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        dt = compute_dtype(self, self.gamma)
        return layer_norm(x, None, None, LN_EPS, dt) * self.gamma.to(dt)


class GEGLU(nn.Module):
    """x * gelu(gate), with the exact erf gelu."""

    def forward(self, x):
        x, gate = x.chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        inner = int(dim * mult * 2 / 3)
        # scale-and-bias LayerNorm here, unlike the gamma-only one around attention
        self.norm = AffineLayerNorm(dim, eps=LN_EPS, **fk)
        self.proj_in = Dense(dim, inner * 2, bias=False, **fk)
        self.geglu = GEGLU()
        self.proj_out = Dense(inner, dim, bias=False, **fk)

    def forward(self, x):
        return self.proj_out(self.geglu(self.proj_in(self.norm(x))))


class PEG(nn.Module):
    """Residual depthwise 3D conv over the full (t, h, w) token grid, rebuilt
    from whichever axial fold the caller is in.  ``reference_layout``
    reproduces the reference's temporal-fold scramble (the (b*h*w, t, d)
    fold reshaped straight to (b, t, h, w, d))."""

    def __init__(self, dim: int, causal: bool = True, reference_layout: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.causal = causal
        self.reference_layout = reference_layout
        self.kernel = nn.Parameter(torch.zeros(3, 3, 3, 1, dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x, shape3d: tuple[int, int, int], fold: str = "full"):
        t, h, w = shape3d
        B, n, d = x.shape
        temporal_fixed = fold == "temporal" and not self.reference_layout
        if fold == "spatial":           # (b*t, h*w, d)
            grid = x.reshape(B // t, t, h, w, d)
        elif fold == "temporal":        # (b*h*w, t, d)
            b = B // (h * w)
            grid = (x.reshape(b, h, w, t, d).permute(0, 3, 1, 2, 4) if temporal_fixed
                    else x.reshape(b, t, h, w, d))
        else:                           # (b, t*h*w, d)
            grid = x.reshape(B, t, h, w, d)
        dt = compute_dtype(self, self.kernel)
        out = grid + peg_conv3d(grid, self.kernel.to(dt), causal=self.causal) + self.bias.to(dt)
        if temporal_fixed:
            out = out.permute(0, 2, 3, 1, 4)
        return out.reshape(B, n, d)


class CosineAttention(nn.Module):
    """Multi-head attention with QK l2-norm and learned (dim_head,) q/k scales
    shared across heads.  Self-attention K/V are projected from the
    UN-normalized input unless ``kv_from_normed`` (the reference quirk, kept
    so imported checkpoints reproduce).  With ``context_dim`` the module
    attends to a ``context`` of that width instead, LayerNormed by
    ``context_norm`` when ``norm_context``.  ``num_null_kv`` learned null
    key/values (``null_kv``: (2, heads, n_null, dim_head)) are prepended to
    the keys.  ``causal`` adds ALiBi and the triangular mask.  ``use_flash``
    routes an unmasked attention without null key/values through the
    flash-attention kernel with the analytic logit bound of cosine
    attention; there ``causal`` is the kernel's mask, without ALiBi (ctpa's
    split).  ``cp_mesh``/``cp_axis`` shard that non-causal flash attention's
    sequence over the axis (``parallel/context.py``)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, scale: float = 8.0,
                 causal: bool = False, num_null_kv: int = 0, context_dim: int | None = None,
                 norm_context: bool = True, kv_from_normed: bool = False,
                 use_flash: bool = False, cp_mesh=None, cp_axis: str | None = None,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        inner = heads * dim_head
        self.heads = heads
        self.scale = scale
        self.causal = causal
        self.kv_from_normed = kv_from_normed
        self.use_flash = use_flash
        self.cp_mesh, self.cp_axis = cp_mesh, cp_axis
        self.norm = LayerNorm(dim, **fk)
        if context_dim is not None and norm_context:
            self.context_norm = LayerNorm(context_dim, **fk)
        self.norm_context = norm_context
        self.to_q = Dense(dim, inner, bias=False, **fk)
        self.to_kv = Dense(dim if context_dim is None else context_dim, inner * 2, bias=False,
                           **fk)
        self.q_scale = nn.Parameter(torch.ones(dim_head, **fk))
        self.k_scale = nn.Parameter(torch.ones(dim_head, **fk))
        self.null_kv = (nn.Parameter(torch.zeros(2, heads, num_null_kv, dim_head, **fk))
                        if num_null_kv > 0 else None)
        self.to_out = Dense(inner, dim, bias=False, **fk)

    def forward(self, x, context=None, mask=None, bias=None):
        raw = x
        x = self.norm(x)
        if context is not None:
            kv_in = self.context_norm(context) if self.norm_context else context
        else:
            kv_in = x if self.kv_from_normed else raw
        q = self.to_q(x)
        k, v = self.to_kv(kv_in).chunk(2, dim=-1)
        q, k, v = (split_heads(t, self.heads) for t in (q, k, v))
        null_kv = None
        if self.null_kv is not None:
            null_kv = self.null_kv.to(compute_dtype(self, self.null_kv))

        if self.use_flash and mask is None and null_kv is None:
            qn = (l2norm(q) * self.q_scale).to(q.dtype).contiguous()
            kn = (l2norm(k) * self.k_scale).to(k.dtype).contiguous()
            # |s| <= scale * max|q_scale| * max|k_scale| (+ max bias): the
            # kernel's flat softmax needs no running max under this bound
            bound = (self.scale * self.q_scale.abs().max().float()
                     * self.k_scale.abs().max().float())
            if bias is not None:
                bound = bound + bias.max().float()
            if self.cp_mesh is not None and not self.causal:
                out = context_parallel_attention(qn, kn, v.contiguous(), self.cp_mesh,
                                                 self.cp_axis, bias=bias, scale=self.scale,
                                                 impl="flash", logit_bound=bound)
            else:
                out = flash_attention(qn, kn, v.contiguous(), bias=bias, causal=self.causal,
                                      scale=self.scale, logit_bound=bound)
        else:
            out = cosine_attention(q, k, v, q_scale=self.q_scale, k_scale=self.k_scale,
                                   null_kv=null_kv, scale=self.scale, bias=bias, mask=mask,
                                   causal=self.causal)
        return self.to_out(merge_heads(out))


class ContinuousPositionBias(nn.Module):
    """MLP over signed-log relative positions of the 2D token grid, giving an
    (heads, n, n) additive bias; leaky_relu slope 0.1."""

    def __init__(self, dim: int = 512, heads: int = 8, num_layers: int = 2,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.mlp = nn.ModuleList(
            [Dense(2 if i == 0 else dim, dim, **fk) for i in range(num_layers)])
        self.to_heads = Dense(dim, heads, **fk)

    def forward(self, height: int, width: int):
        w = self.to_heads.weight
        h = continuous_position_bias_grid(height, width, device=w.device).to(
            compute_dtype(self, w))
        for layer in self.mlp:
            h = F.leaky_relu(layer(h), negative_slope=0.1)
        return self.to_heads(h).permute(2, 0, 1).contiguous()


class TransformerBlock(nn.Module):
    """Pre-norm residual block: self-attention, with ``cross_attend`` a
    cross-attention to the context (2 null key/values), then the
    feed-forward."""

    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int = 4,
                 causal: bool = False, cross_attend: bool = False,
                 context_dim: int | None = None, use_flash: bool = False,
                 kv_from_normed: bool = False, cp_mesh=None, cp_axis: str | None = None,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.attn = CosineAttention(dim, heads, dim_head, causal=causal, use_flash=use_flash,
                                    kv_from_normed=kv_from_normed, cp_mesh=cp_mesh,
                                    cp_axis=cp_axis, **fk)
        self.cross_attn = (CosineAttention(dim, heads, dim_head, num_null_kv=2,
                                           context_dim=context_dim or dim, **fk)
                           if cross_attend else None)
        self.ff = FeedForward(dim, ff_mult, **fk)

    def forward(self, x, context=None, mask=None, bias=None):
        x = x + self.attn(x, mask=mask, bias=bias)
        if self.cross_attn is not None:
            x = x + self.cross_attn(x, context=context)
        return x + self.ff(x)


class Transformer(nn.Module):
    """Pre-norm stack with a PEG before every block (when ``peg``) and a final
    gamma-only LayerNorm.  The 3D grid shape comes with the call, so one stack
    serves the spatial (b*t, h*w, d) and temporal (b*h*w, t, d) folds.
    ``causal`` and ``cross_attend`` (with ``context_dim``, the context's width,
    ``dim`` by default) as in ``TransformerBlock``."""

    def __init__(self, dim: int, depth: int, heads: int = 8, dim_head: int = 32,
                 ff_mult: int = 4, causal: bool = False, cross_attend: bool = False,
                 context_dim: int | None = None, peg: bool = False, peg_causal: bool = True,
                 peg_reference_layout: bool = False, use_flash: bool = False,
                 kv_from_normed: bool = False, remat: bool = False, cp_mesh=None,
                 cp_axis: str | None = None, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.remat = remat
        self.pegs = nn.ModuleList(
            [PEG(dim, causal=peg_causal, reference_layout=peg_reference_layout, **fk)
             for _ in range(depth)] if peg else [])
        self.blocks = nn.ModuleList(
            [TransformerBlock(dim, heads, dim_head, ff_mult, causal=causal,
                              cross_attend=cross_attend, context_dim=context_dim,
                              use_flash=use_flash, kv_from_normed=kv_from_normed,
                              cp_mesh=cp_mesh, cp_axis=cp_axis, **fk)
             for _ in range(depth)])
        self.norm_out = LayerNorm(dim, **fk)

    def forward(self, x, shape3d=None, fold: str = "full", mask=None, bias=None, context=None):
        for i, block in enumerate(self.blocks):
            if self.pegs:
                x = self.pegs[i](x, shape3d, fold)
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, context, mask, bias, use_reentrant=False)
            else:
                x = block(x, context=context, mask=mask, bias=bias)
        return self.norm_out(x)
