"""CTViT — factorized spatial/temporal 3D vision transformer with a cosine
VQ bottleneck (port of ``ctpa/models/ctvit.py``): the axial encoder
(spatial fold, then temporal fold) or, with ``cfg.fused_attention``, the
fused full-sequence encoder (exact attention over all t*h*w tokens through
the flash kernels); and, with ``cfg.use_decoder``, the generative decoder
(temporal fold, then spatial fold, then the pixel projection) behind
``decode_tokens``, ``decode_from_codebook_indices`` and ``reconstruct``."""

from __future__ import annotations

import torch
from einops import rearrange
from torch import nn

from ctpa_torch.core.config import CTViTConfig
from ctpa_torch.models.attention import ContinuousPositionBias, Transformer
from ctpa_torch.models.layers import AffineLayerNorm, Dense, compute_dtype
from ctpa_torch.ops.patchify import patchify_project
from ctpa_torch.ops.preprocess import Stage3Operands
from ctpa_torch.ops.resample_patchify import resample3_patchify_project
from ctpa_torch.ops.vq import VQOutput, VQState, vq_encode, vq_lookup


class PatchEmbed3D(nn.Module):
    """b c (t pt) (h p1) (w p2) -> b t h w d as LayerNorm -> Linear -> LayerNorm.

    Parameters keep ctpa's names and layout: ``norm_in_scale``,
    ``norm_in_bias`` (patch_dim,), ``proj_kernel`` (patch_dim, dim),
    ``proj_bias`` (dim,).  With ``cfg.pallas_patchify`` (one channel) the
    fused patchify kernel computes the LN-folded projection; otherwise the
    patch layout is formed explicitly.  ``forward_stage3`` embeds a raw
    volume's stage-1/2 operands through the fused resample-patchify kernel
    (K9) instead, with the same parameters."""

    def __init__(self, cfg: CTViTConfig, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.eps = eps
        pd, dim = cfg.patch_dim, cfg.dim
        self.norm_in_scale = nn.Parameter(torch.ones(pd, **fk))
        self.norm_in_bias = nn.Parameter(torch.zeros(pd, **fk))
        self.proj_kernel = nn.Parameter(torch.zeros(pd, dim, **fk))
        self.proj_bias = nn.Parameter(torch.zeros(dim, **fk))
        self.norm_out = AffineLayerNorm(dim, eps=eps, **fk)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        pt, p = c.temporal_patch_size, c.patch_size
        dtype = compute_dtype(self, self.proj_kernel)
        g_in, b_in, kernel = self.norm_in_scale, self.norm_in_bias, self.proj_kernel
        shift = (b_in @ kernel) + self.proj_bias
        if c.pallas_patchify and c.channels == 1:
            y = torch.stack([
                patchify_project(v, g_in, kernel, pt, p, p, eps=self.eps, out_dtype=dtype)
                for v in video[:, 0].to(dtype)])
            return self.norm_out(y + shift.to(y.dtype))
        x = rearrange(video.to(dtype), "b c (t pt) (h p1) (w p2) -> b t h w (c pt p1 p2)",
                      pt=pt, p1=p, p2=p)
        xf = x.to(torch.float32)
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        xhat = ((xf - mean) * torch.rsqrt(var + self.eps)).to(dtype)
        y = (xhat * g_in.to(dtype)) @ kernel.to(dtype)
        return self.norm_out(y + shift.to(y.dtype))

    def forward_stage3(self, ops: Stage3Operands) -> torch.Tensor:
        """One volume's ``ops/preprocess.py:preprocess_stage12`` operands, ``x2``
        in the compute dtype -> (1, t, h, w, d): the stage-3 resample, window
        and pad mask fused into the patch embed (K9)."""
        c = self.cfg
        if c.channels != 1:
            raise ValueError(f"the fused resample front end takes one channel, not {c.channels}")
        pt, p = c.temporal_patch_size, c.patch_size
        dtype = compute_dtype(self, self.proj_kernel)
        kernel = self.proj_kernel
        shift = (self.norm_in_bias @ kernel) + self.proj_bias
        y = resample3_patchify_project(ops.x2, ops.wwp, ops.vd, ops.vh, ops.vw,
                                       self.norm_in_scale, kernel, pt, p, p, eps=self.eps,
                                       window=ops.window, pad_value=ops.pad_value,
                                       out_dtype=dtype, taps=ops.taps)[None]
        return self.norm_out(y + shift.to(y.dtype))


class CTViT(nn.Module):
    """forward(video, vq_state) -> (tokens, VQOutput | None); video is
    (b, c, T, H, W) and tokens (b, t, h, w, d), quantized when a VQ state is
    given and ``cfg.use_vq`` (straight-through in the backward).  ``remat``
    recomputes each transformer block in the backward.  Training keeps
    ``cfg.pallas_patchify`` off: the patchify kernel is forward-only.
    ``dtype`` is the parameters' dtype; the compute dtype (ctpa's module
    ``dtype``) is set with ``models.layers.set_compute_dtype``.

    With ``cfg.fused_attention`` the encoder is ``enc_fused_transformer``
    (``cfg.fused_depth`` blocks, flash attention with no bias, PEG on the
    full grid) and the axial stacks are not built: ctpa's parameter tree has
    none of them then.  ``cfg.use_decoder`` adds ``dec_temporal_transformer``,
    ``dec_spatial_transformer`` (plain attention, as ctpa's, whose decoder
    stacks have no flash option) and ``to_pixels``; the decoder's spatial
    fold takes ``spatial_rel_pos_bias``, which is built whenever the axial
    encoder or the decoder is.  ``cp_mesh``/``cp_axis`` shard the fused
    encoder's t*h*w token axis over that mesh axis (context parallelism,
    ``parallel/context.py``); every rank holds the whole sequence outside
    the attention, as ctpa's global arrays."""

    def __init__(self, cfg: CTViTConfig, device="cuda", dtype=torch.float32,
                 remat: bool = False, cp_mesh=None, cp_axis: str | None = None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.patch_embed = PatchEmbed3D(cfg, **fk)
        tkw = dict(dim=cfg.dim, heads=cfg.heads, dim_head=cfg.dim_head, ff_mult=cfg.ff_mult,
                   peg=True, peg_causal=True, peg_reference_layout=cfg.peg_reference_layout,
                   kv_from_normed=cfg.attn_kv_from_normed, remat=remat, **fk)
        if cfg.fused_attention:
            self.enc_fused_transformer = Transformer(depth=cfg.fused_depth, use_flash=True,
                                                     cp_mesh=cp_mesh, cp_axis=cp_axis, **tkw)
        if not cfg.fused_attention or cfg.use_decoder:
            self.spatial_rel_pos_bias = ContinuousPositionBias(cfg.dim, cfg.heads, **fk)
        if not cfg.fused_attention:
            # the 576-token spatial fold goes through the flash kernel with
            # flash_axial; the 24-token temporal fold stays plain
            self.enc_spatial_transformer = Transformer(depth=cfg.spatial_depth,
                                                       use_flash=cfg.flash_axial, **tkw)
            self.enc_temporal_transformer = Transformer(depth=cfg.temporal_depth, **tkw)
        if cfg.use_decoder:
            self.dec_spatial_transformer = Transformer(depth=cfg.spatial_depth, **tkw)
            self.dec_temporal_transformer = Transformer(depth=cfg.temporal_depth, **tkw)
            self.to_pixels = Dense(cfg.dim, cfg.patch_dim, **fk)

    @property
    def grid(self) -> tuple[int, int, int]:
        c = self.cfg
        return (c.temporal_tokens, c.image_size // c.patch_size, c.image_size // c.patch_size)

    def encode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Axial encode: spatial fold, then temporal fold; or, with
        ``cfg.fused_attention``, one stack over all t*h*w tokens."""
        b, t, h, w, d = tokens.shape
        if self.cfg.fused_attention:
            x = rearrange(tokens, "b t h w d -> b (t h w) d")
            x = self.enc_fused_transformer(x, shape3d=(t, h, w), fold="full")
            return rearrange(x, "b (t h w) d -> b t h w d", t=t, h=h, w=w)
        bias = self.spatial_rel_pos_bias(h, w)                   # (heads, hw, hw)
        x = rearrange(tokens, "b t h w d -> (b t) (h w) d")
        x = self.enc_spatial_transformer(x, shape3d=(t, h, w), fold="spatial", bias=bias)
        x = rearrange(x, "(b t) (h w) d -> (b h w) t d", b=b, h=h, w=w)
        x = self.enc_temporal_transformer(x, shape3d=(t, h, w), fold="temporal")
        return rearrange(x, "(b h w) t d -> b t h w d", b=b, h=h, w=w)

    def decode_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Tokens (b, t, h, w, d) -> voxels (b, c, T, H, W): temporal fold,
        spatial fold with the position bias, the pixel projection and the
        inverse patch layout."""
        if not self.cfg.use_decoder:
            raise ValueError("decode_tokens needs a CTViT built with use_decoder=True")
        b, t, h, w, d = tokens.shape
        x = rearrange(tokens, "b t h w d -> (b h w) t d")
        x = self.dec_temporal_transformer(x, shape3d=(t, h, w), fold="temporal")
        x = rearrange(x, "(b h w) t d -> (b t) (h w) d", b=b, h=h, w=w)
        bias = self.spatial_rel_pos_bias(h, w)
        x = self.dec_spatial_transformer(x, shape3d=(t, h, w), fold="spatial", bias=bias)
        x = rearrange(x, "(b t) (h w) d -> b t h w d", b=b, h=h, w=w)
        c, pt, p = self.cfg.channels, self.cfg.temporal_patch_size, self.cfg.patch_size
        return rearrange(self.to_pixels(x), "b t h w (c pt p1 p2) -> b c (t pt) (h p1) (w p2)",
                         c=c, pt=pt, p1=p, p2=p)

    def decode_from_codebook_indices(self, indices: torch.Tensor, vq_state: VQState):
        """Code ids (b, t*h*w) -> reconstructed voxels, the codes cast to the
        decoder's compute dtype."""
        t, h, w = self.grid
        codes = vq_lookup(vq_state, indices).reshape(indices.shape[0], t, h, w, self.cfg.dim)
        return self.decode_tokens(codes.to(compute_dtype(self.to_pixels, self.to_pixels.weight)))

    def reconstruct(self, video: torch.Tensor, vq_state: VQState | None = None,
                    frame_mask: torch.Tensor | None = None):
        """Encode, quantize (where a VQ state is given) and decode: returns
        (recon_video, VQOutput | None)."""
        tokens, vq_out = self(video, vq_state, frame_mask)
        return self.decode_tokens(tokens), vq_out

    def token_mask(self, frame_mask: torch.Tensor) -> torch.Tensor:
        """(b, T) frame validity -> (b, t*h*w) token mask: a temporal patch is
        valid if any of its frames is."""
        b = frame_mask.shape[0]
        t, h, w = self.grid
        fm = rearrange(frame_mask, "b (t pt) -> b t pt", pt=self.cfg.temporal_patch_size)
        tok = fm.bool().any(dim=-1)
        return tok.repeat_interleave(h * w, dim=-1).reshape(b, t * h * w)

    def forward(self, video: torch.Tensor, vq_state: VQState | None = None,
                frame_mask: torch.Tensor | None = None):
        return self.quantize(self.encode_tokens(self.patch_embed(video)), vq_state, frame_mask)

    def forward_stage3(self, ops: Stage3Operands, vq_state: VQState | None = None):
        """``forward`` for one raw volume from its stage-1/2 operands
        (``ops/preprocess.py:preprocess_stage12``) through the fused
        resample-patchify front end (K9); the caller chooses this path."""
        return self.quantize(self.encode_tokens(self.patch_embed.forward_stage3(ops)), vq_state)

    def quantize(self, tokens: torch.Tensor, vq_state: VQState | None,
                 frame_mask: torch.Tensor | None = None):
        """The VQ bottleneck on encoded tokens (b, t, h, w, d), where a state
        is given and ``cfg.use_vq``."""
        if vq_state is None or not self.cfg.use_vq:
            return tokens, None
        b, t, h, w, d = tokens.shape
        mask = self.token_mask(frame_mask) if frame_mask is not None else None
        out: VQOutput = vq_encode(vq_state, tokens.reshape(b, t * h * w, d), mask=mask)
        return out.quantized.reshape(b, t, h, w, d), out
