"""Attention-adjacent primitives of the CTViT tower in PyTorch (port of
``ctpa/ops/attention_ops.py``): QK-l2norm cosine attention with learned
scales, optional null key/values and the causal mode with ALiBi, the ALiBi
slopes and bias, the continuous-position-bias feature grid, and the PEG
depthwise 3x3x3 convolution."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from einops import rearrange


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


def cosine_attention(
    q: torch.Tensor,                    # (b, h, n, d)
    k: torch.Tensor,                    # (b, h, m, d)
    v: torch.Tensor,                    # (b, h, m, d)
    *,
    q_scale: torch.Tensor,              # (d,) learned scale, shared across heads
    k_scale: torch.Tensor,              # (d,)
    null_kv: torch.Tensor | None = None,  # (2, h, num_null, d)
    scale: float = 8.0,
    bias: torch.Tensor | None = None,   # (h or 1, n, m) or (b, h, n, m)
    mask: torch.Tensor | None = None,   # (b, m) True = keep
    causal: bool = False,
) -> torch.Tensor:
    """QK-l2-normalised attention: null k/v (if any) are prepended before the
    l2norm, q/k are l2-normalised over head-dim and multiplied by their
    learned scales, the similarity is multiplied by ``scale`` and the bias
    (zero over the null columns) is added before the fp32 softmax.  Causal
    mode adds ALiBi over the real-key columns and masks key j of query i
    unless j <= i + (m - n) (bottom-right aligned; null columns stay
    visible)."""
    b, h, n, d = q.shape
    n_null = 0
    if null_kv is not None:
        n_null = null_kv.shape[2]
        nk = null_kv[0][None].expand(b, h, n_null, d).to(k.dtype)
        nv = null_kv[1][None].expand(b, h, n_null, d).to(v.dtype)
        k = torch.cat([nk, k], dim=2)
        v = torch.cat([nv, v], dim=2)

    q = l2norm(q) * q_scale.float()
    k = l2norm(k) * k_scale.float()
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale

    if bias is not None:
        if n_null:
            bias = F.pad(bias, (n_null, 0))
        sim = sim + (bias[None] if bias.ndim == 3 else bias).float()
    if mask is not None:
        keep = mask.bool()
        if n_null:
            keep = F.pad(keep, (n_null, 0), value=True)
        sim = sim.masked_fill(~keep[:, None, None, :], torch.finfo(sim.dtype).min)
    if causal:
        m = k.shape[2]
        sim = sim + _causal_alibi(h, n, m, n_null, sim.device)
        row = torch.arange(n, device=sim.device)[:, None]
        col = torch.arange(m - n_null, device=sim.device)[None, :]
        cm = F.pad(col <= row + (m - n_null) - n, (n_null, 0), value=True)
        sim = sim.masked_fill(~cm, torch.finfo(sim.dtype).min)

    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def _causal_alibi(heads: int, n: int, m: int, n_null: int, device) -> torch.Tensor:
    """(1, heads, n, m) ALiBi over the real-key columns, zero over the
    ``n_null`` leading null columns."""
    return F.pad(alibi_bias(heads, n, m - n_null, device=device), (n_null, 0))[None]


def alibi_slopes(heads: int, device="cuda") -> torch.Tensor:
    """ALiBi's per-head slopes, fp32: the geometric series from
    2^(-8 / heads) for a power of two; otherwise the closest lower power's
    series followed by every other slope of the double's."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(heads).is_integer():
        s = pow2_slopes(heads)
    else:
        closest = 2 ** int(math.floor(math.log2(heads)))
        s = pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][: heads - closest]
    return torch.tensor(s, dtype=torch.float32, device=device)


def alibi_bias(heads: int, n: int, m: int | None = None, device="cuda") -> torch.Tensor:
    """(heads, n, m) ALiBi bias: -slope * |j - i|."""
    m = n if m is None else m
    dist = -(torch.arange(m, device=device)[None, :]
             - torch.arange(n, device=device)[:, None]).abs().to(torch.float32)
    return dist[None] * alibi_slopes(heads, device=device)[:, None, None]


def continuous_position_bias_grid(height: int, width: int, device="cuda") -> torch.Tensor:
    """(n, n, 2) signed-log relative-position features of the 2D token grid:
    rel = sign(delta) * log(1 + |delta|)."""
    gy, gx = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    pos = torch.stack([gy.reshape(-1), gx.reshape(-1)], dim=-1).to(torch.float32)
    rel = pos[:, None, :] - pos[None, :, :]
    return torch.sign(rel) * torch.log1p(torch.abs(rel))


def peg_conv3d(x: torch.Tensor, kernel: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Depthwise 3x3x3 convolution over the (b, t, h, w, c) token grid; the
    kernel is (3, 3, 3, 1, c).  ``causal`` pads the temporal axis on the left
    only.  Written as 27 shifted multiply-adds, the same sum in the same order
    as ctpa."""
    pad_t = (2, 0) if causal else (1, 1)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1) + pad_t).to(kernel.dtype)
    t, h, w = x.shape[1], x.shape[2], x.shape[3]
    out = None
    for dt in range(3):
        for dh in range(3):
            for dw in range(3):
                term = xp[:, dt:dt + t, dh:dh + h, dw:dw + w] * kernel[dt, dh, dw, 0]
                out = term if out is None else out + term
    return out


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    return rearrange(x, "b n (h d) -> b h n d", h=heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    return rearrange(x, "b h n d -> b n (h d)")
