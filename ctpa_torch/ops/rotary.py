"""Rotary position embeddings, llama's rotate-half convention (port of
``ctpa/ops/rotary.py``)."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10000.0,
                     device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """(max_len, head_dim // 2) cos and sin tables, fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, device=device).float() / head_dim))
    freqs = torch.outer(torch.arange(max_len, device=device).float(), inv)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x (b, n, h, d); positions (b, n) index the tables.  With x1, x2 the
    two halves of d: [x1 cos - x2 sin, x2 cos + x1 sin], in x's dtype."""
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
