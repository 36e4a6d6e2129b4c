"""LoRA overlay on a projection (port of ``ctpa/models/lora.py``, the
forward): ``base(x) + (alpha / rank) (x A) B``.  Rank 0 is the base
projection alone.  A is (in, rank) and B (rank, out), ctpa's layout; B
starts at zero, so a fresh overlay is the identity.  Serving runs adapters
unmerged, as ctpa's report CLI does; the trainable mask and the merge come
with report training."""

from __future__ import annotations

import torch
from torch import nn

from ctpa_torch.models.layers import Dense


class LoRADense(nn.Module):
    def __init__(self, in_features: int, features: int, rank: int = 0, alpha: float = 1.0,
                 use_bias: bool = False, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.rank, self.alpha = rank, alpha
        self.base = Dense(in_features, features, bias=use_bias, **fk)
        if rank > 0:
            self.lora_a = nn.Parameter(torch.randn(in_features, rank, **fk) / rank)
            self.lora_b = nn.Parameter(torch.zeros(rank, features, **fk))

    def forward(self, x):
        y = self.base(x)
        if self.rank > 0:
            y = y + (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype) * (self.alpha / self.rank)
        return y
