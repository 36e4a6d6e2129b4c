"""Seeded random weights for runs without a checkpoint."""

from __future__ import annotations

import torch
from torch import nn

from ctpa_torch.models.attention import LayerNorm
from ctpa_torch.models.llm import RMSNorm

# gains that start at 1 in ctpa's initializers
_ONES = ("gamma", "q_scale", "k_scale", "norm_in_scale")


@torch.no_grad()
def random_init_(model: nn.Module, generator: torch.Generator, std: float = 0.02) -> nn.Module:
    """Fill every parameter from ``generator`` (which lives on the model's
    device): LayerNorm and RMSNorm gains and the q/k scales 1, the
    log-temperature 1, everything else normal(0, std), biases included (an
    all-zero bias makes padded patches degenerate: their LayerNorm input is
    exactly constant).
    Parameters are visited in registration order, so a seed fixes the weights."""
    gains = {id(m.weight) for m in model.modules()
             if isinstance(m, nn.LayerNorm) and m.weight is not None}
    gains |= {id(m.gamma) for m in model.modules() if isinstance(m, LayerNorm)}
    gains |= {id(m.weight) for m in model.modules() if isinstance(m, RMSNorm)}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if id(p) in gains or leaf in _ONES or leaf == "temperature":
            p.fill_(1.0)
        else:
            p.copy_(torch.randn(p.shape, generator=generator, device=p.device) * std)
    return model
