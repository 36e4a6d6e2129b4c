"""LoRA overlay on a projection (port of ``ctpa/models/lora.py``):
``base(x) + (alpha / rank) (x A) B``.  Rank 0 is the base projection alone.
A is (in, rank) and B (rank, out), ctpa's layout; B starts at zero, so a
fresh overlay is the identity.  Serving runs adapters unmerged, as ctpa's
report CLI does.  ``lora_trainable_mask`` selects the adapters (and any
extra modules) by parameter name, as ctpa's optimizer mask does by path;
``merge_lora_scaled`` folds the adapters into the base weights of a
``state_dict``, as ctpa's folds them into its param tree."""

from __future__ import annotations

import torch
from torch import nn

from ctpa_torch.models.layers import Dense

_LORA = ("lora_a", "lora_b")


def is_lora(name: str) -> bool:
    """Whether a parameter name is a LoRA adapter's (a component ending in
    ``lora_a``/``lora_b``, as ctpa's path match)."""
    return any(part.endswith(_LORA) for part in name.split("."))


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


def lora_trainable_mask(model: nn.Module, extra_trainable: tuple[str, ...] = ()) -> dict[str, bool]:
    """Parameter name -> True for the LoRA parameters (a name component
    ending in ``lora_a``/``lora_b``) and for any name with a component that
    contains one of ``extra_trainable`` (e.g. ``"cross_attention"``); False
    for the frozen base weights."""

    def label(name: str) -> bool:
        return is_lora(name) or any(t in part for t in extra_trainable
                                    for part in name.split("."))

    return {name: label(name) for name, _ in model.named_parameters()}


def merge_lora_scaled(state: dict[str, torch.Tensor], alpha: float, rank: int) -> dict:
    """A copy of ``state`` (a ``state_dict``) with each adapter folded into its
    base weight, W + (alpha / rank) (A B) in ctpa's (in, out) layout, and the
    adapter zeroed, so the module graph is unchanged and the overlay is a
    no-op."""
    scale = alpha / rank
    out = dict(state)
    for key in state:
        if not key.endswith(".lora_a"):
            continue
        prefix = key[:-len("lora_a")]
        a, b = state[key], state[prefix + "lora_b"]
        weight = state[prefix + "base.weight"]                 # torch's (out, in)
        out[prefix + "base.weight"] = weight + scale * (a @ b).T.to(weight.dtype)
        out[key], out[prefix + "lora_b"] = torch.zeros_like(a), torch.zeros_like(b)
    return out
