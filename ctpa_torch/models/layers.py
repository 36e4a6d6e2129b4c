"""Layers that compute in a module's compute dtype, as ctpa's flax modules
do with their ``dtype`` field.

Parameters are stored in their own dtype (fp32 for training, bf16 for the
card's serving models) and cast to the compute dtype at use.  A module's
compute dtype is its ``compute_dtype`` attribute, set on a whole model by
``set_compute_dtype``; where it is unset the module computes in its
parameters' dtype.  Where ctpa asks for an fp32 result from bf16 operands
(``preferred_element_type=float32``) the callers cast the operands to fp32
themselves: a product of two bf16 values is exact in fp32, so the sums are
the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def compute_dtype(module: nn.Module, like: torch.Tensor) -> torch.dtype:
    """The module's compute dtype, or the dtype of ``like`` (one of its
    parameters) where none is set."""
    return getattr(module, "compute_dtype", None) or like.dtype


def set_compute_dtype(model: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """Compute every submodule of ``model`` in ``dtype`` (None: in its
    parameters' dtype)."""
    for m in model.modules():
        m.compute_dtype = dtype
    return model


def layer_norm(x: torch.Tensor, weight, bias, eps: float, dtype: torch.dtype) -> torch.Tensor:
    """flax's LayerNorm: fp32 statistics, the affine applied in fp32, the
    result in ``dtype``."""
    if x.dtype == dtype and all(p is None or p.dtype == dtype for p in (weight, bias)):
        # PyTorch's kernel computes in fp32 for bf16 inputs and rounds once
        return F.layer_norm(x, x.shape[-1:], weight, bias, eps)
    f32 = (lambda p: None if p is None else p.float())
    return F.layer_norm(x.float(), x.shape[-1:], f32(weight), f32(bias), eps).to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` whose input, weight and bias are cast to the compute
    dtype (flax ``Dense(dtype=...)``)."""

    def forward(self, x):
        dt = compute_dtype(self, self.weight)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class AffineLayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with scale and bias, output in the compute dtype."""

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, compute_dtype(self, self.weight))
