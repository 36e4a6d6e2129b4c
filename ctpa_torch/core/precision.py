"""Precision policy (port of ``ctpa/core/precision.py``): fp32 parameters,
compute in the policy's compute dtype.

ctpa sets the precision of a computation through each flax module's
``dtype``: parameters stay fp32 and are cast to that dtype at use, so
``CTCLIP(dtype=jnp.bfloat16)`` (its bf16 training program) computes the
projections, LayerNorm outputs, PEG and the residual stream in bf16, and
the default fp32 modules (its training CLI) compute in fp32 throughout.  In
both, attention scores, the VQ search and the contrastive similarity are
fp32 (``preferred_element_type=float32``).  The port's modules do the same
through their compute dtype (``models/layers.py``); the training step sets
it from the policy, whose two modes are ``policy("bf16")`` and
``policy("fp32")``.  Nothing runs under ``torch.autocast``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    def cast_to_compute(self, tree):
        """Floating tensors of nested dicts, lists and tuples to the compute dtype."""
        if torch.is_tensor(tree):
            return tree.to(self.compute_dtype) if tree.is_floating_point() else tree
        if isinstance(tree, dict):
            return {k: self.cast_to_compute(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_to_compute(v) for v in tree)
        return tree


def policy(name: str = "bf16") -> Policy:
    if name in ("bf16", "bfloat16", "mixed"):
        return Policy()
    if name in ("fp32", "float32", "full"):
        return Policy(compute_dtype=torch.float32)
    raise ValueError(f"unknown precision policy {name!r}")
