"""Precision policy: fp32 parameters, bf16 compute (port of
``ctpa/core/precision.py``).

ctpa keeps its parameters in fp32 and lets each flax module cast them to the
compute dtype at use.  The port keeps the parameters in fp32 too and runs
the forward under ``torch.autocast`` in the compute dtype
(``Policy.autocast``): matrix products take bf16 operands, normalisations
and reductions stay fp32.  Where ctpa asks for an fp32 result from bf16
operands (``preferred_element_type=float32``: attention scores, the VQ
search, the contrastive similarity), the port computes inside
``full_precision``, a region with autocast off.
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

    def autocast(self, device) -> torch.autocast:
        """The region a forward runs in: autocast to the compute dtype, off
        when it equals the parameter dtype."""
        return torch.autocast(device_type=torch.device(device).type, dtype=self.compute_dtype,
                              enabled=self.compute_dtype != self.param_dtype)


def policy(name: str = "bf16") -> Policy:
    if name in ("bf16", "bfloat16", "mixed"):
        return Policy()
    if name in ("fp32", "float32", "full"):
        return Policy(compute_dtype=torch.float32)
    raise ValueError(f"unknown precision policy {name!r}")


def full_precision(device) -> torch.autocast:
    """A region with autocast off, for the sums the policy keeps in fp32."""
    return torch.autocast(device_type=torch.device(device).type, enabled=False)
