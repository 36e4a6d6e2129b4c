"""Token sampling: temperature, top-k and top-p (port of
``ctpa/ops/sampling.py``).

``filter_logits`` gives the temperature-scaled logits masked to the
sampling support (-inf outside it), so ``softmax(filter_logits(x))`` is the
distribution ``sample_logits`` draws from.  Every operation stays on the
logits' device: nothing is read back to the host.  Draws come from a
``torch.Generator`` (Gumbel-max, as ``jax.random.categorical``); the
generator gives other numbers than a JAX key, so draws are compared with
ctpa's by their distribution.
"""

from __future__ import annotations

from typing import Optional

import torch


def filter_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None) -> torch.Tensor:
    """Temperature-scale, then keep the top-k (value-thresholded: ties at the
    k-th value all survive), then the top-p nucleus over the survivors
    (rank-based: the smallest prefix of the descending order whose mass
    reaches top_p, so ties at the boundary do not leak in).  The argmax
    always survives, for any top_p."""
    logits = logits.float() / max(temperature, 1e-6)
    vocab = logits.shape[-1]
    if top_k is not None and 0 < top_k < vocab:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        order = torch.argsort(-logits, dim=-1, stable=True)
        probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep[..., 0] = True
        n_keep = keep.sum(dim=-1, keepdim=True)
        ranks = torch.argsort(order, dim=-1)
        logits = logits.masked_fill(ranks >= n_keep, float("-inf"))
    return logits


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                  temperature: float = 1.0, top_k: Optional[int] = None,
                  top_p: Optional[float] = None, greedy: bool = False) -> torch.Tensor:
    """One token id per row (int64).  ``greedy`` takes the argmax and
    ignores every other knob."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    return categorical(filter_logits(logits, temperature=temperature, top_k=top_k, top_p=top_p),
                       generator)


def categorical(logits: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One draw per row from softmax(logits) (int64; -inf entries are never
    drawn), by Gumbel-max as ``jax.random.categorical``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)
