"""Masked-language-modelling objective over the text tower (port of
``ctpa/models/mlm.py``): select ``mask_prob`` of the real (non-pad) tokens,
at least one a row, replace ``replace_prob`` of the selected ones with the
mask token, and take the cross-entropy over the selected positions only.

The draws are apart from the arithmetic: ``mask_tokens_from`` takes the two
uniform tensors ctpa draws (the selection scores and the replacement
draws) and is exact given them; ``mask_tokens`` draws them from a
``torch.Generator``."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def mask_tokens_from(input_ids: torch.Tensor, scores: torch.Tensor, replace: torch.Tensor,
                     mask_prob: float = 0.15, replace_prob: float = 0.90,
                     mask_token_id: int = 103, pad_token_id: int = 0):
    """(masked_ids, selected) from the uniform draws ``scores`` and
    ``replace`` (both shaped like ``input_ids``).  A row whose draws select
    no real token selects its real token of least score (the first on a
    tie), as ctpa forces it; a row of padding selects nothing."""
    real = input_ids != pad_token_id
    scores = torch.where(real, scores, torch.inf)
    selected = (scores < mask_prob) & real
    force = torch.nn.functional.one_hot(scores.argmin(dim=-1), input_ids.shape[-1]).bool() & real
    selected = torch.where(selected.any(dim=-1, keepdim=True), selected, force)
    do_replace = (replace < replace_prob) & selected
    return torch.where(do_replace, mask_token_id, input_ids), selected


def mask_tokens(input_ids: torch.Tensor, generator: Optional[torch.Generator] = None,
                mask_prob: float = 0.15, replace_prob: float = 0.90, mask_token_id: int = 103,
                pad_token_id: int = 0):
    """``mask_tokens_from`` on uniforms drawn from ``generator`` (on the
    ids' device)."""
    scores, replace = mlm_draws(input_ids, generator)
    return mask_tokens_from(input_ids, scores, replace, mask_prob, replace_prob, mask_token_id,
                            pad_token_id)


def mlm_draws(input_ids: torch.Tensor, generator: Optional[torch.Generator] = None):
    """The selection scores and the replacement draws, uniform in [0, 1)."""
    kw = dict(generator=generator, device=input_ids.device)
    return torch.rand(input_ids.shape, **kw), torch.rand(input_ids.shape, **kw)


def mlm_loss(apply_fn: Callable, input_ids: torch.Tensor, attention_mask: torch.Tensor,
             draws, mask_prob: float = 0.15, replace_prob: float = 0.90,
             mask_token_id: int = 103, pad_token_id: int = 0, mesh=None,
             axis: str = "data") -> torch.Tensor:
    """Mean cross-entropy (fp32 log-softmax) of the original tokens over the
    selected positions: ``apply_fn(masked_ids, attention_mask)`` gives the
    (b, n, vocab) logits; ``draws`` is the pair ``mlm_draws`` returns.

    With ``mesh`` the rows are this rank's of a global batch, and the mean
    is the global one: the selected count is summed over ``axis``, and this
    rank returns p times its own sum over that count, so that the mean over
    ranks of the returned values, and of their gradients, is the global
    mean and its gradient (a mean of per-rank means would weigh each rank's
    tokens by its own count)."""
    masked, selected = mask_tokens_from(input_ids, *draws, mask_prob, replace_prob,
                                        mask_token_id, pad_token_id)
    logp = torch.log_softmax(apply_fn(masked, attention_mask).float(), dim=-1)
    nll = -torch.gather(logp, -1, input_ids.long()[..., None])[..., 0]
    sel = selected.float()
    num, den = (nll * sel).sum(), sel.sum()
    if mesh is not None:
        from ctpa_torch.comms.collectives import psum

        num, den = num * mesh.size(axis), psum(den, mesh, axis)
    return num / torch.clamp(den, min=1.0)
