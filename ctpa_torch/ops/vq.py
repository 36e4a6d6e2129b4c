"""Cosine-similarity vector quantization (port of ``ctpa/ops/vq.py``): the
encode with its straight-through estimator, the EMA codebook update and
the decode lookup of the generative path.  The codebook state is explicit,
as in ctpa.  The (n, d) x (d, K) nearest-code search is one
``torch.matmul`` in fp32 whatever the input's dtype, as ctpa computes it."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ctpa_torch.ops.attention_ops import l2norm


class VQState(NamedTuple):
    codebook: torch.Tensor       # (K, d) l2-normalised code embeddings
    cluster_size: torch.Tensor   # (K,) EMA of assignment counts
    embed_avg: torch.Tensor      # (K, d) EMA of assigned-vector sums


class VQOutput(NamedTuple):
    quantized: torch.Tensor      # input shape, straight-through
    indices: torch.Tensor        # (...,) int32 code ids
    commit_loss: torch.Tensor    # scalar
    counts: torch.Tensor         # (K,) this batch's assignment counts
    sums: torch.Tensor           # (K, d) this batch's assigned-vector sums


def vq_init(generator: torch.Generator, codebook_size: int, dim: int,
            device="cuda") -> VQState:
    """Random l2-normalised codebook drawn from ``generator`` (which must live
    on ``device``)."""
    codes = l2norm(torch.randn(codebook_size, dim, generator=generator, device=device))
    return VQState(codebook=codes,
                   cluster_size=torch.zeros(codebook_size, device=device),
                   embed_avg=codes.clone())


def vq_encode(state: VQState, x: torch.Tensor, mask: torch.Tensor | None = None) -> VQOutput:
    """Quantize x (..., d) against the codebook by cosine similarity.

    ``mask`` (...,) bool: True = real token.  Masked tokens still get indices
    but add nothing to counts, sums or the commit loss."""
    shape = x.shape
    d = shape[-1]
    flat = x.reshape(-1, d).to(torch.float32)
    nf = l2norm(flat)
    cb = l2norm(state.codebook.to(torch.float32))
    idx = torch.argmax(torch.matmul(nf, cb.t()), dim=-1)
    quant = cb[idx]

    m = (mask.reshape(-1).to(torch.float32) if mask is not None
         else torch.ones(flat.shape[0], device=x.device))
    diff = torch.sum((nf - quant.detach()) ** 2, dim=-1)
    commit = torch.sum(diff * m) / torch.clamp(torch.sum(m), min=1.0)

    K = cb.shape[0]
    counts = torch.zeros(K, device=x.device).index_add_(0, idx, m)
    sums = torch.zeros(K, d, device=x.device).index_add_(0, idx, nf * m[:, None])

    quant_st = flat + (quant - flat).detach()
    return VQOutput(quantized=quant_st.reshape(shape).to(x.dtype),
                    indices=idx.reshape(shape[:-1]).to(torch.int32),
                    commit_loss=commit, counts=counts, sums=sums)


@torch.no_grad()
def ema_update(state: VQState, counts: torch.Tensor, sums: torch.Tensor,
               decay: float = 0.99, eps: float = 1e-5) -> VQState:
    """EMA codebook update from one batch's assignment ``counts`` and
    ``sums``; a code whose EMA count falls below ``eps`` (dead) keeps its old
    embedding rather than collapsing to NaN."""
    cluster = state.cluster_size * decay + counts * (1.0 - decay)
    embed_avg = state.embed_avg * decay + sums * (1.0 - decay)
    n = torch.sum(cluster)
    smoothed = (cluster + eps) / (n + cluster.shape[0] * eps) * n
    codebook = l2norm(embed_avg / smoothed[:, None])
    dead = cluster < eps
    codebook = torch.where(dead[:, None], state.codebook, codebook)
    return VQState(codebook=codebook, cluster_size=cluster, embed_avg=embed_avg)


def vq_lookup(state: VQState, indices: torch.Tensor) -> torch.Tensor:
    """Code ids (...) -> their l2-normalised embeddings (..., d)."""
    return l2norm(state.codebook)[indices.long()]
