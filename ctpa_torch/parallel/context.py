"""Context (sequence) parallelism: exact attention over a sequence sharded
over a mesh axis (port of ``ctpa/parallel/context.py``).

Each of the axis's p ranks takes n/p query rows and runs exact attention
of its rows over all n keys and values: the flash kernels (K2 with its
logsumexp, K3 in the backward; their plain versions on CPU tensors) or the
dense attention.  ctpa's ``shard_map`` all-gathers the key and value
blocks (one all-gather, not ring attention's p hops); here every rank
holds them already, so the forward moves none of them.

ctpa's ``shard_map`` takes global (replicated) arrays and returns a global
one; so does ``context_parallel_attention`` here, on every rank:
  * q (and the bias) enters through ``collectives.shard`` (this rank's
    rows; the backward gathers the rows' gradients, so the replicated
    computation before it gets its whole gradient);
  * k and v enter whole through ``collectives.replicated``: each rank's
    dK/dV over all n keys is a partial sum over its queries, and the
    backward's all-reduce adds the ranks' partials (ctpa's all-gather
    transposes to a reduce-scatter, which its replicated inputs gather
    back: the same sum);
  * the output leaves through ``collectives.gather_replicated``.
So the gradients equal the unsharded attention's on every rank.

``rank_attention`` is the per-rank body: what rank r computes from its
query block and all the keys and values.  Under ``causal`` its queries
are rows [r n/p, (r + 1) n/p) of the sequence, so the causal mask shifts by
``q_offset = r n/p`` (an int32 tensor on the device; the kernels skip the
key tiles past each query tile's last causal key by it).  This is the LLM
sequence-parallel form; the fused volumetric sequence is non-causal.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ctpa_torch.comms.collectives import gather_replicated, replicated, shard
from ctpa_torch.ops.flash_attention import flash_attention


def _dense_attention(q, k, v, bias, kv_mask, scale, causal=False, q_offset=None):
    """The dense oracle (ctpa's ``_dense_attention``): fp32 scores, the
    bias, the causal mask shifted by ``q_offset``, the key mask (> 0 is a
    real key), -1e30 fill, the softmax in fp32 cast to v's dtype."""
    n, m = q.shape[2], k.shape[2]
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        s = s + (bias if bias.ndim == 4 else bias[None]).float()
    if causal:
        q_pos = torch.arange(n, device=q.device)[None, None, :, None]
        if q_offset is not None:
            q_pos = q_pos + torch.as_tensor(q_offset, device=q.device).reshape(())
        s = torch.where(torch.arange(m, device=q.device)[None, None, None, :] <= q_pos, s,
                        torch.full((), -1e30, device=q.device))
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", p, v)


def rank_offset(rank, n_local: int, device) -> torch.Tensor:
    """The global index of a rank's first query row, an int32 scalar tensor
    on ``device`` (what the causal mask of its block shifts by)."""
    return torch.tensor(rank * n_local, dtype=torch.int32, device=device)


def rank_attention(q_blk, k_full, v_full, bias_blk=None, kv_mask=None,
                   scale: Optional[float] = None, impl: str = "flash", causal: bool = False,
                   q_offset=None, logit_bound=None, return_lse: bool = False):
    """One rank's attention: its (b, h, n/p, d) query block over the
    whole (b, h, n, d) keys and values.  ``bias_blk`` holds the bias rows
    of the block ((h, n/p, n), (1, n/p, n) or (b, h, n/p, n)); ``kv_mask``
    (b, n) spans the whole sequence; ``q_offset`` shifts the causal mask.
    ``impl="flash"``: the flash kernels (``return_lse`` adds the fp32
    logsumexp); ``"dense"``: ``_dense_attention``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q_blk.shape[-1])
    if impl == "flash":
        return flash_attention(q_blk, k_full, v_full, bias=bias_blk, causal=causal,
                               scale=scale, kv_mask=kv_mask, q_offset=q_offset,
                               logit_bound=logit_bound, return_lse=return_lse)
    if impl != "dense":
        raise ValueError(f"impl must be 'flash' or 'dense', got {impl!r}")
    if return_lse:
        raise ValueError("the dense attention returns no logsumexp")
    return _dense_attention(q_blk, k_full, v_full, bias_blk, kv_mask, float(scale),
                            causal=causal, q_offset=q_offset)


def context_parallel_attention(q, k, v, mesh, axis: str, bias=None, kv_mask=None,
                               scale: Optional[float] = None, impl: str = "flash",
                               causal: bool = False, logit_bound=None) -> torch.Tensor:
    """Exact attention with the sequence dim of (b, h, n, d) q, k, v sharded
    over ``axis`` of ``mesh``.  The inputs are the global tensors, the same
    on every rank, and so is the output, as ctpa's; the gradients are the
    unsharded attention's.  ``bias`` ((h, n, n), (1, n, n) or (b, h, n, n))
    rows follow the query shard; ``kv_mask`` (b, n) spans the sequence;
    ``causal`` shifts each rank's mask by its first row (``rank_offset``).
    A sequence that p does not divide raises."""
    n = q.shape[2]
    p = mesh.size(axis)
    if n % p != 0:
        raise ValueError(f"sequence {n} not divisible by axis '{axis}' size {p}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    n_local = n // p
    q_blk = shard(q, mesh, axis, 2)
    bias_blk = None
    if bias is not None:
        bias_blk = shard(bias, mesh, axis, bias.ndim - 2)
    k_full, v_full = (replicated(t, mesh, axis).contiguous() for t in (k, v))
    q_off = rank_offset(mesh.index(axis), n_local, q.device) if causal else None
    out = rank_attention(q_blk, k_full, v_full, bias_blk, kv_mask, float(scale), impl, causal,
                         q_off, logit_bound)
    return gather_replicated(out, mesh, axis, 2)

