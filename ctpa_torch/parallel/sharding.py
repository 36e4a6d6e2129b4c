"""Parameter sharding rules: tensor parallelism over the 'model' axis (port
of ``ctpa/parallel/sharding.py``).

ctpa's rules map flax paths to ``PartitionSpec``s over (in, out) kernels,
and GSPMD inserts the collectives.  Here the rules are written on the
port's parameter names, and a rule gives the dim of torch's (out, in)
weight that is split: column-parallel (flax's ``P(None, model)``, the
output features) is dim 0, row-parallel (``P(model, None)``, the input
features) dim 1.  Where the axis does not divide that dim, or the leaf has
fewer than 2 dims, the weight is replicated, as ctpa's.

Megatron-style layout, as ctpa's:
  * attention q/k/v and MLP up/gate: column-parallel;
  * attention out and MLP down: row-parallel;
  * the 294,912 -> 512 visual latent projection: its input dim;
  * CTViT's to_q and to_out (ctpa's feed-forward rules name nothing);
  * embeddings, norms, biases and scalars: replicated.

``shard_llm_`` splits a ``LlamaForCausalLM`` for tensor parallel serving
by ``llm_shard_dims``: it keeps this rank's block of each split weight and
turns on the modules' collectives (``models/llm.py``).  A module whose
weights do not all split (quantized weights, which no rule names, or heads
that the axis does not divide) stays whole on every rank, with no
collective; its results are the same.  ``rank_kv_cache`` sizes a cache by
``kv_cache_shards``.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Optional

import torch
from torch import nn

from ctpa_torch.core.mesh import MODEL_AXIS
from ctpa_torch.models.llm import KVCache

COLUMN = 0   # torch (out, in): the output features
ROW = 1      # the input features

CTCLIP_RULES: list[tuple[str, int]] = [
    (r"to_visual_latent\.weight$", ROW),
    (r"to_text_latent\.weight$", COLUMN),
    # BERT
    (r"attention_self\.(query|key|value)\.weight$", COLUMN),
    (r"attention_output_dense\.weight$", ROW),
    (r"intermediate_dense\.weight$", COLUMN),
    (r"layers\.\d+\.output_dense\.weight$", COLUMN),
    # CTViT cosine attention: ctpa's to_(q|k|v) matches no fused to_kv, and
    # its ff/Dense_0, ff/Dense_1 name no parameter (the GEGLU feed-forward's
    # are proj_in and proj_out), so both stay replicated, as they act there
    (r"attn\.to_q\.weight$", COLUMN),
    (r"attn\.to_out\.weight$", ROW),
]

LLM_RULES: list[tuple[str, int]] = [
    (r"self_attn\.(q_proj|k_proj|v_proj)\.base\.weight$", COLUMN),
    (r"self_attn\.o_proj\.base\.weight$", ROW),
    (r"mlp\.(gate_proj|up_proj)\.weight$", COLUMN),
    (r"mlp\.down_proj\.weight$", ROW),
    (r"lm_head\.weight$", COLUMN),
]


def dim_for_name(name: str, rules: list[tuple[str, int]]) -> Optional[int]:
    """The split dim of the first rule that ``name`` matches, or None."""
    for pattern, dim in rules:
        if re.search(pattern, name):
            return dim
    return None


def param_shard_dims(shapes: dict[str, tuple], tp: int,
                     rules: list[tuple[str, int]]) -> dict[str, Optional[int]]:
    """Parameter name -> the dim split over a model axis of size ``tp``, or
    None (replicated), for the (name -> shape) map ``shapes`` (e.g. from a
    ``state_dict``)."""

    def assign(name, shape):
        dim = dim_for_name(name, rules)
        if dim is None or len(shape) < 2 or shape[dim] % tp:
            return None
        return dim

    return {name: assign(name, tuple(shape)) for name, shape in shapes.items()}


def clip_shard_dims(model: nn.Module, tp: int) -> dict[str, Optional[int]]:
    return param_shard_dims({n: p.shape for n, p in model.named_parameters()}, tp,
                            CTCLIP_RULES)


def llm_shard_dims(model: nn.Module, tp: int) -> dict[str, Optional[int]]:
    return param_shard_dims({n: p.shape for n, p in model.named_parameters()}, tp,
                            LLM_RULES + CTCLIP_RULES)


def kv_cache_shards(cache, tp: int):
    """The cache's fields -> the split axis over a model axis of size
    ``tp``: 2 (the kv heads of the head-major (L, b, kvh, m[, ...]) k, v and
    scales) where ``tp`` divides it, else None; the offsets, lengths and
    validity replicated."""

    def head_axis(x):
        if x is None or x.ndim < 4 or x.shape[2] % tp:
            return None
        return 2

    return type(cache)(k=head_axis(cache.k), v=head_axis(cache.v), write_offset=None,
                       true_len=None, valid=None, k_scale=head_axis(cache.k_scale),
                       v_scale=head_axis(cache.v_scale))


@torch.no_grad()
def _narrow_(module: nn.Module, name: str, dim: int, tp: int, r: int) -> None:
    old = getattr(module, name)
    blk = old.shape[dim] // tp
    setattr(module, name, nn.Parameter(old.narrow(dim, r * blk, blk).contiguous(),
                                       requires_grad=old.requires_grad))


def shard_llm_(llm: nn.Module, mesh, axis: str = MODEL_AXIS) -> dict[str, bool]:
    """Tensor-parallel ``llm`` (a ``LlamaForCausalLM``) in place: each weight
    keeps this rank's block along its ``llm_shard_dims`` dim (and a LoRA
    factor with it: B's columns on a column-parallel projection, A's rows
    on a row-parallel one); the attentions' ``cfg`` counts this rank's
    heads.  A module is split only if every one of its weights is (and, for
    the attention, the axis divides the heads and the kv heads); otherwise
    it stays whole, with no collective.  Returns which parts were split
    ("attention", "mlp", "lm_head")."""
    tp, r = mesh.size(axis), mesh.index(axis)
    cfg = llm.cfg
    dims = llm_shard_dims(llm, tp)
    modules = dict(llm.named_modules())

    def narrow(names: list[str]) -> bool:
        if any(dims.get(f"{name}.weight") is None for name in names):
            return False
        for name in names:
            dim = dims[f"{name}.weight"]
            _narrow_(modules[name], "weight", dim, tp, r)
            lora = modules[name.removesuffix(".base")] if name.endswith(".base") else None
            if lora is not None and lora.rank > 0:
                if dim == COLUMN:
                    _narrow_(lora, "lora_b", 1, tp, r)          # (rank, out)
                else:
                    _narrow_(lora, "lora_a", 0, tp, r)          # (in, rank)
        return True

    heads = cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
    local = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp,
                                num_kv_heads=cfg.num_kv_heads // tp,
                                hidden_size=cfg.hidden_size // tp)
    split = dict.fromkeys(("attention", "mlp", "lm_head"), False)
    for i, layer in enumerate(llm.model.layers):
        prefix = f"model.layers.{i}"
        if heads and narrow([f"{prefix}.self_attn.{n}_proj.base" for n in "qkvo"]):
            layer.self_attn.cfg, layer.self_attn.tp = local, (mesh, axis)
            split["attention"] = True
        if narrow([f"{prefix}.mlp.{n}_proj" for n in ("gate", "up", "down")]):
            layer.mlp.tp = (mesh, axis)
            split["mlp"] = True
    if narrow(["lm_head"]):
        llm.tp = (mesh, axis)
        split["lm_head"] = True
    return split


def rank_kv_cache(llm: nn.Module, batch: int, max_len: int, dtype, device):
    """A KV cache for ``llm`` that holds this rank's kv heads: the full
    config's cache, each field split where ``kv_cache_shards`` splits it
    over the model axis of ``llm``'s attentions (whole where they are)."""
    attn = llm.model.layers[0].self_attn if len(llm.model.layers) else None
    tp = 1 if attn is None or attn.tp is None else attn.tp[0].size(attn.tp[1])
    full = KVCache.create(llm.cfg, batch, max_len, dtype=dtype, device="meta")

    def local(t, axis):
        if t is None:
            return None
        shape = list(t.shape)
        if axis is not None:
            shape[axis] //= tp
        return torch.zeros(shape, dtype=t.dtype, device=device)

    return KVCache(*(local(t, axis) for t, axis in zip(full, kv_cache_shards(full, tp))))


def tensor_parallel_copy(model: nn.Module, mesh, axis: str = MODEL_AXIS) -> nn.Module:
    """A copy of ``model`` (a ``CTReportGenerator``) whose LLM is
    ``shard_llm_``'d; every tensor the split leaves whole is shared with
    ``model``, which is left as it was."""
    memo = {id(t): t for t in list(model.parameters()) + list(model.buffers())}
    twin = copy.deepcopy(model, memo)
    shard_llm_(twin.llm, mesh, axis)
    return twin
