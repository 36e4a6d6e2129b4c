"""Decoder-only LLM at llama-2 / Meditron-7B geometry with a KV cache (port of
``ctpa/models/llm.py``, the float-weight path).

Parameter names follow ctpa's flax tree (``embed_tokens``,
``layers.i.self_attn.q_proj.base``, ``input_layernorm``, ``mlp.gate_proj``,
``lm_head``), so ``ctpa_torch.convert`` carries its weights.  Parameters
are cast to the compute dtype at use, as ctpa's modules cast to their
``dtype``; attention scores and the softmax are fp32.

The KV cache is head-major, (L, b, kvh, m, hd), as ctpa's.  Unlike ctpa's
functional updates, each layer writes its new rows into the cache buffers
**in place**: the ``KVCache`` a forward returns holds the same k/v (and
scale) tensors as the one it was given, with new offsets and validity.
Single-token steps with ``flash_decode`` run the decode-attention kernel
(``ops/decode_attention.py``); no-cache forwards of at least
``flash_min_len`` tokens with ``flash_prefill`` (report training) run the
flash kernel, causal with the attention mask as its key mask
(``ops/flash_attention.py``); everything else runs the dense grouped-query
attention.  Nothing in a forward reads a device value back to the host.

Quantized serving weights (``weight_quant``, ctpa's ``Int8Dense``,
``Int4Dense`` and their callers): each targeted projection is an
``Int8Dense`` holding ctpa's ``kernel_q`` (in, out) int8 and ``scale``
(out,) as buffers, run by ``ops/quant.py:int8_matmul`` (kernel K4), or an
``Int4Dense`` holding ``kernel_q`` (in/2, out) and ``scale_g`` (in/group,
out), run by ``int4_matmul`` (kernel K5), the lm_head too; ``quant_fused``
gives the fused ``qkv_proj`` and ``gateup_proj``, ``quant_ffn_kernel`` runs
the whole SwiGLU FFN through ``int8_ffn`` (kernel K6) or ``int4_ffn``
(kernel K7), ``quant_act`` is w8a8 / w4a8, and ``quant_impl="xla"`` takes
ctpa's plain composition instead of the kernels.  The trees come from
``ops/quant.py:quantize_tree``.

Quantized KV caches (``kv_quant``): "int8" stores int8 rows with per-(kv
head, slot) fp32 scales; "int4" stores nibble-packed rows with per-(kv head,
slot, head_dim group) scales (``ops/quant.py:quantize_kv_int4``, groups of
``kv_quant_group``, scales in ``kv_scale_dtype``), read by grouped partial
dots with the scales folded in.  ``kv_int8_dots`` runs the int8 cache's
attention as int8 x int8 dots with exact integer sums.  Those attentions
are ctpa's XLA einsums, not kernels, and stay plain torch here; the decode
kernel takes the float and int8 caches only.

Tensor parallelism (``parallel/sharding.py:shard_llm_``, ctpa's
Megatron-style ``LLM_RULES`` under GSPMD): each rank of the model axis
holds its columns of q/k/v, gate and up (its heads and FFN columns; the
attention's ``cfg`` then counts its own heads) and its rows of o_proj and
down, whose partial products (LoRA's too) are summed by one all-reduce
each (``tp``); a column-parallel lm_head's logits are all-gathered before
anything reads them.  The KV cache holds the rank's kv heads.

Continuous batching (``pipelines/streaming.py``) keeps one batched cache on
a ring: ``align_lane_to_clock`` rotates a prefilled one-lane cache onto the
shared clock and ``insert_lane``/``insert_lanes`` copy it into lanes, in
place.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ctpa_torch.comms.collectives import all_reduce, gather_replicated
from ctpa_torch.core.config import LLMConfig, LoRAConfig
from ctpa_torch.models.layers import Dense, compute_dtype
from ctpa_torch.models.lora import LoRADense
from ctpa_torch.ops.decode_attention import decode_attention
from ctpa_torch.ops.flash_attention import flash_attention
from ctpa_torch.ops.quant import (GROUP, _int4_group, int4_ffn, int4_matmul, int8_ffn,
                                  int8_matmul, quantize_kv_int4, unpack_kv_int4)
from ctpa_torch.ops.rotary import apply_rope, rope_frequencies


def check_ported(cfg: LLMConfig) -> None:
    """Raise on configuration values whose paths the port does not have, or
    that would act on nothing."""
    if cfg.weight_quant not in (None, "int8", "int4"):
        raise ValueError(f"unknown weight_quant {cfg.weight_quant!r}")
    if cfg.quant_impl not in ("pallas", "xla"):
        raise ValueError(f"unknown quant_impl {cfg.quant_impl!r}")
    if cfg.kv_quant not in (None, "int8", "int4"):
        raise ValueError(f"unknown kv_quant {cfg.kv_quant!r}")
    if cfg.kv_scale_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown kv_scale_dtype {cfg.kv_scale_dtype!r}")
    # settings that act only on the quantized-weight, int4-cache and
    # int8-cache paths: where those are off, a value other than the default
    # would be ignored, so it is refused
    default = LLMConfig()
    ignored = []
    if cfg.kv_quant != "int4":
        ignored += ["kv_quant_group", "kv_scale_dtype"]
    if cfg.kv_quant != "int8":
        ignored += ["kv_int8_dots"]
    if cfg.weight_quant is None:
        ignored += ["quant_impl", "quant_fused", "quant_ffn_kernel", "quant_act"]
    unported = [name for name in ignored if getattr(cfg, name) != getattr(default, name)]
    if unported:
        raise NotImplementedError(f"LLMConfig {unported} act only with settings that are off")
    if cfg.kv_quant == "int4":
        _int4_group(cfg.head_dim, cfg.kv_quant_group)


class _QuantDense(nn.Module):
    """A quantized serving projection's settings: x is cast to the compute
    dtype (``dtype``, or the module's ``compute_dtype`` when set) first."""

    def __init__(self, cfg: LLMConfig, dtype=None):
        super().__init__()
        self.impl, self.act_quant = cfg.quant_impl, cfg.quant_act
        self.dtype = dtype or torch.get_default_dtype()

    def act_dtype(self) -> torch.dtype:
        return getattr(self, "compute_dtype", None) or self.dtype


class Int8Dense(_QuantDense):
    """An int8 serving projection (ctpa's ``Int8Dense``): ``kernel_q`` (in,
    out) int8 and ``scale`` (out,) fp32 buffers, as ``quantize_tree(bits=8)``
    writes them.  The buffers also feed the fused FFN (``LlamaMLP``)."""

    def __init__(self, in_features: int, features: int, cfg: LLMConfig, device=None,
                 dtype=None):
        super().__init__(cfg, dtype)
        self.register_buffer("kernel_q", torch.zeros(in_features, features, dtype=torch.int8,
                                                     device=device))
        self.register_buffer("scale", torch.ones(features, device=device))

    def forward(self, x):
        return int8_matmul(x.to(self.act_dtype()), self.kernel_q, self.scale, self.impl,
                           self.act_quant)


class Int4Dense(_QuantDense):
    """An int4 serving projection (ctpa's ``Int4Dense``): ``kernel_q`` (in/2,
    out) packed int8 and ``scale_g`` (in/group, out) fp32 buffers, as
    ``quantize_tree(bits=4)`` writes them.  The buffers also feed the fused
    FFN (``LlamaMLP``)."""

    def __init__(self, in_features: int, features: int, cfg: LLMConfig, device=None,
                 dtype=None):
        super().__init__(cfg, dtype)
        self.group = _int4_group(in_features, GROUP)
        self.register_buffer("kernel_q", torch.zeros(in_features // 2, features,
                                                     dtype=torch.int8, device=device))
        self.register_buffer("scale_g", torch.ones(in_features // self.group, features,
                                                   device=device))

    def forward(self, x):
        return int4_matmul(x.to(self.act_dtype()), self.kernel_q, self.scale_g, self.group,
                           self.impl, self.act_quant)


def _quant_dense(cfg: LLMConfig, in_features: int, features: int, fk: dict) -> _QuantDense:
    """The serving projection for ``cfg.weight_quant`` (ctpa's ``_quant_dense``)."""
    cls = Int4Dense if cfg.weight_quant == "int4" else Int8Dense
    return cls(in_features, features, cfg, **fk)


def _proj(cfg: LLMConfig, in_features: int, features: int, fk: dict,
          lora: Optional[LoRAConfig] = None, lora_name: Optional[str] = None) -> nn.Module:
    """Projection factory (ctpa's ``_proj``): int8 or int4 when
    ``cfg.weight_quant`` is set (a LoRA overlay on it raises: merge the
    adapters first), a ``LoRADense`` where the caller names a LoRA slot, else
    a ``Dense``."""
    if cfg.weight_quant is not None:
        if lora is not None and lora_name in (lora.target_projections or ()):
            raise ValueError("LoRA overlays are not supported with quantized weights "
                             "(merge adapters first)")
        return _quant_dense(cfg, in_features, features, fk)
    if lora_name is not None:
        return LoRADense(in_features, features, **_lora_args(lora, lora_name), **fk)
    return Dense(in_features, features, bias=False, **fk)


class RMSNorm(nn.Module):
    """fp32 statistics and weight; the output in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * self.weight.float()).to(x.dtype)


class KVCache(NamedTuple):
    """Static-shape KV cache, head-major: k, v (L, b, kvh, m, hd).

    ``write_offset`` (b,) is each sequence's next free slot (an unwrapped
    clock on the serving ring: slots are taken modulo m); ``true_len`` (b,)
    counts its real tokens and gives the RoPE positions; ``valid`` (b, m)
    marks the slots that hold a real token's key and value.  The int8 cache
    stores int8 rows with per-(kv head, slot) fp32 absmax scales
    ``k_scale``, ``v_scale`` (L, b, kvh, m); the int4 cache packed rows (L,
    b, kvh, m, hd/2) with per-(kv head, slot, group) scales (L, b, kvh, m,
    hd/group).  Every slot operation treats the scales by their slot axis
    (3), which both share.  A forward writes k, v and the scales in place."""

    k: torch.Tensor
    v: torch.Tensor
    write_offset: torch.Tensor
    true_len: torch.Tensor
    valid: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int, max_len: Optional[int] = None,
               dtype=torch.bfloat16, device="cuda") -> "KVCache":
        max_len = max_len or cfg.max_seq_len
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
        store, scale_shape, scale_dtype = dtype, None, torch.float32
        if cfg.kv_quant == "int8":
            store, scale_shape = torch.int8, shape[:-1]
        elif cfg.kv_quant == "int4":
            gs = _int4_group(cfg.head_dim, cfg.kv_quant_group)
            store, scale_shape = torch.int8, shape[:-1] + (cfg.head_dim // gs,)
            shape = shape[:-1] + (cfg.head_dim // 2,)
            scale_dtype = getattr(torch, cfg.kv_scale_dtype)

        def scales():
            return (None if scale_shape is None
                    else torch.zeros(scale_shape, dtype=scale_dtype, device=device))

        return cls(k=torch.zeros(shape, dtype=store, device=device),
                   v=torch.zeros(shape, dtype=store, device=device),
                   write_offset=torch.zeros(batch, dtype=torch.int32, device=device),
                   true_len=torch.zeros(batch, dtype=torch.int32, device=device),
                   valid=torch.zeros(batch, max_len, dtype=torch.bool, device=device),
                   k_scale=scales(), v_scale=scales())


def _planes(cache: KVCache) -> tuple:
    """The cache's per-lane tensors with a slot axis: k, v and the scales."""
    return tuple(t for t in (cache.k, cache.v, cache.k_scale, cache.v_scale) if t is not None)


def align_lane_to_clock(lane: KVCache, clock) -> KVCache:
    """Rotate a freshly prefilled one-lane cache (slots [0, n)) so its last
    written token lands at slot (clock - 1) mod m, and stamp its
    write_offset with the unwrapped clock: new[s] = old[(s - shift) mod m],
    shift = (clock - n) mod m, for k, v, the scales and the validity alike.
    Every lane of the serving ring then writes at one shared slot.  The
    shift is taken on the device (``clock`` a Python int or a 0-d tensor):
    nothing is read back to the host.  Returns new tensors; ``lane`` is
    left as it was."""
    m = lane.k.shape[3]
    dev = lane.k.device
    shift = (clock - lane.write_offset[0]) % m
    perm = (torch.arange(m, device=dev) - shift) % m
    k, v, ks, vs = (None if t is None else t.index_select(3, perm)
                    for t in (lane.k, lane.v, lane.k_scale, lane.v_scale))
    return KVCache(k=k, v=v, write_offset=torch.zeros_like(lane.write_offset) + clock,
                   true_len=lane.true_len, valid=lane.valid.index_select(1, perm),
                   k_scale=ks, v_scale=vs)


def insert_lane(big: KVCache, lane: KVCache, idx) -> KVCache:
    """Copy a one-lane cache into lane ``idx`` of a batched cache, in place;
    returns ``big`` with the lane's offsets and validity."""
    return insert_lanes(big, lane, torch.full((1,), idx, device=big.k.device))


def insert_lanes(big: KVCache, lane: KVCache, idxs: torch.Tensor) -> KVCache:
    """Copy ONE one-lane cache into every lane of ``idxs`` of a batched
    cache, in place (batched shared-prefix admission).  ``idxs`` may repeat
    a lane (the caller pads it by repeating the last real lane): every
    write of a lane carries the same content, which is the only reason the
    duplicates are safe under ``index_put_(accumulate=False)``, whose write
    order among duplicates is unspecified."""
    idxs = idxs.to(device=big.k.device, dtype=torch.long)
    q = idxs.shape[0]
    for dst, src in zip(_planes(big), _planes(lane)):
        dst[:, idxs] = src.expand(src.shape[0], q, *src.shape[2:])   # index_put_, no accumulate
    meta = []
    for dst, src in ((big.write_offset, lane.write_offset), (big.true_len, lane.true_len),
                     (big.valid, lane.valid)):
        out = dst.clone()
        out.index_put_((idxs,), src.expand(q, *src.shape[1:]), accumulate=False)
        meta.append(out)
    return big._replace(write_offset=meta[0], true_len=meta[1], valid=meta[2])


def _write(cache: torch.Tensor, layer: int, new: torch.Tensor, index: torch.Tensor) -> None:
    """Write ``new`` (b, kvh, n[, hd]) into slots ``index + [0, n)`` (mod m)
    of layer ``layer`` of ``cache`` (L, b, kvh, m[, hd]), in place.  A 0-d
    ``index`` is one slot shared by every sequence; a (b,) index is one per
    sequence."""
    plane = cache[layer]
    m, n = plane.shape[2], new.shape[2]
    steps = torch.arange(n, device=new.device)
    if index.ndim == 0:
        plane.index_copy_(2, (index + steps) % m, new)
    else:
        slots = (index[:, None] + steps[None]) % m                         # (b, n)
        rows = torch.arange(plane.shape[0], device=new.device)[:, None]
        plane[rows, :, slots] = new.movedim(2, 1)


def _quant_rows(rows: torch.Tensor):
    """Symmetric absmax int8 per (kv head, token) over head_dim: (int8 rows,
    fp32 scales)."""
    rf = rows.float()
    scale = torch.clamp(rf.abs().amax(-1) / 127.0, min=1e-12)
    return torch.clamp(torch.round(rf / scale[..., None]), -127, 127).to(torch.int8), scale


def _lora_args(lora: Optional[LoRAConfig], name: str) -> dict:
    if lora is not None and name in lora.target_projections:
        return {"rank": lora.rank, "alpha": lora.alpha}
    return {"rank": 0}


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LLMConfig, lora: Optional[LoRAConfig] = None, layer_idx: int = 0,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg, self.layer_idx = cfg, layer_idx
        h, kvh, hd, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.hidden_size
        # quantize_tree(fuse=True)'s layout: one projection for q, k and v
        self.fused = cfg.weight_quant is not None and cfg.quant_fused
        if self.fused:
            if lora is not None and {"q_proj", "k_proj", "v_proj"} & set(
                    lora.target_projections or ()):
                raise ValueError("LoRA overlays are not supported with quantized weights "
                                 "(merge adapters first)")
            self.qkv_proj = _quant_dense(cfg, d, (h + 2 * kvh) * hd, fk)
        else:
            for name, out in (("q_proj", h * hd), ("k_proj", kvh * hd), ("v_proj", kvh * hd)):
                setattr(self, name, _proj(cfg, d, out, fk, lora, name))
        self.o_proj = _proj(cfg, h * hd, d, fk, lora, "o_proj")
        self.tp = None           # (mesh, axis) of a row-parallel o_proj

    def _out(self, x):
        """o_proj, its partial products summed over the model axis when it
        is row-parallel."""
        y = self.o_proj(x)
        return y if self.tp is None else all_reduce(y, *self.tp)

    def _qkv(self, x):
        if not self.fused:
            return self.q_proj(x), self.k_proj(x), self.v_proj(x)
        h, kvh, hd = self.cfg.num_heads, self.cfg.num_kv_heads, self.cfg.head_dim
        return self.qkv_proj(x).split((h * hd, kvh * hd, kvh * hd), dim=-1)

    def forward(self, x, positions, rope, kv_write_index=None, cache_k=None, cache_v=None,
                attn_mask=None, key_mask=None, flash: bool = False):
        """x (b, n, d); ``rope`` the (cos, sin) tables.  With a cache,
        ``cache_k``/``cache_v`` are (buffer, scale or None) pairs of the FULL
        stacked cache: this layer writes its n new rows at
        ``kv_write_index`` and attends its own plane.  ``attn_mask`` is
        (b, 1, n, m) or (b, 1, 1, m), True = attend; ``key_mask`` (b, m) is
        the validity the decode kernel takes, and with ``flash`` (no cache)
        the flash kernel's key mask."""
        c = self.cfg
        h, kvh, hd = c.num_heads, c.num_kv_heads, c.head_dim
        b, n, _ = x.shape
        cos, sin = rope
        q, k, v = self._qkv(x)
        q = apply_rope(q.reshape(b, n, h, hd), cos, sin, positions)
        k = apply_rope(k.reshape(b, n, kvh, hd), cos, sin, positions)
        v = v.reshape(b, n, kvh, hd)
        dt = q.dtype
        k_sc = v_sc = None
        if cache_k is not None:
            (ck, ksc), (cv, vsc) = cache_k, cache_v
            k_hm, v_hm = k.transpose(1, 2), v.transpose(1, 2)               # (b, kvh, n, hd)
            int4 = c.kv_quant == "int4"
            if ksc is not None:
                if int4:
                    sdt = getattr(torch, c.kv_scale_dtype)
                    (k8, k_rows), (v8, v_rows) = (quantize_kv_int4(t, c.kv_quant_group, sdt)
                                                  for t in (k_hm, v_hm))
                else:
                    (k8, k_rows), (v8, v_rows) = _quant_rows(k_hm), _quant_rows(v_hm)
                for buf, new in ((ck, k8), (cv, v8), (ksc, k_rows), (vsc, v_rows)):
                    _write(buf, self.layer_idx, new, kv_write_index)
            else:
                _write(ck, self.layer_idx, k_hm.to(ck.dtype), kv_write_index)
                _write(cv, self.layer_idx, v_hm.to(cv.dtype), kv_write_index)
            if n == 1 and key_mask is not None and c.flash_decode:
                if int4:
                    raise ValueError("flash_decode does not support kv_quant='int4' (the "
                                     "kernel folds scalar per-row scales, not head_dim "
                                     "groups); use kv_quant='int8' or None")
                out = decode_attention(q[:, 0], ck, cv, key_mask, self.layer_idx,
                                       k_scale=ksc, v_scale=vsc, scale=1.0 / math.sqrt(hd))
                return self._out(out.reshape(b, 1, h * hd).to(x.dtype))
            if int4:
                out = self._int4_attention(q, ck, cv, ksc, vsc, attn_mask)
                return self._out(out.reshape(b, n, h * hd))
            if ksc is not None and c.kv_int8_dots:
                out = self._int8_dot_attention(q, ck, cv, ksc, vsc, attn_mask)
                return self._out(out.reshape(b, n, h * hd).to(x.dtype))
            if ksc is not None:
                k_sc, v_sc = ksc[self.layer_idx], vsc[self.layer_idx]        # (b, kvh, m)
            k_full, v_full = ck[self.layer_idx].to(dt), cv[self.layer_idx].to(dt)
        else:
            k_full, v_full = k.transpose(1, 2), v.transpose(1, 2)
            if flash:
                # the kernel wants as many kv heads as q heads: q head g * rep
                # + r attends kv head g, as jnp.repeat(kv, rep, axis=1)
                rep = h // kvh
                if rep > 1:
                    k_full = k_full.repeat_interleave(rep, dim=1)
                    v_full = v_full.repeat_interleave(rep, dim=1)
                out = flash_attention(q.transpose(1, 2).contiguous(), k_full.contiguous(),
                                      v_full.contiguous(), causal=True, kv_mask=key_mask,
                                      scale=1.0 / math.sqrt(hd))
                return self._out(out.transpose(1, 2).reshape(b, n, h * hd).to(x.dtype))
        # grouped-query attention against the un-repeated K/V: q head
        # g * rep + r attends kv head g; fp32 scores (preferred_element_type)
        qg = q.reshape(b, n, kvh, h // kvh, hd)
        sim = torch.einsum("bngrd,bgmd->bgrnm", qg.float(), k_full.float()) / math.sqrt(hd)
        if k_sc is not None:
            sim = sim * k_sc[:, :, None, None, :]
        if attn_mask is not None:
            sim = sim.masked_fill(~attn_mask[:, :, None], torch.finfo(torch.float32).min)
        attn = torch.softmax(sim, dim=-1)
        if v_sc is not None:
            attn = attn * v_sc[:, :, None, None, :]
        out = torch.einsum("bgrnm,bgmd->bngrd", attn.to(v_full.dtype), v_full)
        return self._out(out.reshape(b, n, h * hd))

    def _int4_attention(self, q, ck, cv, ksc, vsc, attn_mask):
        """Grouped attention over the int4 cache -> (b, n, kvh, rep, G, gs) in
        q's dtype.  The group scales vary along the contractions (head_dim
        for QK, slots for PV), so QK runs as per-group partial dots with the
        K scales contracted second, and the V scales fold into the weights
        per group before the PV dots: sum_d q_d k_d = sum_G s_G sum_{d in G}
        q_d k8_d, exactly."""
        c = self.cfg
        b, n, h, hd = q.shape
        kvh = c.num_kv_heads
        gq = _int4_group(hd, c.kv_quant_group)
        layer = self.layer_idx
        k8 = unpack_kv_int4(ck[layer], gq)                             # (b, kvh, m, G, gs)
        v8 = unpack_kv_int4(cv[layer], gq)
        k_sg, v_sg = ksc[layer].float(), vsc[layer].float()             # (b, kvh, m, G)
        qg4 = q.reshape(b, n, kvh, h // kvh, hd // gq, gq)
        simg = torch.einsum("bngrGd,bgmGd->bgrnmG", qg4.float(), k8.float())
        sim = torch.einsum("bgrnmG,bgmG->bgrnm", simg, k_sg) / math.sqrt(hd)
        if attn_mask is not None:
            sim = sim.masked_fill(~attn_mask[:, :, None], torch.finfo(torch.float32).min)
        attn = torch.softmax(sim, dim=-1)
        attng = (attn[..., None] * v_sg[:, :, None, None]).to(q.dtype)  # (b, g, r, n, m, G)
        return torch.einsum("bgrnmG,bgmGd->bngrGd", attng, v8.to(q.dtype))

    def _int8_dot_attention(self, q, ck, cv, ksc, vsc, attn_mask):
        """Attention with the int8 cache rows as the dots' operands -> (b, n,
        kvh, rep, hd) fp32: q quantized per (b, n, head) absmax, the QK dot
        int8 x int8 with exact integer sums, then the q and k scales; for PV
        the v scales fold into the fp32 weights before their row
        quantization (weights >= 0, levels 0-127), so the exact int dot
        times the row scale recovers the fold.  The integer sums run in fp64,
        which holds them exactly (|sum| <= m 127^2), as ctpa's int32 dots."""
        c = self.cfg
        b, n, h, hd = q.shape
        kvh, layer = c.num_kv_heads, self.layer_idx
        qg8 = q.reshape(b, n, kvh, h // kvh, hd).float()
        q_sc = torch.clamp(qg8.abs().amax(-1) / 127.0, min=1e-12)        # (b, n, g, r)
        qq = torch.clamp(torch.round(qg8 / q_sc[..., None]), -127, 127)
        sim = torch.einsum("bngrd,bgmd->bgrnm", qq.double(), ck[layer].double()).float()
        sim = (sim * q_sc.permute(0, 2, 3, 1)[..., None]
               * ksc[layer][:, :, None, None, :]) / math.sqrt(hd)
        if attn_mask is not None:
            sim = sim.masked_fill(~attn_mask[:, :, None], torch.finfo(torch.float32).min)
        attn = torch.softmax(sim, dim=-1) * vsc[layer][:, :, None, None, :]
        a_sc = torch.clamp(attn.amax(-1) / 127.0, min=1e-30)              # (b, g, r, n)
        a8 = torch.clamp(torch.round(attn / a_sc[..., None]), 0, 127)
        out = torch.einsum("bgrnm,bgmd->bngrd", a8.double(), cv[layer].double()).float()
        return out * a_sc.permute(0, 3, 1, 2)[..., None]


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x)).  With quantized weights: the
    fused ``gateup_proj`` (``quant_fused``), or the whole FFN in one
    ``int8_ffn`` or ``int4_ffn`` call on the three projections' buffers
    (``quant_ffn_kernel``)."""

    def __init__(self, cfg: LLMConfig, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        d, i = cfg.hidden_size, cfg.intermediate_size
        quant = cfg.weight_quant is not None
        self.ffn_kernel = quant and cfg.quant_ffn_kernel
        self.fused = quant and cfg.quant_fused and not self.ffn_kernel
        if self.fused:
            self.gateup_proj = _quant_dense(cfg, d, 2 * i, fk)
        else:
            self.gate_proj = _proj(cfg, d, i, fk)
            self.up_proj = _proj(cfg, d, i, fk)
        self.down_proj = _proj(cfg, i, d, fk)
        self.tp = None           # (mesh, axis) of a row-parallel down_proj

    def forward(self, x):
        if self.ffn_kernel:
            c = self.cfg
            g, u, dn = self.gate_proj, self.up_proj, self.down_proj
            x = x.to(g.act_dtype())
            if c.weight_quant == "int8":
                return int8_ffn(x, g.kernel_q, g.scale, u.kernel_q, u.scale, dn.kernel_q,
                                dn.scale, impl=c.quant_impl, act_quant=c.quant_act)
            return int4_ffn(x, g.kernel_q, g.scale_g, u.kernel_q, u.scale_g, dn.kernel_q,
                            dn.scale_g, group=GROUP, impl=c.quant_impl, act_quant=c.quant_act)
        if self.fused:
            gate, up = self.gateup_proj(x).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        y = self.down_proj(F.silu(gate) * up)
        return y if self.tp is None else all_reduce(y, *self.tp)


class LlamaBlock(nn.Module):
    """Pre-norm residual block."""

    def __init__(self, cfg: LLMConfig, lora: Optional[LoRAConfig] = None, layer_idx: int = 0,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **fk)
        self.self_attn = LlamaAttention(cfg, lora, layer_idx, **fk)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **fk)
        self.mlp = LlamaMLP(cfg, **fk)

    def forward(self, x, positions, rope, kv_write_index=None, cache_k=None, cache_v=None,
                attn_mask=None, key_mask=None, flash: bool = False):
        x = x + self.self_attn(self.input_layernorm(x), positions, rope, kv_write_index,
                               cache_k, cache_v, attn_mask, key_mask, flash)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    """Embeddings, blocks and the final norm.  forward -> (hidden, new cache
    or None): a full-sequence forward without a cache, a prefill with one,
    or a single-token decode step (n == 1 with a cache).  ``remat``
    recomputes each block in the backward (``torch.utils.checkpoint``, ctpa's
    ``nn.remat`` per block), keeping only the blocks' inputs for it."""

    def __init__(self, cfg: LLMConfig, lora: Optional[LoRAConfig] = None, device=None,
                 dtype=None, remat: bool = False):
        super().__init__()
        check_ported(cfg)
        fk = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.remat = remat
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **fk)
        self.layers = nn.ModuleList([LlamaBlock(cfg, lora, i, **fk)
                                     for i in range(cfg.num_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **fk)

    def forward(self, input_ids=None, attention_mask=None, cache: Optional[KVCache] = None,
                positions=None, inputs_embeds=None, shared_kv_offset: bool = False):
        """``attention_mask`` (b, n): 1 = real token.  Positions default to
        ``cache.true_len + [0, n)`` (pads get positions past the real length;
        they are never attended).  ``shared_kv_offset`` promises that every
        sequence's ``cache.write_offset`` is the same (lockstep decode of
        right-padded prompts): the rows are then written at one shared slot."""
        c = self.cfg
        weight = self.embed_tokens.weight
        dt = compute_dtype(self, weight)
        if inputs_embeds is None:
            b, n = input_ids.shape
            x = F.embedding(input_ids, weight).to(dt)
        else:
            b, n = inputs_embeds.shape[:2]
            x = inputs_embeds.to(dt)
        dev = x.device
        steps = torch.arange(n, device=dev)
        if positions is None:
            positions = (cache.true_len[:, None] + steps[None] if cache is not None
                         else steps[None].expand(b, n))
        key_mask = write_idx = ck = cv = None
        flash = False
        if cache is not None:
            m = cache.k.shape[3]
            real = (attention_mask.bool() if attention_mask is not None
                    else torch.ones(b, n, dtype=torch.bool, device=dev))
            write_slots = (cache.write_offset[:, None] + steps[None]) % m          # (b, n)
            slot = torch.arange(m, device=dev)
            newly = ((slot[None, None] == write_slots[:, :, None]) & real[:, :, None]).any(1)
            valid_now = cache.valid | newly
            if n == 1:
                # an append-only cache: causality is validity
                mask = valid_now[:, None, None, :]
                key_mask = valid_now if c.flash_decode else None
            else:
                mask = ((slot[None, None, None] <= write_slots[:, None, :, None])
                        & valid_now[:, None, None, :])
            write_idx = cache.write_offset[0] if shared_kv_offset else cache.write_offset
            ck, cv = (cache.k, cache.k_scale), (cache.v, cache.v_scale)
        elif c.flash_prefill and n >= c.flash_min_len:
            # the flash kernel masks causally and by key itself: no (b, 1, n,
            # n) mask is built
            flash, mask = True, None
            key_mask = attention_mask > 0 if attention_mask is not None else None
        else:
            mask = steps[None, None, None, :] <= steps[None, None, :, None]
            if attention_mask is not None:
                mask = mask & (attention_mask[:, None, None, :] > 0)
        rope = rope_frequencies(c.head_dim, c.max_seq_len, c.rope_theta, device=dev)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, positions, rope, write_idx, ck, cv, mask, key_mask,
                               flash, use_reentrant=False)
            else:
                x = layer(x, positions, rope, write_idx, ck, cv, mask, key_mask, flash)
        x = self.norm(x)
        if cache is None:
            return x, None
        return x, cache._replace(write_offset=cache.write_offset + n,
                                 true_len=cache.true_len + real.sum(-1).to(torch.int32),
                                 valid=valid_now)


class LlamaForCausalLM(nn.Module):
    """The trunk and the lm_head.  ``dtype`` is the parameters' dtype; the
    compute dtype (ctpa's ``dtype``) is set with ``set_compute_dtype``."""

    def __init__(self, cfg: LLMConfig, lora: Optional[LoRAConfig] = None, device="cuda",
                 dtype=torch.float32, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.model = LlamaModel(cfg, lora, device=device, dtype=dtype, remat=remat)
        if not cfg.tie_embeddings:
            self.lm_head = _proj(cfg, cfg.hidden_size, cfg.vocab_size,
                                 dict(device=device, dtype=dtype))
        self.tp = None           # (mesh, axis) of a column-parallel lm_head

    def apply_lm_head(self, hidden):
        if self.cfg.tie_embeddings:
            raise NotImplementedError("tied embeddings not needed for Meditron/llama-2")
        logits = self.lm_head(hidden)
        return logits if self.tp is None else gather_replicated(logits, *self.tp, dim=-1)

    def forward(self, input_ids=None, attention_mask=None, cache: Optional[KVCache] = None,
                positions=None, inputs_embeds=None, shared_kv_offset: bool = False):
        """-> (logits, hidden, new cache or None)."""
        hidden, new_cache = self.model(input_ids, attention_mask, cache, positions,
                                       inputs_embeds, shared_kv_offset)
        return self.apply_lm_head(hidden), hidden, new_cache
