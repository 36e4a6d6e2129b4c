"""Carry ``ctpa``'s flax parameters into the port's modules.

The flax tree (nested dicts of arrays, the ``"params"`` collection of any
ctpa module) becomes the ``state_dict`` of the matching ``ctpa_torch``
module.  The layout rules:

* a 2-D ``kernel`` is a flax ``Dense`` weight, stored (in, out); a torch
  ``Linear`` stores (out, in), so it is transposed into ``weight``;
* a 4-D ``kernel`` is a flax 2-D ``Conv`` weight, stored (kh, kw, in, out);
  ``F.conv2d`` takes (out, in, kh, kw), so it is permuted into ``weight``
  (the discriminator's and the perceptual net's convolutions; the PEG's
  5-D depthwise kernel is not a ``Conv`` and keeps its layout, below);
* ``embedding`` becomes ``weight``; a flax ``LayerNorm`` ``scale`` becomes
  ``weight``;
* a quantized projection (``quantize_tree``'s leaves) keeps ctpa's names
  and layout: ``kernel_q`` (in, out) int8 or (in/2, out) packed int4,
  ``scale_g`` (in/group, out), and a ``scale`` beside a ``kernel_q`` (the
  int8 per-column scale) stays ``scale``;
* every other leaf keeps its name and layout: ``gamma``, ``q_scale``,
  ``k_scale``, the PEG's (3, 3, 3, 1, c) ``kernel``, ``PatchEmbed3D``'s
  ``norm_in_scale``/``norm_in_bias``/``proj_kernel``/``proj_bias``, the fused
  ``to_kv`` (split at use), ``temperature``;
* numbered flax submodules ``peg_i``, ``block_i``, ``layer_i`` (BERT),
  ``layers_i`` (the LLM), ``mlp_i`` become the entries of the ModuleLists
  ``pegs``, ``blocks``, ``layers``, ``layers``, ``mlp``;
* the LLM's RMSNorm ``weight`` and LoRA's (in, r) ``lora_a`` and (r, out)
  ``lora_b`` keep their names and layout, so a report generator's tree
  with trained adapters, its ``cross_attention`` and the vision
  ``proj``/``norm`` converts whole (``tests/test_torch_report_train.py``);
  so do BERT's adapters, which ctpa keeps beside the projections
  (``attention_self/query_lora_a`` and ``_b``, the same for ``key`` and
  ``value``) and the port as parameters of ``BertSelfAttention``
  (``layers.i.attention_self.query_lora_a``).

The discriminator and the perceptual net keep flax's automatic names
(``Conv_i``, ``DiscriminatorBlock_i``, ``Dense_i``) and ctpa's
``conv_{i}{a,b,c}``; the decoder's ``dec_spatial_transformer``,
``dec_temporal_transformer`` and ``to_pixels`` carry over as the encoder's
stacks do.

The CLIP model's optional heads carry ctpa's names as they are
(``to_text_latent_extra``, ``to_visual_latent_extra``, the (4, 4, c)
``downsample_depthwise``, ``downsample_pointwise``, ``mlm_head``), and so does
the fused encoder (``visual_transformer.enc_fused_transformer``).  flax's
automatic names (``Dense_0``, ``BatchNorm_0``, the SSL projector's) are kept
too; ``load_flax_variables`` merges a ``batch_stats`` collection (a flax
BatchNorm's ``mean`` and ``var``) into the params before loading, onto the
port's buffers of those names.

``load_flax_params`` is strict: an unused flax leaf, a missing torch entry
or a shape mismatch raises.  ``overlay_flax_params`` grafts a partial tree
(an imported checkpoint) the way ctpa's ``overlay_base`` grafts it onto an
initialized flax tree, leaving the entries it does not name as they are.
Integer leaves are copied as they are; float leaves go
through fp32 to the parameter's dtype.  It imports no JAX: leaves are
anything ``numpy.asarray`` takes.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from ctpa_torch.core.logging import get_logger
from ctpa_torch.ops.vq import VQState

_LISTS = re.compile(r"^(peg|block|layers?|mlp)_(\d+)$")
_LIST_NAMES = {"peg": "pegs", "block": "blocks", "layer": "layers", "layers": "layers",
               "mlp": "mlp"}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _module_parts(mods) -> list[str]:
    """A flax module path as the torch module path's parts."""
    parts = []
    for mod in mods:
        m = _LISTS.match(mod)
        parts += [_LIST_NAMES[m.group(1)], m.group(2)] if m else [mod]
    return parts


def _torch_key(path: tuple[str, ...], value: np.ndarray,
               quantized: bool) -> tuple[str, np.ndarray]:
    """``quantized``: the leaf sits beside a ``kernel_q``."""
    *mods, leaf = path
    parts = _module_parts(mods)
    if leaf == "kernel" and value.ndim == 2:
        leaf, value = "weight", value.T
    elif leaf == "kernel" and value.ndim == 4:
        leaf, value = "weight", value.transpose(3, 2, 0, 1)
    elif leaf == "embedding" or (leaf == "scale" and not quantized):
        leaf = "weight"
    return ".".join(parts + [leaf]), value


def flax_to_state_dict(params: dict) -> dict[str, np.ndarray]:
    """Rename and re-lay-out a flax param tree; values stay numpy."""
    out = {}
    leaves = list(_flatten(params))
    quantized = {path[:-1] for path, _ in leaves if path[-1] == "kernel_q"}
    for path, value in leaves:
        key, value = _torch_key(path, value, path[:-1] in quantized)
        if key in out:
            raise KeyError(f"two flax leaves map to {key}")
        out[key] = value
    return out


def _as_param(key: str, value: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    """``value`` as a tensor of ``ref``'s dtype and device: integers exactly,
    floats through fp32."""
    if np.issubdtype(value.dtype, np.integer):
        exact = torch.from_numpy(np.array(value))
        if exact.dtype != ref.dtype:
            raise TypeError(f"{key}: flax {value.dtype} into torch {ref.dtype}")
        return exact.to(device=ref.device)
    return torch.from_numpy(np.array(value, np.float32)).to(device=ref.device, dtype=ref.dtype)


def load_flax_params(module: nn.Module, params: dict) -> nn.Module:
    """Load a flax param tree into ``module`` (strict), casting each value to
    the dtype and device of the parameter it replaces."""
    converted = flax_to_state_dict(params)
    own = module.state_dict()
    unused = sorted(set(converted) - set(own))
    missing = sorted(set(own) - set(converted))
    if unused or missing:
        raise KeyError(f"flax/torch parameter mismatch: unused {unused}, missing {missing}")
    state = {}
    for key, ref in own.items():
        value = converted[key]
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax shape {value.shape} != torch shape {tuple(ref.shape)}")
        state[key] = _as_param(key, value, ref)
    module.load_state_dict(state, strict=True)
    return module


def _merge(a: dict, b: dict) -> dict:
    out = dict(a)
    for key, val in b.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], val)
        elif key in out:
            raise KeyError(f"{key} is in both collections")
        else:
            out[key] = val
    return out


def load_flax_variables(module: nn.Module, variables: dict) -> nn.Module:
    """``load_flax_params`` of a flax variables dict: its ``params`` and, where
    there is one, its ``batch_stats`` merged into one tree."""
    return load_flax_params(module, _merge(variables["params"],
                                           variables.get("batch_stats", {})))


def overlay_flax_params(module: nn.Module, params: dict, allow_missing: bool = False) -> list[str]:
    """Graft a flax-shaped tree (an import, possibly partial) onto ``module``
    in place, with ctpa's ``overlay_base`` semantics: the module's entries the
    tree does not name keep their values; with ``allow_missing`` (torch's
    ``strict=False``) a subtree or leaf the module does not have, or a leaf
    of another shape, is skipped, else it raises.  Returns the skipped
    entries as ``overlay_base`` names them ("/a/b", "/a/b/c (shape s vs d)",
    flax layouts), and logs them as it does.  Each leaf of ``params`` is set
    to None once it is copied onto the module's device: every caller passes
    a tree it does not read again."""
    own = module.state_dict()
    prefixes = {".".join(key.split(".")[:i]) for key in own for i in range(1, key.count(".") + 1)}
    skipped: list[str] = []
    state = {}

    def skip(entry: str, error: Exception) -> None:
        if not allow_missing:
            raise error
        skipped.append(entry)

    def walk(tree: dict, path: tuple) -> None:
        quantized = "kernel_q" in tree
        for name, val in tree.items():
            sub = path + (name,)
            flat = "/" + "/".join(sub)
            if isinstance(val, dict):
                if ".".join(_module_parts(sub)) not in prefixes:
                    skip(flat, KeyError(f"imported key {flat} not in model tree"))
                else:
                    walk(val, sub)
                continue
            value = np.asarray(val)
            key, tval = _torch_key(sub, value, quantized)
            if key not in own:
                skip(flat, KeyError(f"imported key {flat} not in model tree"))
                continue
            ref = own[key]
            if tuple(tval.shape) != tuple(ref.shape):
                d = tuple(ref.shape)
                if name == "kernel" and value.ndim == 2:
                    d = d[::-1]
                elif name == "kernel" and value.ndim == 4:
                    d = (d[2], d[3], d[1], d[0])
                skip(f"{flat} (shape {value.shape} vs {d})",
                     ValueError(f"shape mismatch at {flat}: {d} vs {value.shape}"))
                continue
            state[key] = _as_param(key, tval, ref)
            del value, tval
            tree[name] = None

    walk(params, ())
    module.load_state_dict(state, strict=False)
    if skipped:
        get_logger().warning(
            "overlay_base skipped %d keys (strict=False): %s%s", len(skipped),
            ", ".join(skipped[:5]), "..." if len(skipped) > 5 else "")
    return skipped


def vq_state_from_numpy(state, device="cuda") -> VQState:
    """ctpa's VQState (codebook, cluster_size, embed_avg), any array type."""
    return VQState(*(torch.as_tensor(np.asarray(x, np.float32), device=device) for x in state))
