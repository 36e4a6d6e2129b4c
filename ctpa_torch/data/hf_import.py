"""Weight import: HF/torch checkpoints -> flax-shaped numpy trees (an own
copy of ``ctpa/data/hf_import.py``; the port imports nothing of ``ctpa``).

The production models load `microsoft/BiomedVLP-CXR-BERT-specialized` (the
CLIP text tower), `epfl-llm/meditron-7b` (the report LLM) and the
`CT-CLIP_v2.pt` torch checkpoint.  These converters are pure dict-renames +
transposes (torch nn.Linear stores (out, in); flax Dense stores (in, out)),
so they run on host numpy — pass any mapping of name -> array (a torch
state_dict works directly).  The trees they return are ctpa's flax trees;
``ctpa_torch.convert`` carries them onto the port's modules
(``load_flax_params``, strict; ``overlay_flax_params``, torch's
``strict=False``).

Conventions of the target trees:
  * BertEncoder       (layer_i/attention_self/query/...)
  * LlamaForCausalLM  (model/layers_i/self_attn/q_proj/base/...)
    — attention projections nest under 'base' because they are LoRADense.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Mapping

import numpy as np

from ctpa_torch.core.config import BertConfig, LLMConfig
from ctpa_torch.core.logging import get_logger


Array = Any


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _lin(sd: Mapping[str, Array], name: str, bias: bool = True) -> dict:
    out = {"kernel": _np(sd[f"{name}.weight"]).T}
    if bias and f"{name}.bias" in sd:
        out["bias"] = _np(sd[f"{name}.bias"])
    return out


def _ln(sd: Mapping[str, Array], name: str) -> dict:
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


def import_bert(sd: Mapping[str, Array], cfg: BertConfig,
                prefix: str = "") -> dict:
    """HF BertModel state_dict -> ctpa BertEncoder params['params'].

    `prefix` handles nesting (e.g. 'bert.' for BertForMaskedLM dumps, or
    'text_transformer.' inside the CT-CLIP checkpoint)."""
    p = prefix
    params: dict[str, Any] = {
        "embeddings": {
            "word_embeddings": {"embedding": _np(sd[f"{p}embeddings.word_embeddings.weight"])},
            "position_embeddings": {"embedding": _np(sd[f"{p}embeddings.position_embeddings.weight"])},
            "token_type_embeddings": {"embedding": _np(sd[f"{p}embeddings.token_type_embeddings.weight"])},
            "LayerNorm": _ln(sd, f"{p}embeddings.LayerNorm"),
        }
    }
    for i in range(cfg.num_layers):
        lp = f"{p}encoder.layer.{i}."
        params[f"layer_{i}"] = {
            "attention_self": {
                "query": _lin(sd, lp + "attention.self.query"),
                "key": _lin(sd, lp + "attention.self.key"),
                "value": _lin(sd, lp + "attention.self.value"),
            },
            "attention_output_dense": _lin(sd, lp + "attention.output.dense"),
            "attention_output_LayerNorm": _ln(sd, lp + "attention.output.LayerNorm"),
            "intermediate_dense": _lin(sd, lp + "intermediate.dense"),
            "output_dense": _lin(sd, lp + "output.dense"),
            "output_LayerNorm": _ln(sd, lp + "output.LayerNorm"),
        }
    return params


def import_bert_mlm_head(sd: Mapping[str, Array], prefix: str = "cls.") -> dict:
    """HF BertForMaskedLM prediction head -> ctpa BertMLMHead params."""
    p = prefix
    head = {
        "transform_dense": _lin(sd, f"{p}predictions.transform.dense"),
        "transform_LayerNorm": _ln(sd, f"{p}predictions.transform.LayerNorm"),
        "decoder": {"kernel": _np(sd[f"{p}predictions.decoder.weight"]).T},
    }
    if f"{p}predictions.bias" in sd:
        head["decoder"]["bias"] = _np(sd[f"{p}predictions.bias"])
    elif f"{p}predictions.decoder.bias" in sd:
        head["decoder"]["bias"] = _np(sd[f"{p}predictions.decoder.bias"])
    return head


def import_llama(sd: Mapping[str, Array], cfg: LLMConfig,
                 prefix: str = "") -> dict:
    """HF LlamaForCausalLM state_dict -> ctpa LlamaForCausalLM params['params'].

    Attention projections land under .../q_proj/base/kernel (LoRADense); fresh
    LoRA A/B (if enabled) are NOT produced here — init the flax model first
    and graft these imports over the 'base' subtrees (see `overlay_base`)."""
    p = prefix
    model: dict[str, Any] = {
        "embed_tokens": {"embedding": _np(sd[f"{p}model.embed_tokens.weight"])},
        "norm": {"weight": _np(sd[f"{p}model.norm.weight"])},
    }
    for i in range(cfg.num_layers):
        lp = f"{p}model.layers.{i}."
        model[f"layers_{i}"] = {
            "self_attn": {
                "q_proj": {"base": _lin(sd, lp + "self_attn.q_proj", bias=False)},
                "k_proj": {"base": _lin(sd, lp + "self_attn.k_proj", bias=False)},
                "v_proj": {"base": _lin(sd, lp + "self_attn.v_proj", bias=False)},
                "o_proj": {"base": _lin(sd, lp + "self_attn.o_proj", bias=False)},
            },
            "mlp": {
                "gate_proj": _lin(sd, lp + "mlp.gate_proj", bias=False),
                "up_proj": _lin(sd, lp + "mlp.up_proj", bias=False),
                "down_proj": _lin(sd, lp + "mlp.down_proj", bias=False),
            },
            "input_layernorm": {"weight": _np(sd[lp + "input_layernorm.weight"])},
            "post_attention_layernorm": {"weight": _np(sd[lp + "post_attention_layernorm.weight"])},
        }
    out = {"model": model}
    if f"{p}lm_head.weight" in sd:
        out["lm_head"] = {"kernel": _np(sd[f"{p}lm_head.weight"]).T}
    return out


def overlay_base(init_params: dict, imported: dict, allow_missing: bool = False) -> dict:
    """Graft imported weights over an initialized tree, preserving leaves the
    import does not provide (fresh LoRA A/B, heads, cross-attention...).

    Imported leaves must exist in init_params with matching shapes.
    `allow_missing=True` gives torch `strict=False` semantics
    (ct_clip.py:593-597): unknown keys and shape mismatches are skipped."""

    skipped: list[str] = []

    def merge(dst, src, path=""):
        if not isinstance(src, dict):
            d = np.asarray(dst)
            s = np.asarray(src)
            if d.shape != s.shape:
                if allow_missing:
                    skipped.append(f"{path} (shape {s.shape} vs {d.shape})")
                    return dst
                raise ValueError(f"shape mismatch at {path}: {d.shape} vs {s.shape}")
            return s.astype(d.dtype)
        out = dict(dst)
        for k, v in src.items():
            if k not in out:
                if allow_missing:
                    skipped.append(path + "/" + k)
                    continue
                raise KeyError(f"imported key {path + '/' + k} not in model tree")
            out[k] = merge(out[k], v, path + "/" + k)
        return out

    merged = merge(init_params, imported)
    if skipped:
        get_logger().warning(
            "overlay_base skipped %d keys (strict=False): %s%s", len(skipped),
            ", ".join(skipped[:5]), "..." if len(skipped) > 5 else "")
    return merged


def _peg(sd: Mapping[str, Array], name: str) -> dict:
    # torch Conv3d depthwise weight (dim, 1, 3, 3, 3) -> ours (3, 3, 3, 1, dim)
    w = _np(sd[f"{name}.dsconv.weight"])
    out = {"kernel": np.transpose(w, (2, 3, 4, 1, 0))}
    out["bias"] = (_np(sd[f"{name}.dsconv.bias"])
                   if f"{name}.dsconv.bias" in sd
                   else np.zeros(w.shape[0], np.float32))
    return out


def _cosine_attn(sd: Mapping[str, Array], name: str) -> dict:
    out = {
        "norm": {"gamma": _np(sd[f"{name}.norm.gamma"])},
        "to_q": {"kernel": _np(sd[f"{name}.to_q.weight"]).T},
        "to_kv": {"kernel": _np(sd[f"{name}.to_kv.weight"]).T},
        "to_out": {"kernel": _np(sd[f"{name}.to_out.weight"]).T},
        "q_scale": _np(sd[f"{name}.q_scale"]),
        "k_scale": _np(sd[f"{name}.k_scale"]),
    }
    nkv = _np(sd.get(f"{name}.null_kv", np.zeros((0,))))
    if nkv.size:  # (heads, 2*num_null, dim_head) -> (2, heads, num_null, d)
        h, two_n, d = nkv.shape
        out["null_kv"] = np.transpose(
            nkv.reshape(h, two_n // 2, 2, d), (2, 0, 1, 3))
    return out


def _geglu_ff(sd: Mapping[str, Array], name: str) -> dict:
    return {
        "norm": _ln(sd, f"{name}.0"),
        "proj_in": {"kernel": _np(sd[f"{name}.1.weight"]).T},
        "proj_out": {"kernel": _np(sd[f"{name}.4.weight"]).T},
    }


def _ctvit_transformer(sd: Mapping[str, Array], name: str, depth: int,
                       peg: bool = True) -> dict:
    out: dict[str, Any] = {"norm_out": {"gamma": _np(sd[f"{name}.norm_out.gamma"])}}
    for i in range(depth):
        lp = f"{name}.layers.{i}"
        if peg:
            out[f"peg_{i}"] = _peg(sd, f"{lp}.0")
        out[f"block_{i}"] = {
            "attn": _cosine_attn(sd, f"{lp}.1"),
            "ff": _geglu_ff(sd, f"{lp}.3"),
        }
    return out


def _patch_embed(sd: Mapping[str, Array], prefix: str) -> dict:
    """Reference `to_patch_emb` Sequential (ctvit.py:169-174: Rearrange, LN,
    Linear, LN) -> ctpa PatchEmbed3D flat params."""
    p = prefix
    return {
        # conv-path PatchEmbed3D keeps the same math with flat params
        "norm_in_scale": _np(sd[f"{p}to_patch_emb.1.weight"]),
        "norm_in_bias": _np(sd[f"{p}to_patch_emb.1.bias"]),
        "proj_kernel": _np(sd[f"{p}to_patch_emb.2.weight"]).T,
        "proj_bias": _np(sd[f"{p}to_patch_emb.2.bias"]),
        "norm_out": _ln(sd, f"{p}to_patch_emb.3"),
    }


def import_ctvit(sd: Mapping[str, Array], spatial_depth: int, temporal_depth: int,
                 prefix: str = "", cpb_layers: int = 2) -> dict:
    """Reference CTViT state_dict (ctvit.py:117-224 module tree, lucidrains
    layout) -> ctpa CTViT params.  Covers the encoder path the CLIP stack
    uses; decoder `to_pixels` is mapped when present."""
    p = prefix
    params: dict[str, Any] = {
        "patch_embed": _patch_embed(sd, p),
        "spatial_rel_pos_bias": {},
    }
    cpb: dict[str, Any] = {}
    for i in range(cpb_layers):
        cpb[f"mlp_{i}"] = _lin(sd, f"{p}spatial_rel_pos_bias.net.{i}.0")
    cpb["to_heads"] = _lin(sd, f"{p}spatial_rel_pos_bias.net.{cpb_layers}")
    params["spatial_rel_pos_bias"] = cpb
    params["enc_spatial_transformer"] = _ctvit_transformer(
        sd, f"{p}enc_spatial_transformer", spatial_depth)
    params["enc_temporal_transformer"] = _ctvit_transformer(
        sd, f"{p}enc_temporal_transformer", temporal_depth)
    if f"{p}to_pixels.0.weight" in sd:
        params["to_pixels"] = _lin(sd, f"{p}to_pixels.0")
    return params


def import_ctclip(sd: Mapping[str, Array], bert_cfg: BertConfig,
                  spatial_depth: int = 4, temporal_depth: int = 4) -> tuple[dict, dict]:
    """Reference CT-CLIP_v2.pt checkpoint -> (ctpa CTCLIP params, extras).

    Maps: learnable temperature (ct_clip.py:568), CXR-BERT text tower
    (text_transformer.*), CTViT encoder (visual_transformer.*), latent
    projections (to_text_latent/to_visual_latent, ct_clip.py:549/564).
    `extras` carries the VQ codebook (visual_transformer.vq.*) for VQState.
    """
    params: dict[str, Any] = {
        "temperature": _np(sd["temperature"]),
        "text_transformer": import_bert(sd, bert_cfg, prefix="text_transformer."),
        "visual_transformer": import_ctvit(
            sd, spatial_depth, temporal_depth, prefix="visual_transformer."),
        "to_text_latent": {"kernel": _np(sd["to_text_latent.weight"]).T},
        "to_visual_latent": {"kernel": _np(sd["to_visual_latent.weight"]).T},
    }
    if "to_text_latent_extra.weight" in sd:
        params["to_text_latent_extra"] = {"kernel": _np(sd["to_text_latent_extra.weight"]).T}
        params["to_visual_latent_extra"] = {"kernel": _np(sd["to_visual_latent_extra.weight"]).T}
    extras = {}
    for key in ("visual_transformer.vq._codebook.embed",
                "visual_transformer.vq.codebook"):
        if key in sd:
            cb = _np(sd[key])
            extras["vq_codebook"] = cb[0] if cb.ndim == 3 else cb
            break
    for key in ("visual_transformer.vq._codebook.cluster_size",):
        if key in sd:
            cs = _np(sd[key])
            extras["vq_cluster_size"] = cs[0] if cs.ndim == 2 else cs
    return params, extras


def import_cross_attention(sd: Mapping[str, Array], prefix: str = "") -> dict:
    """Reference CrossAttentionLayer (model_components.py:82-138) -> ctpa
    CrossAttentionLayer params.

    The reference projects TWICE: its own query/key/value Linears feed a torch
    nn.MultiheadAttention which applies its in_proj again.  Two consecutive
    affine maps fuse exactly into one — W = W_mha @ W_pre,
    b = W_mha @ b_pre + b_mha — so ctpa's single q/k/v Denses reproduce the
    reference numerics with no extra parameters."""
    p = prefix
    d = _np(sd[f"{p}query.weight"]).shape[0]
    in_w = _np(sd[f"{p}multihead.in_proj_weight"])      # (3d, d)
    in_b = _np(sd[f"{p}multihead.in_proj_bias"])        # (3d,)
    mha = {
        "q": (in_w[:d], in_b[:d]),
        "k": (in_w[d:2 * d], in_b[d:2 * d]),
        "v": (in_w[2 * d:], in_b[2 * d:]),
    }

    def fused(name: str) -> dict:
        w_pre = _np(sd[f"{p}{name if name != 'q' else 'query'}.weight"])
        b_pre = _np(sd[f"{p}{name if name != 'q' else 'query'}.bias"])
        w_mha, b_mha = mha[name]
        return {"kernel": (w_mha @ w_pre).T, "bias": w_mha @ b_pre + b_mha}

    return {
        "q": fused("q"),
        "k": {"kernel": (mha["k"][0] @ _np(sd[f"{p}key.weight"])).T,
              "bias": mha["k"][0] @ _np(sd[f"{p}key.bias"]) + mha["k"][1]},
        "v": {"kernel": (mha["v"][0] @ _np(sd[f"{p}value.weight"])).T,
              "bias": mha["v"][0] @ _np(sd[f"{p}value.bias"]) + mha["v"][1]},
        "out": _lin(sd, f"{p}multihead.out_proj"),
        "norm": _ln(sd, f"{p}norm"),
    }


def import_report_generator(sd: Mapping[str, Array], llm_cfg: LLMConfig) -> dict:
    """Reference CTReportGenerator state_dict (model_components.py:140-191:
    llm + RobustVisionFeatureExtractor + CrossAttentionLayer) -> ctpa
    CTReportGenerator params.

    Handles both a plain HF LLM ('llm.model.layers...') and a peft-wrapped
    dump ('llm.base_model.model.model.layers...', peft>=0.6 'base_layer'
    naming collapsed onto the base weights).  The vision trunk maps the
    patch-embed stage only — the reference extractor uses nothing deeper
    (model_components.py:49-71)."""
    sd = dict(sd)
    if any(k.startswith("llm.base_model.model.") for k in sd):
        remap = {}
        for k, v in sd.items():
            k2 = k.replace("llm.base_model.model.", "llm.", 1)
            k2 = k2.replace(".base_layer.weight", ".weight")
            remap[k2] = v
        sd = remap

    vfe_prefix = next(
        (f"vision_feature_extractor.{name}."
         for name in ("vision_encoder", "ctclip.visual_transformer")
         if f"vision_feature_extractor.{name}.to_patch_emb.1.weight" in sd),
        None)
    if vfe_prefix is None:
        raise KeyError("no vision_feature_extractor patch-embed weights in checkpoint")

    return {
        "llm": import_llama(sd, llm_cfg, prefix="llm."),
        "vision_feature_extractor": {
            "ctvit": {"patch_embed": _patch_embed(sd, vfe_prefix)},
            "proj": _lin(sd, "vision_feature_extractor.projection.0"),
            "norm": _ln(sd, "vision_feature_extractor.projection.1"),
        },
        "cross_attention": import_cross_attention(sd, prefix="cross_attention."),
    }


# safetensors dtype codes -> numpy (little-endian), the set
# ``safetensors.numpy`` maps, plus BF16, which it reads wherever ml_dtypes has
# registered a bfloat16 with numpy (a JAX process, as ctpa's): here BF16 is
# widened exactly to fp32, the value ctpa casts it to.  The F8 codes (F8_E4M3,
# F8_E5M2) stay refused: ctpa's reader has no numpy dtype for them either.
_ST_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "U64": "<u8",
    "I32": "<i4", "U32": "<u4", "I16": "<i2", "U16": "<u2", "I8": "i1", "U8": "u1",
    "BOOL": "?", "C64": "<c8", "BF16": "<u2",
}


def load_safetensors(path: str) -> dict:
    """One ``*.safetensors`` file -> name -> numpy array, without the
    ``safetensors`` package: an 8-byte little-endian header length, the JSON
    header ({name: {dtype, shape, data_offsets}}, offsets relative to the
    end of the header), then each tensor's bytes.  A BF16 tensor comes back
    as fp32 (its 16 bits become the high half of an fp32, which is exact),
    so it takes twice its size in memory."""
    out: dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        (n,) = np.frombuffer(f.read(8), "<u8")
        header = json.loads(f.read(int(n)))
        base = 8 + int(n)
        for name, info in header.items():
            if name == "__metadata__":
                continue
            code = info["dtype"]
            if code not in _ST_DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {code}, which numpy "
                                 f"cannot hold")
            dtype = np.dtype(_ST_DTYPES[code])
            begin, end = info["data_offsets"]
            count = int(np.prod(info["shape"], dtype=np.int64))
            if end - begin != count * dtype.itemsize:
                raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, "
                                 f"not {count} x {dtype.itemsize}")
            f.seek(base + begin)
            value = np.fromfile(f, dtype, count)
            if code == "BF16":
                value = (value.astype("<u4") << 16).view("<f4")
            out[name] = value.reshape(info["shape"])
    return out


def load_hf_snapshot(directory: str) -> dict:
    """Load all weights from a local HF snapshot dir (safetensors shards or
    pytorch_model*.bin) into one name->numpy dict."""
    sd: dict[str, np.ndarray] = {}
    st_files = sorted(glob.glob(os.path.join(directory, "*.safetensors")))
    if st_files:
        for f in st_files:
            sd.update(load_safetensors(f))
        return sd
    bin_files = sorted(glob.glob(os.path.join(directory, "pytorch_model*.bin")))
    if not bin_files:
        raise FileNotFoundError(f"no weight files in {directory}")
    import torch

    for f in bin_files:
        part = torch.load(f, map_location="cpu", weights_only=True)
        sd.update({k: _np(v) for k, v in part.items()})
    return sd


def load_torch_checkpoint(path: str) -> dict:
    """Read a torch .pt/.pth checkpoint into a flat name->numpy dict without
    keeping torch tensors alive (host-side; used by the CT-CLIP_v2.pt and
    fine-tune checkpoint importers)."""
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and all(
        hasattr(v, "detach") for v in obj["model"].values()
    ):
        obj = obj["model"]
    return {k: _np(v) for k, v in obj.items() if hasattr(v, "detach") or isinstance(v, np.ndarray)}


# torchvision vgg16().features conv indices per stage (the Sequential layout
# conv,relu,conv,relu,pool | conv,relu,conv,relu,pool | 3x(conv,relu),pool ...)
VGG16_FEATURE_CONV_INDICES: tuple[tuple[int, ...], ...] = (
    (0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28),
)


def import_vgg_features(sd: Mapping[str, Array], n_stages: int = 5) -> dict:
    """torchvision `vgg16(pretrained=True).features` state_dict -> PerceptualNet
    params (reference ctvit.py:202 uses that module for the perceptual loss).

    Accepts either bare `features` keys ('0.weight', '2.weight', ...) or a
    full-model dump with a 'features.' prefix.  Conv weights transpose from
    torch (out, in, kh, kw) to flax (kh, kw, in, out).  `n_stages` truncates
    the pyramid (e.g. 3 for a 64/128/256 net).  Pair with
    `PerceptualNet.vgg16()` (or matching stages/convs_per_stage) and graft via
    `overlay_base` or use directly as {'params': ...}."""
    prefix = "features." if any(k.startswith("features.") for k in sd) else ""
    params: dict[str, dict] = {}
    for i, conv_idxs in enumerate(VGG16_FEATURE_CONV_INDICES[:n_stages]):
        for j, t in enumerate(conv_idxs):
            w = _np(sd[f"{prefix}{t}.weight"]).transpose(2, 3, 1, 0)
            b = _np(sd[f"{prefix}{t}.bias"])
            params[f"conv_{i}{'abcdef'[j]}"] = {"kernel": w, "bias": b}
    return {"params": params}
