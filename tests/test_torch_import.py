"""Weight import into the port against ctpa's on the CPU: the HF/torch
converters (``ctpa_torch.data.hf_import``), ``overlay_flax_params`` against
ctpa's ``overlay_base``, ``models.pretrained.build_ctclip`` on a
reference-layout ``CT-CLIP_v2.pt``, the safetensors reader and
``HFTokenizer``.  Every state dict, checkpoint and snapshot is written by
the test from a seed; nothing is downloaded.

Tolerances: imported tensors are copies (fp32 in, fp32 out), so they are
held bit for bit; the latents of the imported tiny CT-CLIP run ctpa's flax
and the port's torch in fp32, which differ in the order of sums: 1e-5.
"""

import dataclasses
import json
import re
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ctpa.core import config as jc
from ctpa.data import hf_import as jhf
from ctpa.data import tokenizer as jtok
from ctpa.models import pretrained as jpre
from ctpa.models.ctclip import CTCLIP as JCLIP
from ctpa_torch.convert import flax_to_state_dict, load_flax_params, overlay_flax_params
from ctpa_torch.core import config as tc
from ctpa_torch.data import hf_import as thf
from ctpa_torch.data import tokenizer as ttok
from ctpa_torch.models import attention as tatt
from ctpa_torch.models import pretrained as tpre
from ctpa_torch.models.ctclip import CTCLIP
from ctpa_torch.models.report_generator import CTReportGenerator

torch.set_num_threads(1)
ATOL = 1e-5
VIT, BERT = tc.CTViTConfig.tiny(), tc.BertConfig.tiny()
CLIP = tc.CTCLIPConfig.tiny(VIT, BERT)


def jcfg(cfg, **over):
    """The ctpa config with the same field values as a port config."""
    jtype = {tc.CTViTConfig: jc.CTViTConfig, tc.BertConfig: jc.BertConfig,
             tc.CTCLIPConfig: jc.CTCLIPConfig, tc.LLMConfig: jc.LLMConfig}[type(cfg)]
    return jtype(**{**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}, **over})


def reference_sd(seed, std=0.2, vit=VIT):
    """chip_smoke's reference-layout CT-CLIP state dict, as numpy, at the
    tiny widths (std 0.2, so the PEG layout moves the latents)."""
    gen = torch.Generator().manual_seed(seed)
    sd = chip_smoke.reference_ctclip_state(vit, BERT, CLIP, gen, "cpu", std=std)
    return {k: v.numpy() for k, v in sd.items()}


def leaves_equal(a, b):
    """Two nested trees of arrays: the same paths, bit-equal values."""
    fa, fb = flax_to_state_dict(a), flax_to_state_dict(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k


class _Recorder:
    """Stands in for ctpa's logger: keeps overlay_base's warning arguments."""

    def __init__(self):
        self.calls = []

    def warning(self, msg, *args):
        self.calls.append(args)


def ctpa_skipped(recorder):
    """overlay_base's skipped entries from its one warning (it names up to
    five, all of them in these tests)."""
    if not recorder.calls:
        return []
    (count, names, more), = recorder.calls
    assert more == "" and count <= 5
    return re.split(r", (?=/)", names)


# ----------------------------------------------------------- the importers

def _bert_sd(rng, cfg, prefix=""):
    sd, h = {}, cfg.hidden_size

    def t(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd[prefix + "embeddings.word_embeddings.weight"] = t(cfg.vocab_size, h)
    sd[prefix + "embeddings.position_embeddings.weight"] = t(cfg.max_position_embeddings, h)
    sd[prefix + "embeddings.token_type_embeddings.weight"] = t(cfg.type_vocab_size, h)
    for name in ("embeddings.LayerNorm.weight", "embeddings.LayerNorm.bias"):
        sd[prefix + name] = t(h)
    for i in range(cfg.num_layers):
        lp = prefix + f"encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value",
                     "attention.output.dense"):
            sd[lp + name + ".weight"], sd[lp + name + ".bias"] = t(h, h), t(h)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[lp + name + ".weight"], sd[lp + name + ".bias"] = t(h), t(h)
        sd[lp + "intermediate.dense.weight"] = t(cfg.intermediate_size, h)
        sd[lp + "intermediate.dense.bias"] = t(cfg.intermediate_size)
        sd[lp + "output.dense.weight"] = t(h, cfg.intermediate_size)
        sd[lp + "output.dense.bias"] = t(h)
    return sd


def _llama_sd(rng, cfg, prefix=""):
    sd, h, hd = {}, cfg.hidden_size, cfg.head_dim

    def t(*shape):
        return rng.normal(size=shape).astype(np.float32)

    sd[prefix + "model.embed_tokens.weight"] = t(cfg.vocab_size, h)
    sd[prefix + "model.norm.weight"] = t(h)
    sd[prefix + "lm_head.weight"] = t(cfg.vocab_size, h)
    for i in range(cfg.num_layers):
        lp = prefix + f"model.layers.{i}."
        sd[lp + "self_attn.q_proj.weight"] = t(cfg.num_heads * hd, h)
        sd[lp + "self_attn.k_proj.weight"] = t(cfg.num_kv_heads * hd, h)
        sd[lp + "self_attn.v_proj.weight"] = t(cfg.num_kv_heads * hd, h)
        sd[lp + "self_attn.o_proj.weight"] = t(h, cfg.num_heads * hd)
        sd[lp + "mlp.gate_proj.weight"] = t(cfg.intermediate_size, h)
        sd[lp + "mlp.up_proj.weight"] = t(cfg.intermediate_size, h)
        sd[lp + "mlp.down_proj.weight"] = t(h, cfg.intermediate_size)
        sd[lp + "input_layernorm.weight"] = t(h)
        sd[lp + "post_attention_layernorm.weight"] = t(h)
    return sd


def _report_sd(rng, llm, vit, vision_dim, peft):
    """A reference CTReportGenerator dump: the LLM (plain or peft-wrapped),
    the vision extractor's patch embed and projection, the cross-attention."""
    t = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    sd = _llama_sd(rng, llm, prefix="llm.")
    if peft:
        sd = {k.replace("llm.", "llm.base_model.model.", 1).replace(
            "q_proj.weight", "q_proj.base_layer.weight"): v for k, v in sd.items()}
    v = "vision_feature_extractor.vision_encoder."
    pd, d, h = vit.patch_dim, vit.dim, llm.hidden_size
    sd[v + "to_patch_emb.1.weight"], sd[v + "to_patch_emb.1.bias"] = t(pd), t(pd)
    sd[v + "to_patch_emb.2.weight"], sd[v + "to_patch_emb.2.bias"] = t(d, pd), t(d)
    sd[v + "to_patch_emb.3.weight"], sd[v + "to_patch_emb.3.bias"] = t(d), t(d)
    sd["vision_feature_extractor.projection.0.weight"] = t(vision_dim, d)
    sd["vision_feature_extractor.projection.0.bias"] = t(vision_dim)
    sd["vision_feature_extractor.projection.1.weight"] = t(vision_dim)
    sd["vision_feature_extractor.projection.1.bias"] = t(vision_dim)
    c = "cross_attention."
    for name, width in (("query", h), ("key", vision_dim), ("value", vision_dim)):
        sd[c + name + ".weight"], sd[c + name + ".bias"] = t(h, width), t(h)
    sd[c + "multihead.in_proj_weight"], sd[c + "multihead.in_proj_bias"] = t(3 * h, h), t(3 * h)
    sd[c + "multihead.out_proj.weight"], sd[c + "multihead.out_proj.bias"] = t(h, h), t(h)
    sd[c + "norm.weight"], sd[c + "norm.bias"] = t(h), t(h)
    return sd


def _vgg_sd(rng):
    sd, c_in = {}, 3
    for stage, convs in enumerate(thf.VGG16_FEATURE_CONV_INDICES):
        c_out = 8 * 2 ** min(stage, 3)
        for t in convs:
            sd[f"features.{t}.weight"] = rng.normal(size=(c_out, c_in, 3, 3)).astype(np.float32)
            sd[f"features.{t}.bias"] = rng.normal(size=c_out).astype(np.float32)
            c_in = c_out
    return sd


def _importer_case(name, m):
    """(importer name, its arguments) for one importer; ``m`` is the config
    module (ctpa's or the port's), the state dict the same from its seed."""
    rng = np.random.default_rng(40)
    llm = m.LLMConfig.tiny()
    if name == "bert":
        return "import_bert", (_bert_sd(rng, BERT, prefix="bert."), m.BertConfig.tiny(), "bert.")
    if name == "bert_mlm_head":
        h, v = BERT.hidden_size, BERT.vocab_size
        t = "cls.predictions.transform."
        return "import_bert_mlm_head", ({
            t + "dense.weight": rng.normal(size=(h, h)), t + "dense.bias": rng.normal(size=h),
            t + "LayerNorm.weight": rng.normal(size=h), t + "LayerNorm.bias": rng.normal(size=h),
            "cls.predictions.decoder.weight": rng.normal(size=(v, h)),
            "cls.predictions.bias": rng.normal(size=v)},)
    if name == "llama":
        return "import_llama", (_llama_sd(rng, llm), llm)
    if name == "ctvit":
        sd = reference_sd(41)
        sd["visual_transformer.to_pixels.0.weight"] = rng.normal(size=(VIT.patch_dim, VIT.dim))
        sd["visual_transformer.to_pixels.0.bias"] = rng.normal(size=VIT.patch_dim)
        return "import_ctvit", (sd, VIT.spatial_depth, VIT.temporal_depth, "visual_transformer.")
    if name == "ctclip":
        sd = reference_sd(42)
        sd["visual_transformer.enc_spatial_transformer.layers.0.1.null_kv"] = rng.normal(
            size=(VIT.heads, 4, VIT.dim_head))
        sd["to_text_latent_extra.weight"] = rng.normal(size=(CLIP.dim_latent, BERT.hidden_size))
        sd["to_visual_latent_extra.weight"] = rng.normal(size=(CLIP.dim_latent, CLIP.dim_image))
        sd["visual_transformer.vq._codebook.cluster_size"] = rng.normal(
            size=(1, VIT.codebook_size))
        return "import_ctclip", (sd, m.BertConfig.tiny(), VIT.spatial_depth, VIT.temporal_depth)
    if name == "cross_attention":
        return "import_cross_attention", (_report_sd(rng, llm, VIT, 48, peft=False),
                                          "cross_attention.")
    if name.startswith("report_generator"):
        return "import_report_generator", (
            _report_sd(rng, llm, VIT, 48, peft=name.endswith("peft")), llm)
    return "import_vgg_features", (_vgg_sd(rng), 4)


@pytest.mark.parametrize("name", ["bert", "bert_mlm_head", "llama", "ctvit", "ctclip",
                                  "cross_attention", "report_generator", "report_generator_peft",
                                  "vgg_features"])
def test_importers_give_ctpa_trees(name):
    """Each converter of the copy gives ctpa's tree, bit for bit."""
    fn, args = _importer_case(name, jc)
    ref = getattr(jhf, fn)(*args)
    fn, args = _importer_case(name, tc)
    got = getattr(thf, fn)(*args)
    if isinstance(ref, tuple):      # import_ctclip: (params, extras)
        leaves_equal(got[0], ref[0])
        assert sorted(got[1]) == sorted(ref[1])
        for k in ref[1]:
            assert np.array_equal(got[1][k], ref[1][k]), k
    else:
        leaves_equal(got, ref)


@pytest.mark.parametrize("peft", [False, True])
def test_report_generator_import_loads_strictly(peft):
    """A reference CTReportGenerator dump (a plain or a peft-wrapped LLM)
    imports into a tree that the port's generator loads with no key left
    over or missing, and whose values are the dump's."""
    llm, rg = tc.LLMConfig.tiny(), tc.ReportGenConfig(vision_dim=48)
    sd = _report_sd(np.random.default_rng(43), llm, VIT, rg.vision_dim, peft)
    model = CTReportGenerator(llm, VIT, rg, device="cpu")
    load_flax_params(model, thf.import_report_generator(sd, llm))
    state = model.state_dict()
    prefix = "llm.base_model.model." if peft else "llm."
    np.testing.assert_array_equal(state["llm.lm_head.weight"].numpy(),
                                  sd[prefix + "lm_head.weight"])
    q = "model.layers.1.self_attn.q_proj"
    np.testing.assert_array_equal(
        state[f"llm.{q}.base.weight"].numpy(),
        sd[prefix + q + (".base_layer.weight" if peft else ".weight")])


def test_overlay_matches_overlay_base():
    """overlay_flax_params skips what overlay_base skips (a subtree and a
    leaf the model lacks, a leaf of another shape), names them as it does,
    and leaves every other entry as overlay_base leaves its tree."""
    rng = np.random.default_rng(44)
    module = tatt.ContinuousPositionBias(16, 4)
    init = {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
    init_tree = {"mlp_0": {"kernel": init["mlp.0.weight"].T, "bias": init["mlp.0.bias"]},
                 "mlp_1": {"kernel": init["mlp.1.weight"].T, "bias": init["mlp.1.bias"]},
                 "to_heads": {"kernel": init["to_heads.weight"].T,
                              "bias": init["to_heads.bias"]}}
    imported = {"mlp_0": {"kernel": rng.normal(size=(2, 16)).astype(np.float32)},
                "mlp_1": {"kernel": rng.normal(size=(16, 15)).astype(np.float32),
                          "bias": rng.normal(size=16).astype(np.float32),
                          "stray": np.zeros(3, np.float32)},
                "to_heads": {"bias": rng.normal(size=4).astype(np.float32)},
                "decoder": {"kernel": np.zeros((2, 2), np.float32)}}
    recorder = _Recorder()
    import ctpa.core.logging as jlog

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlog, "get_logger", lambda: recorder)
        merged = jhf.overlay_base(init_tree, imported, allow_missing=True)
    skipped = overlay_flax_params(module, imported, allow_missing=True)
    assert skipped == ctpa_skipped(recorder)
    assert len(skipped) == 3
    ref = flax_to_state_dict(merged)
    for key, val in module.state_dict().items():
        assert np.array_equal(val.numpy(), ref[key]), key
    for bad in ({"decoder": {"kernel": np.zeros((2, 2))}},
                {"mlp_1": {"kernel": np.zeros((16, 15))}}):
        with pytest.raises((KeyError, ValueError)):
            jhf.overlay_base(init_tree, bad)
        with pytest.raises((KeyError, ValueError)):
            overlay_flax_params(module, bad)


# ------------------------------------------------------------ build_ctclip

@pytest.mark.parametrize("layout", ["default (reference PEG layout on)", "explicit vit_cfg (off)"])
def test_build_ctclip_from_reference_pt_matches_ctpa(tmp_path, monkeypatch, layout):
    """The same reference-layout .pt into ctpa's build_ctclip and the port's:
    the same skipped keys, every imported tensor bit-equal after
    flax_to_state_dict, the same VQ codebook, and latents within 1e-5.  A
    .pt turns the reference PEG layout on unless a vit_cfg is passed; the
    latents show the flag matters."""
    sd = reference_sd(45)
    # keys the shipped model has no place for, skipped by both
    sd["visual_transformer.to_pixels.0.weight"] = np.zeros((VIT.patch_dim, VIT.dim), np.float32)
    sd["visual_transformer.enc_temporal_transformer.layers.0.1.null_kv"] = np.ones(
        (VIT.heads, 2, VIT.dim_head), np.float32)
    pt = str(tmp_path / "CT-CLIP_v2.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt)

    default = layout.startswith("default")
    # the shipped default geometry, cut to the tiny one in both packages
    monkeypatch.setattr(jpre, "CTViTConfig", jc.CTViTConfig.tiny)
    monkeypatch.setattr(tpre, "CTViTConfig", tc.CTViTConfig.tiny)
    recorder = _Recorder()
    import ctpa.core.logging as jlog

    monkeypatch.setattr(jlog, "get_logger", lambda: recorder)
    jbert = jcfg(BERT)
    jclip = jc.CTCLIPConfig.tiny(jcfg(VIT), jbert)
    ref = jpre.build_ctclip(pt, bert_cfg=jbert, clip_cfg=jclip,
                            vit_cfg=None if default else jcfg(VIT))
    got = tpre.build_ctclip(pt, bert_cfg=BERT, clip_cfg=CLIP,
                            vit_cfg=None if default else VIT, device="cpu")
    assert got.vit_cfg.peg_reference_layout == ref.vit_cfg.peg_reference_layout == default
    assert got.skipped == ctpa_skipped(recorder)
    assert sorted(got.skipped) == ["/visual_transformer/enc_temporal_transformer/block_0/attn/"
                                   "null_kv", "/visual_transformer/to_pixels"]
    ref_sd = flax_to_state_dict(jax.tree.map(np.asarray, ref.params["params"]))
    own = got.model.state_dict()
    assert sorted(own) == sorted(ref_sd)
    for key, val in own.items():
        assert np.array_equal(val.numpy(), ref_sd[key]), key
    np.testing.assert_array_equal(got.vq_state.codebook.numpy(), np.asarray(ref.vq_state.codebook))
    np.testing.assert_array_equal(got.vq_state.embed_avg.numpy(),
                                  np.asarray(ref.vq_state.embed_avg))

    rng = np.random.default_rng(46)
    video = rng.uniform(-1, 1, size=(2, 1, VIT.temporal_size, VIT.image_size,
                                     VIT.image_size)).astype(np.float32)
    ids = rng.integers(3, BERT.vocab_size, size=(2, 12)).astype(np.int32)
    mask = (np.arange(12)[None] < np.array([[12], [7]])).astype(np.int32)
    img_ref, _ = ref.model.apply(ref.params, jnp.asarray(video), ref.vq_state,
                                 method=JCLIP.encode_image)
    txt_ref = ref.model.apply(ref.params, jnp.asarray(ids), jnp.asarray(mask),
                              method=JCLIP.encode_text)
    with torch.no_grad():
        vq = got.vq_state
        img, _ = got.model.encode_image(torch.from_numpy(video), vq)
        txt = got.model.encode_text(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        # the same weights with the other PEG layout
        flipped = CTCLIP(CLIP, dataclasses.replace(got.vit_cfg, peg_reference_layout=not default),
                         BERT, device="cpu")
        flipped.load_state_dict(own)
        other, _ = flipped.encode_image(torch.from_numpy(video), vq)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_ref), atol=ATOL)
    np.testing.assert_allclose(txt.numpy(), np.asarray(txt_ref), atol=ATOL)
    assert np.abs(other.numpy() - img.numpy()).max() > 100 * ATOL


def test_build_ctclip_restores_the_ports_checkpoint_store(tmp_path):
    """A directory is the port's CheckpointManager store as CTClipTrainer
    writes it: the parameters and the VQ state come back as saved."""
    from ctpa_torch.core.checkpoint import CheckpointManager

    src = tpre.build_ctclip(vit_cfg=VIT, bert_cfg=BERT, clip_cfg=CLIP, seed=3, device="cpu")
    CheckpointManager(str(tmp_path)).save(7, {"params": src.model.state_dict(),
                                              "vq_state": src.vq_state._asdict(), "step": 7})
    got = tpre.build_ctclip(str(tmp_path), vit_cfg=VIT, bert_cfg=BERT, clip_cfg=CLIP,
                            seed=4, device="cpu")
    assert not got.vit_cfg.peg_reference_layout
    for key, val in src.model.state_dict().items():
        assert torch.equal(got.model.state_dict()[key], val), key
    for a, b in zip(got.vq_state, src.vq_state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_build_ctclip_bert_weights_match_ctpa(tmp_path, fmt):
    """bert_weights: an HF BertModel snapshot (safetensors shards or
    pytorch_model.bin, with a 'bert.' prefix) loads the text tower strictly,
    with the tensors ctpa's build_ctclip imports."""
    sd = _bert_sd(np.random.default_rng(47), BERT, prefix="bert.")
    if fmt == "safetensors":
        st = pytest.importorskip("safetensors.numpy")
        keys = sorted(sd)
        st.save_file({k: sd[k] for k in keys[:len(keys) // 2]},
                     str(tmp_path / "model-00001-of-00002.safetensors"))
        st.save_file({k: sd[k] for k in keys[len(keys) // 2:]},
                     str(tmp_path / "model-00002-of-00002.safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   str(tmp_path / "pytorch_model.bin"))
    jbert = jcfg(BERT)
    ref = jpre.build_ctclip(bert_weights=str(tmp_path), vit_cfg=jcfg(VIT), bert_cfg=jbert,
                            clip_cfg=jc.CTCLIPConfig.tiny(jcfg(VIT), jbert))
    got = tpre.build_ctclip(bert_weights=str(tmp_path), vit_cfg=VIT, bert_cfg=BERT,
                            clip_cfg=CLIP, device="cpu")
    ref_sd = flax_to_state_dict(jax.tree.map(np.asarray, ref.params["params"]["text_transformer"]))
    own = got.model.text_transformer.state_dict()
    assert sorted(own) == sorted(ref_sd)
    for key, val in own.items():
        assert np.array_equal(val.numpy(), ref_sd[key]), key
    # strict: a snapshot that lacks a tensor of the tower is refused
    bad = tmp_path / "bad"
    bad.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()
                if k != "bert.encoder.layer.1.output.dense.bias"}, str(bad / "pytorch_model.bin"))
    with pytest.raises(KeyError):
        tpre.build_ctclip(bert_weights=str(bad), vit_cfg=VIT, bert_cfg=BERT, clip_cfg=CLIP,
                          device="cpu")


# -------------------------------------------------------- safetensors, HF

ST_DTYPES = [np.float64, np.float32, np.float16, np.int64, np.uint64, np.int32, np.uint32,
             np.int16, np.uint16, np.int8, np.uint8, np.bool_, np.complex64]


def test_safetensors_reader_matches_the_package(tmp_path):
    """load_safetensors equals safetensors.numpy.load_file for every dtype
    that reader returns (a scalar, an empty and a 3-D tensor each)."""
    st = pytest.importorskip("safetensors.numpy")
    rng = np.random.default_rng(48)
    tensors = {}
    for dt in ST_DTYPES:
        name = np.dtype(dt).name
        tensors[f"{name}.3d"] = (rng.normal(size=(2, 3, 4)) * 50).astype(dt)
        tensors[f"{name}.scalar"] = np.asarray(rng.normal() * 50).astype(dt)
        tensors[f"{name}.empty"] = np.zeros((0, 5), dt)
    path = str(tmp_path / "model.safetensors")
    st.save_file(tensors, path, metadata={"format": "np"})
    ref, got = st.load_file(path), thf.load_safetensors(path)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert np.array_equal(got[k], ref[k]), k


def _bf16_shard(path, seed):
    """A shard with a BF16 tensor (normal draws, and the bit patterns of NaN,
    -0, +-inf and a subnormal), an F32 tensor beside it and ``__metadata__``."""
    rng = np.random.default_rng(seed)
    fp32 = (rng.normal(size=(3, 7)) * 50).astype(np.float32)
    bits = (fp32.view(np.uint32) >> 16).astype(np.uint16)     # truncated to bf16
    bits.flat[:5] = [0x7FC1, 0x8000, 0x7F80, 0xFF80, 0x0003]
    other = rng.normal(size=(4,)).astype(np.float32)
    header = json.dumps({"__metadata__": {"format": "pt"},
                         "w": {"dtype": "BF16", "shape": [3, 7], "data_offsets": [0, 42]},
                         "b": {"dtype": "F32", "shape": [4], "data_offsets": [42, 58]}}).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + bits.tobytes() + other.tobytes())


def test_safetensors_reader_refuses_bf16(tmp_path):
    """The reader's BF16 case.  (The name is kept from when the reader refused
    BF16.)  ctpa's ``load_hf_snapshot`` reads BF16 through
    ``safetensors.numpy`` because JAX's ml_dtypes registers a bfloat16 with
    numpy; the port's reader widens it to fp32, bit for bit equal to ctpa's
    values cast to fp32 (NaN payloads, -0, infinities and subnormals
    included).  What ctpa cannot read either, the F8 codes, is still refused
    with the tensor's name and dtype."""
    snap = tmp_path / "snapshot"
    snap.mkdir()
    _bf16_shard(str(snap / "model-00001-of-00001.safetensors"), 49)
    ref, got = jhf.load_hf_snapshot(str(snap)), thf.load_hf_snapshot(str(snap))
    assert sorted(got) == sorted(ref) == ["b", "w"]
    assert got["w"].dtype == np.float32 and got["w"].shape == (3, 7)
    want = np.asarray(ref["w"]).astype(np.float32)
    assert np.array_equal(got["w"].view(np.uint32), want.view(np.uint32))
    assert np.array_equal(got["b"], ref["b"]) and got["b"].dtype == ref["b"].dtype
    header = json.dumps({"q": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}})
    f8 = tmp_path / "f8.safetensors"
    f8.write_bytes(struct.pack("<Q", len(header)) + header.encode() + bytes(2))
    with pytest.raises(ValueError, match="'q'.*F8_E4M3"):
        thf.load_safetensors(str(f8))


WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "lung", "is", "not", "present",
         "nodule", "effusion", "pleural", "embolism", "pulmonary", ".", "##s", "opacity"]


def test_hf_tokenizer_matches_ctpa(tmp_path):
    """HFTokenizer on a BertTokenizerFast snapshot saved from the test's own
    vocab.txt gives ctpa's ids, masks and decoded text."""
    transformers = pytest.importorskip("transformers")
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(WORDS) + "\n")
    snap = tmp_path / "snapshot"
    transformers.BertTokenizerFast(vocab_file=str(vocab)).save_pretrained(str(snap))
    texts = ["Pulmonary Embolism is present.", "the lung nodules is not present .",
             "pleural effusion opacity unknownword"]
    ref, got = jtok.HFTokenizer(str(snap), max_length=16), ttok.HFTokenizer(str(snap),
                                                                            max_length=16)
    for kw in ({}, {"max_length": 6}, {"padding": "longest"}):
        a, b = ref(texts, **kw), got(texts, **kw)
        for key in ("input_ids", "attention_mask"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(b[key], a[key])
    ids = got(texts[0])["input_ids"][0]
    assert got.decode(ids) == ref.decode(ids)
    assert (got.pad_token_id, got.cls_token_id, got.sep_token_id) == (
        ref.pad_token_id, ref.cls_token_id, ref.sep_token_id)


def test_hf_tokenizer_without_transformers_names_it(monkeypatch):
    """Where transformers is not installed (the card's machine) HFTokenizer
    raises ImportError naming it; nothing falls back to another tokenizer."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        ttok.HFTokenizer("/nonexistent/snapshot")
    with pytest.raises(ImportError, match="transformers"):
        tpre.build_ctclip(tokenizer_path="/nonexistent/snapshot", vit_cfg=VIT, bert_cfg=BERT,
                          clip_cfg=CLIP, device="cpu")
