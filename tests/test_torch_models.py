"""ctpa_torch models against ctpa's flax models on the CPU, in fp32.

Each test builds the ctpa module, replaces its parameters by numpy draws from
a fixed seed (non-zero biases included), carries them into the port with
``ctpa_torch.convert`` and runs both on the same numpy input.  Tolerance:
fp32 on both sides, differing in the order of sums and in library kernels,
so 2e-5 absolute on outputs of order 1 (whole towers: 5e-5).  The port's
kernel switches (``pallas_patchify``, ``flash_axial``) are exercised on the
CPU, where the kernels' wrappers take their plain versions; ctpa runs its
plain paths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpa.core import config as jc
from ctpa.eval import zeroshot as jzs
from ctpa.models import attention as jatt
from ctpa.models.bert import BertEncoder as JBert
from ctpa.models.ctclip import CTCLIP as JCLIP
from ctpa.models.ctvit import CTViT as JViT
from ctpa.models.ctvit import PatchEmbed3D as JPatch
from ctpa.ops.preprocess import preprocess_volume_inference as jpre_infer
from ctpa.ops.vq import VQState as JVQState
from ctpa_torch.convert import flax_to_state_dict, load_flax_params, vq_state_from_numpy
from ctpa_torch.core import config as tc
from ctpa_torch.data.tokenizer import SimpleWordTokenizer
from ctpa_torch.eval import zeroshot as tzs
from ctpa_torch.models import attention as tatt
from ctpa_torch.models.bert import BertEncoder
from ctpa_torch.models.ctclip import CTCLIP
from ctpa_torch.models.ctvit import CTViT, PatchEmbed3D
from ctpa_torch.ops.preprocess import preprocess_volume_inference

torch.set_num_threads(1)
ATOL = 2e-5
TOWER_ATOL = 5e-5
KEY = jax.random.key(0)
GAINS = {"gamma", "scale", "q_scale", "k_scale", "norm_in_scale"}


def np_params(tree, seed):
    """A numpy draw for every leaf of a flax param tree: gains near 1, Dense
    kernels at 1/sqrt(fan_in), everything else (biases too) at 0.1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, np.shape(leaf)
        if name in GAINS or name == "temperature":
            val = 1 + 0.1 * rng.normal(size=shape)
        elif name.endswith("kernel") and len(shape) == 2:
            val = rng.normal(size=shape) / np.sqrt(shape[0])
        else:
            val = 0.1 * rng.normal(size=shape)
        return jnp.asarray(val, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def port(module, flax_params):
    return load_flax_params(module, jax.tree.map(np.asarray, flax_params)).eval()


def _t(x):
    return torch.tensor(np.asarray(x))


def close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol)


def jcfg_from(cfg, **over):
    """The ctpa config with the same field values as a port config."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    jtype = {tc.CTViTConfig: jc.CTViTConfig, tc.BertConfig: jc.BertConfig}[type(cfg)]
    kw = {k: getattr(cfg, k) for k in fields}
    kw.update(over)
    return jtype(**kw)


VIT = tc.CTViTConfig.tiny()
BERT = tc.BertConfig.tiny()


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("fold,reference_layout", [
    ("spatial", False), ("temporal", False), ("temporal", True), ("full", False)])
def test_peg_matches_ctpa(fold, reference_layout):
    t, h, w, d, b = 3, 4, 5, 8, 2
    rng = np.random.default_rng(10)
    B, n = {"spatial": (b * t, h * w), "temporal": (b * h * w, t), "full": (b, t * h * w)}[fold]
    x = rng.normal(size=(B, n, d)).astype(np.float32)
    jm = jatt.PEG(dim=d, reference_layout=reference_layout)
    p = np_params(jm.init(KEY, x, (t, h, w), fold)["params"], 11)
    ref = jm.apply({"params": p}, x, (t, h, w), fold)
    tm = port(tatt.PEG(d, reference_layout=reference_layout), p)
    close(tm(_t(x), (t, h, w), fold), ref)


def test_continuous_position_bias_matches_ctpa():
    jm = jatt.ContinuousPositionBias(dim=16, heads=4)
    p = np_params(jm.init(KEY, 3, 5)["params"], 12)
    close(port(tatt.ContinuousPositionBias(16, 4), p)(3, 5), jm.apply({"params": p}, 3, 5))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("kv_from_normed", [False, True])
def test_cosine_attention_module_matches_ctpa(use_flash, kv_from_normed):
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 12, 32)).astype(np.float32)
    bias = rng.normal(size=(4, 12, 12)).astype(np.float32)
    jm = jatt.CosineAttention(dim=32, heads=4, dim_head=16, kv_from_normed=kv_from_normed)
    p = np_params(jm.init(KEY, x, bias=bias)["params"], 14)
    ref = jm.apply({"params": p}, x, bias=bias)
    tm = port(tatt.CosineAttention(32, 4, 16, kv_from_normed=kv_from_normed,
                                   use_flash=use_flash), p)
    close(tm(_t(x), bias=_t(bias)), ref)


@pytest.mark.parametrize("fold", ["spatial", "temporal"])
def test_transformer_matches_ctpa(fold):
    t, h, w, d = 3, 4, 4, 32
    rng = np.random.default_rng(15)
    x = rng.normal(size=((2 * t, h * w) if fold == "spatial" else (2 * h * w, t)) + (d,))
    x = x.astype(np.float32)
    n = x.shape[1]
    bias = rng.normal(size=(4, n, n)).astype(np.float32) if fold == "spatial" else None
    kw = dict(dim=d, depth=2, heads=4, dim_head=16, peg=True)
    jm = jatt.Transformer(**kw)
    p = np_params(jm.init(KEY, x, (t, h, w), fold, bias=bias)["params"], 16)
    ref = jm.apply({"params": p}, x, (t, h, w), fold, bias=bias)
    tm = port(tatt.Transformer(**kw, use_flash=fold == "spatial"), p)
    close(tm(_t(x), (t, h, w), fold, bias=None if bias is None else _t(bias)), ref)


# -------------------------------------------------------------- CTViT side

def _video(seed, b=2, cfg=VIT):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(b, 1, cfg.temporal_size, cfg.image_size,
                                    cfg.image_size)).astype(np.float32)


@pytest.mark.parametrize("kernel_path", [False, True])
def test_patch_embed_matches_ctpa_plain_path(kernel_path):
    video = _video(17)
    jm = JPatch(jcfg_from(VIT))
    p = np_params(jm.init(KEY, video)["params"], 18)
    ref = jm.apply({"params": p}, video)
    tm = port(PatchEmbed3D(dataclasses.replace(VIT, pallas_patchify=kernel_path)), p)
    # the kernel path's LN-folded form adds fp32 cancellation (mu*rsig*v2);
    # the kernel is forward-only, so it runs without grad
    with torch.no_grad():
        close(tm(_t(video)), ref, atol=1e-4 if kernel_path else ATOL)


def _vq_np(seed, k, d):
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(k, d)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    return cb, np.zeros(k, np.float32), cb.copy()


@pytest.mark.parametrize("kernels", [False, True])
def test_ctvit_with_vq_and_frame_mask_matches_ctpa(kernels):
    video = _video(19)
    vq = _vq_np(20, VIT.codebook_size, VIT.dim)
    frame_mask = np.ones((2, VIT.temporal_size), bool)
    frame_mask[1, 9:] = False
    jm = JViT(jcfg_from(VIT))
    p = np_params(jm.init(KEY, video, None)["params"], 21)
    tokens_ref, out_ref = jm.apply({"params": p}, video, JVQState(*map(jnp.asarray, vq)),
                                   jnp.asarray(frame_mask))
    cfg = dataclasses.replace(VIT, pallas_patchify=kernels, flash_axial=kernels)
    tm = port(CTViT(cfg, device="cpu"), p)
    with torch.no_grad():       # the patchify kernel is forward-only
        tokens, out = tm(_t(video), vq_state_from_numpy(vq, device="cpu"), _t(frame_mask))
        encoded = tm(_t(video))[0]
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(out_ref.indices))
    close(tokens, tokens_ref)
    close(out.commit_loss, out_ref.commit_loss)
    close(out.counts, out_ref.counts)
    # and the encoder alone, before the bottleneck
    close(encoded, jm.apply({"params": p}, video, None)[0], atol=TOWER_ATOL)


def test_token_mask_matches_ctpa():
    fm = np.random.default_rng(22).uniform(size=(2, VIT.temporal_size)) > 0.5
    jm = JViT(jcfg_from(VIT))
    ref = jm.apply({}, jnp.asarray(fm), method=JViT.token_mask)
    np.testing.assert_array_equal(CTViT(VIT, device="cpu").token_mask(_t(fm)).numpy(),
                                  np.asarray(ref))


# --------------------------------------------------------------- text side

def test_bert_encoder_matches_ctpa():
    rng = np.random.default_rng(23)
    ids = rng.integers(3, BERT.vocab_size, size=(3, 20)).astype(np.int32)
    mask = np.ones((3, 20), np.int32)
    mask[1, 12:] = 0
    mask[2, 5:] = 0
    jm = JBert(jcfg_from(BERT))
    p = np_params(jm.init(KEY, ids, mask)["params"], 24)
    hidden_ref, cls_ref = jm.apply({"params": p}, ids, mask)
    tm = port(BertEncoder(BERT, device="cpu"), p)
    hidden, cls = tm(_t(ids).long(), _t(mask))
    close(hidden, hidden_ref, atol=TOWER_ATOL)
    close(cls, cls_ref, atol=TOWER_ATOL)


# ------------------------------------------------------ CTCLIP and zero-shot

@pytest.fixture(scope="module")
def clip_pair():
    """ctpa's tiny CTCLIP with numpy weights, and the port with the same."""
    clip_cfg = tc.CTCLIPConfig.tiny(VIT, BERT)
    jm = JCLIP(jc.CTCLIPConfig.tiny(jcfg_from(VIT), jcfg_from(BERT)), jcfg_from(VIT),
               jcfg_from(BERT))
    ids = np.ones((2, 8), np.int32)
    p = np_params(jm.init(KEY, ids, ids, _video(0))["params"], 25)
    kcfg = dataclasses.replace(VIT, pallas_patchify=True, flash_axial=True)
    tm = port(CTCLIP(clip_cfg, kcfg, BERT, device="cpu"), p)
    vq = _vq_np(26, VIT.codebook_size, VIT.dim)
    return jm, p, tm, vq


def test_ctclip_encode_image_matches_ctpa(clip_pair):
    jm, p, tm, vq = clip_pair
    video = _video(27)
    ref, _ = jm.apply({"params": p}, video, JVQState(*map(jnp.asarray, vq)),
                      method=JCLIP.encode_image)
    with torch.no_grad():
        got, _ = tm.encode_image(_t(video), vq_state_from_numpy(vq, device="cpu"))
    close(got, ref)


def test_ctclip_encode_text_matches_ctpa(clip_pair):
    jm, p, tm, _ = clip_pair
    rng = np.random.default_rng(28)
    ids = rng.integers(3, BERT.vocab_size, size=(4, 16)).astype(np.int32)
    mask = (np.arange(16)[None] < np.array([[16], [9], [4], [12]])).astype(np.int32)
    ref = jm.apply({"params": p}, ids, mask, method=JCLIP.encode_text)
    with torch.no_grad():
        close(tm.encode_text(_t(ids).long(), _t(mask)), ref)


def test_score_prompt_pairs_matches_ctpa():
    rng = np.random.default_rng(29)
    img = rng.normal(size=(3, 8)).astype(np.float32)
    prompts = rng.normal(size=(6, 8)).astype(np.float32)
    ref = jzs.score_prompt_pairs(jnp.asarray(img), jnp.asarray(prompts), jnp.float32(2.5))
    close(tzs.score_prompt_pairs(_t(img), _t(prompts), 2.5), ref, atol=1e-6)
    assert tzs.prompt_pairs() == jzs.prompt_pairs() and tzs.PATHOLOGIES == jzs.PATHOLOGIES


def test_zeroshot_end_to_end_matches_ctpa(clip_pair):
    """The slice as a whole: inference preprocess -> image latent -> scores
    against 36 cached prompt latents, in both frameworks."""
    jm, p, tm, vq = clip_pair
    tok = SimpleWordTokenizer(vocab_size=BERT.vocab_size, max_length=24)
    rng = np.random.default_rng(30)
    vols = [rng.uniform(-1.1, 1.1, size=(36, 30, 18)).astype(np.float32) for _ in range(2)]
    grid = (VIT.temporal_size, VIT.image_size, VIT.image_size)
    jpre_cfg = dataclasses.replace(jc.PreprocessConfig.inference(), target_shape=grid)
    tpre_cfg = dataclasses.replace(tc.PreprocessConfig.inference(), target_shape=grid)
    temp = float(np.exp(np.asarray(p["temperature"])))
    jvq = JVQState(*map(jnp.asarray, vq))

    def j_text(ids, mask):
        return jm.apply({"params": p}, ids, mask, method=JCLIP.encode_text)

    def j_tok(texts):
        out = tok(texts)
        return jnp.asarray(out["input_ids"]), jnp.asarray(out["attention_mask"])

    jclf = jzs.ZeroShotClassifier(j_text, j_tok, temp)
    jvideo = jnp.stack([jpre_infer(jnp.asarray(v), cfg=jpre_cfg) for v in vols])
    ref = jclf.predict(jm.apply({"params": p}, jvideo, jvq, method=JCLIP.encode_image)[0])

    def t_tok(texts):
        out = tok(texts)
        return torch.as_tensor(out["input_ids"]).long(), torch.as_tensor(out["attention_mask"])

    with torch.no_grad():
        tclf = tzs.ZeroShotClassifier(tm.encode_text, t_tok, tm.temperature.exp())
        tvideo = torch.stack([preprocess_volume_inference(v, tpre_cfg, device="cpu")
                              for v in vols])
        got = tclf.predict(tm.encode_image(tvideo, vq_state_from_numpy(vq, device="cpu"))[0])
    assert got.shape == (2, len(tzs.PATHOLOGIES))
    np.testing.assert_allclose(tclf.prompt_latents.numpy(), jclf.prompt_latents, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=1e-5)


# ----------------------------------------------------------------- convert

def test_convert_is_strict():
    jm = jatt.ContinuousPositionBias(dim=8, heads=2)
    p = jax.tree.map(np.asarray, jm.init(KEY, 2, 2)["params"])
    assert "mlp.0.weight" in flax_to_state_dict(p)
    np.testing.assert_array_equal(flax_to_state_dict(p)["mlp.0.weight"], p["mlp_0"]["kernel"].T)
    extra = dict(p, stray={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="unused"):
        load_flax_params(tatt.ContinuousPositionBias(8, 2), extra)
    missing = {k: v for k, v in p.items() if k != "to_heads"}
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(tatt.ContinuousPositionBias(8, 2), missing)
    with pytest.raises(ValueError, match="shape"):
        load_flax_params(tatt.ContinuousPositionBias(8, 3), p)
