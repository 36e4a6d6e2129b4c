"""The port's CLIP loss variants, SSL objectives and fused full-sequence
CTViT encoder against ctpa's, on the CPU, at the tiny configurations.

Inputs are numpy draws from a seed; weights are ctpa's parameter shapes
filled from numpy and carried into the port by ``ctpa_torch.convert``.
Where ctpa draws random numbers (the MLM masks, the augmented views), the
port is fed ctpa's own draws.

Tolerances, fp32 on both sides, differing in the order of sums:
  * losses, similarities, head outputs: 1e-5 (relative for losses);
  * the train steps: loss, grad_norm and the SSL metrics 1e-5 relative;
    every parameter after one AdamW step (lr 1e-3) 1e-5 abs, but where its
    gradient is fp32 noise (below 1e-5 in magnitude: Adam's first update
    is lr * g / |g| there, so noise moves it by up to 2 lr);
  * the MLM masks and the augmented views: equal (the views to 1e-6);
  * the fused encoder's tokens against ctpa's interpreted flash kernel:
    1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpa.core import config as jc
from ctpa.core.precision import Policy as JPolicy
from ctpa.models import bert as jbert
from ctpa.models import mlm as jmlm
from ctpa.models import visual_ssl as jssl
from ctpa.models.ctclip import CTCLIP as JCLIP
from ctpa.models.ctclip import filip_similarity as j_filip
from ctpa.models.ctvit import CTViT as JViT
from ctpa.ops.vq import VQState as JVQState
from ctpa.train import optim as joptim
from ctpa.train.clip_trainer import make_clip_train_step as j_make_step
from ctpa.train.train_state import CLIPTrainState as JState
from ctpa_torch.convert import load_flax_params, load_flax_variables, vq_state_from_numpy
from ctpa_torch.core import config as tc
from ctpa_torch.core.mesh import single_device_mesh
from ctpa_torch.core.precision import policy
from ctpa_torch.models import mlm as tmlm
from ctpa_torch.models import visual_ssl as tssl
from ctpa_torch.models.bert import BertMLMHead
from ctpa_torch.models.ctclip import CTCLIP, filip_similarity
from ctpa_torch.models.ctvit import CTViT
from ctpa_torch.train import clip_trainer
from ctpa_torch.train import optim as toptim
from ctpa_torch.train.clip_trainer import SSLDraws, make_clip_train_step
from ctpa_torch.train.train_state import CLIPTrainState

torch.set_num_threads(1)
KEY = jax.random.key(0)
VIT, BERT = tc.CTViTConfig.tiny(), tc.BertConfig.tiny()
JVIT, JBERT = jc.CTViTConfig.tiny(), jc.BertConfig.tiny()
LR = 1e-3
TOL = 1e-5
NOISE = 1e-5          # gradients below this are fp32 noise for Adam's first step
GAINS = ("scale", "gamma", "q_scale", "k_scale", "norm_in_scale", "temperature")


@pytest.fixture(scope="module", autouse=True)
def _sync_dispatch():
    """ctpa's interpreted Pallas kernel deadlocks under asynchronous CPU
    dispatch (tests/conftest.py); this module turns it off while it runs."""
    before = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", before)


def _t(x):
    return torch.from_numpy(np.array(x))


def _fill(shapes, seed):
    """Numpy weights for a flax param tree: gains near 1, the rest at 0.1."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name in GAINS:
            return np.asarray(1 + 0.1 * rng.normal(size=shape), np.float32)
        return np.asarray(0.1 * rng.normal(size=shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(seed, b=2, seq=8):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, seq), np.int32)
    mask[1, 5:] = 0
    ids = rng.integers(3, BERT.vocab_size, size=(b, seq)).astype(np.int32) * mask
    return {"input_ids": ids, "attention_mask": mask,
            "video": rng.uniform(-1, 1, size=(b, 1, VIT.temporal_size, VIT.image_size,
                                              VIT.image_size)).astype(np.float32)}


def _vq(seed=5):
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(VIT.codebook_size, VIT.dim)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    return cb, np.abs(rng.normal(size=VIT.codebook_size)).astype(np.float32), cb.copy()


def _models(**over):
    """ctpa's tiny CTCLIP with ``over`` on its config, its numpy weights, and
    the port's model carrying them."""
    jcfg = dataclasses.replace(jc.CTCLIPConfig.tiny(JVIT, JBERT), **over)
    jm = JCLIP(jcfg, JVIT, JBERT)
    b = _batch(0)
    shapes = jax.eval_shape(lambda: jm.init(KEY, b["input_ids"], b["attention_mask"],
                                            b["video"], JVQState(*map(jnp.asarray, _vq())),
                                            method=JCLIP.init_all))["params"]
    params = _fill(shapes, 3)
    tcfg = dataclasses.replace(tc.CTCLIPConfig.tiny(VIT, BERT), **over)
    model = load_flax_params(CTCLIP(tcfg, VIT, BERT, device="cpu"), params)
    return jm, params, model


def _tbatch(b):
    return {"input_ids": _t(b["input_ids"]).long(), "attention_mask": _t(b["attention_mask"]),
            "video": _t(b["video"])}


def _steps_match(over, step_kw=None, draws=None, with_vq=True):
    """One ctpa step (jit, fp32 policy, AdamW lr 1e-3) and one port step from
    the same weights and batch: metrics within 1e-5 relative, every
    parameter within 1e-5 but where its gradient is noise."""
    step_kw = step_kw or {}
    jm, params, model = _models(**over)
    vq = _vq() if with_vq else None
    batch = _batch(1)
    jtx = joptim.get_optimizer(jc.OptimizerConfig(lr=LR), {"params": params})
    jstate = JState.create({"params": params}, jtx,
                           JVQState(*map(jnp.asarray, vq)) if with_vq else None)
    jstep = jax.jit(j_make_step(jm, jtx, policy=JPolicy(compute_dtype=jnp.float32), **step_kw))
    jstate, jm_ = jstep(jstate, jax.tree.map(jnp.asarray, batch))
    tx = toptim.get_optimizer(tc.OptimizerConfig(lr=LR), model)
    state = CLIPTrainState.create(model, tx,
                                  vq_state_from_numpy(vq, device="cpu") if with_vq else None)
    with pytest.MonkeyPatch.context() as mp:
        if draws is not None:
            mp.setattr(clip_trainer, "ssl_draws", draws)
        _, m = make_clip_train_step(model, tx, policy=policy("fp32"), **step_kw)(
            state, _tbatch(batch))
    assert set(m) == set(jm_)
    for key, ref in jm_.items():
        np.testing.assert_allclose(float(m[key]), float(ref), rtol=TOL, err_msg=key)
    from ctpa_torch.convert import flax_to_state_dict

    ref = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params["params"]))
    got = dict(model.named_parameters())
    assert set(got) == set(ref)
    for key, p in got.items():
        noisy = (p.grad.abs() < NOISE).numpy() if p.grad is not None else np.ones(p.shape, bool)
        diff = np.abs(p.detach().numpy() - ref[key])
        assert diff[~noisy].max(initial=0) <= TOL, key
        assert diff[noisy].max(initial=0) <= 2 * LR + TOL, key
    return m


# ------------------------------------------------------------- the variants

@pytest.mark.parametrize("over", [
    dict(decoupled_contrastive_learning=True),
    dict(extra_latent_projection=True),
    dict(use_all_token_embeds=True, dim_image=VIT.dim),
    dict(downsample_image_embeds=True,
         dim_image=((VIT.image_size // VIT.patch_size) // 2) ** 2 * 32),
], ids=["dcl", "cloob", "filip", "downsample"])
def test_variant_train_step_matches_ctpa(over):
    # FILIP without the VQ bottleneck: quantized tokens repeat codebook
    # vectors, so its maxima over image tokens meet exact ties, whose
    # subgradient torch splits evenly and XLA's fused sums may break by an ulp
    m = _steps_match(over, with_vq="use_all_token_embeds" not in over)
    assert np.isfinite(float(m["loss"]))


def _ctpa_draws(step, ids, video, seed=0):
    """ctpa's draws of the step (``make_clip_train_step``'s keys)."""
    base = jax.random.key(seed)
    k1, k2 = jax.random.split(jax.random.fold_in(base, step * 2 + 1))
    mlm = (_t(jax.random.uniform(k1, ids.shape)), _t(jax.random.uniform(k2, ids.shape)))
    views = tuple(_view_draws(k, video) for k in
                  jax.random.split(jax.random.fold_in(base, step * 2 + 2)))
    return SSLDraws(mlm, views)


def _view_draws(key, video, noise_std=0.05):
    """ctpa's ``augment_volume`` draws for one fp32 view."""
    assert video.dtype == torch.float32
    k1, k2, k3, k4 = jax.random.split(key, 4)
    return tssl.AugmentDraws(
        _t(jax.random.bernoulli(k1)), _t(jax.random.bernoulli(k2)),
        _t(1.0 + 0.1 * jax.random.uniform(k3, (), minval=-1.0, maxval=1.0)),
        _t(noise_std * jax.random.normal(k4, tuple(video.shape), jnp.float32)))


def test_ssl_train_step_with_ctpa_draws_matches_ctpa():
    """use_mlm + use_visual_ssl (weights 0.5, mask token 7): the port's step
    fed ctpa's draws through its one draw function."""
    over = dict(use_mlm=True, text_ssl_loss_weight=0.5, image_ssl_loss_weight=0.5)
    kw = dict(use_mlm=True, use_visual_ssl=True, mask_token_id=7)

    def draws(seed, step, ids, video, use_mlm, use_visual_ssl):
        assert (seed, use_mlm, use_visual_ssl) == (0, True, True)
        return _ctpa_draws(step, ids.numpy(), video)

    m = _steps_match(over, kw, draws)
    assert float(m["mlm_loss"]) > 0 and np.isfinite(float(m["visual_ssl_loss"]))


def test_ssl_step_draws_from_seed_and_step():
    """The port's own draws: fixed by (seed, step), other for another step,
    and the views' noise in the video's dtype."""
    ids = torch.arange(16).reshape(2, 8)
    video = torch.zeros(2, 1, 4, 4, 4, dtype=torch.bfloat16)
    a = clip_trainer.ssl_draws(0, 3, ids, video, True, True)
    b = clip_trainer.ssl_draws(0, 3, ids, video, True, True)
    c = clip_trainer.ssl_draws(0, 4, ids, video, True, False)
    assert torch.equal(a.mlm[0], b.mlm[0]) and torch.equal(a.views[1].noise, b.views[1].noise)
    assert not torch.equal(a.mlm[0], c.mlm[0]) and c.views is None
    assert a.views[0].noise.dtype == torch.bfloat16 and a.mlm[0].shape == ids.shape


def test_multiview_loss_matches_ctpa():
    jm, params, model = _models()
    vq = _vq()
    b, aug = _batch(2), _batch(9)
    jvq = JVQState(*map(jnp.asarray, vq))
    tvq = vq_state_from_numpy(vq, device="cpu")
    args = [jnp.asarray(b[k]) for k in ("input_ids", "attention_mask", "video")]
    augs = [jnp.asarray(aug[k]) for k in ("input_ids", "attention_mask", "video")]
    targs, taugs = list(_tbatch(b).values()), list(_tbatch(aug).values())
    for views, tviews in ((augs, taugs), (augs[:2] + [None], taugs[:2] + [None]),
                          ([None] * 3, [None] * 3)):
        ref = jm.apply({"params": params}, *args, *views, jvq, method=JCLIP.multiview_loss)
        with torch.no_grad():
            got = model.multiview_loss(*targs, *tviews, vq_state=tvq)
        np.testing.assert_allclose(float(got), float(ref), rtol=TOL)


def test_filip_similarity_and_downsample_pool_match_ctpa():
    rng = np.random.default_rng(4)
    t = rng.normal(size=(3, 5, 8)).astype(np.float32)
    i = rng.normal(size=(2, 7, 8)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [0, 0, 0, 0, 0]], bool)
    np.testing.assert_allclose(filip_similarity(_t(t), _t(i), _t(mask)).numpy(),
                               np.asarray(j_filip(t, i, mask)), atol=TOL)
    # the stride-2 depthwise grid of an odd and an even token grid
    for h, w in ((5, 4), (4, 4)):
        jcfg = dataclasses.replace(jc.CTCLIPConfig.tiny(JVIT, JBERT), downsample_image_embeds=True)
        jm = JCLIP(jcfg, JVIT, JBERT)
        tokens = rng.normal(size=(2, 3, h, w, VIT.dim)).astype(np.float32)
        shapes = jax.eval_shape(lambda: jm.init(KEY, tokens, method=JCLIP.pool_image_tokens))
        params = _fill(shapes["params"], 6)
        ref = jm.apply({"params": params}, tokens, method=JCLIP.pool_image_tokens)
        model = CTCLIP(dataclasses.replace(tc.CTCLIPConfig.tiny(VIT, BERT),
                                           downsample_image_embeds=True), VIT, BERT, device="cpu")
        model.downsample_depthwise.data = _t(params["downsample_depthwise"])
        model.downsample_pointwise.weight.data = _t(params["downsample_pointwise"]["kernel"].T)
        model.downsample_pointwise.bias.data = _t(params["downsample_pointwise"]["bias"])
        with torch.no_grad():
            got = model.pool_image_tokens(_t(tokens))
        # ceil((h - 1) / 2) x ceil((w - 1) / 2) positions of 32 channels
        assert got.shape == ref.shape == (2, -(-(h - 1) // 2) * -(-(w - 1) // 2) * 32)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL)


def test_mlm_logits_and_visual_ssl_embed_match_ctpa():
    jm, params, model = _models(use_mlm=True)
    b = _batch(3)
    with torch.no_grad():
        got = model.mlm_logits(_t(b["input_ids"]).long(), _t(b["attention_mask"]))
        emb = model.visual_ssl_embed(_t(b["video"]))
    ref = jm.apply({"params": params}, b["input_ids"], b["attention_mask"],
                   method=JCLIP.mlm_logits)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
    ref = jm.apply({"params": params}, b["video"], method=JCLIP.visual_ssl_embed)
    np.testing.assert_allclose(emb.numpy(), np.asarray(ref), atol=TOL)


def test_filip_refuses_the_elementwise_score():
    _, _, model = _models(use_all_token_embeds=True, dim_image=VIT.dim)
    b = _tbatch(_batch(4))
    with pytest.raises(ValueError, match="FILIP"), torch.no_grad():
        model(*b.values(), None, return_loss=False)


# ------------------------------------------------------------ MLM and SSL parts

def test_bert_mlm_head_matches_ctpa():
    head = jbert.BertMLMHead(JBERT)
    x = np.random.default_rng(5).normal(size=(2, 6, BERT.hidden_size)).astype(np.float32)
    params = _fill(jax.eval_shape(lambda: head.init(KEY, x))["params"], 7)
    got = load_flax_params(BertMLMHead(BERT, device="cpu"), params)(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(head.apply({"params": params}, x)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_tokens_fed_ctpa_uniforms_give_ctpa_masks(seed):
    """Rows with padding, a row of padding only, and low mask_prob so that
    most rows take the forced token."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 50, size=(5, 12)).astype(np.int32)
    ids[1, 8:] = 0
    ids[3] = 0
    key = jax.random.key(seed)
    for mask_prob in (0.15, 0.02):
        ref_masked, ref_sel = jmlm.mask_tokens(key, jnp.asarray(ids), mask_prob=mask_prob,
                                               mask_token_id=7)
        k1, k2 = jax.random.split(key)
        u1, u2 = (_t(jax.random.uniform(k, ids.shape)) for k in (k1, k2))
        masked, sel = tmlm.mask_tokens_from(_t(ids), u1, u2, mask_prob=mask_prob, mask_token_id=7)
        assert torch.equal(masked, _t(ref_masked)) and torch.equal(sel, _t(ref_sel))
        assert not sel[3].any() and bool(sel[[0, 1, 2, 4]].any(-1).all())


def test_mlm_loss_matches_ctpa():
    rng = np.random.default_rng(8)
    ids = rng.integers(1, 40, size=(3, 10)).astype(np.int32)
    ids[2, 6:] = 0
    am = (ids > 0).astype(np.int32)
    w = rng.normal(size=(40, 40)).astype(np.float32)
    key = jax.random.key(3)
    ref = jmlm.mlm_loss(key, lambda m, a: jax.nn.one_hot(m, 40) @ w * a[..., None], ids, am,
                        mask_token_id=7)
    k1, k2 = jax.random.split(key)
    draws = tuple(_t(jax.random.uniform(k, ids.shape)) for k in (k1, k2))
    got = tmlm.mlm_loss(lambda m, a: torch.nn.functional.one_hot(m.long(), 40).float() @ _t(w)
                        * a[..., None], _t(ids), _t(am), draws, mask_token_id=7)
    np.testing.assert_allclose(float(got), float(ref), rtol=TOL)
    masked, sel = tmlm.mask_tokens(_t(ids), torch.Generator().manual_seed(0))
    assert sel.any(-1).all() and not sel[2, 6:].any()


def test_nt_xent_and_simsiam_match_ctpa():
    rng = np.random.default_rng(9)
    z1, z2, p1, p2 = (rng.normal(size=(4, 16)).astype(np.float32) for _ in range(4))
    np.testing.assert_allclose(float(tssl.nt_xent_loss(_t(z1), _t(z2))),
                               float(jssl.nt_xent_loss(z1, z2)), rtol=TOL)
    np.testing.assert_allclose(float(tssl.nt_xent_loss(_t(z1), _t(z2), 0.5)),
                               float(jssl.nt_xent_loss(z1, z2, 0.5)), rtol=TOL)
    np.testing.assert_allclose(float(tssl.simsiam_loss(*map(_t, (p1, z2, p2, z1)))),
                               float(jssl.simsiam_loss(p1, z2, p2, z1)), rtol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_augment_volume_fed_ctpa_draws_matches_ctpa(seed):
    video = np.random.default_rng(seed).normal(size=(2, 1, 4, 6, 5)).astype(np.float32)
    key = jax.random.key(seed)
    got = tssl.augment_volume_from(_t(video), _view_draws(key, _t(video)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jssl.augment_volume(key, video)),
                               atol=1e-6)
    own = tssl.augment_volume(_t(video), torch.Generator().manual_seed(seed))
    assert own.shape == video.shape and own.dtype == torch.float32
    enc = np.random.default_rng(seed + 10).normal(size=(120, 8)).astype(np.float32)
    ref = jssl.simclr_ssl_loss(key, lambda v: v.reshape(2, -1) @ enc, jnp.asarray(video))
    k1, k2 = jax.random.split(key)
    views = (_view_draws(k1, _t(video)), _view_draws(k2, _t(video)))
    loss = tssl.simclr_ssl_loss(lambda v: v.reshape(2, -1) @ _t(enc), _t(video), views)
    np.testing.assert_allclose(float(loss), float(ref), rtol=TOL)


def test_projector_with_batch_stats_and_predictor_match_ctpa():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, 24)).astype(np.float32)
    proj = jssl.ProjectorMLP(hidden=32, out=16, num_layers=3)
    variables = jax.eval_shape(lambda: proj.init(KEY, x))
    params = _fill(variables["params"], 12)
    stats = jax.tree.map(lambda s: np.asarray(np.abs(rng.normal(size=s.shape)) + 0.5, np.float32),
                         variables["batch_stats"])
    ref = proj.apply({"params": params, "batch_stats": stats}, x)
    port = load_flax_variables(tssl.ProjectorMLP(24, 32, 16, 3, device="cpu"),
                               {"params": params, "batch_stats": stats})
    port.train()     # the running statistics in training too, as ctpa
    np.testing.assert_allclose(port(_t(x)).detach().numpy(), np.asarray(ref), atol=TOL)
    assert torch.equal(port.BatchNorm_1.var, _t(stats["BatchNorm_1"]["var"]))
    pred = jssl.PredictorMLP(hidden=32, out=16)
    pp = _fill(jax.eval_shape(lambda: pred.init(KEY, x))["params"], 13)
    got = load_flax_params(tssl.PredictorMLP(24, 32, 16, device="cpu"), pp)(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(pred.apply({"params": pp}, x)),
                               atol=TOL)


# --------------------------------------------------------- the fused encoder

def test_fused_encoder_matches_ctpa_interpreted_flash():
    """ctpa's fused CTViT (fused_depth 1; its flash kernel in interpret mode)
    against the port's (the flash wrapper's plain version on the CPU):
    tokens and the VQ output within 1e-4."""
    from jax.experimental.pallas import tpu as pltpu

    jcfg = dataclasses.replace(JVIT, fused_attention=True, fused_depth=1)
    jm = JViT(jcfg)
    video = np.random.default_rng(14).uniform(
        -1, 1, size=(2, 1, VIT.temporal_size, VIT.image_size, VIT.image_size)).astype(np.float32)
    vq = _vq()
    jvq = JVQState(*map(jnp.asarray, vq))
    params = _fill(jax.eval_shape(lambda: jm.init(KEY, video, jvq))["params"], 15)
    assert set(params) == {"patch_embed", "enc_fused_transformer"}
    with pltpu.force_tpu_interpret_mode():
        ref_tokens, ref_vq = jm.apply({"params": params}, video, jvq)
    model = load_flax_params(CTViT(dataclasses.replace(VIT, fused_attention=True,
                                                       fused_depth=1), device="cpu"), params)
    assert model.enc_fused_transformer.blocks[0].attn.use_flash
    with torch.no_grad():
        tokens, out = model(_t(video), vq_state_from_numpy(vq, device="cpu"))
    np.testing.assert_allclose(tokens.numpy(), np.asarray(ref_tokens), atol=1e-4)
    np.testing.assert_allclose(float(out.commit_loss), float(ref_vq.commit_loss), rtol=1e-4)
    # context parallelism over a one-rank mesh gives the same tokens (more
    # ranks: tests/test_torch_context_parallel.py)
    cp = CTViT(dataclasses.replace(VIT, fused_attention=True, fused_depth=1), device="cpu",
               cp_mesh=single_device_mesh("cpu"), cp_axis="data")
    cp.load_state_dict(model.state_dict())
    with torch.no_grad():
        cp_tokens, _ = cp(_t(video), vq_state_from_numpy(vq, device="cpu"))
    torch.testing.assert_close(cp_tokens, tokens, atol=0, rtol=0)
