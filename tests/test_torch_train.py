"""The port's contrastive training slice against ctpa's, on the CPU.

Each test builds the same inputs (and, where there are weights, the same
numpy weights, carried into the port by ``ctpa_torch.convert``) for ctpa and
for the port, runs both and bounds the difference.  On the CPU the flash
kernels' wrappers take their plain versions, so these tests hold the
autograd wiring, the recompute from the logsumexp, the losses, the
optimizer and the step against ctpa's own code; the CUDA kernels are held
against the same plain versions on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).

Tolerances, fp32 on both sides, differing only in the order of sums:
  * flash forward logsumexp and backward: 1e-5 abs + 1e-4 rel;
  * losses, schedules, EMA update: 1e-6 abs or 1e-5 rel as stated;
  * the train step: loss and grad norm 1e-5 rel, every parameter after the
    update 1e-6 abs, the VQ state 1e-5 abs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ctpa.core import config as jc
from ctpa.core.precision import Policy as JPolicy
from ctpa.models.ctclip import CTCLIP as JCLIP
from ctpa.models.ctclip import infonce_loss as j_infonce
from ctpa.ops import attention_ops as jops
from ctpa.ops import preprocess as jpre
from ctpa.ops.pallas.flash_attention import _dense_bwd
from ctpa.ops.vq import VQState as JVQState
from ctpa.ops.vq import ema_update as j_ema
from ctpa.train import optim as joptim
from ctpa.train.clip_trainer import clip_finetune_mask as j_finetune_mask
from ctpa.train.clip_trainer import make_clip_train_step as j_make_step
from ctpa.train.train_state import CLIPTrainState as JState
from ctpa_torch.convert import flax_to_state_dict, load_flax_params, vq_state_from_numpy
from ctpa_torch.core import config as tc
from ctpa_torch.core.checkpoint import CheckpointManager
from ctpa_torch.core.mesh import single_device_mesh
from ctpa_torch.core.precision import Policy, policy
from ctpa_torch.models.ctclip import CTCLIP, infonce_loss
from ctpa_torch.models.ctvit import PatchEmbed3D
from ctpa_torch.models.layers import Dense
from ctpa_torch.ops import preprocess as tpre
from ctpa_torch.ops.attention_ops import l2norm
from ctpa_torch.ops.flash_attention import (
    LAUNCHES,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from ctpa_torch.ops.vq import VQState, ema_update
from ctpa_torch.train import optim as toptim
from ctpa_torch.train.clip_trainer import CTClipTrainer, clip_finetune_mask, make_clip_train_step
from ctpa_torch.train.train_state import CLIPTrainState

torch.set_num_threads(1)
KEY = jax.random.key(0)
VIT = tc.CTViTConfig.tiny()
BERT = tc.BertConfig.tiny()
FA_ATOL, FA_RTOL = 1e-5, 1e-4
GAINS = {"gamma", "scale", "q_scale", "k_scale", "norm_in_scale"}


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x), requires_grad=requires_grad)


def close(got, ref, atol, rtol=0.0, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol, err_msg=msg)


def jcfg(cfg, **over):
    """The ctpa config with the field values of a port config."""
    jtype = {tc.CTViTConfig: jc.CTViTConfig, tc.BertConfig: jc.BertConfig}[type(cfg)]
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return jtype(**{**kw, **over})


def np_params(tree, seed):
    """Numpy draws for a flax param tree: gains near 1, Dense kernels at
    1/sqrt(fan_in), everything else (biases too) at 0.1."""
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


# ------------------------------------------------------- flash attention

def _attn_inputs(seed, b=2, h=3, n=20, m=13, d=16, bias_form="h"):
    rng = np.random.default_rng(seed)
    unit = lambda *s: (lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True))(rng.normal(size=s))
    q, k = unit(b, h, n, d), unit(b, h, m, d)
    v, do = rng.normal(size=(b, h, m, d)), rng.normal(size=(b, h, n, d))
    shape = {"h": (h, n, m), "1": (1, n, m), "bh": (b, h, n, m), None: None}[bias_form]
    bias = None if shape is None else rng.normal(size=shape)
    return [None if x is None else x.astype(np.float32) for x in (q, k, v, bias, do)]


@pytest.mark.parametrize("bias_form", ["h", "1", "bh"])
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("n", [20, 13])             # ragged against m = 13, and square
def test_flash_lse_and_backward_match_ctpa_dense(bias_form, bounded, n):
    q, k, v, bias, do = _attn_inputs(1, n=n, bias_form=bias_form)
    scale = 8.0
    tq, tk, tv, tb = (_t(x, requires_grad=True) for x in (q, k, v, bias))
    bound = (scale + float(bias.max())) if bounded else None
    out, lse = flash_attention(tq, tk, tv, bias=tb, scale=scale, logit_bound=bound,
                               return_lse=True)
    s = jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale + (bias[None] if bias.ndim == 3 else bias)
    close(lse, jax.nn.logsumexp(s, axis=-1), FA_ATOL, FA_RTOL)
    got = torch.autograd.grad(out, (tq, tk, tv, tb), grad_outputs=_t(do))
    ref = _dense_bwd(*map(jnp.asarray, (q, k, v, bias)), None, None, jnp.asarray(do),
                     causal=False, scale=scale)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        close(g, r, FA_ATOL, FA_RTOL)


@pytest.mark.parametrize("bias_form", [None, "h"])
def test_cosine_attention_grads_through_flash_match_ctpa(bias_form):
    """The composition the model runs: l2norm and the learned scales, then
    flash attention with the analytic bound, differentiated against
    jax.vjp of ctpa's cosine_attention."""
    q, k, v, bias, do = _attn_inputs(2, bias_form=bias_form)
    rng = np.random.default_rng(3)
    qs, ks = (1 + 0.1 * rng.normal(size=16)).astype(np.float32), \
        (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    args = [q, k, v, qs, ks] + ([] if bias is None else [bias])

    def jfn(q, k, v, qs, ks, bias=None):
        return jops.cosine_attention(q, k, v, q_scale=qs, k_scale=ks, scale=8.0, bias=bias)

    ref_out, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    ref = vjp(jnp.asarray(do))
    targs = [_t(x, requires_grad=True) for x in args]
    tq, tk, tv, tqs, tks = targs[:5]
    tb = targs[5] if bias is not None else None
    bound = 8.0 * tqs.abs().max() * tks.abs().max() + (0 if tb is None else tb.max())
    out = flash_attention((l2norm(tq) * tqs).contiguous(), (l2norm(tk) * tks).contiguous(), tv,
                          bias=tb, scale=8.0, logit_bound=bound)
    close(out, ref_out, FA_ATOL, FA_RTOL)
    for g, r in zip(torch.autograd.grad(out, targs, grad_outputs=_t(do)), ref):
        close(g, r, FA_ATOL, FA_RTOL)


def test_flash_bwd_wrapper_checks_and_plain_dispatch():
    q, k, v, bias, do = (_t(x) for x in _attn_inputs(4))
    out, lse = flash_attention_plain(q, k, v, bias, 8.0, return_lse=True)
    before = dict(LAUNCHES)
    got = flash_attention_bwd(q, k, v, bias, out, lse, do, 8.0)
    assert LAUNCHES == before          # CPU tensors take the plain version
    for g, r in zip(got, flash_attention_bwd_plain(q, k, v, bias, out, lse, do, 8.0)):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    assert flash_attention_bwd(q, k, v, bias, out, lse, do, 8.0, need_dbias=False)[3] is None
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, bias, out, lse[..., :-1].contiguous(), do, 8.0)
    with pytest.raises(ValueError, match="must match"):
        flash_attention_bwd(q, k, v, bias, out.double(), lse, do, 8.0)
    # no input requires grad: the forward returns the logsumexp without autograd
    o2, l2 = flash_attention(q, k, v, bias=bias, scale=8.0, return_lse=True)
    assert not o2.requires_grad and torch.equal(l2, lse)


# --------------------------------------------------------- small modules

def test_patchify_kernel_path_refuses_gradients():
    video = torch.tensor(np.random.default_rng(5).uniform(
        -1, 1, size=(1, 1, VIT.temporal_size, VIT.image_size, VIT.image_size)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    plain = PatchEmbed3D(VIT)
    with torch.no_grad():
        for p in plain.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen) + (p.ndim == 1))
    fast = PatchEmbed3D(dataclasses.replace(VIT, pallas_patchify=True))
    fast.load_state_dict(plain.state_dict())
    with pytest.raises(RuntimeError, match="forward-only"):
        fast(video)
    with torch.no_grad():
        torch.testing.assert_close(fast(video), plain(video), atol=1e-4, rtol=0)


def test_ema_update_matches_ctpa():
    rng = np.random.default_rng(6)
    K, d = 12, 8
    cb = rng.normal(size=(K, d)).astype(np.float32)
    cluster = np.abs(rng.normal(size=K)).astype(np.float32)
    cluster[:3] = 0.0                              # dead codes stay where they are
    state = (cb, cluster, rng.normal(size=(K, d)).astype(np.float32))
    counts = rng.integers(0, 4, size=K).astype(np.float32)
    counts[:3] = 0.0
    sums = rng.normal(size=(K, d)).astype(np.float32)
    ref = j_ema(JVQState(*map(jnp.asarray, state)), jnp.asarray(counts), jnp.asarray(sums))
    got = ema_update(VQState(*map(_t, state)), _t(counts), _t(sums))
    for g, r in zip(got, ref):
        close(g, r, 1e-6, 1e-6)
    np.testing.assert_array_equal(got.codebook[:3].numpy(), cb[:3])


@pytest.mark.parametrize("decoupled", [False, True])
def test_infonce_loss_matches_ctpa(decoupled):
    sim = np.random.default_rng(7).normal(size=(5, 5)).astype(np.float32) * 3
    close(infonce_loss(_t(sim), decoupled=decoupled),
          j_infonce(jnp.asarray(sim), decoupled=decoupled), 1e-6)


@pytest.mark.parametrize("name,make", [
    ("cosine_warmup_restarts", lambda m: m.cosine_warmup_restarts(1e-3, T_0=3, T_warmup=2)),
    ("cosine_warmup_restarts T_mult 2", lambda m: m.cosine_warmup_restarts(
        1e-3, T_0=2, T_mult=2, T_warmup=1, gamma=0.5)),
    ("onecycle", lambda m: m.onecycle(1e-3, total_steps=6)),
])
def test_schedules_match_optax_at_steps_0_to_5(name, make):
    jsched, tsched = make(joptim), make(toptim)
    for step in range(6):
        assert tsched(step) == pytest.approx(float(jsched(step)), rel=1e-5, abs=1e-12), step
    if name == "cosine_warmup_restarts":
        assert tsched(0) == 0.0


@pytest.mark.parametrize("schedule", ["constant", "cosine_warmup_restarts", "onecycle", "cosine"])
def test_build_schedule_matches_ctpa(schedule):
    kw = dict(lr=1e-3, schedule=schedule, warmup_steps=2, total_steps=6, min_lr_ratio=0.1)
    jsched = joptim.build_schedule(jc.OptimizerConfig(**kw))
    tsched = toptim.build_schedule(tc.OptimizerConfig(**kw))
    for step in range(6):
        ref = jsched if isinstance(jsched, float) else float(jsched(step))
        assert tsched(step) == pytest.approx(ref, rel=1e-5, abs=1e-12), step


def test_precision_policy():
    assert policy("bf16") == Policy() and policy("fp32").compute_dtype == torch.float32
    with pytest.raises(ValueError):
        policy("fp8")
    tree = {"x": torch.ones(2), "ids": torch.ones(2, dtype=torch.long), "n": [torch.ones(1)]}
    out = Policy().cast_to_compute(tree)
    assert out["x"].dtype == torch.bfloat16 and out["ids"].dtype == torch.long
    assert out["n"][0].dtype == torch.bfloat16
    # the step computes in the policy's dtype: it sets the model's compute dtype
    model = torch.nn.Sequential(Dense(2, 2))
    make_clip_train_step(model, None, policy=policy("bf16"))
    assert model[0](torch.ones(1, 2)).dtype == torch.bfloat16
    make_clip_train_step(model, None, policy=policy("fp32"))
    assert model[0](torch.ones(1, 2)).dtype == torch.float32


def test_preprocess_batch_matches_ctpa():
    rng = np.random.default_rng(8)
    grid = (8, 12, 12)
    raws = rng.integers(-1024, 2000, size=(2, 10, 14, 16)).astype(np.float32)
    slopes = np.array([1.0, 0.5], np.float32)
    intercepts = np.array([-1024.0, 0.0], np.float32)
    spacings = np.array([[2.0, 0.9, 0.8], [1.5, 0.75, 0.75]], np.float32)
    jcfg_pre = dataclasses.replace(jc.PreprocessConfig.train(), target_shape=grid)
    tcfg_pre = dataclasses.replace(tc.PreprocessConfig.train(), target_shape=grid)
    ref = jpre.preprocess_batch(*map(jnp.asarray, (raws, slopes, intercepts, spacings)),
                                cfg=jcfg_pre)
    got = tpre.preprocess_batch(raws, slopes, intercepts, spacings, tcfg_pre, device="cpu")
    assert got.shape == (2, 1) + grid
    close(got, ref, 1e-5)
    src = np.array([[9, 14, 13], [10, 11, 16]], np.int32)
    ref = jpre.preprocess_batch_bucketed(*map(jnp.asarray, (raws, slopes, intercepts, spacings,
                                                              src)), cfg=jcfg_pre)
    got = tpre.preprocess_batch_bucketed(raws, slopes, intercepts, spacings, src, tcfg_pre,
                                         device="cpu")
    close(got, ref, 1e-5)


def test_checkpoint_manager_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore() is None
    for step in (1, 2, 3):
        mgr.save(step, {"w": torch.full((2,), float(step))})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert torch.equal(mgr.restore()["w"], torch.full((2,), 3.0))
    assert mgr.restore(2)["w"][0] == 2.0
    with pytest.raises(FileExistsError):
        mgr.save(3, {})
    mgr.save(3, {"w": torch.zeros(1)}, force=True)
    assert mgr.restore(3)["w"].shape == (1,)
    mgr.wait()
    mgr.close()


# ------------------------------------------------------- model and slice

@pytest.fixture(scope="module")
def clip_pair():
    """ctpa's tiny CTCLIP (plain attention) with numpy weights and its VQ
    state, and the same weights carried into the port."""
    jclip_cfg = jc.CTCLIPConfig.tiny(jcfg(VIT), jcfg(BERT))
    jm = JCLIP(jclip_cfg, jcfg(VIT), jcfg(BERT))
    batch = _batch(0)
    params = np_params(jm.init(KEY, batch["input_ids"], batch["attention_mask"],
                               batch["video"])["params"], 9)
    rng = np.random.default_rng(10)
    cb = rng.normal(size=(VIT.codebook_size, VIT.dim)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    vq = (cb, np.abs(rng.normal(size=VIT.codebook_size)).astype(np.float32), cb.copy())
    return jm, params, vq


def _batch(seed, b=2, seq=12):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, seq), np.int32)
    mask[1, 7:] = 0
    return {"input_ids": rng.integers(3, BERT.vocab_size, size=(b, seq)).astype(np.int32),
            "attention_mask": mask,
            "video": rng.uniform(-1, 1, size=(b, 1, VIT.temporal_size, VIT.image_size,
                                              VIT.image_size)).astype(np.float32)}


def _port(params, flash=True, remat=True):
    vit = dataclasses.replace(VIT, flash_axial=flash)
    model = CTCLIP(tc.CTCLIPConfig.tiny(vit, BERT), vit, BERT, device="cpu", remat=remat)
    return load_flax_params(model, jax.tree.map(np.asarray, params))


def _tbatch(batch):
    return {"input_ids": _t(batch["input_ids"]).long(), "attention_mask": _t(batch["attention_mask"]),
            "video": _t(batch["video"])}


@pytest.mark.parametrize("return_loss", [True, False])
def test_ctclip_forward_matches_ctpa(clip_pair, return_loss):
    jm, params, vq = clip_pair
    batch = _batch(11)
    ref = jm.apply({"params": params}, *map(jnp.asarray, batch.values()),
                   JVQState(*map(jnp.asarray, vq)), return_loss=return_loss)
    with torch.no_grad():
        got = _port(params)(*_tbatch(batch).values(), vq_state_from_numpy(vq, device="cpu"),
                            return_loss=return_loss)
    if return_loss:
        close(got.loss, ref.loss, 1e-5)
    close(got.sim, ref.sim, 1e-5)
    close(got.vq_counts, ref.vq_counts, 0)
    close(got.vq_sums, ref.vq_sums, 1e-5)


def _mask_by_name(params, mask):
    """A flax bool tree beside its params -> {torch parameter name: bool}."""
    full = jax.tree.map(lambda p, m: np.full(np.shape(p), bool(m)), params, mask)
    return {k: bool(v.reshape(-1)[0]) for k, v in flax_to_state_dict(full).items()}


def test_finetune_mask_and_optimizer_groups_match_ctpa(clip_pair):
    _, params, _ = clip_pair
    model = _port(params)
    names = {id(p): n for n, p in model.named_parameters()}
    jmask = _mask_by_name(params, joptim.weight_decay_mask(params))
    assert toptim.weight_decay_mask(model) == jmask
    tx = toptim.get_optimizer(tc.OptimizerConfig(), model)
    decay, no_decay = tx.opt.param_groups
    assert {names[id(p)] for p in decay["params"]} == {k for k, v in jmask.items() if v}
    assert {names[id(p)] for p in no_decay["params"]} == {k for k, v in jmask.items() if not v}
    assert decay["weight_decay"] == 1e-2 and no_decay["weight_decay"] == 0.0
    jfreeze = _mask_by_name(params, j_finetune_mask(params))
    assert clip_finetune_mask(model) == jfreeze
    frozen = toptim.get_optimizer(tc.OptimizerConfig(), model, trainable=jfreeze)
    assert {names[id(p)] for p in frozen.params} == {k for k, v in jfreeze.items() if v}


LR = 1e-3
# Adam's first updates are lr * g / (|g| + eps) with eps 1e-8: an element
# whose gradient is fp32 noise (|g| ~ 1e-9, e.g. attention key biases, whose
# gradient is zero in exact arithmetic: softmax ignores a per-row shift)
# turns a 1e-9 difference in the order of sums into a difference of order
# lr.  Parameters are held to 1e-6 abs where every step's gradient is 0 or
# at least ADAM_SENSITIVE_BELOW in magnitude (there a gradient within its
# own tolerance moves the update by < 1e-7); elsewhere by the largest step
# Adam can take, and those elements must stay a small share.
ADAM_SENSITIVE_BELOW = 1e-5


@pytest.fixture(scope="module")
def jax_two_steps(clip_pair):
    """ctpa's jitted step, twice, and its gradients at each step."""
    jm, params, vq = clip_pair
    pol = JPolicy(compute_dtype=jnp.float32)
    tx = joptim.get_optimizer(jc.OptimizerConfig(lr=LR))
    state = JState.create({"params": params}, tx, JVQState(*map(jnp.asarray, vq)))
    step = jax.jit(j_make_step(jm, tx, policy=pol))

    def loss(p, vq_state, b):
        return jm.apply(p, b["input_ids"], b["attention_mask"], pol.cast_to_compute(b["video"]),
                        vq_state, return_loss=True).loss

    grad = jax.jit(jax.grad(loss))
    metrics, grads = [], []
    for seed in (12, 13):
        batch = jax.tree.map(jnp.asarray, _batch(seed))
        g = grad(state.params, state.vq_state, batch)["params"]
        grads.append(flax_to_state_dict(jax.tree.map(np.asarray, g)))
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, grads


@pytest.mark.parametrize("flash,remat", [(True, True), (False, False)])
def test_train_steps_match_ctpa(clip_pair, jax_two_steps, flash, remat):
    """One and two steps of make_clip_train_step: the port (flash_axial
    through the autograd Function on the CPU with remat on, or the plain
    path) against ctpa's plain path, fp32, batch 2, AdamW lr 1e-3, clip 0.5."""
    _, params, vq = clip_pair
    jstate, jmetrics, jgrads = jax_two_steps
    model = _port(params, flash=flash, remat=remat)
    tx = toptim.get_optimizer(tc.OptimizerConfig(lr=LR), model)
    state = CLIPTrainState.create(model, tx, vq_state_from_numpy(vq, device="cpu"))
    step = make_clip_train_step(model, tx, policy=policy("fp32"))
    clip = tc.OptimizerConfig().grad_clip_norm
    for i, seed in enumerate((12, 13)):
        state, m = step(state, _tbatch(_batch(seed)))
        for key in ("loss", "grad_norm", "temperature", "vq_commit"):
            close(m[key], jmetrics[i][key], 0, 1e-5, msg=key)
        if i == 0:
            # from the same parameters, every gradient element agrees; p.grad
            # holds the clipped gradient, so the clip is undone to compare
            unclip = max(float(m["grad_norm"]) / clip, 1.0)
            for name, p in model.named_parameters():
                close(p.grad * unclip, jgrads[0][name], 1e-6, 1e-4, msg=f"grad {name}")
    assert state.step == 2
    for g, r in zip(state.vq_state, jstate.vq_state):
        close(g, r, 1e-5)
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params["params"]))
    got = model.state_dict()
    assert set(got) == set(ref)
    sensitive = total = 0
    for key in ref:
        noisy = np.zeros(ref[key].shape, bool)
        for g in jgrads:
            noisy |= (g[key] != 0) & (np.abs(g[key]) < ADAM_SENSITIVE_BELOW)
        diff = np.abs(got[key].numpy() - ref[key])
        assert diff[~noisy].max(initial=0) <= 1e-6, key
        assert diff[noisy].max(initial=0) <= 2 * 2 * LR, key
        sensitive, total = sensitive + noisy.sum(), total + noisy.size
    assert sensitive <= 0.01 * total, (sensitive, total)


def test_optimizer_matches_optax_on_the_same_gradients():
    """The update alone, from identical gradients (noise-sized ones, exact
    zeros and a clipped step included), on every element: 1e-6 abs."""
    rng = np.random.default_rng(14)
    shapes = {"w": (6, 5), "emb": (4, 3), "b": (5,), "t": ()}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    cfg = dict(lr=1e-2, schedule="cosine", warmup_steps=1, total_steps=5)
    jtx = joptim.get_optimizer(jc.OptimizerConfig(**cfg), params)
    jparams = jax.tree.map(jnp.asarray, params)
    jopt = jtx.init(jparams)
    model = nn_module(params)
    tx = toptim.get_optimizer(tc.OptimizerConfig(**cfg), model)
    for step in range(4):
        scale = 10.0 if step == 1 else 1e-2          # step 1: the clip triggers
        grads = {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in shapes.items()}
        grads["b"][:2] = [1e-9, -3e-10]
        grads["emb"][0] = 0.0
        updates, jopt = jtx.update(jax.tree.map(jnp.asarray, grads), jopt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, p in model.named_parameters():
            p.grad = _t(grads[name])
        tx.step(step)
        for name, p in model.named_parameters():
            close(p, jparams[name], 1e-6, msg=f"step {step} {name}")


def nn_module(arrays):
    """A module whose parameters are the given arrays, under their keys."""
    module = torch.nn.Module()
    for name, value in arrays.items():
        module.register_parameter(name, torch.nn.Parameter(_t(value)))
    return module


def test_trainer_steps_saves_and_resumes(clip_pair, tmp_path):
    _, params, vq = clip_pair
    model = _port(params)
    tx = toptim.get_optimizer(tc.OptimizerConfig(lr=1e-3), model)
    state = CLIPTrainState.create(model, tx, vq_state_from_numpy(vq, device="cpu"))
    loader = iter([_batch(20), _batch(21), _batch(22)])
    cfg = tc.TrainConfig(num_train_steps=2, save_model_every=1000, save_results_every=1000,
                         results_dir=str(tmp_path / "res"), checkpoint_dir=str(tmp_path / "ckpt"),
                         precision="fp32")
    trainer = CTClipTrainer(model, state, loader, cfg=cfg,
                            opt_cfg=tc.OptimizerConfig(lr=1e-3))
    last = trainer.train()
    assert trainer.state.step == 2 and np.isfinite(last["loss"])
    assert trainer.ckpt.all_steps() == [2]
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.train_step()
    assert trainer.state.step == 3
    trainer.load(2)
    assert trainer.state.step == 2
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, saved[k], atol=0, rtol=0)
    trainer.close()
    # data parallelism is ported (tests/test_torch_parallel.py): over a
    # one-rank mesh the trainer steps as without one
    dp = CTClipTrainer(model, trainer.state, iter([_batch(22)]), cfg=cfg,
                       mesh=single_device_mesh("cpu"))
    assert dp.mesh is not None and np.isfinite(float(dp.train_step()["loss"]))
    # the MLM objective and the CLIP variants are ported
    # (tests/test_torch_clip_variants.py)
    make_clip_train_step(model, tx, use_mlm=True)
    assert CTCLIP(dataclasses.replace(tc.CTCLIPConfig.tiny(VIT, BERT), use_all_token_embeds=True),
                  VIT, BERT, device="cpu").cfg.use_all_token_embeds
    frozen = CTClipTrainer(model, trainer.state, iter([_batch(23)]), cfg=cfg,
                           trainable_mask=clip_finetune_mask)
    before = model.to_visual_latent.weight.detach().clone()
    frozen.train_step()
    torch.testing.assert_close(model.to_visual_latent.weight, before, atol=0, rtol=0)


# ------------------------------------------------------- precision modes and the clip

# bf16 mode against ctpa's CTCLIP(dtype=jnp.bfloat16), plain attention on
# both sides.  bf16 rounds at other places in the two frameworks (XLA keeps
# some fused intermediates in fp32), so the bounds are bf16 ones: loss 5e-3
# abs, the fp32 similarity 5e-2 abs, latent cosine >= 0.999, and every
# first-step gradient tensor cosine >= 0.995 except those that are zero in
# exact arithmetic (attention key biases and the CPB's per-head bias, which
# softmax ignores; in bf16 they are pure rounding noise).
BF16_LOSS_ATOL, BF16_SIM_ATOL, BF16_LATENT_COS, BF16_GRAD_COS = 5e-3, 5e-2, 0.999, 0.995
SOFTMAX_INVARIANT = ("attention_self.key.bias", "spatial_rel_pos_bias.to_heads.bias")


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def test_bf16_mode_matches_ctpa_bf16_ctclip(clip_pair):
    jm0, params, vq = clip_pair
    jm = JCLIP(jm0.cfg, jm0.vit_cfg, jm0.bert_cfg, dtype=jnp.bfloat16)
    batch = _batch(12)

    def loss(p, vq_state, b):
        out = jm.apply(p, b["input_ids"], b["attention_mask"],
                       JPolicy().cast_to_compute(b["video"]), vq_state, return_loss=True)
        return out.loss, out

    (_, ref), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {"params": params}, JVQState(*map(jnp.asarray, vq)), jax.tree.map(jnp.asarray, batch))
    jgrad = flax_to_state_dict(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                            jgrad["params"]))
    model = _port(params, flash=False, remat=False)
    tx = toptim.get_optimizer(tc.OptimizerConfig(lr=LR), model)
    state = CLIPTrainState.create(model, tx, vq_state_from_numpy(vq, device="cpu"))
    outs = {}
    hooks = [m.register_forward_hook(lambda m, i, o, key=key: outs.setdefault(key, o))
             for key, m in (("peg", model.visual_transformer.enc_spatial_transformer.pegs[0]),
                            ("gamma_ln", model.visual_transformer.enc_spatial_transformer.norm_out),
                            ("affine_ln", model.text_transformer.embeddings.LayerNorm),
                            ("block", model.visual_transformer.enc_temporal_transformer.blocks[0]),
                            ("bert_layer", model.text_transformer.layers[0]),
                            ("ctclip", model))]
    _, m = make_clip_train_step(model, tx, policy=policy("bf16"))(state, _tbatch(batch))
    for h in hooks:
        h.remove()
    for key in ("peg", "gamma_ln", "affine_ln", "block", "bert_layer"):
        assert outs[key].dtype == torch.bfloat16, key
    assert model.visual_transformer.enc_spatial_transformer.pegs[0].kernel.dtype == torch.float32
    got = outs["ctclip"]
    assert got.sim.dtype == torch.float32 and got.text_latents.dtype == torch.bfloat16
    close(m["loss"], ref.loss, BF16_LOSS_ATOL)
    close(got.sim, ref.sim, BF16_SIM_ATOL)
    for key in ("text_latents", "image_latents"):
        for g, r in zip(getattr(got, key).float(), np.asarray(getattr(ref, key), np.float32)):
            assert _cos(g.detach(), r) >= BF16_LATENT_COS, key
    unclip = max(float(m["grad_norm"]) / tc.OptimizerConfig().grad_clip_norm, 1.0)
    for name, p in model.named_parameters():
        if not name.endswith(SOFTMAX_INVARIANT):
            assert _cos(p.grad * unclip, jgrad[name]) >= BF16_GRAD_COS, name


def test_fp32_mode_computes_in_fp32(clip_pair):
    _, params, vq = clip_pair
    model = _port(params, flash=False, remat=False)
    tx = toptim.get_optimizer(tc.OptimizerConfig(lr=LR), model)
    step = make_clip_train_step(model, tx, policy=policy("fp32"))
    seen = []
    hook = model.visual_transformer.enc_spatial_transformer.pegs[0].register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    step(CLIPTrainState.create(model, tx, vq_state_from_numpy(vq, device="cpu")),
         _tbatch(_batch(12)))
    hook.remove()
    assert seen == [torch.float32]


@pytest.mark.parametrize("scale", [1e-2, 10.0])
def test_clip_scale_matches_optax(scale):
    """Below and above the threshold: the clipped gradients to 1e-6."""
    rng = np.random.default_rng(15)
    grads = {k: (scale * rng.normal(size=s)).astype(np.float32)
             for k, s in {"w": (6, 5), "b": (5,), "t": ()}.items()}
    clip = tc.OptimizerConfig().grad_clip_norm
    tx = optax.clip_by_global_norm(clip)
    ref, _ = tx.update(jax.tree.map(jnp.asarray, grads), tx.init(grads))
    tgrads = [_t(grads[k]) for k in grads]
    norm = toptim.global_norm(tgrads)
    close(norm, optax.global_norm(jax.tree.map(jnp.asarray, grads)), 0, 1e-6)
    factor = toptim.clip_scale(norm, clip)
    assert torch.is_tensor(factor) and (float(factor) == 1.0) == (scale < 1)
    for key, g in zip(grads, tgrads):
        close(g * factor, ref[key], 1e-6)


@pytest.mark.parametrize("frozen", [False, True])
def test_optimizer_clips_by_the_trainable_norm(frozen):
    """The caller's whole-model norm is the clip's norm unless a parameter
    is frozen; then the clip uses the trainable gradients' own norm, as
    optax's multi_transform does.  Gradients above the threshold; the clip
    scales ``p.grad`` in place, so the clipped gradients are read there."""
    torch.manual_seed(3)
    clip = tc.OptimizerConfig().grad_clip_norm
    model = torch.nn.Sequential(torch.nn.Linear(5, 4), torch.nn.Linear(4, 3))
    trainable = {n: not (frozen and n.startswith("1.")) for n, _ in model.named_parameters()}
    grads = [10.0 * torch.randn_like(p) for p in model.parameters()]
    for p, g in zip(model.parameters(), grads):
        p.grad = g.clone()
    tx = toptim.get_optimizer(tc.OptimizerConfig(lr=LR), model, trainable=trainable)
    tx.step(0, grad_norm=toptim.global_norm(grads))
    kept = [g for (n, _), g in zip(model.named_parameters(), grads) if trainable[n]]
    factor = toptim.clip_scale(toptim.global_norm(kept), clip)
    assert float(factor) < 1
    for (n, p), g in zip(model.named_parameters(), grads):
        torch.testing.assert_close(p.grad, g * factor if trainable[n] else g, atol=1e-6, rtol=0)


_SYNCS = ("__bool__", "item", "__float__", "__int__", "tolist")


def test_train_step_makes_no_host_sync(clip_pair, monkeypatch):
    """No bool(), if, .item() or float() on a tensor inside the step.  The
    one exception is Adam's step counter, which PyTorch keeps on the host
    (a CPU tensor also beside CUDA parameters) and reads with .item()."""
    _, params, vq = clip_pair
    model = _port(params)
    tx = toptim.get_optimizer(tc.OptimizerConfig(lr=LR), model)
    step = make_clip_train_step(model, tx, policy=policy("bf16"))
    state = CLIPTrainState.create(model, tx, vq_state_from_numpy(vq, device="cpu"))
    state, _ = step(state, _tbatch(_batch(12)))          # creates Adam's state
    counters = {id(s["step"]) for s in tx.opt.state.values()}
    calls = []

    def guard(name):
        original = getattr(torch.Tensor, name)

        def patched(self, *args, **kwargs):
            if id(self) not in counters:
                calls.append(name)
                raise AssertionError(f"host sync: Tensor.{name} in train_step")
            return original(self, *args, **kwargs)
        return patched

    batch = _tbatch(_batch(13))
    for name in _SYNCS:
        monkeypatch.setattr(torch.Tensor, name, guard(name))
    norms = []
    real_norm = toptim.global_norm
    monkeypatch.setattr("ctpa_torch.train.clip_trainer.global_norm",
                        lambda g: norms.append(1) or real_norm(g))
    monkeypatch.setattr(toptim, "global_norm", lambda g: norms.append(1) or real_norm(g))
    state, m = step(state, batch)
    monkeypatch.undo()
    assert not calls and state.step == 2
    assert len(norms) == 1                               # one global norm a step
    assert np.isfinite(float(m["loss"]))
