"""The port's report-training slice against ctpa's, on the CPU.

The same numpy-seeded inputs and weights go through ctpa's function and
the port's.  On the CPU the flash wrappers take their plain versions; ctpa's
Pallas flash kernel runs in interpret mode (with synchronous CPU dispatch
for this module, as ``tests/conftest.py`` sets for ctpa's own interpret
tests), and elsewhere ctpa's dense references stand in for it.  The CUDA
kernels are held against the same plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances, fp32 on both sides, differing only in the order of sums:
  * flash attention, forward, logsumexp and every gradient: 1e-5 abs +
    1e-4 rel (as for the unmasked forms);
  * the LLM's logits, flash prefill against ctpa's dense path: 2e-4 abs +
    rel, the bound of ctpa's own LLM tests; the LoRA gradients through
    them 2e-4 rel plus 2e-4 of each tensor's largest element (its elements
    are sums of terms of that size, so fp32 cancellation scales with it);
  * the losses: 1e-5 rel; the LoRA helpers: 1e-6 abs;
  * the partitioned step: loss and grad norm 1e-5 rel, every first-step
    trainable gradient 1e-6 abs + 1e-4 rel, the parameters after two steps
    1e-6 abs + 1e-5 rel where Adam's update is not decided by noise (see
    ``test_partitioned_steps_match_ctpa``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ctpa.core import config as jc
from ctpa.models import llm as jllm
from ctpa.models import lora as jlora
from ctpa.models import report_generator as jrg
from ctpa.ops.pallas import flash_attention as jfa
from ctpa.train import report_trainer as jrt
from ctpa.train.train_state import SimpleTrainState as JState
from ctpa_torch.convert import flax_to_state_dict, load_flax_params
from ctpa_torch.core import config as tc
from ctpa_torch.models import llm as tllm
from ctpa_torch.models import lora as tlora
from ctpa_torch.models.report_generator import CTReportGenerator
from ctpa_torch.ops import flash_attention as tfa
from ctpa_torch.train import report_trainer as trt
from ctpa_torch.train.train_state import SimpleTrainState

torch.set_num_threads(1)
KEY = jax.random.key(0)
FA_ATOL, FA_RTOL = 1e-5, 1e-4
LLM_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _sync_dispatch():
    """ctpa's interpreted Pallas kernel deadlocks under asynchronous CPU
    dispatch (tests/conftest.py); this module turns it off while it runs."""
    before = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", before)


def _t(x, requires_grad=False):
    t = torch.from_numpy(np.array(x))
    return t.requires_grad_() if requires_grad else t


def close(got, ref, atol, rtol=0.0, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol, err_msg=msg)


# ------------------------------------------------------- K2 and K3: masked forms

MASK_FORMS = {
    "causal": dict(causal=True),
    "causal q_offset": dict(causal=True, q_offset=4),
    "kv right padding": dict(kv="pad"),
    "kv inner holes": dict(kv="holes"),
    "causal kv inner holes": dict(causal=True, kv="holes"),
}


def _masked_inputs(seed, form, bias_form, d, b=2, h=2, n=21, m=27):
    """q, k, v, bias, dO and the masks of one form; n and m ragged.  Inner
    holes include key 0, so with causal row 0 has no valid key."""
    rng = np.random.default_rng(seed)
    q, k = rng.normal(size=(b, h, n, d)), rng.normal(size=(b, h, m, d))
    v, do = rng.normal(size=(b, h, m, d)), rng.normal(size=(b, h, n, d))
    shape = {"h": (h, n, m), "1": (1, n, m), "bh": (b, h, n, m), None: None}[bias_form]
    bias = None if shape is None else rng.normal(size=shape)
    spec = MASK_FORMS[form]
    kv = None
    if spec.get("kv") == "pad":
        kv = np.arange(m)[None] < np.array([[m], [m - 9]])
    elif spec.get("kv") == "holes":
        kv = rng.uniform(size=(b, m)) > 0.3
        kv[:, 0] = False
        kv[1, 5:11] = False
    f32 = [None if x is None else x.astype(np.float32) for x in (q, k, v, bias, do)]
    return (*f32, spec.get("causal", False), kv, spec.get("q_offset"))


def _dense(q, k, v, bias, causal, kv, q_offset, scale):
    """ctpa's dense masked attention: out and the row logsumexp."""
    n, m = q.shape[2], k.shape[2]
    s = jnp.einsum("bhnd,bhmd->bhnm", q, k) * scale
    if bias is not None:
        s = s + (bias[None] if bias.ndim == 3 else bias)
    valid = jnp.ones((1, 1, n, m), bool)
    if causal:
        valid = valid & (jnp.arange(m)[None, :] <= jnp.arange(n)[:, None] + (q_offset or 0))
    if kv is not None:
        valid = valid & (kv[:, None, None, :] > 0)
    s = jnp.where(valid, s, jfa.NEG_INF)
    return jnp.einsum("bhnm,bhmd->bhnd", jax.nn.softmax(s, -1), v), jax.nn.logsumexp(s, -1)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("bias_form", [None, "h", "1", "bh"])
@pytest.mark.parametrize("form", list(MASK_FORMS))
def test_flash_masked_forms_match_ctpa_dense(form, bias_form, d):
    """Forward, logsumexp and the gradients of q, k, v and the bias through
    the port's autograd function (the plain versions on the CPU) against
    ctpa's dense masked attention: its softmax and logsumexp, ``_dense_bwd``
    (with a bias) and ``jax.vjp`` (without)."""
    q, k, v, bias, do, causal, kv, qo = _masked_inputs(7, form, bias_form, d)
    scale = d ** -0.5
    leaves = [_t(x, requires_grad=True) for x in (q, k, v, bias) if x is not None]
    tb = leaves[3] if bias is not None else None
    out, lse = tfa.flash_attention(*leaves[:3], bias=tb, causal=causal, scale=scale,
                                   kv_mask=None if kv is None else _t(kv), q_offset=qo,
                                   return_lse=True)
    jargs = [None if x is None else jnp.asarray(x) for x in (q, k, v, bias)]
    jkv = None if kv is None else jnp.asarray(kv)
    ref_out, ref_lse = _dense(*jargs, causal, jkv, qo, scale)
    close(out, ref_out, FA_ATOL, FA_RTOL, "out")
    close(lse, ref_lse, FA_ATOL, FA_RTOL, "lse")
    got = torch.autograd.grad(out, leaves, grad_outputs=_t(do))
    if bias is not None:
        ref = jfa._dense_bwd(*jargs, jkv, None if qo is None else jnp.asarray(qo),
                             jnp.asarray(do), causal=causal, scale=scale)
    else:
        _, vjp = jax.vjp(lambda *a: _dense(*a, None, causal, jkv, qo, scale)[0], *jargs[:3])
        ref = vjp(jnp.asarray(do))
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        assert g.shape == r.shape
        close(g, r, FA_ATOL, FA_RTOL, name)


def test_flash_row_without_valid_key_matches_dense_bwd():
    """Rows with no valid key (causal with a negative q_offset, and a batch
    item whose keys are all masked): the output is the mean of v, the
    logsumexp NEG_INF, and the gradients are those of ctpa's _dense_bwd."""
    q, k, v, bias, do, _, _, _ = _masked_inputs(8, "causal", "h", 16)
    kv = np.ones((2, k.shape[2]), bool)
    kv[1] = False
    for causal, qo, mask in ((True, -3, None), (False, None, kv)):
        leaves = [_t(x, requires_grad=True) for x in (q, k, v, bias)]
        out, lse = tfa.flash_attention(*leaves[:3], bias=leaves[3], causal=causal, scale=0.25,
                                       kv_mask=None if mask is None else _t(mask), q_offset=qo,
                                       return_lse=True)
        empty = (lse == tfa.NEG_INF)
        assert empty.any()
        rows = out[empty]
        mean_v = _t(v).mean(2, keepdim=True).expand_as(out)[empty]
        close(rows, mean_v.detach().numpy(), FA_ATOL, FA_RTOL)
        jargs = [jnp.asarray(x) for x in (q, k, v, bias)]
        ref = jfa._dense_bwd(*jargs, None if mask is None else jnp.asarray(mask),
                             None if qo is None else jnp.asarray(qo), jnp.asarray(do),
                             causal=causal, scale=0.25)
        for g, r in zip(torch.autograd.grad(out, leaves, grad_outputs=_t(do)), ref):
            close(g, r, FA_ATOL, FA_RTOL)


@pytest.mark.parametrize("form", ["causal q_offset", "causal kv inner holes", "kv right padding"])
def test_flash_masked_forward_matches_ctpa_interpreted_kernel(form):
    """ctpa's Pallas kernel itself, interpreted, at one small size (no row
    without a valid key: ctpa's kernel differs from its dense reference
    there): out and the logsumexp of ``_flash_call``."""
    q, k, v, bias, _, causal, kv, qo = _masked_inputs(9, form, "h", 16, n=40, m=37)
    if kv is not None:
        kv[:, 0] = True
    jargs = [jnp.asarray(x) for x in (q, k, v, bias)]
    with pltpu.force_tpu_interpret_mode():
        ref_out, ref_lse = jfa._flash_call(
            *jargs, None if kv is None else jnp.asarray(kv.astype(np.float32)),
            None if qo is None else jnp.asarray(qo, jnp.int32), None, causal=causal,
            block_q=None, block_k=None, scale=0.25, return_lse=True)
    out, lse = tfa.flash_attention(*(_t(x) for x in (q, k, v)), bias=_t(bias), causal=causal,
                                   scale=0.25, kv_mask=None if kv is None else _t(kv),
                                   q_offset=qo, return_lse=True)
    close(out, ref_out, FA_ATOL, FA_RTOL)
    close(lse.reshape(-1, q.shape[2]), ref_lse, FA_ATOL, FA_RTOL)


def test_flash_plain_dispatch_and_mask_checks():
    q, k, v, bias, do, causal, kv, qo = _masked_inputs(10, "causal kv inner holes", "h", 32)
    tq, tk, tv, tb, tdo = (_t(x) for x in (q, k, v, bias, do))
    masks = tfa.make_masks(causal, _t(kv), qo, 2, k.shape[2], "cpu")
    assert masks.kv_mask.dtype == torch.bool and masks.q_offset is None
    out, lse = tfa.flash_attention_plain(tq, tk, tv, tb, 0.5, return_lse=True, masks=masks)
    before = dict(tfa.LAUNCHES)
    got = tfa.flash_attention_bwd(tq, tk, tv, tb, out, lse, tdo, 0.5, masks=masks)
    assert tfa.LAUNCHES == before          # CPU tensors take the plain version
    ref = tfa.flash_attention_bwd_plain(tq, tk, tv, tb, out, lse, tdo, 0.5, masks=masks)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    # an int q_offset becomes a device scalar; an int 0/1 mask a bool one
    m2 = tfa.make_masks(True, _t(kv.astype(np.int64)), 3, 2, k.shape[2], "cpu")
    assert m2.q_offset.dtype == torch.int32 and m2.q_offset.ndim == 0
    assert torch.equal(m2.kv_mask, _t(kv))
    for bad in (dict(kv_mask=_t(kv)[:, :-1]), dict(q_offset=torch.tensor([1, 2])),
                dict(q_offset=1.5), dict(q_offset=torch.tensor(1.0))):
        with pytest.raises(ValueError):
            tfa.flash_attention(tq, tk, tv, causal=True, **bad)


# ------------------------------------------------------- shared tiny models

JLORA, TLORA = jc.LoRAConfig(rank=4, alpha=8.0), tc.LoRAConfig(rank=4, alpha=8.0)
JLLM = jc.LLMConfig.tiny()                                    # ctpa's dense path
TLLM = dataclasses.replace(tc.LLMConfig.tiny(), flash_prefill=True, flash_min_len=16)
JVIT, TVIT = jc.CTViTConfig.tiny(), tc.CTViTConfig.tiny()
LR = 1e-3
JGEN = jc.ReportGenConfig(vision_dim=24, lora=JLORA, llm_lr=LR, cross_attn_lr=LR)
TGEN = tc.ReportGenConfig(vision_dim=24, lora=TLORA, llm_lr=LR, cross_attn_lr=LR)
LENS = (48, 31)                   # right-padded to 48, as tests/test_flash_attention.py


def np_params(tree, seed):
    """Numpy draws for a flax param tree: gains near 1, everything else
    (lora_b included, so lora_a's gradient is not zero) at 0.2 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name in ("scale", "weight", "norm_in_scale"):
            val = 1 + 0.1 * rng.normal(size=shape)
        else:
            val = 0.2 * rng.normal(size=shape)
        return jnp.asarray(val, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _batch(seed, label_mask=False):
    rng = np.random.default_rng(seed)
    n = max(LENS)
    mask = (np.arange(n)[None] < np.array(LENS)[:, None]).astype(np.int32)
    out = {"video": rng.uniform(-1, 1, size=(2, 1, TVIT.temporal_size, TVIT.image_size,
                                             TVIT.image_size)).astype(np.float32),
           "input_ids": (rng.integers(1, JLLM.vocab_size, size=(2, n)) * mask).astype(np.int32),
           "attention_mask": mask}
    if label_mask:
        out["label_mask"] = (np.arange(n)[None] >= 10).astype(np.int32).repeat(2, 0)
    return out


def _tbatch(batch):
    return {k: _t(v).long() if k != "video" and k != "vision" else _t(v) for k, v in batch.items()}


def _by_name(tree_like, params):
    """ctpa's per-leaf values (labels, masks) under the port's parameter names."""
    codes = {v: i for i, v in enumerate(sorted({str(x) for x in jax.tree.leaves(tree_like)}))}
    filled = jax.tree.map(lambda lab, p: np.full(np.shape(p), codes[str(lab)]), tree_like, params)
    names = {i: v for v, i in codes.items()}
    return {k: names[int(np.ravel(v)[0])] for k, v in flax_to_state_dict(filled).items()}


@pytest.fixture(scope="module")
def gen_pair():
    jm = jrg.CTReportGenerator(JLLM, JVIT, JGEN, lora=JLORA)
    b = _batch(0)
    params = np_params(jax.eval_shape(lambda: jm.init(KEY, *(jnp.asarray(b[k]) for k in (
        "video", "input_ids", "attention_mask"))))["params"], 21)
    return jm, params


def _port(params, llm_cfg=TLLM):
    tm = CTReportGenerator(llm_cfg, TVIT, TGEN, lora=TLORA, device="cpu")
    return load_flax_params(tm, jax.tree.map(np.asarray, params))


# ------------------------------------------------------- the LLM's flash prefill

def test_llm_flash_prefill_matches_ctpa_dense(monkeypatch):
    """LlamaForCausalLM with flash_prefill (flash_min_len 16) at b 2, n 48,
    lengths 48/31: logits and the LoRA gradients against ctpa's dense path;
    every layer goes through flash_attention, causal with the key mask."""
    jm = jllm.LlamaForCausalLM(JLLM, lora=JLORA)
    b = _batch(1)
    ids, mask = jnp.asarray(b["input_ids"]), jnp.asarray(b["attention_mask"])
    params = np_params(jax.eval_shape(lambda: jm.init(KEY, ids, mask))["params"], 22)
    w = np.random.default_rng(2).normal(size=(2, max(LENS), JLLM.vocab_size)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jm.apply({"params": p}, ids, mask)[0] * w)

    ref_logits = jm.apply({"params": params}, ids, mask)[0]
    ref_grads = flax_to_state_dict(jax.tree.map(np.asarray, jax.grad(jloss)(params)))
    tm = load_flax_params(tllm.LlamaForCausalLM(TLLM, TLORA, device="cpu"),
                          jax.tree.map(np.asarray, params))
    calls = []
    real = tllm.flash_attention
    monkeypatch.setattr(tllm, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    logits = tm(_t(b["input_ids"]).long(), _t(b["attention_mask"]))[0]
    assert len(calls) == JLLM.num_layers
    assert all(kw["causal"] and kw["kv_mask"].dtype == torch.bool for kw in calls)
    close(logits, ref_logits, LLM_TOL, LLM_TOL)
    (logits * _t(w)).sum().backward()
    lora = [(n, p) for n, p in tm.named_parameters() if n.endswith(("lora_a", "lora_b"))]
    assert len(lora) == 2 * 4 * JLLM.num_layers
    for name, p in lora:
        scale = np.abs(ref_grads[name]).max()
        assert scale > 0
        # each element is a sum of terms up to the tensor's largest: the
        # bound is relative to that scale
        close(p.grad, ref_grads[name], LLM_TOL * scale, LLM_TOL, name)


# ------------------------------------------------------- losses and LoRA helpers

@pytest.mark.parametrize("from_vision", [False, True])
@pytest.mark.parametrize("label_mask", [False, True])
def test_losses_match_ctpa(gen_pair, from_vision, label_mask):
    jm, params = gen_pair
    b = _batch(3, label_mask)
    lm = b.get("label_mask")
    args = [jnp.asarray(b["input_ids"]), jnp.asarray(b["attention_mask"]),
            None if lm is None else jnp.asarray(lm)]
    tm = _port(params)
    targs = [_t(b["input_ids"]).long(), _t(b["attention_mask"]), None if lm is None else _t(lm)]
    with torch.no_grad():
        if from_vision:
            vision = np.random.default_rng(4).normal(size=(2, 24)).astype(np.float32)
            ref = jm.apply({"params": params}, jnp.asarray(vision), *args,
                           method=jrg.CTReportGenerator.loss_from_vision)
            got = tm.loss_from_vision(_t(vision), *targs)
        else:
            ref = jm.apply({"params": params}, jnp.asarray(b["video"]), *args,
                           method=jrg.CTReportGenerator.loss)
            got = tm.loss(_t(b["video"]), *targs)
    close(got, ref, 0, 1e-5)


def test_lora_helpers_match_ctpa(gen_pair):
    jm, params = gen_pair
    tm = _port(params)
    want = _by_name(jlora.lora_trainable_mask(params, ("cross_attention",)), params)
    assert tlora.lora_trainable_mask(tm, ("cross_attention",)) == {k: v == "True"
                                                                  for k, v in want.items()}
    assert any(v == "True" for v in want.values()) and any(v == "False" for v in want.values())
    ref = flax_to_state_dict(jax.tree.map(np.asarray, jlora.merge_lora_scaled(
        params, JLORA.alpha, JLORA.rank)))
    got = tlora.merge_lora_scaled(tm.state_dict(), TLORA.alpha, TLORA.rank)
    assert set(got) == set(ref)
    for key, value in got.items():
        close(value, ref[key], 1e-6, 0, key)
    merged = _port(params)
    merged.load_state_dict(got)
    b = _tbatch(_batch(5))
    with torch.no_grad():                      # the merged model computes the same function
        close(merged.loss(b["video"], b["input_ids"], b["attention_mask"]),
              tm.loss(b["video"], b["input_ids"], b["attention_mask"]).numpy(), 0, 1e-5)


def test_trainable_labels_match_ctpa(gen_pair):
    """Equal label sets; as in ctpa, the vision projection stays frozen (its
    names never match ctpa's keystr paths; report_trainer.py)."""
    _, params = gen_pair
    tm = _port(params)
    labels = trt.trainable_labels(tm)
    assert labels == _by_name(jrt.trainable_labels({"params": params})["params"], params)
    assert {"head", "llm", "frozen"} == set(labels.values())
    assert labels["vision_feature_extractor.proj.weight"] == "frozen"


# ------------------------------------------------------- the partitioned step

ADAM_SENSITIVE_BELOW = 1e-5


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads(jm, params, batch):
    """ctpa's gradients of the loss, under the port's parameter names."""
    g = jax.grad(lambda p: jm.apply(p, *(jnp.asarray(batch[k]) for k in (
        "video", "input_ids", "attention_mask")), method=jrg.CTReportGenerator.loss))(params)
    return flax_to_state_dict(jax.tree.map(np.asarray, g["params"]))


@pytest.fixture(scope="module")
def ctpa_two_steps(gen_pair):
    """Two steps of ctpa's partitioned step from the shared parameters: per
    step the batch, the gradients, the metrics and the parameters after."""
    jm, params = gen_pair
    full = {"params": params}
    step_fn, opt0 = jrt.make_partitioned_report_step(jm, full, JGEN, total_steps=10)
    step_fn = jax.jit(step_fn)
    state = JState(params=full, opt_state=opt0, step=jnp.zeros((), jnp.int32))
    out = []
    for seed in (30, 31):
        batch = _batch(seed)
        grads = _grads(jm, state.params, batch)
        state, m = step_fn(state, _jbatch(batch))
        out.append((batch, grads, {k: float(v) for k, v in m.items()},
                    flax_to_state_dict(jax.tree.map(np.asarray, state.params["params"]))))
    return out


def test_partitioned_steps_match_ctpa(gen_pair, ctpa_two_steps):
    """Loss and grad norm at both steps; every first-step trainable gradient
    (as clipped, the step clips in place); the frozen parameters get no
    gradient and do not move; the parameters after two steps.  Adam's first
    steps are lr * g / (|g| + 1e-8): where a gradient is fp32 noise
    (0 < |g| < 1e-5 at either step) summation-order differences decide its
    sign, so those elements (asserted under 1%) are held to the largest move
    Adam can make in two steps, the rest (exact zeros included: the
    cross-attention's q and k, a softmax over one key) to 1e-6 abs + 1e-5
    rel."""
    _, params = gen_pair
    tm = _port(params)
    labels = trt.trainable_labels(tm)
    start = {n: p.detach().clone() for n, p in tm.named_parameters()}
    step, tx = trt.make_partitioned_report_step(tm, TGEN, total_steps=10)
    state = SimpleTrainState.create(tm, tx)
    for i, (batch, ref_grads, ref_m, _) in enumerate(ctpa_two_steps):
        state, m = step(state, _tbatch(batch))
        close(m["loss"], ref_m["loss"], 0, 1e-5, "loss")
        close(m["grad_norm"], ref_m["grad_norm"], 0, 1e-5, "grad norm")
        if i == 0:
            clip = min(1.0, 1.0 / ref_m["grad_norm"])
            for name, p in tm.named_parameters():
                if labels[name] == "frozen":
                    assert p.grad is None and not p.requires_grad, name
                else:
                    close(p.grad, ref_grads[name] * clip, 1e-6, 1e-4, name)
    assert state.step == 2
    ref_p = ctpa_two_steps[-1][3]
    noisy = total = 0
    for name, p in tm.named_parameters():
        if labels[name] == "frozen":
            assert torch.equal(p, start[name]), name
            continue
        small = np.zeros(p.shape, bool)
        for _, ref_grads, _, _ in ctpa_two_steps:
            small |= (ref_grads[name] != 0) & (np.abs(ref_grads[name]) < ADAM_SENSITIVE_BELOW)
        got, want = p.detach().numpy(), ref_p[name]
        np.testing.assert_allclose(got[~small], want[~small], atol=1e-6, rtol=1e-5, err_msg=name)
        assert np.abs(got[small] - want[small]).max(initial=0) <= 2 * 2 * LR, name
        noisy, total = noisy + small.sum(), total + small.size
    assert noisy < 0.01 * total


_SYNCS = ("__bool__", "item", "__float__", "__int__", "tolist")


def test_partitioned_step_makes_no_host_sync(gen_pair, monkeypatch):
    """No bool(), if, .item() or float() on a tensor inside the step, but for
    Adam's step counter, which PyTorch keeps on the host."""
    _, params = gen_pair
    tm = _port(params)
    step, tx = trt.make_partitioned_report_step(tm, TGEN, total_steps=10)
    state, _ = step(SimpleTrainState.create(tm, tx), _tbatch(_batch(32)))
    counters = {id(s["step"]) for s in tx.opt.state.values()}
    calls = []

    def guard(name):
        original = getattr(torch.Tensor, name)

        def patched(self, *args, **kwargs):
            if id(self) not in counters:
                calls.append(name)
                raise AssertionError(f"host sync: Tensor.{name} in the step")
            return original(self, *args, **kwargs)
        return patched

    batch = _tbatch(_batch(33))
    for name in _SYNCS:
        monkeypatch.setattr(torch.Tensor, name, guard(name))
    state, m = step(state, batch)
    monkeypatch.undo()
    assert not calls and state.step == 2
    assert np.isfinite(float(m["loss"]))


def test_full_tree_step_matches_ctpa(gen_pair):
    """make_report_train_step: gradients of every parameter, the clip over
    all of them, updates to the trainable ones only."""
    jm, params = gen_pair
    full = {"params": params}
    jtx = jrt.make_report_optimizer(full, JGEN, total_steps=10)
    jstate, jm_metrics = jax.jit(jrt.make_report_train_step(jm, jtx))(
        JState.create(full, jtx), _jbatch(_batch(34)))
    ref_p = flax_to_state_dict(jax.tree.map(np.asarray, jstate.params["params"]))
    tm = _port(params)
    tx = trt.make_report_optimizer(tm, TGEN, total_steps=10)
    state, m = trt.make_report_train_step(tm, tx)(SimpleTrainState.create(tm, tx),
                                                  _tbatch(_batch(34)))
    close(m["loss"], jm_metrics["loss"], 0, 1e-5)
    close(m["grad_norm"], jm_metrics["grad_norm"], 0, 1e-5)
    labels = trt.trainable_labels(tm)
    assert sum(p.numel() for p in tx.params) == sum(
        p.numel() for n, p in tm.named_parameters() if labels[n] != "frozen")
    for name, p in tm.named_parameters():
        if labels[name] == "frozen":
            close(p, ref_p[name], 0, 0, name)


def test_report_optimizer_groups_match_ctpa():
    """Two groups, each with its OneCycle schedule at its own peak, and weight
    decay on every trainable parameter (optax's adamw has no mask)."""
    tm = CTReportGenerator(TLLM, TVIT, TGEN, lora=TLORA, device="cpu")
    gen = dataclasses.replace(TGEN, llm_lr=2e-5, cross_attn_lr=1e-4)
    tx = trt.make_report_optimizer(tm, gen, total_steps=20)
    labels = trt.trainable_labels(tm)
    params = dict(tm.named_parameters())
    groups = [{id(p) for p in g["params"]} for g in tx.opt.param_groups]
    assert groups == [{id(params[n]) for n, lab in labels.items() if lab == want}
                      for want in ("head", "llm")]
    assert [g["weight_decay"] for g in tx.opt.param_groups] == [1e-2, 1e-2]
    assert any(p.ndim == 1 for g in tx.opt.param_groups for p in g["params"])
    for count in range(6):
        want = [float(jrt.onecycle(peak, 20)(count)) for peak in (1e-4, 2e-5)]
        np.testing.assert_allclose([s(count) for s in tx.schedules], want, rtol=1e-5)


def test_report_trainer_epoch_saves_and_restores(gen_pair, tmp_path):
    """Three tiny batches: one host read of the metrics per step, a
    best-by-loss checkpoint of the trained parameters and the optimizer,
    then a best-by-val one from eval_fn; a fresh trainer on the same base
    restores the first."""
    _, params = gen_pair
    cfg = tc.TrainConfig(results_dir=str(tmp_path / "results"),
                         checkpoint_dir=str(tmp_path / "checkpoints"))

    def trainer(eval_fn=None):
        tm = _port(params)
        step, tx = trt.make_partitioned_report_step(tm, TGEN, total_steps=10)
        return trt.ReportTrainer(tm, SimpleTrainState.create(tm, tx), tx, cfg=cfg,
                                 eval_fn=eval_fn, step_fn=step)

    first = trainer(eval_fn=lambda state: {"composite": 0.5})
    res = first.train_epoch(iter([_batch(s) for s in (40, 41, 42)]), epoch=0)
    assert first.state.step == 3 and np.isfinite(res["mean_loss"])
    assert first.ckpt.all_steps() == [3, 4]
    assert first.ckpt.restore_metadata(3) == {"kind": "best_loss", "epoch": 0,
                                              "loss": res["mean_loss"]}
    assert first.ckpt.restore_metadata(4)["kind"] == "best_val"
    first.close()
    trained = {n: p.detach().clone() for n, p in first.model.named_parameters()}
    second = trainer()
    second.state.load_state_dict(second.ckpt.restore(3))
    assert second.state.step == 3
    for name, p in second.model.named_parameters():
        assert torch.equal(p, trained[name]), name
    saved = torch.load(tmp_path / "checkpoints" / "3" / "state.pt", weights_only=False)
    assert set(saved["params"]) == {n for n, lab in trt.trainable_labels(second.model).items()
                                    if lab != "frozen"}
    for a, b in zip(first.state.optimizer.params, second.state.optimizer.params):
        sa, sb = first.state.optimizer.opt.state[a], second.state.optimizer.opt.state[b]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
