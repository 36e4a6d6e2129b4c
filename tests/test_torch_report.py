"""The port's report-generation slice against ctpa's, on the CPU.

The same numpy weights (carried into the port by ``ctpa_torch.convert``)
and the same numpy-seeded inputs go through ctpa's function and the port's.
On the CPU the decode-attention wrapper takes its plain version; ctpa's
Pallas kernel runs in interpret mode.  The CUDA kernel is held against the
same plain version on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).

Tolerances, fp32 on both sides, differing only in the order of sums:
  * decode attention, RoPE, RMSNorm, LoRA, cross-attention and the vision
    feature: 1e-5 abs;
  * filter_logits: 1e-6 abs (and the same -inf support);
  * the LLM's logits over a prefill and 3 cached steps: 2e-4 abs + rel,
    the bound of ctpa's own KV-cache tests;
  * greedy generation: identical tokens and lengths;
  * sampling: 24,000 draws from a 6-token vocabulary within 0.02 total
    variation of softmax(filter_logits) (4 standard deviations of the
    empirical distribution at this count), none outside the support.
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
from ctpa.ops import rotary as jrot
from ctpa.ops import sampling as jsamp
from ctpa.ops.pallas.decode_attention import decode_attention as j_decode_attention
from ctpa_torch.convert import load_flax_params
from ctpa_torch.core import config as tc
from ctpa_torch.models import llm as tllm
from ctpa_torch.models.lora import LoRADense
from ctpa_torch.models.report_generator import (
    CrossAttentionLayer,
    CTReportGenerator,
    VisionFeatureExtractor,
)
from ctpa_torch.ops import decode_attention as tda
from ctpa_torch.ops import rotary as trot
from ctpa_torch.ops import sampling as tsamp

torch.set_num_threads(1)
KEY = jax.random.key(0)
ATOL = 1e-5
LLM_TOL = 2e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def close(got, ref, atol, rtol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def np_params(tree, seed, scale=0.2):
    """Numpy draws for a flax param tree: 1-D leaves near 1 (gains) or near
    0, matrices at ``scale``."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name in ("scale", "weight", "norm_in_scale", "gamma", "q_scale", "k_scale"):
            val = 1 + 0.1 * rng.normal(size=shape)
        elif len(shape) >= 2:
            val = scale * rng.normal(size=shape)
        else:
            val = 0.1 * rng.normal(size=shape)
        return jnp.asarray(val, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------- K8: decode attention

def _decode_inputs(seed, quant, b=3, h=4, kvh=2, m=11, hd=16, L=3):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    shape = (L, b, kvh, m, hd)
    if quant:
        ck = rng.integers(-127, 128, size=shape).astype(np.int8)
        cv = rng.integers(-127, 128, size=shape).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, size=shape[:4]).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, size=shape[:4]).astype(np.float32)
    else:
        ck, cv = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
        ks = vs = None
    valid = np.ones((b, m), bool)
    valid[0, [2, 3, 7]] = False         # holes in the middle
    valid[1, 6:] = False                # a ragged tail
    valid[2] = False                    # no valid slot: zeros
    return q, ck, cv, valid, ks, vs


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("layer_idx", [0, 2])
def test_decode_attention_plain_matches_ctpa(quant, layer_idx):
    q, ck, cv, valid, ks, vs = _decode_inputs(0, quant)
    scale = 1 / np.sqrt(q.shape[-1])
    jargs = [jnp.asarray(x) if x is not None else None for x in (q, ck, cv, valid, ks, vs)]
    ref = j_decode_attention(*jargs[:4], layer_idx, k_scale=jargs[4], v_scale=jargs[5],
                             scale=float(scale), interpret=True)
    targs = [_t(x) if x is not None else None for x in (q, ck, cv, valid, ks, vs)]
    before = tda.LAUNCHES["decode_attention"]
    got = tda.decode_attention(*targs[:4], layer_idx, k_scale=targs[4], v_scale=targs[5],
                               scale=float(scale))
    assert tda.LAUNCHES["decode_attention"] == before      # the CPU takes the plain version
    close(got, ref, ATOL)
    assert not got[2].any()                                  # the empty row


def test_decode_attention_checks_inputs():
    q, ck, cv, valid, ks, vs = (_t(x) if x is not None else None
                                for x in _decode_inputs(1, True))
    with pytest.raises(ValueError):
        tda.decode_attention(q, ck, cv, valid, 0)            # int8 without scales
    with pytest.raises(ValueError):
        tda.decode_attention(q, ck, cv, valid, 3, ks, vs)    # layer out of range
    with pytest.raises(ValueError):
        tda.decode_attention(q, ck, cv, valid.int(), 0, ks, vs)
    with pytest.raises(ValueError):
        tda.decode_attention(q[:, :3], ck, cv, valid, 0, ks, vs)


# ------------------------------------------------------- sampling

def _logits():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 12)).astype(np.float32)
    x[0, [3, 5, 8]] = 2.5               # a three-way tie at the top-k boundary
    x[1, :] = np.log(np.array([0.4, 0.3, 0.2, 0.05] + [0.05 / 8] * 8))   # top_p boundary
    x[2, [1, 2]] = 4.0                  # tied argmax
    return x


@pytest.mark.parametrize("kw", [dict(top_k=4), dict(top_p=0.7), dict(top_p=0.9),
                                dict(top_k=5, top_p=0.6), dict(temperature=0.7, top_p=0.8),
                                dict(temperature=1.3), dict(top_p=0.0)])
def test_filter_logits_matches_ctpa(kw):
    x = _logits()
    ref = np.asarray(jsamp.filter_logits(jnp.asarray(x), **kw))
    got = tsamp.filter_logits(_t(x), **kw).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    finite = np.isfinite(ref)
    close(got[finite], ref[finite], 1e-6)


def test_sample_logits_greedy_and_distribution():
    x = _logits()
    assert torch.equal(tsamp.sample_logits(_t(x), greedy=True, temperature=0.1, top_k=1),
                       torch.argmax(_t(x), -1))
    row = np.array([1.0, 0.3, -0.5, 2.0, 0.9, -3.0], np.float32)
    kw = dict(temperature=0.8, top_k=5, top_p=0.95)
    p = torch.softmax(tsamp.filter_logits(_t(row), **kw), -1).numpy()
    draws = 24_000
    gen = torch.Generator().manual_seed(0)
    tok = tsamp.sample_logits(_t(np.tile(row, (draws, 1))), gen, **kw).numpy()
    freq = np.bincount(tok, minlength=row.size) / draws
    assert freq[p == 0].sum() == 0
    assert 0.5 * np.abs(freq - p).sum() <= 0.02


# ------------------------------------------------------- small modules

def test_rope_matches_ctpa():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 40, size=(2, 5))
    jcos, jsin = jrot.rope_frequencies(16, 64, 10000.0)
    cos, sin = trot.rope_frequencies(16, 64, 10000.0, device="cpu")
    close(cos, jcos, ATOL)
    close(sin, jsin, ATOL)
    ref = jrot.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    close(trot.apply_rope(_t(x), cos, sin, _t(pos)), ref, ATOL)


def init_shapes(module, *args, **kw):
    """The shapes of a flax module's params (traced, never computed)."""
    return jax.eval_shape(lambda: module.init(KEY, *args, **kw))["params"]


def _module_pair(jmodule, tmodule, *inputs, seed=4):
    params = np_params(init_shapes(jmodule, *map(jnp.asarray, inputs)), seed)
    ref = jmodule.apply({"params": params}, *map(jnp.asarray, inputs))
    load_flax_params(tmodule, to_numpy(params))
    with torch.no_grad():
        got = tmodule(*map(_t, inputs))
    return got, ref


def test_rmsnorm_matches_ctpa():
    x = np.random.default_rng(5).normal(size=(2, 3, 16)).astype(np.float32)
    got, ref = _module_pair(jllm.RMSNorm(1e-5), tllm.RMSNorm(16, 1e-5), x)
    close(got, ref, ATOL)


@pytest.mark.parametrize("rank", [0, 4])
def test_lora_dense_matches_ctpa(rank):
    x = np.random.default_rng(6).normal(size=(2, 3, 16)).astype(np.float32)
    got, ref = _module_pair(jlora.LoRADense(24, rank=rank, alpha=8.0),
                            LoRADense(16, 24, rank=rank, alpha=8.0), x)
    close(got, ref, ATOL)


def test_cross_attention_matches_ctpa():
    rng = np.random.default_rng(7)
    hidden = rng.normal(size=(2, 5, 32)).astype(np.float32)
    vision = rng.normal(size=(2, 24)).astype(np.float32)
    got, ref = _module_pair(jrg.CrossAttentionLayer(llm_dim=32),
                            CrossAttentionLayer(32, 24), hidden, vision)
    close(got, ref, ATOL)


JVIT = jc.CTViTConfig.tiny()
TVIT = tc.CTViTConfig.tiny()


def _video(seed, b=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(b, 1, TVIT.temporal_size, TVIT.image_size,
                                    TVIT.image_size)).astype(np.float32)


@pytest.mark.parametrize("use_encoder", [False, True])
def test_vision_feature_extractor_matches_ctpa(use_encoder):
    video = _video(8)
    got, ref = _module_pair(jrg.VisionFeatureExtractor(JVIT, out_dim=24, use_encoder=use_encoder),
                            VisionFeatureExtractor(TVIT, 24, use_encoder=use_encoder,
                                                   device="cpu"), video)
    close(got, ref, ATOL)
    with pytest.raises(ValueError):
        VisionFeatureExtractor(TVIT, 24, device="cpu")(_t(video[:, :, :8]))


# ------------------------------------------------------- the LLM with its cache

JLLM = jc.LLMConfig.tiny()
TLLM = tc.LLMConfig.tiny()


@pytest.fixture(scope="module")
def llm_params():
    return np_params(init_shapes(jllm.LlamaForCausalLM(JLLM), jnp.ones((1, 4), jnp.int32)), 9)


def _prompts():
    rng = np.random.default_rng(10)
    ids = rng.integers(1, JLLM.vocab_size, size=(2, 5))
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]])     # lengths 5 and 3, right-padded
    return ids * mask, mask


@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("flash_decode", [False, True])
@pytest.mark.parametrize("shared", [True, False])
def test_llm_prefill_and_cached_decode_match_ctpa(llm_params, kv_quant, flash_decode, shared):
    over = dict(kv_quant=kv_quant, flash_decode=flash_decode)
    jcfg, tcfg = dataclasses.replace(JLLM, **over), dataclasses.replace(TLLM, **over)
    jm = jllm.LlamaForCausalLM(jcfg)
    tm = load_flax_params(tllm.LlamaForCausalLM(tcfg, device="cpu"), to_numpy(llm_params))
    ids, mask = _prompts()
    jcache = jllm.KVCache.create(jcfg, 2, max_len=9, dtype=jnp.float32)
    tcache = tllm.KVCache.create(tcfg, 2, max_len=9, dtype=torch.float32, device="cpu")
    with pltpu.force_tpu_interpret_mode(), torch.no_grad():
        ref, _, jcache = jm.apply({"params": llm_params}, jnp.asarray(ids), jnp.asarray(mask),
                                  jcache, shared_kv_offset=shared)
        got, _, tcache = tm(_t(ids), _t(mask), tcache, shared_kv_offset=shared)
        close(got, ref, LLM_TOL, LLM_TOL)
        step = np.argmax(np.asarray(ref)[np.arange(2), mask.sum(-1) - 1], -1)
        for _ in range(3):
            ref, _, jcache = jm.apply({"params": llm_params}, jnp.asarray(step[:, None]), None,
                                      jcache, shared_kv_offset=shared)
            got, _, tcache = tm(_t(step[:, None]), None, tcache, shared_kv_offset=shared)
            close(got, ref, LLM_TOL, LLM_TOL)
            step = np.argmax(np.asarray(ref)[:, 0], -1)
    for name in ("write_offset", "true_len", "valid"):
        assert np.array_equal(getattr(tcache, name).numpy(), np.asarray(getattr(jcache, name)))
    # the short prompt left a hole of invalid slots between its tokens;
    # 5 prefill slots and 3 steps leave slot 8 unwritten
    assert not tcache.valid[1, 3:5].any() and tcache.valid[1, 5:8].all()
    assert not tcache.valid[:, 8].any()


def test_llm_raises_on_unported_paths():
    for over in (dict(kv_int8_dots=True),
                 dict(quant_act=True), dict(quant_ffn_kernel=True),
                 # these act only on the paths above, so a non-default is refused
                 dict(quant_impl="xla"), dict(quant_fused=False), dict(kv_quant_group=16),
                 dict(kv_scale_dtype="bfloat16")):
        with pytest.raises(NotImplementedError):
            tllm.LlamaForCausalLM(dataclasses.replace(TLLM, **over), device="cpu")
    # the int4 KV cache is ported (tests/test_torch_kv_quant.py)
    assert tllm.LlamaForCausalLM(dataclasses.replace(TLLM, kv_quant="int4"),
                                 device="cpu").cfg.kv_quant == "int4"
    # int8 weights are ported (tests/test_torch_quant_int8.py)
    assert isinstance(tllm.LlamaForCausalLM(dataclasses.replace(TLLM, weight_quant="int8"),
                                            device="cpu").lm_head, tllm.Int8Dense)
    # flash_prefill is ported (tests/test_torch_report_train.py): taken, both
    # at and below flash_min_len
    model = tllm.LlamaForCausalLM(dataclasses.replace(TLLM, flash_prefill=True, flash_min_len=4),
                                  device="cpu")
    model(torch.ones(1, 4, dtype=torch.long))
    model(torch.ones(1, 3, dtype=torch.long))                # below flash_min_len: dense


# ------------------------------------------------------- generate

GEN = jc.ReportGenConfig(vision_dim=24)


@pytest.fixture(scope="module")
def generator_pair():
    jcfg = dataclasses.replace(JLLM, flash_decode=True)
    jm = jrg.CTReportGenerator(jcfg, JVIT, GEN)
    ids, mask = _prompts()
    params = np_params(init_shapes(jm, jnp.asarray(_video(11)), jnp.asarray(ids),
                                   jnp.asarray(mask)), 12)
    tcfg = dataclasses.replace(TLLM, flash_decode=True)
    tm = CTReportGenerator(tcfg, TVIT, tc.ReportGenConfig(vision_dim=24), device="cpu")
    return jm, params, load_flax_params(tm, to_numpy(params))


def _generate(pair, video, ids, mask, eos, max_new=6, with_ctpa=True):
    """(port result, ctpa result or None, the port's trunk calls)."""
    jm, params, tm = pair
    ref = None
    if with_ctpa:
        with pltpu.force_tpu_interpret_mode():
            ref = jm.apply({"params": params}, jnp.asarray(video), jnp.asarray(ids),
                           jnp.asarray(mask), max_new, eos, 0, greedy=True,
                           method=jrg.CTReportGenerator.generate)
    calls = []
    hook = tm.llm.model.register_forward_hook(lambda *a: calls.append(1))
    got = tm.generate(_t(video), _t(ids), _t(mask), max_new, eos, 0, greedy=True)
    hook.remove()
    return got, ref, len(calls)


def _same(got, ref):
    assert np.array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert np.array_equal(got.lengths.numpy(), np.asarray(ref.lengths))


@pytest.fixture(scope="module")
def greedy_run(generator_pair):
    ids, mask = _prompts()
    return _generate(generator_pair, _video(13), ids, mask, eos=-1)


def test_generate_greedy_matches_ctpa(greedy_run):
    got, ref, calls = greedy_run
    _same(got, ref)
    assert calls == 6 and (got.lengths == 6).all()           # one prefill, five steps


def test_generate_eos_pads_and_stops_early(generator_pair, greedy_run):
    ids, mask = _prompts()
    video = _video(13)
    first = greedy_run[0].tokens[0].tolist()
    eos = first[2]
    stop = first.index(eos)                 # lane 0 emits EOS here
    got, ref, _ = _generate(generator_pair, video, ids, mask, eos=eos)
    _same(got, ref)
    assert got.tokens[0, stop] == eos and (got.tokens[0, stop + 1:] == 0).all()
    assert got.lengths[0] == stop
    # lane 0 alone: the same tokens, and the loop ends once it is done
    alone, _, calls = _generate(generator_pair, video[:1], ids[:1], mask[:1], eos=eos,
                                with_ctpa=False)
    assert torch.equal(alone.tokens[0], got.tokens[0])
    assert calls == 1 + stop
