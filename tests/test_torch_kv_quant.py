"""The port's quantized KV caches against ctpa's, on the CPU: the int4 cache
(``quantize_kv_int4``, ``unpack_kv_int4``, the grouped attention) and the
int8 cache's integer attention dots (``kv_int8_dots``).

The same numpy weights (carried into the port by ``ctpa_torch.convert``)
and the same numpy-seeded inputs go through ctpa's function and the port's.
These paths are XLA einsums in ctpa, not kernels, and plain torch in the
port.  Tolerances:
  * the packed int4 bytes and their scales (fp32 and bf16): bit-equal;
  * the rows an attention layer writes into the cache quantize k and v,
    which differ from ctpa's by fp32 noise: scales within 1e-6 (bf16
    scales one bf16 ulp), levels within one step; every other slot
    untouched;
  * an attention layer's output over a quantized cache, int4 and int8 dots,
    one decode row and three prefill rows: 1e-5 abs in fp32;
  * the LLM's logits over a prefill and 3 cached steps: 2e-4 abs + rel,
    the bound of ctpa's own KV-cache tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpa.core import config as jc
from ctpa.models import llm as jllm
from ctpa.ops import quant as jquant
from ctpa_torch.convert import load_flax_params
from ctpa_torch.core import config as tc
from ctpa_torch.models import llm as tllm
from ctpa_torch.ops import quant as tquant
from ctpa_torch.ops import rotary as trot

torch.set_num_threads(1)
ATOL = 1e-5
LLM_TOL = 2e-4
JLLM = jc.LLMConfig.tiny()
TLLM = tc.LLMConfig.tiny()


def _t(x):
    return torch.from_numpy(np.array(x))


def np_params(tree, seed, scale=0.2):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        shape = np.shape(leaf)
        if str(path[-1].key) == "weight":
            val = 1 + 0.1 * rng.normal(size=shape)
        elif len(shape) >= 2:
            val = scale * rng.normal(size=shape)
        else:
            val = 0.1 * rng.normal(size=shape)
        return jnp.asarray(val, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def llm_params():
    shapes = jax.eval_shape(lambda: jllm.LlamaForCausalLM(JLLM).init(
        jax.random.key(0), jnp.ones((1, 4), jnp.int32)))["params"]
    return np_params(shapes, 9)


def _bf16_round(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


# ------------------------------------------------------- the int4 quantizer

@pytest.mark.parametrize("group", [8, 16, 32])
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_quantize_kv_int4_is_bit_equal_to_ctpa(group, scale_dtype):
    rng = np.random.default_rng(group)
    rows = rng.normal(size=(2, 3, 5, 32)).astype(np.float32) * rng.uniform(
        0.01, 5, size=(2, 3, 5, 1)).astype(np.float32)
    rows[0, 0, 0, :8] = 0.0                           # an all-zero group: the 1e-12 floor
    jp, js = jquant.quantize_kv_int4(jnp.asarray(rows), group,
                                     scale_dtype=jnp.dtype(scale_dtype))
    tp, ts = tquant.quantize_kv_int4(_t(rows), group, getattr(torch, scale_dtype))
    assert tp.dtype == torch.int8 and np.array_equal(tp.numpy(), np.asarray(jp))
    assert ts.dtype == getattr(torch, scale_dtype)
    assert np.array_equal(ts.float().numpy(), np.asarray(js).astype(np.float32))
    ju = np.asarray(jquant.unpack_kv_int4(jp, group))
    tu = tquant.unpack_kv_int4(tp, group)
    assert np.array_equal(tu.numpy(), ju)
    assert tu.abs().max() <= 7


def test_unpack_kv_int4_reads_every_byte_as_ctpa():
    packed = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    ref = np.asarray(jquant.unpack_kv_int4(jnp.asarray(packed), 16))
    assert np.array_equal(tquant.unpack_kv_int4(_t(packed), 16).numpy(), ref)


# ------------------------------------------------------- one attention layer

FORMS = {"int4": dict(kv_quant="int4"), "int4 bf16 scales g8": dict(
    kv_quant="int4", kv_scale_dtype="bfloat16", kv_quant_group=8),
    "int8 dots": dict(kv_quant="int8", kv_int8_dots=True)}


def _random_cache(cfg, form, b, m, seed):
    """A (L, b, kvh, m, ...) cache of random rows and scales, with holes."""
    rng = np.random.default_rng(seed)
    L, kvh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    if cfg.kv_quant == "int4":
        gs = tquant._int4_group(hd, cfg.kv_quant_group)
        row, sshape = (L, b, kvh, m, hd // 2), (L, b, kvh, m, hd // gs)
    else:
        row, sshape = (L, b, kvh, m, hd), (L, b, kvh, m)
    ck, cv = (rng.integers(-128, 128, size=row).astype(np.int8) for _ in range(2))
    # the scales of rows with absmax 0.25-4: absmax / 7 for int4, / 127 for int8
    lo, hi = (0.035, 0.6) if cfg.kv_quant == "int4" else (0.002, 0.03)
    ks, vs = (rng.uniform(lo, hi, size=sshape).astype(np.float32) for _ in range(2))
    if cfg.kv_scale_dtype == "bfloat16":
        ks, vs = _bf16_round(ks), _bf16_round(vs)
    valid = rng.random((b, m)) < 0.7
    valid[:, 0] = True
    return ck, cv, ks, vs, valid


def _masks(valid, offsets, n, m):
    """LlamaModel's masks for n rows written at ``offsets`` (b,)."""
    slots = (offsets[:, None] + np.arange(n)[None]) % m
    newly = (np.arange(m)[None, None] == slots[:, :, None]).any(1)
    valid_now = valid | newly
    if n == 1:
        return valid_now[:, None, None, :]
    return (np.arange(m)[None, None, None] <= slots[:, None, :, None]) & valid_now[:, None, None]


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("n,shared", [(1, True), (3, False)])
def test_quantized_attention_matches_ctpa(llm_params, form, n, shared):
    over = FORMS[form]
    jcfg, tcfg = dataclasses.replace(JLLM, **over), dataclasses.replace(TLLM, **over)
    b, m, layer = 2, 12, 1
    ck, cv, ks, vs, valid = _random_cache(tcfg, form, b, m, seed=n)
    rng = np.random.default_rng(10 + n)
    x = rng.normal(size=(b, n, tcfg.hidden_size)).astype(np.float32)
    offsets = np.array([4, 4] if shared else [2, 7])
    positions = offsets[:, None] + np.arange(n)[None]
    mask = _masks(valid, offsets, n, m)
    index = np.int32(offsets[0]) if shared else offsets.astype(np.int32)
    sdt = jnp.dtype(jcfg.kv_scale_dtype)
    jattn = jllm.LlamaAttention(jcfg, layer_idx=layer)
    jparams = {"params": llm_params["model"][f"layers_{layer}"]["self_attn"]}
    jout, (jck, jks), (jcv, jvs) = jax.jit(jattn.apply)(
        jparams, jnp.asarray(x), jnp.asarray(positions), jnp.asarray(index),
        (jnp.asarray(ck), jnp.asarray(ks).astype(sdt)), (jnp.asarray(cv), jnp.asarray(vs).astype(sdt)),
        jnp.asarray(mask), None)
    model = load_flax_params(tllm.LlamaForCausalLM(tcfg, device="cpu"),
                             jax.tree.map(np.asarray, llm_params))
    tdt = getattr(torch, tcfg.kv_scale_dtype)
    tck, tcv, tks, tvs = _t(ck), _t(cv), _t(ks).to(tdt), _t(vs).to(tdt)
    rope = trot.rope_frequencies(tcfg.head_dim, tcfg.max_seq_len, tcfg.rope_theta, device="cpu")
    with torch.no_grad():
        out = model.model.layers[layer].self_attn(_t(x), _t(positions), rope, _t(index),
                                                  (tck, tks), (tcv, tvs), _t(mask), None)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL, rtol=0)
    # every slot but the written ones is as it was, bit for bit; the written
    # rows quantize k and v, which differ from ctpa's by fp32 noise, so their
    # scales agree to 1e-6 and their levels to one step
    written = np.zeros((b, m), bool)
    written[np.arange(b)[:, None], (offsets[:, None] + np.arange(n)) % m] = True

    def split(a):
        """(the rows this layer wrote, every other element)."""
        sel = np.zeros(a.shape[:4], bool)
        sel[layer] = written[:, None, :]
        sel = np.broadcast_to(sel.reshape(sel.shape + (1,) * (a.ndim - 4)), a.shape)
        return a[sel], a[~sel]

    for got, ref, before in ((tck, jck, ck), (tcv, jcv, cv), (tks, jks, ks), (tvs, jvs, vs)):
        got, ref = got.numpy() if got.dtype == torch.int8 else got.float().numpy(), np.asarray(ref)
        if before.dtype == np.int8 and tcfg.kv_quant == "int4":
            got, ref, before = (tquant.unpack_kv_int4(_t(x), tcfg.kv_quant_group).numpy()
                                for x in (got, ref, before))
        (new, kept), (want, ref_kept), (_, was) = split(got), split(ref.astype(got.dtype)), \
            split(before.astype(got.dtype))
        assert np.array_equal(kept, was) and np.array_equal(ref_kept, was)
        if before.dtype == np.int8:
            assert np.abs(new.astype(np.int32) - want).max() <= 1
        else:
            np.testing.assert_allclose(new, want, rtol=1e-6 if tdt == torch.float32 else 2 ** -8)


# ------------------------------------------------------- the whole LLM

def _prompts():
    rng = np.random.default_rng(10)
    ids = rng.integers(1, JLLM.vocab_size, size=(2, 5))
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]])
    return ids * mask, mask


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("shared", [True, False])
def test_llm_with_quantized_cache_matches_ctpa(llm_params, form, shared):
    over = FORMS[form]
    jcfg, tcfg = dataclasses.replace(JLLM, **over), dataclasses.replace(TLLM, **over)
    jm = jax.jit(jllm.LlamaForCausalLM(jcfg).apply, static_argnames="shared_kv_offset")
    tm = load_flax_params(tllm.LlamaForCausalLM(tcfg, device="cpu"),
                          jax.tree.map(np.asarray, llm_params))
    ids, mask = _prompts()
    jcache = jllm.KVCache.create(jcfg, 2, max_len=9, dtype=jnp.float32)
    tcache = tllm.KVCache.create(tcfg, 2, max_len=9, dtype=torch.float32, device="cpu")
    assert tcache.k.shape == jcache.k.shape and tcache.k_scale.shape == jcache.k_scale.shape
    assert str(tcache.k_scale.dtype).split(".")[-1] == str(jcache.k_scale.dtype)
    with torch.no_grad():
        ref, _, jcache = jm({"params": llm_params}, jnp.asarray(ids), jnp.asarray(mask), jcache,
                            shared_kv_offset=shared)
        got, _, tcache = tm(_t(ids), _t(mask), tcache, shared_kv_offset=shared)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LLM_TOL, rtol=LLM_TOL)
        step = np.argmax(np.asarray(ref)[np.arange(2), mask.sum(-1) - 1], -1)
        for _ in range(3):
            ref, _, jcache = jm({"params": llm_params}, jnp.asarray(step[:, None]), None, jcache,
                                shared_kv_offset=shared)
            got, _, tcache = tm(_t(step[:, None]), None, tcache, shared_kv_offset=shared)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LLM_TOL, rtol=LLM_TOL)
            step = np.argmax(np.asarray(ref)[:, 0], -1)
    for name in ("write_offset", "true_len", "valid"):
        assert np.array_equal(getattr(tcache, name).numpy(), np.asarray(getattr(jcache, name)))


def test_flash_decode_refuses_the_int4_cache(llm_params):
    cfg = dataclasses.replace(TLLM, kv_quant="int4", flash_decode=True)
    tm = load_flax_params(tllm.LlamaForCausalLM(cfg, device="cpu"),
                          jax.tree.map(np.asarray, llm_params))
    cache = tllm.KVCache.create(cfg, 1, max_len=6, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        _, _, cache = tm(torch.ones(1, 3, dtype=torch.long), None, cache)   # prefill: dense
        with pytest.raises(ValueError, match="int4"):
            tm(torch.ones(1, 1, dtype=torch.long), None, cache)


def test_quantized_cache_settings_are_accepted_or_refused():
    for over in (dict(kv_quant="int4"), dict(kv_quant="int4", kv_quant_group=8,
                                             kv_scale_dtype="bfloat16"),
                 dict(kv_quant="int8", kv_int8_dots=True, flash_decode=True),
                 dict(kv_quant="int4", weight_quant="int4", quant_act=True)):
        tllm.check_ported(dataclasses.replace(TLLM, **over))
    # settings that would act on nothing
    for over in (dict(kv_int8_dots=True), dict(kv_quant="int4", kv_int8_dots=True),
                 dict(kv_quant="int8", kv_quant_group=8), dict(kv_scale_dtype="bfloat16")):
        with pytest.raises(NotImplementedError):
            tllm.check_ported(dataclasses.replace(TLLM, **over))
    for over in (dict(kv_quant="int2"), dict(kv_quant="int4", kv_scale_dtype="float16"),
                 dict(kv_quant="int4", kv_quant_group=3)):
        with pytest.raises(ValueError):
            tllm.check_ported(dataclasses.replace(TLLM, **over))
