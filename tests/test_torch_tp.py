"""Tensor parallelism of the port (``ctpa_torch/parallel/sharding.py``, the
TP forms of ``models/llm.py`` and ``ContinuousBatcher(mesh=...)``) against
ctpa's, on the CPU.

The sharding rules are held against ctpa's ``param_shardings`` leaf by leaf
(ctpa's (in, out) specs carried through ``convert.py``'s transpose).  The
tensor-parallel model runs in 4 torch-only gloo workers on a (data 2,
model 2) mesh (``tests/test_torch_parallel_worker.py``); the parent
computes ctpa's replicated ``LlamaForCausalLM`` forward and cached decode
(as ``tests/test_llm_tp.py``) and ctpa's greedy ``generate``, which ctpa's
TP batcher reproduces token for token (``tests/test_streaming_tp.py``).
``LLMConfig.tiny()``'s 4 heads and 2 kv heads divide tp 2.

Bounds, fp32: logits within 1e-4 abs + 1e-4 rel (serving logits); tokens
equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ctpa.core import config as jc
from ctpa.models import report_generator as jrg
from ctpa.models.ctclip import CTCLIP as JCLIP
from ctpa.models.llm import KVCache as JKVCache
from ctpa.models.llm import LlamaForCausalLM as JLlama
from ctpa.parallel import sharding as jsh
from ctpa.pipelines import streaming as jstream
from ctpa_torch.convert import flax_to_state_dict, load_flax_params
from ctpa_torch.core import config as tc
from ctpa_torch.core.mesh import single_device_mesh
from ctpa_torch.models.ctclip import CTCLIP
from ctpa_torch.models.llm import KVCache
from ctpa_torch.models.report_generator import CTReportGenerator
from ctpa_torch.parallel import sharding as tsh
from ctpa_torch.pipelines.streaming import ContinuousBatcher
from test_torch_parallel_worker import spawn

torch.set_num_threads(1)
LOGIT_ATOL = LOGIT_RTOL = 1e-4
JLLM, TLLM = jc.LLMConfig.tiny(), tc.LLMConfig.tiny()
JVIT, TVIT = jc.CTViTConfig.tiny(), tc.CTViTConfig.tiny()
VDIM, NEW = 24, 8
KEY = jax.random.key(0)


def np_params(tree, seed, scale=0.2):
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


def _jmesh(tp, dp=1):
    return Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp), ("data", "model"))


def _split_dims(params, shardings):
    """ctpa's specs as the split dim of each torch parameter: each leaf is
    filled with 1 + its index along the sharded flax axis (0 where
    replicated), carried through convert.py's transpose, and the torch dim
    along which it varies read back."""
    def code(leaf, sh):
        axes = [i for i, a in enumerate(sh.spec) if a is not None]
        shape = np.shape(leaf)
        if not axes:
            return np.zeros(shape, np.float32)
        idx = np.arange(shape[axes[0]], dtype=np.float32) + 1
        return np.broadcast_to(idx.reshape([-1 if i == axes[0] else 1 for i in range(len(shape))]),
                               shape).copy()

    coded = flax_to_state_dict(jax.tree.map(code, params, shardings))
    out = {}
    for name, v in coded.items():
        varying = [d for d in range(v.ndim) if v.shape[d] > 1 and np.ptp(v, axis=d).any()]
        out[name] = varying[0] if v.any() else None
    return out


@pytest.mark.parametrize("tp", [2, 3])
def test_sharding_rules_match_ctpa(tp):
    """Every parameter's split dim (torch's (out, in) weight; None =
    replicated) equals ctpa's rule after the transpose, for the report
    generator (LLM_RULES + CTCLIP_RULES) and the CLIP model (CTCLIP_RULES);
    tp 3 divides nothing of the tiny configs, so every rule falls back to
    replication there, as ctpa's."""
    jm = jrg.CTReportGenerator(JLLM, JVIT, jc.ReportGenConfig(vision_dim=VDIM),
                               lora=jc.LoRAConfig())
    rng = np.random.default_rng(0)
    video = rng.uniform(-1, 1, size=(1, 1, JVIT.temporal_size, JVIT.image_size,
                                     JVIT.image_size)).astype(np.float32)
    ids = jnp.ones((1, 6), jnp.int32)
    params = jax.eval_shape(lambda: jm.init(KEY, jnp.asarray(video), ids, ids))["params"]
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), params)
    want = _split_dims(params, jsh.llm_param_shardings(params, _jmesh(tp)))
    tm = CTReportGenerator(TLLM, TVIT, tc.ReportGenConfig(vision_dim=VDIM),
                           lora=tc.LoRAConfig(), device="meta")
    got = tsh.llm_shard_dims(tm, tp)
    assert set(got) == set(want)
    assert got == want
    assert any(d is not None for d in got.values()) == (tp == 2)

    bert = jc.BertConfig.tiny()
    jclip = JCLIP(jc.CTCLIPConfig.tiny(JVIT, bert), JVIT, bert)
    cparams = jax.eval_shape(lambda: jclip.init(KEY, ids, ids, jnp.asarray(video)))["params"]
    cparams = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), cparams)
    want = _split_dims(cparams, jsh.clip_param_shardings(cparams, _jmesh(tp)))
    tclip = CTCLIP(tc.CTCLIPConfig.tiny(TVIT, tc.BertConfig.tiny()), TVIT, tc.BertConfig.tiny(),
                   device="meta")
    assert tsh.clip_shard_dims(tclip, tp) == want


@pytest.mark.parametrize("tp", [2, 8])
def test_kv_cache_shards_match_ctpa(tp):
    """The kv-head axis of the head-major cache and its scales, falling back
    to replication where tp does not divide the kv heads."""
    jcache = jax.eval_shape(lambda: JKVCache.create(dataclasses.replace(JLLM, kv_quant="int8"),
                                                    2, 32, dtype=jnp.float32))
    want = jsh.kv_cache_shardings(jcache, _jmesh(tp))
    cache = KVCache.create(dataclasses.replace(TLLM, kv_quant="int8"), 2, 32,
                           dtype=torch.float32, device="cpu")
    got = tsh.kv_cache_shards(cache, tp)
    for field in cache._fields:
        spec = getattr(want, field).spec
        axes = [i for i, a in enumerate(spec) if a is not None]
        assert getattr(got, field) == (axes[0] if axes else None), field


def test_tp_refusals_match_ctpa():
    """ctpa's two refusals of TP serving, in ctpa's words: the decode kernel
    (flash_decode) and quantized weights on the kernels (quant_impl
    'pallas') are single-card programs."""
    jm = jrg.CTReportGenerator(JLLM, JVIT, jc.ReportGenConfig(vision_dim=VDIM))
    mesh = single_device_mesh("cpu")
    for change in (dict(flash_decode=True), dict(weight_quant="int8", quant_impl="pallas")):
        jcfg = dataclasses.replace(JLLM, **change)
        with pytest.raises(ValueError) as ref:
            jstream.ContinuousBatcher(jrg.CTReportGenerator(jcfg, JVIT, jm.gen_cfg), {},
                                      mesh=_jmesh(2))
        tm = CTReportGenerator(dataclasses.replace(TLLM, **change), TVIT,
                               tc.ReportGenConfig(vision_dim=VDIM), device="cpu")
        with pytest.raises(ValueError) as got:
            ContinuousBatcher(tm, mesh=mesh)
        assert str(got.value) == str(ref.value)


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """ctpa's references and the 4 workers' results (dp 2 x tp 2)."""
    rng = np.random.default_rng(0)
    b, n = 4, 16
    ids = rng.integers(1, JLLM.vocab_size, size=(b, n)).astype(np.int32)
    mask = np.ones((b, n), np.int32)
    # LoRA on q/k/v/o (ctpa's default targets), its B nonzero: o_proj's A is
    # split by input rows and its partial product summed with the base's
    jllm = JLlama(JLLM, lora=jc.LoRAConfig())
    lparams = np_params(jax.eval_shape(lambda: jllm.init(KEY, ids, mask))["params"], 1)
    want_logits, _, _ = jax.jit(lambda p, i, m: jllm.apply({"params": p}, i, m))(
        lparams, ids, mask)

    def prefill_step(p, ids, mask, cache):
        logits, _, cache = jllm.apply({"params": p}, ids, mask, cache=cache)
        tok = jnp.argmax(logits[:, -1].astype(jnp.float32), axis=-1).astype(jnp.int32)
        logits2, _, cache = jllm.apply({"params": p}, tok[:, None], None, cache=cache)
        return logits2[:, 0]

    want_decode = jax.jit(prefill_step)(lparams, ids, mask,
                                        JKVCache.create(JLLM, b, max_len=32, dtype=jnp.float32))

    # the serving model: 3 prompts of 6 tokens on 2 lanes (a lane reused)
    videos = rng.uniform(-1, 1, size=(3, 1, JVIT.temporal_size, JVIT.image_size,
                                      JVIT.image_size)).astype(np.float32)
    prompts = rng.integers(3, JLLM.vocab_size, size=(3, 6)).astype(np.int32)
    pmask = np.ones_like(prompts)
    jm = jrg.CTReportGenerator(JLLM, JVIT, jc.ReportGenConfig(vision_dim=VDIM))
    rparams = np_params(jax.eval_shape(lambda: jm.init(KEY, jnp.asarray(videos[:1]),
                                                        prompts[:1], pmask[:1]))["params"], 5)
    want_tokens = {}
    for kv in (None, "int8"):
        m = jrg.CTReportGenerator(dataclasses.replace(JLLM, kv_quant=kv), JVIT, jm.gen_cfg)
        generate = jax.jit(lambda p, v, i, mk: m.apply(
            {"params": p}, v, i, mk, NEW, eos_token_id=-1, greedy=True,
            method=jrg.CTReportGenerator.generate).tokens)
        want_tokens[kv] = np.asarray(generate(rparams, jnp.asarray(videos), prompts, pmask))
    tm = load_flax_params(CTReportGenerator(TLLM, TVIT, tc.ReportGenConfig(vision_dim=VDIM),
                                            device="cpu"), jax.tree.map(np.asarray, rparams))
    with torch.no_grad():
        visions = tm.extract_vision(torch.from_numpy(videos)).numpy()
    job = {"dp": 2, "tp": 2, "llm": dataclasses.asdict(TLLM), "vision_dim": VDIM,
           "lora": dataclasses.asdict(tc.LoRAConfig()),
           "llm_state": flax_to_state_dict(jax.tree.map(np.asarray, lparams)),
           "rg_state": {k: v.numpy() for k, v in tm.state_dict().items()},
           "ids": ids, "mask": mask, "prompts": list(prompts), "visions": visions, "new": NEW}
    outs = spawn("tp", 4, job, tmp_path_factory.mktemp("tp"))
    return outs, np.asarray(want_logits), np.asarray(want_decode), want_tokens


def test_mesh_lines_are_row_major(tp_run):
    """A (data 2, model 2) mesh over 4 ranks: rank r sits at (r // 2, r % 2);
    its data line holds the ranks of its model index, its model line the
    ranks of its data index."""
    outs = tp_run[0]
    for r, out in enumerate(outs):
        assert out["coords"] == (r // 2, r % 2)
        assert out["data_line"] == [r % 2, r % 2 + 2]
        assert out["model_line"] == [r - r % 2, r - r % 2 + 1]


def test_tp_llm_forward_and_cached_decode_match_ctpa(tp_run):
    """LlamaForCausalLM split over the model axis (q/k/v, gate, up, lm_head
    by columns; o_proj, down by rows) against ctpa's replicated forward and
    its prefill-then-decode logits, with LoRA on q/k/v/o; every part split,
    each rank holding
    half the heads, FFN columns and vocabulary rows (and of o_proj's LoRA
    A rows), and half the kv heads in its cache."""
    outs, want_logits, want_decode, _ = tp_run
    for r, out in enumerate(outs):
        assert out["split"] == {"attention": True, "mlp": True, "lm_head": True}
        hd = TLLM.head_dim
        assert out["shapes"]["model.layers.0.self_attn.q_proj.base.weight"] == (
            TLLM.num_heads // 2 * hd, TLLM.hidden_size)
        assert out["shapes"]["model.layers.0.self_attn.o_proj.base.weight"] == (
            TLLM.hidden_size, TLLM.num_heads // 2 * hd)
        assert out["shapes"]["model.layers.0.mlp.down_proj.weight"] == (
            TLLM.hidden_size, TLLM.intermediate_size // 2)
        assert out["shapes"]["lm_head.weight"] == (TLLM.vocab_size // 2, TLLM.hidden_size)
        assert out["shapes"]["model.layers.0.self_attn.o_proj.lora_a"] == (
            TLLM.num_heads // 2 * hd, tc.LoRAConfig().rank)
        assert out["cache_heads"] == TLLM.num_kv_heads // 2
        np.testing.assert_allclose(out["logits"], want_logits, atol=LOGIT_ATOL,
                                   rtol=LOGIT_RTOL, err_msg=f"rank {r} forward")
        np.testing.assert_allclose(out["decode"], want_decode, atol=LOGIT_ATOL,
                                   rtol=LOGIT_RTOL, err_msg=f"rank {r} decode")


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("tier", ["plain", "spec"])
def test_tp_batcher_greedy_tokens_match_ctpa(tp_run, kv, tier):
    """ContinuousBatcher(mesh=...) (3 requests on 2 lanes, 8 greedy tokens):
    the plain ring tier and the speculative tier, with the float and the
    int8 KV cache, give ctpa's greedy tokens on every rank, from caches of
    the rank's kv heads."""
    outs, _, _, want = tp_run
    for r, out in enumerate(outs):
        assert out["tokens"][(kv, tier, "cache_heads")] == TLLM.num_kv_heads // 2
        for rid, toks in out["tokens"][(kv, tier)].items():
            assert toks == want[kv][rid, :NEW].tolist(), (r, kv, tier, rid)
