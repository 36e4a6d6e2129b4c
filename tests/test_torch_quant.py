"""The port's int4 quantized serving slice against ctpa's, on the CPU.

The same numpy-seeded inputs and weights go through ctpa's function and the
port's.  On the CPU the K5 and K7 wrappers take their plain versions; ctpa's
Pallas kernels run in interpret mode (``pltpu.force_tpu_interpret_mode``, as
``tests/test_quant.py`` runs them) with synchronous CPU dispatch (set in a
module fixture).  The CUDA kernels are held against the same plain versions
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances, fp32 on both sides:
  * the host quantizers (int8, int4, per-token int8): bit for bit;
  * ``quantize_tree`` without LoRA: bit for bit (the same fp32 weights);
    with a LoRA merge, ctpa's and the port's A @ B round differently in
    fp32, so a packed nibble may differ by one level where a value sits on
    a rounding boundary: at most 0.5% of the nibbles, by one level, and the
    scales within 1e-6 relative;
  * K5 and K7, plain and xla forms, against ctpa's: 1e-4 abs + 1e-4 rel of
    outputs of order 10 (the same products summed in another order; in the
    w4a8 FFN the order can also move h across a rounding boundary of its
    int8 grid, one level of one element, which stays far inside this);
  * the tiny LLM's logits over a prefill and 2 cached steps: 2e-4 abs + rel
    (ctpa's own KV-cache tests' bound) weight-only.  With w4a8 a one-ulp
    difference in an activation (ctpa's and the port's RoPE round
    differently, so the int8 KV cache's scales differ by an ulp) moves a
    value that sits on a rounding boundary of its row's int8 grid by one
    level, which moves that row's logits by about 1% of the largest (read:
    0.051 of 5.2): held to 2% of the largest logit, with the same argmax in
    every row.  The greedy generator: the same tokens;
  * the serving bundle: identical logits to the in-memory model.
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
from ctpa.models import report_generator as jrg
from ctpa.ops import quant as jq
from ctpa_torch.cli import export_serving
from ctpa_torch.convert import flax_to_state_dict, load_flax_params
from ctpa_torch.core import config as tc
from ctpa_torch.core.checkpoint import CheckpointManager
from ctpa_torch.models import llm as tllm
from ctpa_torch.models.report_generator import CTReportGenerator
from ctpa_torch.ops import quant as tq

torch.set_num_threads(1)
KEY = jax.random.key(0)
OP_TOL = 1e-4
LLM_TOL = 2e-4
A8_LOGIT_REL = 0.02


@pytest.fixture(scope="module", autouse=True)
def _sync_dispatch():
    """ctpa's interpreted Pallas kernels deadlock under asynchronous CPU
    dispatch (tests/conftest.py); this module turns it off while it runs."""
    before = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", before)


def _t(x):
    return torch.from_numpy(np.array(x))


def close(got, ref, atol, rtol=0.0):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def _normal(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def init_shapes(module, *args, **kw):
    return jax.eval_shape(lambda: module.init(KEY, *args, **kw))["params"]


def np_params(tree, seed, scale=0.2):
    """Numpy draws for a flax param tree: gains near 1, matrices at ``scale``,
    other vectors near 0."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name in ("scale", "weight"):
            val = 1 + 0.1 * rng.normal(size=shape)
        elif len(shape) >= 2:
            val = scale * rng.normal(size=shape)
        else:
            val = 0.1 * rng.normal(size=shape)
        return jnp.asarray(val, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------- host quantizers

@pytest.mark.parametrize("shape,group", [((512, 384), 128), ((192, 40), 128), ((384, 200), 64)])
def test_host_quantizers_match_ctpa_bit_for_bit(shape, group):
    w = _normal(1, *shape, scale=0.05)
    w[3, :5] = 0.0                                      # a column of zeros in a group
    jw4, js = jq.quantize_int4(jnp.asarray(w), group)
    tw4, ts = tq.quantize_int4(_t(w), group)
    assert tw4.dtype == torch.int8 and np.array_equal(tw4.numpy(), np.asarray(jw4))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    g = tq._int4_group(shape[0], group)
    assert g == jq._int4_group(shape[0], group)
    assert np.array_equal(tq._unpack_int4(tw4, g).numpy(), np.asarray(jq._unpack_int4(jw4, g)))
    assert np.array_equal(tq.dequantize_int4(tw4, ts, g, torch.float32).numpy(),
                          np.asarray(jq.dequantize_int4(jw4, js, g, jnp.float32)))
    jw8, js8 = jq.quantize_int8(jnp.asarray(w))
    tw8, ts8 = tq.quantize_int8(_t(w))
    assert np.array_equal(tw8.numpy(), np.asarray(jw8)) and np.array_equal(ts8.numpy(),
                                                                            np.asarray(js8))
    assert np.array_equal(tq.dequantize_int8(tw8, ts8, torch.float32).numpy(),
                          np.asarray(jq.dequantize_int8(jw8, js8, jnp.float32)))
    x = _normal(2, 7, shape[0])
    x[1] = 0.0                                          # an all-zero row: the 1e-12 floor
    jx8, jsx = jq.quantize_act_int8(jnp.asarray(x))
    tx8, tsx = tq.quantize_act_int8(_t(x))
    assert np.array_equal(tx8.numpy(), np.asarray(jx8)) and np.array_equal(tsx.numpy(),
                                                                            np.asarray(jsx))


def test_int4_group_and_block_rules():
    for d_in, group in ((4096, 128), (11008, 128), (64, 128), (96, 128), (192, 128), (40, 32)):
        assert tq._int4_group(d_in, group) == jq._int4_group(d_in, group)
    with pytest.raises(ValueError):
        tq._int4_group(7, 128)
    # ctpa's j-block rule (int4_ffn :812-817), written out
    for inter, g_i, want in ((11008, 128, 256), (384, 128, 256), (128, 128, 128),
                             (96, 32, 96), (320, 64, 256), (192, 64, 192)):
        assert tq.ffn_block_j(inter, g_i) == want


# How many clusters of 1-8 blocks of K5's prefill kernel a card with one
# block an SM runs at once
K5_CARD_1 = (132, 66, 44, 33, 26, 22, 18, 16)
# (m, in, out, sms, resident, act_quant, want): Meditron-7B's qkv_proj,
# o_proj and lm_head on 132 SMs at decode (batch 4 and 32: the streaming
# kernel, as many blocks as the SMs hold at once, in whole splits, added in
# its own launch); past the threshold (33 rows: the prefill kernel's 48 or
# 16 blocks, too few for the card, so its contraction splits across
# clusters), at prefill (4 x 512 rows, no split; w4a8's token tile is 64
# rows) and at the batch-32 prefill (16,384 rows)
K5_PLANS = [(4, 4096, 12288, 132, 4, False, ("stream", 5, 7)),
            (32, 4096, 12288, 132, 2, False, ("stream", 2, 16)),
            (4, 4096, 4096, 132, 4, False, ("stream", 8, 4)),
            (1, 4096, 32000, 132, 3, False, ("stream", 1, 32)),
            (33, 4096, 4096, 132, 4, False, ("wgmma", 1, 16, 8, 4)),
            (33, 4096, 12288, 132, 4, True, ("wgmma", 1, 48, 2, 16)),
            (2048, 4096, 12288, 132, 4, False, ("wgmma", 16, 48, 1, 32)),
            (2048, 4096, 12288, 132, 4, True, ("wgmma", 32, 48, 1, 32)),
            (16384, 4096, 12288, 132, 4, False, ("wgmma", 128, 48, 1, 32)),
            (4, 1408, 4096, 132, 2, False, ("stream", 2, 6)),
            (4, 4096, 200000, 132, 4, False, ("stream", 1, 32))]


@pytest.mark.parametrize("m, d_in, d_out, sms, resident, act_quant, want", K5_PLANS)
def test_int4_matmul_plan_takes_the_kernel_by_rows(m, d_in, d_out, sms, resident, act_quant,
                                                   want):
    """K5's dispatch: up to ``STREAM_MAX_ROWS`` rows the streaming kernel,
    above the prefill kernel; either adds its splits inside its one launch
    (the prefill kernel's in a cluster), so a call is one launch at any row
    count, with no reduction, and w4a8 adds one activation-quantization
    launch.  Every split holds groups or 128-row chunks, the last one
    possibly fewer."""
    g = tq._int4_group(d_in, tq.GROUP)
    occupancy = (sms * resident,) if m <= tq.STREAM_MAX_ROWS else K5_CARD_1
    plan = tq.int4_matmul_plan(m, d_in, d_out, g, occupancy, act_quant)
    assert plan == want
    kernel, *_, splits, per = plan
    assert (kernel == "stream") == (m <= tq.STREAM_MAX_ROWS)
    if kernel == "stream":
        assert (splits - 1) * per < d_in // g <= splits * per
    else:
        _, tiles, strips, _, _ = plan
        tokens = tq.PREFILL_TOKENS_W4A8 if act_quant else tq.PREFILL_TOKENS
        assert (tiles, strips) == (-(-m // tokens), -(-d_out // tq.PREFILL_COLUMNS))
        assert (splits - 1) * per < -(-d_in // tq.PREFILL_KC) <= splits * per
        assert splits == 1 or K5_CARD_1[splits - 1] >= tiles * strips
    suffix = "" if m <= tq.STREAM_MAX_ROWS else "_prefill"
    for a8 in (False, True):
        assert tq.int4_matmul_launches(m, a8) == {
            ("int4_matmul_a8" if a8 else "int4_matmul") + suffix: 1, "int4_act_quant": int(a8)}


# ------------------------------------------------------- K5

K5_CASES = [  # (m, in, out, pallas block_in, block_out): tests/test_quant.py's shapes
    (5, 384, 200, 128, 128),      # three in-blocks, ragged out
    (8, 512, 384, 256, 128),      # two in-blocks of two groups
    (3, 64, 48, 2048, 512),       # the group clamps to 64, one block
    (4, 256, 300, 256, 128),      # ragged out over three out-blocks
    (70, 384, 520, 128, 256),     # the prefill kernel: 70 rows, ragged out
    (300, 256, 200, 128, 128),    # the prefill kernel over two of ctpa's row blocks
]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("case", K5_CASES)
def test_int4_matmul_matches_ctpa(case, act_quant):
    m, d_in, d_out, block_in, block_out = case
    x = _normal(3, m, d_in)
    jw4, js = jq.quantize_int4(jnp.asarray(_normal(4, d_in, d_out, scale=0.1)))
    with pltpu.force_tpu_interpret_mode():
        ref = jq.int4_matmul(jnp.asarray(x), jw4, js, impl="pallas", act_quant=act_quant,
                             block_in=block_in, block_out=block_out)
    ref_xla = jq.int4_matmul(jnp.asarray(x), jw4, js, impl="xla", act_quant=act_quant)
    w4, s = _t(jw4), _t(js)
    before = dict(tq.LAUNCHES)
    got = tq.int4_matmul(_t(x), w4, s, act_quant=act_quant)
    assert tq.LAUNCHES == before                       # the CPU takes the plain version
    close(got, ref, OP_TOL, OP_TOL)
    close(tq.int4_matmul_plain(_t(x), w4, s, act_quant=act_quant), ref, OP_TOL, OP_TOL)
    close(tq.int4_matmul(_t(x), w4, s, impl="xla", act_quant=act_quant), ref_xla, OP_TOL,
          OP_TOL)


def test_int4_matmul_rounds_weights_to_the_activation_dtype():
    """The kernel's weight-only form rounds the dequantized weight to x's dtype
    (ctpa's ``_q4_kernel``); ctpa's xla branch keeps it fp32."""
    x = _t(_normal(5, 4, 256)).to(torch.bfloat16)
    w4, s = tq.quantize_int4(_t(_normal(6, 256, 64, scale=0.1)))
    w = tq.dequantize_int4(w4, s, 128, torch.float32)
    want = (x.float() @ w.to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(tq.int4_matmul(x, w4, s), want)
    assert torch.equal(tq.int4_matmul(x, w4, s, impl="xla"), (x.float() @ w).to(torch.bfloat16))


def test_int4_wrappers_check_inputs():
    x = torch.zeros(2, 256)
    w4, s = tq.quantize_int4(torch.zeros(256, 64))
    with pytest.raises(ValueError):
        tq.int4_matmul(x[:, :128], w4, s)                 # in does not match
    with pytest.raises(ValueError):
        tq.int4_matmul(x, w4, s[:1])                      # wrong scale shape
    with pytest.raises(ValueError):
        tq.int4_matmul(x, w4.float(), s)                  # not packed int8
    with pytest.raises(ValueError):
        tq.int4_matmul(x, w4, s, impl="triton")
    with pytest.raises(ValueError):
        tq.int4_ffn(x, w4, s, w4, s, w4, s)               # down must be (inter/2, hidden)


# ------------------------------------------------------- K7

K7_CASES = [  # (m, hidden, inter): tests/test_quant.py:470-575
    (4, 64, 384),        # groups 64 / 128, the last j-block padded (384 -> 512)
    (5, 256, 384),       # n_gh = 2 hidden groups, n_gj = 2 down groups a block
    (8, 64, 384),
    (32, 256, 384),      # the decode kernels' largest row count (batch 32)
    (70, 256, 384),      # the prefill kernels: 70 rows, not a multiple of their token tile
]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("case", K7_CASES)
def test_int4_ffn_matches_ctpa(case, act_quant):
    m, hidden, inter = case
    x = _normal(7, m, hidden)
    jw = []
    for seed, shape in ((8, (hidden, inter)), (9, (hidden, inter)), (10, (inter, hidden))):
        jw += list(jq.quantize_int4(jnp.asarray(_normal(seed, *shape, scale=0.1))))
    with pltpu.force_tpu_interpret_mode():
        ref = jq.int4_ffn(jnp.asarray(x), *jw, impl="pallas", block_j=256,
                          act_quant=act_quant)
    ref_xla = jq.int4_ffn(jnp.asarray(x), *jw, impl="xla", act_quant=act_quant)
    tw = [_t(a) for a in jw]
    before = dict(tq.LAUNCHES)
    got = tq.int4_ffn(_t(x), *tw, act_quant=act_quant)
    assert tq.LAUNCHES == before
    close(got, ref, OP_TOL, OP_TOL)
    close(tq.int4_ffn(_t(x), *tw, impl="xla", act_quant=act_quant), ref_xla, OP_TOL, OP_TOL)


# How many clusters of 1-8 blocks (gate/up, down) example cards run at once:
# K7's gate/up kernel holds one block an SM (43 clusters of 2 fit, not of
# 3; or, on a roomier card, of 3), its down kernel two (m <= 16: 32
# clusters of 8 fit) or one (m 32: 32 clusters of 4); and a card that fits
# too few even of one block
GU_1 = (132, 66, 39, 30, 22, 17, 15, 15)
GU_1B = (132, 66, 44, 33, 26, 22, 18, 16)
DN_2 = (264, 132, 79, 62, 47, 39, 32, 30)
DN_1 = (132, 66, 39, 33, 22, 17, 15, 15)
K7_CARD_A, K7_CARD_B, K7_CARD_C = (GU_1, DN_2), (GU_1, DN_1), (GU_1B, (264,) * 8)
K7_CARD_0 = ((40, 20, 13, 10, 8, 6, 5, 5), (30, 15, 10, 7, 6, 5, 4, 3))
# (m, hidden, inter, group, clusters, want): Meditron-7B's FFN at decode
# (batch 4 and 32, group 128 and 64 on the roomier card: the two streaming
# kernels, each in the most splits whose clusters all run at once, at least
# STREAM_MIN_GROUPS scale groups a gate/up split), on a card too small, past the threshold
# (33 rows) and at prefill (4 x 512 and 32 x 512 rows: the two prefill
# kernels over 43 j-blocks and 16 output strips); and odd widths: one
# gate/up split of two groups and two j-blocks (inter 384), groups of 32
# with a j-block of 64, a j-block of 192
K7_PLANS = [(4, 4096, 11008, 128, K7_CARD_A, ("stream", 2, 16, 7, 7)),
            (32, 4096, 11008, 128, K7_CARD_B, ("stream", 2, 16, 4, 11)),
            (4, 4096, 11008, 64, K7_CARD_C, ("stream", 3, 22, 8, 6)),
            (1, 4096, 11008, 128, K7_CARD_0, ("stream", 1, 32, 1, 43)),
            (33, 4096, 11008, 128, (), ("wgmma", 43, 16)),
            (2048, 4096, 11008, 128, (), ("wgmma", 43, 16)),
            (16384, 4096, 11008, 128, (), ("wgmma", 43, 16)),
            (4, 256, 384, 128, K7_CARD_A, ("stream", 1, 2, 2, 1)),
            (20, 160, 64, 128, K7_CARD_A, ("stream", 1, 5, 1, 1)),
            (32, 192, 192, 128, K7_CARD_B, ("stream", 1, 3, 1, 1))]


@pytest.mark.parametrize("m, hidden, inter, group, clusters, want", K7_PLANS)
def test_int4_ffn_plan_takes_the_kernel_by_rows(m, hidden, inter, group, clusters, want):
    """K7's dispatch: up to ``STREAM_MAX_ROWS`` rows the two streaming
    kernels (gate/up over splits of the hidden scale groups, down over
    splits of the j-blocks; a j-block's or strip's splits form one cluster,
    which adds them itself: two launches), as many splits as let every
    cluster run at once; above, the two prefill kernels (gate/up one block
    column a j-block, down one a 256-column output strip), no reduction.
    w4a8 adds one activation-quantization launch."""
    plan = tq.int4_ffn_plan(m, hidden, inter, group, clusters)
    assert plan == want
    assert (plan[0] == "stream") == (m <= tq.STREAM_MAX_ROWS)
    g_h, g_i = tq._int4_group(hidden, group), tq._int4_group(inter, group)
    bj = tq.ffn_block_j(inter, g_i)
    n_j = -(-inter // bj)
    if plan[0] == "stream":
        _, gu, gu_per, dn, dn_per = plan
        groups, strips = hidden // g_h, -(-hidden // tq.FFN_STREAM_COLUMNS)
        assert (gu - 1) * gu_per < groups <= gu * gu_per
        assert (dn - 1) * dn_per < n_j <= dn * dn_per
        assert max(gu, dn) <= tq.FFN_STREAM_MAX_SPLITS
        assert gu == 1 or (clusters[0][gu - 1] >= n_j and gu_per >= tq.STREAM_MIN_GROUPS)
        assert dn == 1 or clusters[1][dn - 1] >= strips
    else:
        assert plan == ("wgmma", n_j, -(-hidden // tq.PREFILL_COLUMNS))
    suffix = "" if m <= tq.STREAM_MAX_ROWS else "_prefill"
    for act_quant in (False, True):
        assert tq.int4_ffn_launches(m, hidden, inter, group, act_quant) == {
            ("int4_ffn_a8" if act_quant else "int4_ffn") + suffix: 2,
            "int4_act_quant": int(act_quant)}


def test_int4_ffn_w4a8_requantizes_per_j_block():
    """The kernel form's h scale is taken over each 256-column j-block, ctpa's
    xla branch over the full row: with one block of h much larger than the
    rest the two differ, and the port's plain version follows the kernel."""
    hidden, inter, m = 64, 512, 3
    x = _normal(11, m, hidden)
    wg, wu, wd = (_normal(12, hidden, inter, scale=0.1), _normal(13, hidden, inter, scale=0.1),
                  _normal(14, inter, hidden, scale=0.1))
    wu[:, 256:] *= 50.0                                 # the second j-block's h is 50x larger
    jw = []
    for w in (wg, wu, wd):
        jw += list(jq.quantize_int4(jnp.asarray(w)))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jq.int4_ffn(jnp.asarray(x), *jw, impl="pallas", act_quant=True))
    got = tq.int4_ffn(_t(x), *map(_t, jw), act_quant=True)
    xla = tq.int4_ffn(_t(x), *map(_t, jw), impl="xla", act_quant=True)
    close(got, ref, OP_TOL, OP_TOL)
    assert (got - xla).abs().max() > 100 * OP_TOL * (1 + np.abs(ref).max())


# ------------------------------------------------------- quantize_tree and convert

JLLM = jc.LLMConfig.tiny()
TLLM = tc.LLMConfig.tiny()
LORA = jc.LoRAConfig(rank=4, alpha=8.0)


def _tiny_params(lora=None, seed=20):
    model = jllm.LlamaForCausalLM(JLLM, lora=lora)
    return np_params(init_shapes(model, jnp.ones((1, 4), jnp.int32)), seed)


def _flat(tree):
    return {k: np.array(v) for k, v in flax_to_state_dict(to_numpy(tree)).items()}


@pytest.mark.parametrize("bits,fuse,ffn_kernel", [(4, True, False), (4, True, True),
                                                  (4, False, False), (8, True, False),
                                                  (8, False, True)])
def test_quantize_tree_matches_ctpa(bits, fuse, ffn_kernel):
    params = _tiny_params()
    ref = _flat(jq.quantize_tree({"params": params}, bits=bits, fuse=fuse,
                                 ffn_kernel=ffn_kernel)["params"])
    state = {k: torch.from_numpy(v) for k, v in _flat(params).items()}
    got = tq.quantize_tree(state, bits=bits, fuse=fuse, ffn_kernel=ffn_kernel)
    assert set(got) == set(ref)
    for key, value in got.items():
        assert value.dtype == torch.from_numpy(ref[key]).dtype, key
        assert np.array_equal(value.numpy(), ref[key]), key
    # the converted ctpa tree keeps ctpa's names and layouts
    leaf = "scale_g" if bits == 4 else "scale"
    assert ("model.layers.0.self_attn.qkv_proj." + leaf in ref) == fuse
    assert ("model.layers.0.mlp.gateup_proj.kernel_q" in ref) == (fuse and not ffn_kernel)
    assert ref["lm_head.kernel_q"].shape == ((32, 512) if bits == 4 else (64, 512))
    assert ref["lm_head.kernel_q"].dtype == np.int8
    assert "model.norm.weight" in ref and "model.embed_tokens.weight" in ref


def test_quantize_tree_merges_lora_like_ctpa():
    """The trained adapters are merged (models/lora.py:merge_lora_scaled), the
    ``base`` level collapses and the adapters are dropped.  ctpa's and the
    port's A @ B round differently in fp32, so a packed nibble may sit one
    level apart where a value lies on a rounding boundary."""
    params = _tiny_params(LORA, seed=21)
    ref = _flat(jq.quantize_tree({"params": params}, bits=4, lora=LORA)["params"])
    state = {k: torch.from_numpy(v) for k, v in _flat(params).items()}
    assert any(".base.weight" in k for k in state) and any("lora_a" in k for k in state)
    got = tq.quantize_tree(state, bits=4, lora=tc.LoRAConfig(rank=4, alpha=8.0))
    assert set(got) == set(ref) and not any("lora" in k or ".base." in k for k in got)
    for key, value in got.items():
        if key.endswith("kernel_q"):
            g = tq._int4_group(value.shape[0] * 2, 128)
            q_got, q_ref = tq._unpack_int4(value, g), tq._unpack_int4(_t(ref[key]), g)
            diff = (q_got.int() - q_ref.int()).abs()
            assert diff.max() <= 1 and (diff > 0).float().mean() <= 5e-3, key
        elif key.endswith("scale_g"):
            close(value, ref[key], 0.0, 1e-6)
        else:
            assert np.array_equal(value.numpy(), ref[key]), key


def test_quantize_tree_raises_like_ctpa():
    lora_state = {k: torch.from_numpy(v) for k, v in _flat(_tiny_params(LORA, 22)).items()}
    with pytest.raises(ValueError):
        jq.quantize_tree({"params": _tiny_params(LORA, 22)})
    with pytest.raises(ValueError):                     # adapters without their config
        tq.quantize_tree(lora_state, bits=4)
    state = {k: torch.from_numpy(v) for k, v in _flat(_tiny_params()).items()}
    with pytest.raises(ValueError):
        jq.quantize_tree({"params": _tiny_params()}, targets=("q_proj", "o_proj"))
    with pytest.raises(ValueError):                     # an incomplete fuse group
        tq.quantize_tree(state, targets=("q_proj", "o_proj"))
    with pytest.raises(ValueError):
        tq.quantize_tree(state, bits=3)
    # without fuse, a partial target list is fine
    out = tq.quantize_tree(state, targets=("q_proj", "o_proj"), fuse=False, bits=4)
    assert "model.layers.0.self_attn.q_proj.kernel_q" in out
    assert "model.layers.0.self_attn.k_proj.base.weight" in out


def test_convert_carries_quantized_trees_exactly():
    """A ctpa int4 tree loads into the port's int4 model with its int8 payloads
    copied exactly (no float round trip) and its scales as they are; an int8
    tree's ``scale`` beside ``kernel_q`` stays ``scale``."""
    qtree = jq.quantize_tree({"params": _tiny_params()}, bits=4)["params"]
    model = load_flax_params(
        tllm.LlamaForCausalLM(dataclasses.replace(TLLM, weight_quant="int4"), device="cpu"),
        to_numpy(qtree))
    state = model.state_dict()
    kq = np.asarray(qtree["model"]["layers_1"]["self_attn"]["qkv_proj"]["kernel_q"])
    assert state["model.layers.1.self_attn.qkv_proj.kernel_q"].dtype == torch.int8
    assert np.array_equal(state["model.layers.1.self_attn.qkv_proj.kernel_q"].numpy(), kq)
    assert np.array_equal(state["lm_head.scale_g"].numpy(),
                          np.asarray(qtree["lm_head"]["scale_g"]))
    int8 = flax_to_state_dict(to_numpy(jq.quantize_tree({"params": _tiny_params()})["params"]))
    assert "model.layers.0.self_attn.o_proj.scale" in int8
    assert "model.layers.0.self_attn.o_proj.weight" not in int8
    assert int8["lm_head.kernel_q"].dtype == np.int8 and int8["lm_head.scale"].shape == (512,)


# ------------------------------------------------------- the quantized LLM

@pytest.fixture(scope="module")
def float_llm_params():
    return _tiny_params(seed=23)


def _prompts():
    rng = np.random.default_rng(24)
    ids = rng.integers(1, JLLM.vocab_size, size=(2, 5))
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]])
    return ids * mask, mask


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("ffn_kernel", [False, True])
@pytest.mark.parametrize("act_quant", [False, True])
def test_int4_llm_prefill_and_cached_decode_match_ctpa(float_llm_params, act_quant, ffn_kernel,
                                                       impl):
    over = dict(weight_quant="int4", quant_act=act_quant, quant_ffn_kernel=ffn_kernel,
                quant_impl=impl, kv_quant="int8", flash_decode=True)
    jcfg, tcfg = dataclasses.replace(JLLM, **over), dataclasses.replace(TLLM, **over)
    qtree = jq.quantize_tree({"params": float_llm_params}, bits=4, ffn_kernel=ffn_kernel)
    japply = jax.jit(jllm.LlamaForCausalLM(jcfg).apply, static_argnames="shared_kv_offset")
    tm = load_flax_params(tllm.LlamaForCausalLM(tcfg, device="cpu"),
                          to_numpy(qtree["params"]))
    assert isinstance(tm.lm_head, tllm.Int4Dense) and tm.model.layers[0].self_attn.fused
    ids, mask = _prompts()
    jcache = jllm.KVCache.create(jcfg, 2, max_len=9, dtype=jnp.float32)
    tcache = tllm.KVCache.create(tcfg, 2, max_len=9, dtype=torch.float32, device="cpu")

    def check(got, ref):
        if not act_quant:
            return close(got, ref, LLM_TOL, LLM_TOL)
        got, ref = got.numpy(), np.asarray(ref)
        assert np.abs(got - ref).max() <= A8_LOGIT_REL * np.abs(ref).max()
        assert np.array_equal(got.argmax(-1), ref.argmax(-1))

    with pltpu.force_tpu_interpret_mode(), torch.no_grad():
        ref, _, jcache = japply(qtree, jnp.asarray(ids), jnp.asarray(mask), jcache,
                                shared_kv_offset=True)
        got, _, tcache = tm(_t(ids), _t(mask), tcache, shared_kv_offset=True)
        check(got, ref)
        step = np.argmax(np.asarray(ref)[np.arange(2), mask.sum(-1) - 1], -1)
        for _ in range(2):
            ref, _, jcache = japply(qtree, jnp.asarray(step[:, None]), None, jcache,
                                    shared_kv_offset=True)
            got, _, tcache = tm(_t(step[:, None]), None, tcache, shared_kv_offset=True)
            check(got, ref)
            step = np.argmax(np.asarray(ref)[:, 0], -1)


def test_int4_llm_unfused_layout_matches_ctpa(float_llm_params):
    over = dict(weight_quant="int4", quant_fused=False, quant_impl="xla")
    qtree = jq.quantize_tree({"params": float_llm_params}, bits=4, fuse=False)
    tm = load_flax_params(tllm.LlamaForCausalLM(dataclasses.replace(TLLM, **over), device="cpu"),
                          to_numpy(qtree["params"]))
    ids, mask = _prompts()
    ref, _, _ = jllm.LlamaForCausalLM(dataclasses.replace(JLLM, **over)).apply(
        qtree, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got, _, _ = tm(_t(ids), _t(mask))
    close(got, ref, LLM_TOL, LLM_TOL)


def test_quantized_settings_are_accepted_or_refused():
    for over in (dict(weight_quant="int4"), dict(weight_quant="int4", quant_act=True),
                 dict(weight_quant="int4", quant_ffn_kernel=True, quant_impl="xla"),
                 dict(weight_quant="int4", quant_fused=False, kv_quant="int8"),
                 dict(weight_quant="int8"), dict(weight_quant="int8", kv_quant="int4"),
                 dict(weight_quant="int4", kv_quant="int4")):
        tllm.LlamaForCausalLM(dataclasses.replace(TLLM, **over), device="cpu")
    for over in (dict(weight_quant="int4", kv_int8_dots=True),
                 dict(weight_quant="int4", kv_quant_group=16)):
        with pytest.raises(NotImplementedError):
            tllm.LlamaForCausalLM(dataclasses.replace(TLLM, **over), device="cpu")
    for over in (dict(weight_quant="int2"), dict(weight_quant="int4", quant_impl="triton")):
        with pytest.raises(ValueError):
            tllm.LlamaForCausalLM(dataclasses.replace(TLLM, **over), device="cpu")
    with pytest.raises(ValueError):                     # LoRA on quantized weights
        tllm.LlamaForCausalLM(dataclasses.replace(TLLM, weight_quant="int4"),
                              lora=tc.LoRAConfig(rank=4), device="cpu")


# ------------------------------------------------------- generate and the bundle

JVIT = jc.CTViTConfig.tiny()
TVIT = tc.CTViTConfig.tiny()
GEN = jc.ReportGenConfig(vision_dim=24)
TGEN = tc.ReportGenConfig(vision_dim=24)
QUANT = dict(weight_quant="int4", quant_ffn_kernel=True, kv_quant="int8", flash_decode=True)


def _video(seed, b=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(b, 1, TVIT.temporal_size, TVIT.image_size,
                                    TVIT.image_size)).astype(np.float32)


@pytest.fixture(scope="module")
def generator_params():
    ids, mask = _prompts()
    jm = jrg.CTReportGenerator(JLLM, JVIT, GEN)
    return np_params(init_shapes(jm, jnp.asarray(_video(25)), jnp.asarray(ids),
                                 jnp.asarray(mask)), 26)


@pytest.mark.parametrize("act_quant", [False, True])
def test_int4_generate_matches_ctpa(generator_params, act_quant):
    over = dict(QUANT, quant_act=act_quant)
    qtree = jq.quantize_tree({"params": generator_params}, bits=4, ffn_kernel=True)
    jm = jrg.CTReportGenerator(dataclasses.replace(JLLM, **over), JVIT, GEN)
    tm = load_flax_params(CTReportGenerator(dataclasses.replace(TLLM, **over), TVIT, TGEN,
                                            device="cpu"), to_numpy(qtree["params"]))
    ids, mask = _prompts()
    video = _video(27)
    with pltpu.force_tpu_interpret_mode():
        ref = jm.apply(qtree, jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask), 4, -1, 0,
                       greedy=True, method=jrg.CTReportGenerator.generate)
    got = tm.generate(_t(video), _t(ids), _t(mask), 4, -1, 0, greedy=True)
    assert tm.cache_dtype() == torch.float32
    assert np.array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert np.array_equal(got.lengths.numpy(), np.asarray(ref.lengths))


def test_serving_bundle_round_trip(generator_params, tmp_path):
    """A LoRA fine-tune's checkpoint (trained tensors only) and its base go
    through export_serving.main; the loaded bundle gives the logits of the
    model quantized in memory, and a directory that is not a bundle is
    refused."""
    lora = tc.LoRAConfig(rank=4, alpha=8.0)
    model = load_flax_params(CTReportGenerator(TLLM, TVIT, TGEN, device="cpu"),
                             to_numpy(generator_params))
    base_path = tmp_path / "base.pt"
    torch.save(model.state_dict(), base_path)
    trained = CTReportGenerator(TLLM, TVIT, TGEN, lora=lora, device="cpu")
    trained.load_state_dict(model.state_dict(), strict=False)
    rng = np.random.default_rng(28)
    params = {n: torch.from_numpy(rng.normal(scale=0.05, size=tuple(p.shape)).astype(np.float32))
              for n, p in trained.named_parameters() if "lora_" in n or "cross_attention" in n}
    CheckpointManager(str(tmp_path / "ckpt")).save(3, {"params": params, "step": 3})
    out = tmp_path / "bundle"
    argv = ["--checkpoint-dir", str(tmp_path / "ckpt"), "--base", str(base_path), "--out",
            str(out), "--quant", "int4", "--ffn-kernel", "--act-quant", "--kv-quant", "int8",
            "--flash-decode", "--lora-rank", "4", "--lora-alpha", "8", "--device", "cpu"]
    assert export_serving.main(argv) == 0
    loaded, meta = export_serving.load_serving_bundle(
        str(out), llm_cfg=TLLM, vit_cfg=TVIT, gen_cfg=TGEN, dtype=torch.float32, device="cpu")
    assert meta["kind"] == "ctpa-serving-bundle" and meta["source_step"] == 3
    assert meta["lora_merged"] == {"rank": 4, "alpha": 8.0}
    assert loaded.llm_cfg.quant_act and loaded.llm_cfg.quant_ffn_kernel
    assert loaded.llm_cfg.kv_quant == "int8" and loaded.llm_cfg.flash_decode
    # the same merge and quantization in memory
    full = dict(model.state_dict())
    full.update(params)
    cfg = dataclasses.replace(TLLM, **QUANT, quant_act=True)
    ref = CTReportGenerator(cfg, TVIT, TGEN, device="cpu")
    ref.load_state_dict(tq.quantize_tree(full, bits=4, ffn_kernel=True, lora=lora))
    ids, mask = _prompts()
    video = _t(_video(29))
    with torch.no_grad():
        assert torch.equal(loaded(video, _t(ids), _t(mask)), ref(video, _t(ids), _t(mask)))
    got = loaded.generate(video, _t(ids), _t(mask), 4, -1, 0, greedy=True)
    assert torch.equal(got.tokens, ref.generate(video, _t(ids), _t(mask), 4, -1, 0,
                                                greedy=True).tokens)
    for not_bundle in (tmp_path / "ckpt", tmp_path / "missing"):
        with pytest.raises(ValueError):
            export_serving.load_serving_bundle(str(not_bundle), llm_cfg=TLLM, vit_cfg=TVIT,
                                               gen_cfg=TGEN, device="cpu")
