"""The port's int8 quantized serving slice against ctpa's, on the CPU.

The same numpy-seeded inputs and weights go through ctpa's function and the
port's.  On the CPU the K4 and K6 wrappers take their plain versions; ctpa's
Pallas kernels run in interpret mode (``pltpu.force_tpu_interpret_mode``, as
``tests/test_quant.py`` runs them) with synchronous CPU dispatch (set in a
module fixture).  The CUDA kernels are held against the same plain versions
on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).

Tolerances, fp32 on both sides:
  * K4 against ctpa's Pallas kernel and xla branch: 1e-5 of max|ref| + 1e-5
    relative (w8: the same exact products summed in another order; w8a8:
    the same exact int32 sums, scaled in the same order);
  * K6 against ctpa's kernel: 1e-4 abs + 1e-4 rel of outputs of order 1 (the
    sums in another order; in w8a8 the order can also move an element of h
    across a rounding boundary of its int8 grid, one level of one element,
    which stays far inside this);
  * the tiny LLM's logits over a prefill and 2 cached steps: 2e-4 abs + rel
    weight-only; w8a8 2% of the largest logit with the same argmax in every
    row (a one-ulp difference in an activation can move a value on a
    rounding boundary of its row's int8 grid by one level, as in
    ``tests/test_torch_quant.py``).  The greedy generator: the same tokens;
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
MM_TOL = 1e-5
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


def close_mm(got, ref):
    close(got, ref, MM_TOL * np.abs(np.asarray(ref)).max(), MM_TOL)


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


def _int8_weights(seed, *shape):
    return jq.quantize_int8(jnp.asarray(_normal(seed, *shape, scale=0.05)))


# ------------------------------------------------------- K4

K4_CASES = [  # (m, in, out, pallas block_in, block_out): tests/test_quant.py's shapes
    (4, 384, 300, 128, 128),      # three in-blocks, ragged out
    (5, 256, 200, 128, 128),
    (3, 100, 48, 2048, 1024),     # ragged in, one block
    (8, 512, 384, 256, 128),
    (17, 192, 136, 128, 128),     # more rows than one bf16 row tile
    (32, 384, 300, 128, 128),     # the decode kernel's largest row count (batch 32)
    (70, 384, 520, 128, 256),     # the prefill kernel: 70 rows, ragged out
    (300, 256, 200, 128, 128),    # the prefill kernel over two of ctpa's row blocks
]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("case", K4_CASES)
def test_int8_matmul_matches_ctpa(case, act_quant):
    m, d_in, d_out, block_in, block_out = case
    x = _normal(3, m, d_in)
    jw8, js = _int8_weights(4, d_in, d_out)
    with pltpu.force_tpu_interpret_mode():
        ref = jq.int8_matmul(jnp.asarray(x), jw8, js, impl="pallas", act_quant=act_quant,
                             block_in=block_in, block_out=block_out)
    ref_xla = jq.int8_matmul(jnp.asarray(x), jw8, js, impl="xla", act_quant=act_quant)
    w8, s = _t(jw8), _t(js)
    before = dict(tq.LAUNCHES)
    got = tq.int8_matmul(_t(x), w8, s, act_quant=act_quant)
    assert tq.LAUNCHES == before                       # the CPU takes the plain version
    close_mm(got, ref)
    close_mm(tq.int8_matmul_plain(_t(x), w8, s, act_quant=act_quant), ref)
    close_mm(tq.int8_matmul(_t(x), w8, s, impl="xla", act_quant=act_quant), ref_xla)


# How many clusters of 1-8 blocks of K4's decode kernel example cards run at
# once: two blocks an SM (96 strips' clusters of 2 fit, not of 3), one
# block an SM, and a card that fits too few.  The prefill kernel holds one
# block an SM (K4_CARD_1)
K4_CARD_2 = (264, 132, 88, 66, 52, 44, 36, 32)
K4_CARD_1 = (132, 66, 44, 33, 26, 22, 18, 16)
K4_CARD_0 = (40, 20, 13, 10, 8, 6, 5, 5)
# (m, in, out, clusters, want): Meditron-7B's qkv_proj, o_proj and lm_head
# at decode (the streaming kernel, as many splits of 64-row stages as let
# every strip's cluster run at once, added in its own launch), the unfused
# FFN's down projection at 32 rows on a one-block card; past the threshold
# (33 rows: the prefill kernel's 48 or 16 blocks, too few for the card, so
# its contraction splits across clusters of 2 or 8), at prefill (4 x 512
# rows: 16 token tiles x 48 strips, no split) and at the batch-32 prefill
# (16,384 rows); a ragged contraction (513: a last stage of one row) and a
# contraction too short to split
K4_PLANS = [(4, 4096, 12288, K4_CARD_2, ("stream", 2, 32)),
            (4, 4096, 4096, K4_CARD_2, ("stream", 8, 8)),
            (4, 4096, 32000, K4_CARD_2, ("stream", 1, 64)),
            (32, 11008, 4096, K4_CARD_1, ("stream", 4, 43)),
            (33, 4096, 4096, K4_CARD_1, ("wgmma", 1, 16, 8, 4)),
            (33, 4096, 12288, K4_CARD_1, ("wgmma", 1, 48, 2, 16)),
            (2048, 4096, 12288, K4_CARD_1, ("wgmma", 16, 48, 1, 32)),
            (16384, 4096, 12288, K4_CARD_1, ("wgmma", 128, 48, 1, 32)),
            (5, 513, 1000, K4_CARD_2, ("stream", 2, 5)),
            (2, 72, 40, K4_CARD_0, ("stream", 1, 2))]


@pytest.mark.parametrize("m, d_in, d_out, clusters, want", K4_PLANS)
def test_int8_matmul_plan_takes_the_kernel_by_rows(m, d_in, d_out, clusters, want):
    """K4's dispatch: up to ``STREAM_MAX_ROWS`` rows the streaming kernel,
    above the prefill kernel; either adds its splits (a cluster's blocks)
    inside its one launch, so a call is one launch at any row count, with
    no reduction, and w8a8 adds one activation-quantization launch.  The
    splits cut the contraction in stages or 128-row chunks, the last split
    possibly shorter, and every cluster runs at once."""
    plan = tq.int8_matmul_plan(m, d_in, d_out, clusters)
    assert plan == want
    kernel, *_, splits, per = plan
    assert (kernel == "stream") == (m <= tq.STREAM_MAX_ROWS)
    assert splits <= tq.FFN_STREAM_MAX_SPLITS
    if kernel == "stream":
        stages, strips = -(-d_in // tq.INT8_STREAM_KC), -(-d_out // tq.STREAM_COLUMNS)
        assert (splits - 1) * per < stages <= splits * per
        assert splits == 1 or (clusters[splits - 1] >= strips
                               and per >= tq.FFN_STREAM_MIN_STAGES)
    else:
        _, tiles, strips, _, _ = plan
        chunks = -(-d_in // tq.PREFILL_KC)
        assert (tiles, strips) == (-(-m // tq.PREFILL_TOKENS), -(-d_out // tq.PREFILL_COLUMNS))
        assert (splits - 1) * per < chunks <= splits * per
        assert splits == 1 or (clusters[splits - 1] >= tiles * strips
                               and per >= tq.PREFILL_MIN_CHUNKS)
    suffix = "" if m <= tq.STREAM_MAX_ROWS else "_prefill"
    for act_quant in (False, True):
        assert tq.int8_matmul_launches(m, act_quant) == {
            ("int8_matmul_a8" if act_quant else "int8_matmul") + suffix: 1,
            "int4_act_quant": int(act_quant)}


def test_int8_matmul_scales_after_the_sum():
    """w8 sums x . w8 with the int8 weight exact in x's dtype and scales the
    columns after the sum (ctpa's ``_q_kernel``), which rounds differently
    from a product with the weight dequantized to bf16 first."""
    x = _t(_normal(5, 6, 256)).to(torch.bfloat16)
    w8, s = tq.quantize_int8(_t(_normal(6, 256, 64, scale=0.1)))
    want = ((x.float() @ w8.float()) * s).to(torch.bfloat16)
    assert torch.equal(tq.int8_matmul(x, w8, s), want)
    first = (x.float() @ tq.dequantize_int8(w8, s).float()).to(torch.bfloat16)
    assert not torch.equal(want, first)


def test_int8_plain_sums_are_exact_past_fp32():
    """The w8a8 plain versions sum int8 x int8 products over rows of up to
    11008 (Meditron's down_proj) exactly: at +-127 operands the sums pass
    2^24, where an fp32 product rounds; ``_int_dot`` equals the int64 sum
    rounded once to fp32, as the kernels convert their exact int32 sums."""
    rng = np.random.default_rng(7)
    k = 11008
    a = (127 * np.where(rng.random((4, k)) < 0.9, 1, -1)).astype(np.int8)
    b = rng.choice(np.array([126, 127, -127], np.int8), size=(k, 24), p=[0.45, 0.45, 0.1])
    exact = torch.from_numpy(a.astype(np.int64)) @ torch.from_numpy(b.astype(np.int64))
    assert exact.abs().max() > 2 ** 24
    got = tq._int_dot(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(got, exact.float())
    assert not torch.equal(torch.from_numpy(a).float() @ torch.from_numpy(b).float(),
                           exact.float())
    # the w8a8 matmul on +-127 rows: the exact sums times the row and column
    # scales, in that order
    x = torch.from_numpy(a).float() / 127.0                    # row scale exactly 1/127
    scale = torch.full((24,), 0.01)
    x8, sx = tq.quantize_act_int8(x)
    assert torch.equal(x8, torch.from_numpy(a))
    want = (exact.float() * sx * scale)
    assert torch.equal(tq.int8_matmul_plain(x, torch.from_numpy(b), scale, act_quant=True), want)


def test_int8_wrappers_check_inputs():
    x = torch.zeros(2, 256)
    w8, s = tq.quantize_int8(torch.zeros(256, 64))
    with pytest.raises(ValueError):
        tq.int8_matmul(x[:, :128], w8, s)                 # in does not match
    with pytest.raises(ValueError):
        tq.int8_matmul(x, w8, s[:8])                      # wrong scale shape
    with pytest.raises(ValueError):
        tq.int8_matmul(x, w8.float(), s)                  # not int8
    with pytest.raises(ValueError):
        tq.int8_matmul(x, w8, s.double())                 # scale not fp32
    with pytest.raises(ValueError):
        tq.int8_matmul(x, w8, s, impl="triton")
    wd8, sd = tq.quantize_int8(torch.zeros(64, 256))
    with pytest.raises(ValueError):
        tq.int8_ffn(x, w8, s, w8, s, w8, s)               # down must be (inter, hidden)
    with pytest.raises(ValueError):
        tq.int8_ffn(x, w8, s, w8, s, wd8, sd[:4])         # wrong down scale
    with pytest.raises(ValueError):
        tq.int8_ffn(x, w8, s, w8, s, wd8, sd, impl="cuda")
    assert tq.int8_ffn(x, w8, s, w8, s, wd8, sd).shape == (2, 256)


# ------------------------------------------------------- K6

K6_CASES = [  # (m, hidden, inter, block_j): tests/test_quant.py:215-285 and Meditron's rule
    (5, 128, 176, 64),     # inter padded to 192 in ctpa, three j-blocks
    (4, 64, 384, 256),     # the kernel's block_j: the last j-block padded (384 -> 512)
    (9, 128, 520, 256),    # three j-blocks, the last 8 columns wide
    (32, 128, 520, 256),   # the decode kernels' largest row count (batch 32)
    (70, 128, 520, 256),   # the prefill kernels: 70 rows, not a multiple of their token tile
]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("case", K6_CASES)
def test_int8_ffn_matches_ctpa(case, act_quant):
    m, hidden, inter, block_j = case
    x = _normal(8, m, hidden)
    jw = []
    for seed, shape in ((9, (hidden, inter)), (10, (hidden, inter)), (11, (inter, hidden))):
        jw += list(_int8_weights(seed, *shape))
    with pltpu.force_tpu_interpret_mode():
        ref = jq.int8_ffn(jnp.asarray(x), *jw, block_j=block_j, act_quant=act_quant)
    tw = [_t(a) for a in jw]
    close(tq.int8_ffn_plain(_t(x), *tw, act_quant=act_quant, block_j=block_j), ref, OP_TOL,
          OP_TOL)
    if block_j == tq.INT8_BLOCK_J:
        before = dict(tq.LAUNCHES)
        close(tq.int8_ffn(_t(x), *tw, act_quant=act_quant), ref, OP_TOL, OP_TOL)
        assert tq.LAUNCHES == before
    # impl="xla": ctpa's LlamaMLP composition of three Int8Dense(impl="xla")
    gate = jq.int8_matmul(jnp.asarray(x), *jw[0:2], impl="xla", act_quant=act_quant)
    up = jq.int8_matmul(jnp.asarray(x), *jw[2:4], impl="xla", act_quant=act_quant)
    ref_xla = jq.int8_matmul(jax.nn.silu(gate) * up, *jw[4:6], impl="xla", act_quant=act_quant)
    close(tq.int8_ffn(_t(x), *tw, impl="xla", act_quant=act_quant), ref_xla, OP_TOL, OP_TOL)


# How many clusters of 1-8 blocks (gate/up, down) two example cards run at
# once: one holding two gate/up blocks an SM, whose GPCs fit 5 clusters of
# 5 blocks or fewer of 6 (so 42 of 6 fit, short of 43 j-blocks), and one
# holding one (43 clusters of 3 fit, not of 4); and a card that fits too
# few even of one block
CARD_2 = ((264, 132, 88, 66, 52, 42, 36, 32), (528, 264, 176, 132, 104, 88, 72, 64))
CARD_1 = ((132, 66, 44, 33, 26, 22, 18, 16), (264, 132, 88, 66, 52, 44, 36, 32))
CARD_0 = ((40, 20, 13, 10, 8, 6, 5, 5), (30, 15, 10, 7, 6, 5, 4, 3))
# (m, hidden, inter, clusters, want): Meditron-7B's FFN at decode (batch 4
# and 32: the two streaming kernels, each in the most splits whose clusters
# all run at once), on each card, past the threshold (33 rows) and at
# prefill (4 x 512 and 32 x 512 rows: the two prefill kernels over 43
# j-blocks and 16 output strips), and at small widths (one split, one
# j-block)
K6_PLANS = [(4, 4096, 11008, CARD_2, ("stream", 5, 26, 8, 6)),
            (32, 4096, 11008, CARD_2, ("stream", 5, 26, 8, 6)),
            (1, 4096, 11008, CARD_1, ("stream", 3, 43, 8, 6)),
            (4, 4096, 11008, CARD_0, ("stream", 1, 128, 1, 43)),
            (33, 4096, 11008, (), ("wgmma", 43, 16)),
            (2048, 4096, 11008, (), ("wgmma", 43, 16)),
            (16384, 4096, 11008, (), ("wgmma", 43, 16)),
            (4, 64, 64, CARD_2, ("stream", 1, 2, 1, 1)),
            (32, 80, 520, CARD_2, ("stream", 1, 3, 3, 1))]


@pytest.mark.parametrize("m, hidden, inter, clusters, want", K6_PLANS)
def test_int8_ffn_plan_takes_the_kernel_by_rows(m, hidden, inter, clusters, want):
    """K6's dispatch: up to ``STREAM_MAX_ROWS`` rows the two streaming
    kernels (gate/up over splits of the hidden rows, down over splits of
    the j-blocks; a j-block's or strip's splits form one cluster, which adds
    them itself: two launches), as many splits as let every cluster run at
    once; above, the two prefill kernels (gate/up one block column a
    j-block, down one a 256-column output strip), no reduction.  w8a8 adds
    one activation-quantization launch."""
    plan = tq.int8_ffn_plan(m, hidden, inter, clusters)
    assert plan == want
    assert (plan[0] == "stream") == (m <= tq.STREAM_MAX_ROWS)
    n_j = -(-inter // tq.INT8_BLOCK_J)
    if plan[0] == "stream":
        _, gu, gu_per, dn, dn_per = plan
        stages = -(-hidden // tq.FFN_STREAM_KC)
        strips = -(-hidden // tq.FFN_STREAM_COLUMNS)
        assert (gu - 1) * gu_per < stages <= gu * gu_per
        assert (dn - 1) * dn_per < n_j <= dn * dn_per
        assert max(gu, dn) <= tq.FFN_STREAM_MAX_SPLITS
        # every cluster runs at once, unless not even single blocks do
        assert gu == 1 or clusters[0][gu - 1] >= n_j
        assert dn == 1 or clusters[1][dn - 1] >= strips
    else:
        assert plan == ("wgmma", n_j, -(-hidden // tq.PREFILL_COLUMNS))
    suffix = "" if m <= tq.STREAM_MAX_ROWS else "_prefill"
    for act_quant in (False, True):
        assert tq.int8_ffn_launches(m, hidden, inter, act_quant) == {
            ("int8_ffn_a8" if act_quant else "int8_ffn") + suffix: 2,
            "int4_act_quant": int(act_quant)}


def test_int8_ffn_w8a8_requantizes_per_j_block():
    """The kernel form's h scale is taken over each 256-column j-block, ctpa's
    xla composition's over the full row: with one block of h much larger than
    the rest (and its down rows as much smaller) the two differ, and the
    port's plain version follows the kernel."""
    hidden, inter, m = 64, 512, 3
    x = _normal(12, m, hidden)
    wg, wu, wd = (_normal(13, hidden, inter, scale=0.05), _normal(14, hidden, inter, scale=0.05),
                  _normal(15, inter, hidden, scale=0.05))
    wu[:, 256:] *= 50.0                                 # the second j-block's h is 50x larger,
    wd[256:] /= 50.0                                    # its share of the output as the first's
    jw = []
    for w in (wg, wu, wd):
        jw += list(jq.quantize_int8(jnp.asarray(w)))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jq.int8_ffn(jnp.asarray(x), *jw, act_quant=True))
    got = tq.int8_ffn(_t(x), *map(_t, jw), act_quant=True)
    xla = tq.int8_ffn(_t(x), *map(_t, jw), impl="xla", act_quant=True)
    close(got, ref, OP_TOL, OP_TOL)
    assert (got - xla).abs().max() > 100 * OP_TOL * (1 + np.abs(ref).max())


# ------------------------------------------------------- quantize_tree and convert

JLLM = jc.LLMConfig.tiny()
TLLM = tc.LLMConfig.tiny()


def _tiny_params(seed=30):
    model = jllm.LlamaForCausalLM(JLLM)
    return np_params(init_shapes(model, jnp.ones((1, 4), jnp.int32)), seed)


def test_int8_quantize_tree_with_ffn_layout_matches_ctpa():
    """bits 8, fused qkv and the fused FFN's separate gate/up/down: bit for
    bit (the other int8 layouts are in tests/test_torch_quant.py)."""
    params = _tiny_params()
    ref = {k: np.array(v) for k, v in flax_to_state_dict(to_numpy(
        jq.quantize_tree({"params": params}, fuse=True, ffn_kernel=True)["params"])).items()}
    state = {k: torch.from_numpy(np.array(v))
             for k, v in flax_to_state_dict(to_numpy(params)).items()}
    got = tq.quantize_tree(state, bits=8, fuse=True, ffn_kernel=True)
    assert set(got) == set(ref)
    for key, value in got.items():
        assert np.array_equal(value.numpy(), ref[key]), key
    assert "model.layers.0.mlp.down_proj.scale" in ref
    assert "model.layers.0.self_attn.qkv_proj.kernel_q" in ref


def test_ctpa_int8_tree_loads_exactly():
    """A ctpa int8 tree loads into the port's int8 model with its int8
    payloads and scales as they are."""
    qtree = jq.quantize_tree({"params": _tiny_params()}, ffn_kernel=True)["params"]
    cfg = dataclasses.replace(TLLM, weight_quant="int8", quant_ffn_kernel=True)
    model = load_flax_params(tllm.LlamaForCausalLM(cfg, device="cpu"), to_numpy(qtree))
    state = model.state_dict()
    for key, leaf in (("model.layers.1.self_attn.qkv_proj.kernel_q",
                       qtree["model"]["layers_1"]["self_attn"]["qkv_proj"]["kernel_q"]),
                      ("model.layers.0.mlp.gate_proj.scale",
                       qtree["model"]["layers_0"]["mlp"]["gate_proj"]["scale"]),
                      ("lm_head.kernel_q", qtree["lm_head"]["kernel_q"])):
        assert state[key].dtype == _t(leaf).dtype
        assert np.array_equal(state[key].numpy(), np.asarray(leaf)), key
    assert isinstance(model.lm_head, tllm.Int8Dense)
    assert isinstance(model.model.layers[0].mlp.down_proj, tllm.Int8Dense)


# ------------------------------------------------------- the int8 LLM

@pytest.fixture(scope="module")
def float_llm_params():
    return _tiny_params(seed=31)


def _prompts():
    rng = np.random.default_rng(32)
    ids = rng.integers(1, JLLM.vocab_size, size=(2, 5))
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]])
    return ids * mask, mask


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("ffn_kernel", [False, True])
@pytest.mark.parametrize("act_quant", [False, True])
def test_int8_llm_prefill_and_cached_decode_match_ctpa(float_llm_params, act_quant, ffn_kernel,
                                                       fused):
    over = dict(weight_quant="int8", quant_act=act_quant, quant_ffn_kernel=ffn_kernel,
                quant_fused=fused, kv_quant="int8", flash_decode=True)
    jcfg, tcfg = dataclasses.replace(JLLM, **over), dataclasses.replace(TLLM, **over)
    qtree = jq.quantize_tree({"params": float_llm_params}, fuse=fused, ffn_kernel=ffn_kernel)
    japply = jax.jit(jllm.LlamaForCausalLM(jcfg).apply, static_argnames="shared_kv_offset")
    tm = load_flax_params(tllm.LlamaForCausalLM(tcfg, device="cpu"),
                          to_numpy(qtree["params"]))
    assert isinstance(tm.lm_head, tllm.Int8Dense)
    assert tm.model.layers[0].self_attn.fused == fused
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


@pytest.mark.parametrize("act_quant", [False, True])
def test_int8_llm_xla_impl_matches_ctpa(float_llm_params, act_quant):
    """quant_impl="xla" with the fused FFN's layout: ctpa's three Int8Dense
    (impl="xla") against the port's ``_int8_ffn_xla``, no cache."""
    over = dict(weight_quant="int8", quant_act=act_quant, quant_ffn_kernel=True,
                quant_impl="xla")
    qtree = jq.quantize_tree({"params": float_llm_params}, ffn_kernel=True)
    tm = load_flax_params(tllm.LlamaForCausalLM(dataclasses.replace(TLLM, **over), device="cpu"),
                          to_numpy(qtree["params"]))
    ids, mask = _prompts()
    ref, _, _ = jllm.LlamaForCausalLM(dataclasses.replace(JLLM, **over)).apply(
        qtree, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got, _, _ = tm(_t(ids), _t(mask))
    if act_quant:
        got, ref = got.numpy(), np.asarray(ref)
        assert np.abs(got - ref).max() <= A8_LOGIT_REL * np.abs(ref).max()
        assert np.array_equal(got.argmax(-1), ref.argmax(-1))
    else:
        close(got, ref, LLM_TOL, LLM_TOL)


def test_check_ported_accepts_int8():
    for over in (dict(weight_quant="int8"), dict(weight_quant="int8", quant_act=True),
                 dict(weight_quant="int8", quant_ffn_kernel=True, quant_act=True,
                      kv_quant="int8", flash_decode=True),
                 dict(weight_quant="int8", quant_fused=False, quant_impl="xla"),
                 dict(weight_quant="int8", kv_quant="int4")):
        cfg = dataclasses.replace(TLLM, **over)
        tllm.check_ported(cfg)
        model = tllm.LlamaForCausalLM(cfg, device="cpu")
        assert isinstance(model.lm_head, tllm.Int8Dense)
    for over in (dict(weight_quant="int8", kv_int8_dots=True),):
        with pytest.raises(NotImplementedError):
            tllm.check_ported(dataclasses.replace(TLLM, **over))
    with pytest.raises(ValueError):                     # LoRA on quantized weights
        tllm.LlamaForCausalLM(dataclasses.replace(TLLM, weight_quant="int8"),
                              lora=tc.LoRAConfig(rank=4), device="cpu")


# ------------------------------------------------------- generate and the bundle

JVIT = jc.CTViTConfig.tiny()
TVIT = tc.CTViTConfig.tiny()
GEN = jc.ReportGenConfig(vision_dim=24)
TGEN = tc.ReportGenConfig(vision_dim=24)
QUANT = dict(weight_quant="int8", quant_ffn_kernel=True, kv_quant="int8", flash_decode=True)


def _video(seed, b=2):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(b, 1, TVIT.temporal_size, TVIT.image_size,
                                    TVIT.image_size)).astype(np.float32)


@pytest.fixture(scope="module")
def generator_params():
    ids, mask = _prompts()
    jm = jrg.CTReportGenerator(JLLM, JVIT, GEN)
    return np_params(init_shapes(jm, jnp.asarray(_video(33)), jnp.asarray(ids),
                                 jnp.asarray(mask)), 34)


@pytest.mark.parametrize("act_quant", [False, True])
def test_int8_generate_matches_ctpa(generator_params, act_quant):
    over = dict(QUANT, quant_act=act_quant)
    qtree = jq.quantize_tree({"params": generator_params}, ffn_kernel=True)
    jm = jrg.CTReportGenerator(dataclasses.replace(JLLM, **over), JVIT, GEN)
    tm = load_flax_params(CTReportGenerator(dataclasses.replace(TLLM, **over), TVIT, TGEN,
                                            device="cpu"), to_numpy(qtree["params"]))
    ids, mask = _prompts()
    video = _video(35)
    with pltpu.force_tpu_interpret_mode():
        ref = jm.apply(qtree, jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask), 4, -1, 0,
                       greedy=True, method=jrg.CTReportGenerator.generate)
    got = tm.generate(_t(video), _t(ids), _t(mask), 4, -1, 0, greedy=True)
    assert np.array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    assert np.array_equal(got.lengths.numpy(), np.asarray(ref.lengths))


@pytest.mark.parametrize("flags", [[], ["--ffn-kernel", "--act-quant", "--kv-quant", "int8",
                                        "--flash-decode"]])
def test_int8_serving_bundle_round_trip(generator_params, tmp_path, flags):
    """A LoRA fine-tune's checkpoint and its base through export_serving.main
    with the CLI's default flags (an int8 bundle, unfused FFN, float KV
    cache) and with the fused-FFN w8a8 flags: the loaded bundle gives the
    logits and tokens of the model quantized in memory."""
    lora = tc.LoRAConfig(rank=4, alpha=8.0)
    model = load_flax_params(CTReportGenerator(TLLM, TVIT, TGEN, device="cpu"),
                             to_numpy(generator_params))
    base_path = tmp_path / "base.pt"
    torch.save(model.state_dict(), base_path)
    trained = CTReportGenerator(TLLM, TVIT, TGEN, lora=lora, device="cpu")
    trained.load_state_dict(model.state_dict(), strict=False)
    rng = np.random.default_rng(36)
    params = {n: torch.from_numpy(rng.normal(scale=0.05, size=tuple(p.shape)).astype(np.float32))
              for n, p in trained.named_parameters() if "lora_" in n or "cross_attention" in n}
    CheckpointManager(str(tmp_path / "ckpt")).save(2, {"params": params, "step": 2})
    out = tmp_path / "bundle"
    argv = ["--checkpoint-dir", str(tmp_path / "ckpt"), "--base", str(base_path), "--out",
            str(out), "--lora-rank", "4", "--lora-alpha", "8", "--device", "cpu", *flags]
    assert export_serving.main(argv) == 0
    loaded, meta = export_serving.load_serving_bundle(
        str(out), llm_cfg=TLLM, vit_cfg=TVIT, gen_cfg=TGEN, dtype=torch.float32, device="cpu")
    fused_ffn = "--ffn-kernel" in flags
    assert meta["weight_quant"] == "int8" and meta["source_step"] == 2
    assert loaded.llm_cfg.weight_quant == "int8"
    assert loaded.llm_cfg.quant_ffn_kernel == fused_ffn == loaded.llm_cfg.quant_act
    assert isinstance(loaded.llm.lm_head, tllm.Int8Dense)
    full = dict(model.state_dict())
    full.update(params)
    over = dict(weight_quant="int8")
    if fused_ffn:
        over = dict(QUANT, quant_act=True)
    ref = CTReportGenerator(dataclasses.replace(TLLM, **over), TVIT, TGEN, device="cpu")
    ref.load_state_dict(tq.quantize_tree(full, bits=8, ffn_kernel=fused_ffn, lora=lora))
    ids, mask = _prompts()
    video = _t(_video(37))
    with torch.no_grad():
        assert torch.equal(loaded(video, _t(ids), _t(mask)), ref(video, _t(ids), _t(mask)))
    got = loaded.generate(video, _t(ids), _t(mask), 4, -1, 0, greedy=True)
    assert torch.equal(got.tokens, ref.generate(video, _t(ids), _t(mask), 4, -1, 0,
                                                greedy=True).tokens)
