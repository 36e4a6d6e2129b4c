"""The port's cross-attention, causal ALiBi attention and fallback towers
against ctpa's, on the CPU: ``alibi_slopes``/``alibi_bias``,
``cosine_attention(causal=True)`` with and without null columns,
``CosineAttention`` with a context and null key/values, a causal
``Transformer`` with cross-attending blocks, the causal flash path (the
kernel's mask, no ALiBi), the fallback text and vision towers, and
``PatchDropout``.

Inputs are numpy draws from a seed; weights are ctpa's parameter shapes
filled from numpy and carried into the port by ``ctpa_torch.convert``.
Tolerance: 1e-5 abs, fp32 on both sides, differing in the order of sums;
the slopes and biases 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpa.models import attention as jatt
from ctpa.models import fallback_transformers as jfb
from ctpa.ops import attention_ops as jops
from ctpa_torch.convert import load_flax_params
from ctpa_torch.models import attention as tatt
from ctpa_torch.models import fallback_transformers as tfb
from ctpa_torch.ops import attention_ops as tops

torch.set_num_threads(1)
KEY = jax.random.key(0)
TOL = 1e-5
GAINS = ("scale", "gamma", "q_scale", "k_scale")


def _t(x):
    return torch.from_numpy(np.array(x))


def _fill(shapes, seed):
    """Numpy weights for a flax param tree: gains near 1, kernels at
    1/sqrt(fan_in), the rest (null key/values, embeddings) at 0.5."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), np.shape(leaf)
        if name in GAINS:
            return np.asarray(1 + 0.1 * rng.normal(size=shape), np.float32)
        if name == "kernel":
            return np.asarray(rng.normal(size=shape) / np.sqrt(shape[0]), np.float32)
        return np.asarray(0.5 * rng.normal(size=shape), np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _pair(jmod, tmod, *args, seed=1, **kwargs):
    """ctpa's module with numpy weights, and the port's module carrying them."""
    params = _fill(jax.eval_shape(lambda: jmod.init(KEY, *args, **kwargs))["params"], seed)
    return params, load_flax_params(tmod, jax.tree.map(np.asarray, params))


def _close(got, ref, atol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol)


@pytest.fixture(scope="module", autouse=True)
def _sync_dispatch():
    """ctpa's interpreted Pallas kernel deadlocks under asynchronous CPU
    dispatch (tests/conftest.py); this module turns it off while it runs."""
    before = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", before)


# ------------------------------------------------------------------ ALiBi

@pytest.mark.parametrize("heads", [8, 12])
def test_alibi_slopes_and_bias_match_ctpa(heads):
    _close(tops.alibi_slopes(heads, device="cpu"), jops.alibi_slopes(heads), 1e-6)
    _close(tops.alibi_bias(heads, 5, 7, device="cpu"), jops.alibi_bias(heads, 5, 7), 1e-6)
    _close(tops.alibi_bias(heads, 6, device="cpu"), jops.alibi_bias(heads, 6), 1e-6)


@pytest.mark.parametrize("n_null", [0, 2])
@pytest.mark.parametrize("n,m", [(10, 10), (6, 12)])
def test_causal_cosine_attention_matches_ctpa(n_null, n, m):
    """ALiBi over the real keys, zero over the null columns; the triangular
    mask bottom-right aligned when n < m, with a key mask and a bias."""
    rng = np.random.default_rng(2)
    b, h, d = 2, 4, 16
    q = rng.normal(size=(b, h, n, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, m, d)).astype(np.float32) for _ in range(2))
    qs, ks = (1 + 0.1 * rng.normal(size=d).astype(np.float32) for _ in range(2))
    kw = {"bias": rng.normal(size=(h, n, m)).astype(np.float32),
          "mask": np.arange(m)[None] < np.array([[m], [m - 3]])}
    if n_null:
        kw["null_kv"] = rng.normal(size=(2, h, n_null, d)).astype(np.float32)
    ref = jops.cosine_attention(*map(jnp.asarray, (q, k, v)), q_scale=jnp.asarray(qs),
                                k_scale=jnp.asarray(ks), causal=True,
                                **{a: jnp.asarray(x) for a, x in kw.items()})
    got = tops.cosine_attention(_t(q), _t(k), _t(v), q_scale=_t(qs), k_scale=_t(ks), causal=True,
                                **{a: _t(x) for a, x in kw.items()})
    _close(got, ref)


# -------------------------------------------------------- cross-attention

@pytest.mark.parametrize("norm_context", [True, False])
def test_cross_attention_with_null_kv_matches_ctpa(norm_context):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    context = rng.normal(size=(2, 5, 24)).astype(np.float32)
    jm = jatt.CosineAttention(dim=32, heads=4, dim_head=16, num_null_kv=2,
                              norm_context=norm_context)
    tm = tatt.CosineAttention(32, 4, 16, num_null_kv=2, context_dim=24,
                              norm_context=norm_context, device="cpu")
    params, tm = _pair(jm, tm, x, context=context)
    assert ("context_norm" in params) == norm_context
    assert tuple(tm.null_kv.shape) == (2, 4, 2, 16)
    with torch.no_grad():
        got = tm(_t(x), context=_t(context))
    _close(got, jax.jit(jm.apply)({"params": params}, x, context=context))


def test_causal_transformer_with_cross_attention_matches_ctpa():
    """A causal stack whose blocks cross-attend (2 null key/values each) to
    a context of another width, with PEG on the grid."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    context = rng.normal(size=(2, 6, 24)).astype(np.float32)
    jm = jatt.Transformer(dim=32, depth=2, heads=4, dim_head=8, causal=True, cross_attend=True,
                          peg=True)
    tm = tatt.Transformer(32, 2, heads=4, dim_head=8, causal=True, cross_attend=True,
                          context_dim=24, peg=True, device="cpu")
    params, tm = _pair(jm, tm, x, (2, 2, 2), "full", context)
    assert "cross_attn" in params["block_1"]
    assert "null_kv" in params["block_0"]["cross_attn"]
    with torch.no_grad():
        got = tm(_t(x), (2, 2, 2), "full", context=_t(context))
    ref = jax.jit(lambda p, x, c: jm.apply(p, x, (2, 2, 2), "full", c))({"params": params}, x,
                                                                        context)
    _close(got, ref)


def test_causal_flash_path_takes_the_kernel_mask_without_alibi():
    """With use_flash, causal self-attention goes to the flash kernel's mask
    without ALiBi (ctpa's interpreted kernel; the port's plain version on the
    CPU), and differs from the plain path, which adds ALiBi."""
    from jax.experimental.pallas import tpu as pltpu

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, 32)).astype(np.float32)
    jm = jatt.CosineAttention(dim=32, heads=2, dim_head=16, causal=True, use_flash=True)
    tm = tatt.CosineAttention(32, 2, 16, causal=True, use_flash=True, device="cpu")
    params, tm = _pair(jm, tm, x)
    with pltpu.force_tpu_interpret_mode():
        ref = jm.apply({"params": params}, x)
    with torch.no_grad():
        got = tm(_t(x))
        tm.use_flash = False
        plain = tm(_t(x))
    _close(got, ref)
    _close(plain, jatt.CosineAttention(dim=32, heads=2, dim_head=16, causal=True).apply(
        {"params": params}, x))
    assert (plain - got).abs().max() > 1e-3


# --------------------------------------------------------- fallback towers

@pytest.mark.parametrize("causal", [False, True], ids=["cls", "eos"])
@pytest.mark.parametrize("masked", [False, True])
def test_text_transformer_matches_ctpa(causal, masked):
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    mask = np.array([[1] * 7, [1] * 4 + [0] * 3], np.int32) if masked else None
    kw = dict(dim=32, depth=2, heads=4, dim_head=8, vocab_size=50, max_len=16, causal=causal)
    params, tm = _pair(jfb.TextTransformer(**kw), tfb.TextTransformer(**kw, device="cpu"), ids,
                       mask)
    ref_x, ref_pooled = jax.jit(jfb.TextTransformer(**kw).apply)({"params": params}, ids, mask)
    with torch.no_grad():
        x, pooled = tm(_t(ids).long(), None if mask is None else _t(mask))
    _close(x, ref_x)
    _close(pooled, ref_pooled)


def test_vision_transformer_2d_matches_ctpa_deterministic():
    rng = np.random.default_rng(7)
    images = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    kw = dict(dim=32, depth=2, heads=4, dim_head=8, image_size=16, patch_size=4)
    params, tm = _pair(jfb.VisionTransformer2D(**kw), tfb.VisionTransformer2D(**kw, device="cpu"),
                       images)
    ref_x, ref_pooled = jax.jit(jfb.VisionTransformer2D(**kw).apply)({"params": params}, images)
    with torch.no_grad():
        x, pooled = tm(_t(images))
    _close(x, ref_x)
    _close(pooled, ref_pooled)


def test_patch_dropout_training_mode():
    """Shape max(1, int(n (1 - p))), each item's rows a subset of its own
    tokens without repeats, items drawn apart, and one seed one draw; the
    deterministic mode is the identity."""
    x = torch.arange(2 * 10 * 3, dtype=torch.float32).reshape(2, 10, 3)
    drop = tfb.PatchDropout(0.5)
    assert drop(x) is x
    out = drop(x, generator=torch.Generator().manual_seed(1), deterministic=False)
    assert out.shape == (2, 5, 3)
    for i in range(2):
        rows = {tuple(r) for r in x[i].tolist()}
        picked = [tuple(r) for r in out[i].tolist()]
        assert set(picked) <= rows and len(set(picked)) == 5
    assert not torch.equal(out[0] - x[0, 0], out[1] - x[1, 0])
    again = drop(x, generator=torch.Generator().manual_seed(1), deterministic=False)
    assert torch.equal(out, again)
    assert tfb.PatchDropout(0.99)(x, generator=torch.Generator(), deterministic=False).shape \
        == (2, 1, 3)
