"""ctpa_torch ops against their ctpa counterparts on the CPU, in fp32.

Inputs come from numpy with a fixed seed and go through both the JAX
function and the port's.  Tolerances: both sides compute in fp32 and differ
only in the order of sums and in library kernels (XLA vs ATen), so 1e-5
absolute on O(1) values unless a case says otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctpa.core.config import PreprocessConfig as JPre
from ctpa.ops import attention_ops as jops
from ctpa.ops import preprocess as jpre
from ctpa.ops import vq as jvq
from ctpa_torch.core.config import PreprocessConfig
from ctpa_torch.ops import attention_ops as tops
from ctpa_torch.ops import preprocess as tpre
from ctpa_torch.ops import vq as tvq
from ctpa_torch.ops.flash_attention import flash_attention, flash_attention_plain
from ctpa_torch.ops.patchify import kernel_limits, patchify_project, patchify_project_plain

torch.set_num_threads(1)
ATOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------- preprocess

SMALL = dict(target_spacing=(1.5, 0.75, 0.75), target_shape=(12, 20, 24))


@pytest.mark.parametrize("window_first", [False, True])
@pytest.mark.parametrize("spacing", [(2.0, 0.7, 0.7), (1.0, 0.9, 0.6)])
def test_preprocess_volume_matches_ctpa(window_first, spacing):
    # (1.0, 0.9, 0.6) crops z and y and pads x; (2.0, 0.7, 0.7) pads z
    rng = np.random.default_rng(0)
    raw = rng.integers(-24, 3000, size=(10, 22, 26)).astype(np.float32)
    jcfg = JPre(**SMALL)
    tcfg = PreprocessConfig(**SMALL)
    ref = jpre.preprocess_volume(jnp.asarray(raw), jnp.float32(1.0), jnp.float32(-1024.0),
                                 jnp.asarray(spacing, jnp.float32), cfg=jcfg,
                                 window_first=window_first)
    got = tpre.preprocess_volume(raw, 1.0, -1024.0, spacing, tcfg,
                                 window_first=window_first, device="cpu")
    assert got.shape == (1,) + SMALL["target_shape"]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_preprocess_bucketed_src_shape_matches_ctpa():
    rng = np.random.default_rng(1)
    raw = np.zeros((12, 24, 28), np.float32)
    raw[:9, :20, :25] = rng.integers(-24, 3000, size=(9, 20, 25))
    jcfg, tcfg = JPre(**SMALL), PreprocessConfig(**SMALL)
    sp = (1.8, 0.8, 0.7)
    ref = jpre.preprocess_volume(jnp.asarray(raw), jnp.float32(1.0), jnp.float32(-1024.0),
                                 jnp.asarray(sp, jnp.float32), cfg=jcfg,
                                 src_shape=jnp.asarray([9, 20, 25], jnp.int32))
    got = tpre.preprocess_volume(raw, 1.0, -1024.0, sp, tcfg, src_shape=(9, 20, 25),
                                 device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("shape", [(24, 26, 9), (18, 16, 15)])
def test_preprocess_volume_inference_matches_ctpa(shape):
    rng = np.random.default_rng(2)
    vol = rng.uniform(-1.2, 1.2, size=shape).astype(np.float32)
    jcfg = dataclasses.replace(JPre.inference(), target_shape=(12, 20, 20))
    tcfg = dataclasses.replace(PreprocessConfig.inference(), target_shape=(12, 20, 20))
    ref = jpre.preprocess_volume_inference(jnp.asarray(vol), cfg=jcfg)
    got = tpre.preprocess_volume_inference(vol, tcfg, device="cpu")
    assert got.shape == (1, 12, 20, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_interp_matrix_rows_sum_to_one_inside_extent():
    w, valid = tpre._interp_matrix(9, 14, 12, device="cpu")
    jw, jvalid = jpre._interp_matrix(9, jnp.int32(14), 12)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(w.sum(1).numpy()[valid.numpy()], 1.0, atol=1e-6)


# ------------------------------------------------------------ attention ops

def _qkv(rng, b=2, h=3, n=10, m=12, d=16):
    return (rng.normal(size=(b, h, n, d)).astype(np.float32),
            rng.normal(size=(b, h, m, d)).astype(np.float32),
            rng.normal(size=(b, h, m, d)).astype(np.float32))


@pytest.mark.parametrize("case", ["plain", "bias", "bias4", "mask", "null_kv"])
def test_cosine_attention_matches_ctpa(case):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng)
    qs = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    ks = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    kw = {}
    if case == "bias":
        kw["bias"] = rng.normal(size=(3, 10, 12)).astype(np.float32)
    if case == "bias4":
        kw["bias"] = rng.normal(size=(2, 3, 10, 12)).astype(np.float32)
    if case == "mask":
        mask = np.ones((2, 12), bool)
        mask[1, 7:] = False
        kw["mask"] = mask
    if case == "null_kv":
        kw["null_kv"] = rng.normal(size=(2, 3, 2, 16)).astype(np.float32)
        kw["bias"] = rng.normal(size=(3, 10, 12)).astype(np.float32)
    ref = jops.cosine_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                q_scale=jnp.asarray(qs), k_scale=jnp.asarray(ks), scale=8.0,
                                **{a: jnp.asarray(b) for a, b in kw.items()})
    got = tops.cosine_attention(_t(q), _t(k), _t(v), q_scale=_t(qs), k_scale=_t(ks), scale=8.0,
                                **{a: _t(b) for a, b in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_cosine_attention_causal_is_not_ported():
    """The name is kept from when the port refused causal mode.  Causal
    mode (ALiBi and the triangular mask) is ported now, so this checks that
    it matches ctpa's; tests/test_torch_cross_attention.py holds its other
    forms."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng)
    ones = np.ones(16, np.float32)
    ref = jops.cosine_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                q_scale=jnp.asarray(ones), k_scale=jnp.asarray(ones), causal=True)
    got = tops.cosine_attention(_t(q), _t(k), _t(v), q_scale=_t(ones), k_scale=_t(ones),
                                causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_continuous_position_bias_grid_matches_ctpa():
    np.testing.assert_allclose(tops.continuous_position_bias_grid(3, 4, device="cpu").numpy(),
                               np.asarray(jops.continuous_position_bias_grid(3, 4)), atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_peg_conv3d_matches_ctpa(causal):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 3, 4, 5, 6)).astype(np.float32)
    kern = rng.normal(size=(3, 3, 3, 1, 6)).astype(np.float32)
    ref = jops.peg_conv3d(jnp.asarray(x), jnp.asarray(kern), causal=causal)
    got = tops.peg_conv3d(_t(x), _t(kern), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_split_merge_heads_match_ctpa():
    x = np.random.default_rng(5).normal(size=(2, 7, 12)).astype(np.float32)
    got = tops.split_heads(_t(x), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.split_heads(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(tops.merge_heads(got).numpy(), x)


# ------------------------------------------------------------------------ VQ

@pytest.mark.parametrize("masked", [False, True])
def test_vq_encode_matches_ctpa(masked):
    rng = np.random.default_rng(6)
    cb = rng.normal(size=(32, 8)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    state_np = (cb, np.zeros(32, np.float32), cb.copy())
    x = rng.normal(size=(2, 10, 8)).astype(np.float32)
    mask = rng.uniform(size=(2, 10)) > 0.3 if masked else None
    ref = jvq.vq_encode(jvq.VQState(*map(jnp.asarray, state_np)), jnp.asarray(x),
                        None if mask is None else jnp.asarray(mask))
    got = tvq.vq_encode(tvq.VQState(*map(_t, state_np)), _t(x),
                        None if mask is None else _t(mask))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    for name in ("quantized", "commit_loss", "counts", "sums"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   atol=ATOL, err_msg=name)


# --------------------------------------------------- plain versions of K1, K2

def test_patchify_plain_matches_ctpa_patch_embed():
    """The plain K1 plus the caller's bias and norm_out against ctpa's plain
    PatchEmbed3D path (explicit patch layout, two-pass variance)."""
    from ctpa.core.config import CTViTConfig as JViT
    from ctpa.models.ctvit import PatchEmbed3D as JPatch

    cfg = JViT.tiny()
    rng = np.random.default_rng(7)
    video = rng.uniform(-1, 1, size=(2, 1, cfg.temporal_size, cfg.image_size,
                                     cfg.image_size)).astype(np.float32)
    pd, dim = cfg.patch_dim, cfg.dim
    params = {"norm_in_scale": 1 + 0.1 * rng.normal(size=pd),
              "norm_in_bias": 0.1 * rng.normal(size=pd),
              "proj_kernel": rng.normal(size=(pd, dim)) / np.sqrt(pd),
              "proj_bias": 0.1 * rng.normal(size=dim),
              "norm_out": {"scale": 1 + 0.1 * rng.normal(size=dim),
                           "bias": 0.1 * rng.normal(size=dim)}}
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    ref = JPatch(cfg).apply({"params": params}, jnp.asarray(video))

    p = jax.tree.map(_t, params)
    pt, ps = cfg.temporal_patch_size, cfg.patch_size
    y = torch.stack([patchify_project_plain(v, p["norm_in_scale"], p["proj_kernel"], pt, ps, ps,
                                            out_dtype=torch.float32)
                     for v in _t(video)[:, 0]])
    y = y + p["norm_in_bias"] @ p["proj_kernel"] + p["proj_bias"]
    got = torch.nn.functional.layer_norm(y, (dim,), p["norm_out"]["scale"],
                                         p["norm_out"]["bias"], eps=1e-5)
    # the LN-folded form subtracts mu*rsig*v2 from rsig*(x.gK): fp32
    # cancellation on top of the reordered sums
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("bias_shape", [(4, 20, 20), (1, 20, 20), (2, 4, 20, 20), None])
def test_flash_plain_matches_ctpa_cosine_attention(bias_shape):
    """The plain K2, fed l2-normalised scaled q/k and a logit bound as
    CosineAttention feeds it, against ctpa's cosine_attention."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, b=2, h=4, n=20, m=20, d=16)
    qs = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    ks = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    bias = None if bias_shape is None else rng.normal(size=bias_shape).astype(np.float32)
    ref = jops.cosine_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                q_scale=jnp.asarray(qs), k_scale=jnp.asarray(ks), scale=8.0,
                                bias=None if bias is None else jnp.asarray(bias))
    qn = tops.l2norm(_t(q)) * _t(qs)
    kn = tops.l2norm(_t(k)) * _t(ks)
    bound = 8.0 * np.abs(qs).max() * np.abs(ks).max() + (0 if bias is None else bias.max())
    tb = None if bias is None else _t(bias)
    for lb in (torch.tensor(bound, dtype=torch.float32), None):
        got = flash_attention(qn, kn, _t(v), bias=tb, scale=8.0, logit_bound=lb)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
        np.testing.assert_allclose(flash_attention_plain(qn, kn, _t(v), tb, 8.0, lb).numpy(),
                                   got.numpy(), atol=0)


# --------------------------------------------------- wrapper input checks

def _k1_args(**over):
    a = dict(volume=torch.zeros(8, 16, 16), g=torch.ones(4 * 8 * 8), kernel=torch.zeros(256, 64),
             pt=4, p1=8, p2=8, out_dtype=torch.float32)
    a.update(over)
    return a


@pytest.mark.parametrize("bad, err", [
    (dict(volume=torch.zeros(8, 16)), ValueError),                       # not (T, H, W)
    (dict(volume=torch.zeros(8, 16, 15)), ValueError),                   # ragged patches
    (dict(g=torch.ones(10)), ValueError),                                # wrong patch_dim
    (dict(volume=torch.zeros(8, 16, 16, dtype=torch.float64),
          out_dtype=torch.float64), TypeError),                          # unsupported dtype
    (dict(out_dtype=torch.bfloat16), TypeError),                         # volume not in out dtype
    (dict(volume=torch.zeros(16, 16, 8).transpose(0, 2)), ValueError),   # not contiguous
    (dict(volume=torch.zeros(8, 16, 16, device="meta")), ValueError),    # mixed devices
])
def test_patchify_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        patchify_project(**_k1_args(**bad))


@pytest.mark.parametrize("bad, err", [
    (dict(out_dtype=torch.float32), TypeError),                          # kernel is bf16
    (dict(kernel=torch.zeros(256, 64, dtype=torch.bfloat16)), ValueError),   # dim % 128
    (dict(volume=torch.zeros(8, 16, 200, dtype=torch.bfloat16)), ValueError),  # W/p2 > 24
    (dict(volume=torch.zeros(8, 16, 80, dtype=torch.bfloat16), p2=40), ValueError),  # p2 > 32
])
def test_patchify_kernel_limits(bad, err):
    a = dict(volume=torch.zeros(8, 16, 16, dtype=torch.bfloat16),
             kernel=torch.zeros(256, 128, dtype=torch.bfloat16), p2=8,
             out_dtype=torch.bfloat16)
    kernel_limits(**a)
    a.update(bad)
    with pytest.raises(err):
        kernel_limits(**a)


def test_patchify_wrapper_cpu_uses_plain_version_without_launch():
    a = _k1_args(volume=torch.randn(8, 16, 16))
    before = patchify_project.launches
    out = patchify_project(**a)
    assert patchify_project.launches == before
    assert out.shape == (2, 2, 2, 64)
    torch.testing.assert_close(out, patchify_project_plain(**a), atol=0, rtol=0)


def _k2_args(**over):
    q = torch.randn(2, 3, 8, 16)
    a = dict(q=q, k=torch.randn(2, 3, 9, 16), v=torch.randn(2, 3, 9, 16))
    a.update(over)
    return a


@pytest.mark.parametrize("bad, err", [
    (dict(q=torch.randn(2, 3, 8)), ValueError),                          # not 4-D
    (dict(v=torch.randn(2, 3, 8, 16)), ValueError),                      # k/v mismatch
    (dict(q=torch.randn(2, 3, 8, 24), k=torch.randn(2, 3, 9, 24),
          v=torch.randn(2, 3, 9, 24)), ValueError),                      # head dim 24
    (dict(k=torch.randn(2, 3, 9, 16, dtype=torch.float64)), TypeError),  # mixed dtypes
    (dict(bias=torch.randn(3, 8, 8)), ValueError),                       # bias is not (h, n, m)
    (dict(bias=torch.randn(3, 8, 9, dtype=torch.bfloat16)), TypeError),  # bias dtype
    (dict(bias=torch.randn(3, 9, 8).transpose(1, 2)), ValueError),       # not contiguous
    # the masked forms are ported (tests/test_torch_report_train.py); these
    # four refusals keep the ids of the cases they replaced
    pytest.param(dict(causal=True, kv_mask=torch.ones(2, 8)), ValueError,   # kv_mask not (b, m)
                 id="bad7-NotImplementedError"),
    pytest.param(dict(causal=True, q_offset=torch.tensor([3, 4])), ValueError,  # not a scalar
                 id="bad8-NotImplementedError"),
    pytest.param(dict(q=torch.randn(2, 3, 8, 96), k=torch.randn(2, 3, 9, 96),
                      v=torch.randn(2, 3, 9, 96), kv_mask=torch.ones(2, 9)), ValueError,
                 id="bad9-NotImplementedError"),                          # head dim 96
    pytest.param(dict(kv_mask=torch.ones(3, 9), return_lse=True), ValueError,  # kv_mask not (b, m)
                 id="bad10-NotImplementedError"),
    (dict(q=torch.randn(2, 3, 8, 16, device="meta")), ValueError),       # mixed devices
])
def test_flash_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        flash_attention(**_k2_args(**bad))
