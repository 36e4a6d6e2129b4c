"""The fused resample-patchify front end (K9) and the raw-volume encode path
against ctpa on the CPU.

Inputs are numpy draws with fixed seeds, fed to both packages.  ctpa's K9
(``ctpa/ops/pallas/resample_patchify.py``) runs in interpret mode, which
computes on the CPU; the port's wrapper takes its plain version on CPU
tensors.  The raws are small (``CTViTConfig.tiny()``'s (16, 32, 32) grid,
patches (4, 8, 8)) and cover a depth resample with an h crop and a w pad,
whole temporal patches of pad, a bucketed raw (``src_shape``) and the
offline order (``window_first``, no window in the kernel).

Tolerances, each with its reason:
- fp32 K9 (``FP32_TOL``): both sides compute in fp32 and differ in the
  order of sums (1e-6 measured); on a fully padded patch, which is
  constant, rsig = 1/sqrt(eps) = 316 multiplies that noise in the
  LN-folded form rsig * acc - mu * rsig * v2 (8.9e-5 measured): 2e-4.
- bf16 K9 (``BF16_ATOL``, ``BF16_RTOL``): the same roundings on both sides,
  the output rounded to bf16 once (2^-8 relative) after fp32 sums taken in
  another order, which can move a small output by up to 1e-3 (9.8e-4
  measured).  Reading stage 3 with ``wwp`` rounded to bf16 instead misses
  ctpa by 1.5e-3 to 3.9e-3, beyond both bounds: the tests pin ctpa's fp32
  stage-3 product.
- The raw-volume encode path in fp32 (``SLICE_TOL``), both front ends,
  against ctpa's unfused patch embed: 1e-5 where no patch is constant
  (3.6e-7 measured).  On a fully padded patch ctpa's LayerNorm gives
  exactly 0 and the LN-folded form rsig * (fp32 sum-order noise), about
  1e-4; norm_out divides that by the token's spread, and before the VQ
  snaps the tokens the latent moves by up to 3.8e-4 (K1's path) and 2.0e-4
  (K9's): 1e-3 for that raw.
"""

import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from ctpa.core import config as jc
from ctpa.models.ctvit import CTViT as JViT
from ctpa.ops.attention_ops import l2norm as jl2norm
from ctpa.ops.pallas.resample_patchify import resample3_patchify_project as ctpa_k9
from ctpa.ops.preprocess import preprocess_volume as ctpa_preprocess
from ctpa.ops.vq import VQState as JVQState
from ctpa_torch.convert import load_flax_params, vq_state_from_numpy
from ctpa_torch.core.config import CTViTConfig, PreprocessConfig
from ctpa_torch.models.ctvit import CTViT
from ctpa_torch.ops import resample_patchify as rp
from ctpa_torch.ops.patchify import patchify_project_plain
from ctpa_torch.ops.preprocess import _interp_matrix, preprocess_stage12, resample_stage3

torch.set_num_threads(1)
FP32_TOL = 2e-4
BF16_ATOL, BF16_RTOL = 1e-3, 2.0 ** -8
SLICE_TOL = {"crop_pad": 1e-5, "padded_patches": 1e-3}
VIT = CTViTConfig.tiny()
GRID = (VIT.temporal_size, VIT.image_size, VIT.image_size)
PT, P, DIM = VIT.temporal_patch_size, VIT.patch_size, VIT.dim
PRE = PreprocessConfig(target_shape=GRID)
JPRE = jc.PreprocessConfig(target_shape=GRID)
# name: (array shape, true extents or None, spacing, window_first)
RAWS = {
    "crop_pad": ((12, 40, 36), None, (2.0, 0.75, 0.6), False),  # depth 16, h 40->32, w 28->32
    "padded_patches": ((6, 40, 28), None, (1.5, 0.75, 0.75), False),  # t rows 0, 3 all pad
    "bucketed": ((12, 44, 40), (10, 40, 36), (1.8, 0.8, 0.7), False),
    "window_first": ((12, 40, 36), None, (2.0, 0.75, 0.6), True),
}
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _sync_dispatch():
    """ctpa's interpreted Pallas kernels deadlock under asynchronous CPU
    dispatch (tests/conftest.py); this module turns it off while it runs."""
    before = jax.config.values["jax_cpu_enable_async_dispatch"]
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    yield
    jax.config.update("jax_cpu_enable_async_dispatch", before)


def _raw(name, seed=0):
    shape, true, spacing, window_first = RAWS[name]
    raw = np.zeros(shape, np.float32)
    real = true or shape
    raw[tuple(slice(0, n) for n in real)] = np.random.default_rng(seed).integers(-24, 3000,
                                                                                 size=real)
    return raw, true, spacing, window_first


def _ops(name, dtype):
    raw, true, spacing, window_first = _raw(name)
    return preprocess_stage12(raw, 1.0, -1024.0, spacing, PRE, window_first, true, dtype=dtype,
                              device="cpu")


def _gk(seed=1):
    rng = np.random.default_rng(seed)
    pd = PT * P * P
    return ((1 + 0.1 * rng.normal(size=pd)).astype(np.float32),
            rng.normal(0, 0.02, size=(pd, DIM)).astype(np.float32))


def _ctpa_k9(ops, g, K, jdtype):
    j = lambda t: jnp.asarray(t.float().numpy() if t.is_floating_point() else t.numpy())
    out = ctpa_k9(j(ops.x2).astype(jdtype), j(ops.wwp), j(ops.vd), j(ops.vh), j(ops.vw),
                  jnp.asarray(g), jnp.asarray(K), PT, P, P, 1e-5, ops.window, ops.pad_value,
                  jdtype, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _plain(ops, g, K, wwp=None):
    return rp.resample3_patchify_project_plain(
        ops.x2, ops.wwp if wwp is None else wwp, ops.vd, ops.vh, ops.vw, torch.tensor(g),
        torch.tensor(K), PT, P, P, window=ops.window, pad_value=ops.pad_value,
        out_dtype=ops.x2.dtype).float().numpy()


def _within(got, ref, dtype) -> bool:
    if dtype == torch.float32:
        return bool(np.all(np.abs(got - ref) <= FP32_TOL))
    return bool(np.all(np.abs(got - ref) <= BF16_ATOL + BF16_RTOL * np.abs(ref)))


# ------------------------------------------------------- K9's plain version

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(RAWS))
def test_k9_plain_matches_ctpa_interpreted_kernel(name, dt):
    dtype, jdtype = DTYPES[dt]
    ops = _ops(name, dtype)
    g, K = _gk()
    ref = _ctpa_k9(ops, g, K, jdtype)
    got = _plain(ops, g, K)
    assert got.shape == (GRID[0] // PT, GRID[1] // P, GRID[2] // P, DIM)
    assert _within(got, ref, dtype), np.abs(got - ref).max()
    if name != "padded_patches":     # that raw's weights are 0 and 1, exact in bf16
        alt = _plain(ops, g, K, wwp=ops.wwp.to(torch.bfloat16).float())
        assert not _within(alt, ref, dtype), "the tolerance cannot tell the stage-3 readings apart"


def test_k9_fully_padded_patches_keep_ctpa_rounding():
    """bf16: a constant patch gets rsig * (sum(g*K) - sum(bf16(g*K))) with
    rsig = 1/sqrt(eps), as ctpa's kernel gives it, where K1's rounding,
    bf16(x * g) . K, gives about 0."""
    ops = _ops("padded_patches", torch.bfloat16)
    g, K = _gk()
    pad_rows = ~ops.vd.reshape(-1, PT).any(1)
    assert pad_rows.tolist() == [True, False, False, True]
    ref = _ctpa_k9(ops, g, K, jnp.bfloat16)[pad_rows.numpy()]
    got = _plain(ops, g, K)[pad_rows.numpy()]
    k3 = torch.tensor(g)[:, None] * torch.tensor(K)
    gap = (k3.sum(0) - k3.to(torch.bfloat16).float().sum(0)) / np.sqrt(1e-5)
    np.testing.assert_allclose(got, np.broadcast_to(gap.numpy(), got.shape), atol=2e-3,
                               rtol=2 ** -8)
    np.testing.assert_allclose(got, ref, atol=BF16_ATOL, rtol=BF16_RTOL)
    assert np.abs(got).max() > 0.1
    video = resample_stage3(*ops).to(torch.bfloat16)
    k1 = patchify_project_plain(video, torch.tensor(g).to(torch.bfloat16),
                                torch.tensor(K).to(torch.bfloat16), PT, P, P).float()
    assert k1[pad_rows].abs().max() < 1e-2


@pytest.mark.parametrize("name", list(RAWS))
def test_stage12_then_stage3_matches_ctpa_preprocess(name):
    """The operands' fp32 stage 3 is ctpa's preprocess_volume (1e-5: fp32
    sums in another order); a bf16 x2 moves it by x2's rounding only (2^-8
    of |HU| / 1000 before the window's clip)."""
    raw, true, spacing, window_first = _raw(name)
    ref = np.asarray(ctpa_preprocess(
        jnp.asarray(raw), jnp.float32(1.0), jnp.float32(-1024.0),
        jnp.asarray(spacing, jnp.float32), cfg=JPRE, window_first=window_first,
        src_shape=None if true is None else jnp.asarray(true, jnp.int32)))[0]
    np.testing.assert_allclose(resample_stage3(*_ops(name, torch.float32)).numpy(), ref, atol=1e-5)
    got = resample_stage3(*_ops(name, torch.bfloat16)).numpy()
    np.testing.assert_allclose(got, ref, atol=2.0 ** -8 * 2.0, rtol=2.0 ** -8)


def test_resampled_len_matches_ctpa_jitted_arithmetic():
    """ctpa's jitted preprocess multiplies by the target spacing's fp32
    reciprocal (XLA's rewrite of the division); 10 * 1.8 / 1.5 is 12 there
    and 11.999999 as a true fp32 division."""
    from ctpa_torch.ops.preprocess import _resampled_len

    length = jax.jit(lambda e, s, t: (e * (s / t)).astype(jnp.int32), static_argnums=2)
    rng = np.random.default_rng(33)
    extents = np.concatenate([[10], rng.integers(1, 700, 2000)]).astype(np.int32)
    spacings = np.concatenate([[1.8], rng.uniform(0.3, 3.0, 2000)]).astype(np.float32)
    for target in (1.5, 0.75):
        ref = np.asarray(length(jnp.asarray(extents), jnp.asarray(spacings), target))
        got = [_resampled_len(int(e), float(s), target) for e, s in zip(extents, spacings)]
        np.testing.assert_array_equal(got, ref)
    assert _resampled_len(10, float(np.float32(1.8)), 1.5) == 12


# ---------------------------------------------------- stage-3 taps

@pytest.mark.parametrize("source, n, target, true_len", [
    (36, 28, 32, None),          # pad rows at both ends
    (40, 40, 32, None),          # crop, identity weights
    (40, 43, 32, 36),            # bucketed: columns 36-39 are end padding
    (9, 14, 12, None),           # upsample with edge-clamped rows
])
def test_stage3_taps_reproduce_the_dense_product(source, n, target, true_len):
    wwp, _ = _interp_matrix(source, n, target, true_len=true_len, device="cpu")
    taps_i, taps_w, too_many = rp.stage3_taps(wwp)
    assert not too_many
    x = torch.randn(5, source)
    two_tap = taps_w[:, 0] * x[:, taps_i[:, 0].long()] + taps_w[:, 1] * x[:, taps_i[:, 1].long()]
    torch.testing.assert_close(two_tap, x @ wwp.t(), atol=1e-6, rtol=1e-6)
    if true_len is not None:
        assert int(taps_i.max()) < true_len
    empty = (wwp != 0).sum(1) == 0
    assert not taps_w[empty].any()


def test_stage3_taps_flag_a_row_with_three_non_zeros():
    """The wrapper raises on the flag before it launches the kernel (the
    card's refusal is in tests/test_torch_gpu.py)."""
    wwp, _ = _interp_matrix(36, 28, 32, device="cpu")
    wwp[5, :3] = 0.25
    assert bool(rp.stage3_taps(wwp)[2])


@pytest.mark.parametrize("raw_shape, true, spacing, width", [
    ((2, 2, 512), None, (2.0, 0.75, 0.75), 480),        # the shipped raw's width: a crop
    ((2, 2, 640), (2, 2, 600), (2.0, 0.8, 0.7), 480),   # bucketed: columns 600-639 are padding
    ((2, 2, 9), None, (2.0, 0.75, 1.2), 12),            # upsampled, edge-clamped rows
    ((2, 2, 28), None, (2.0, 0.75, 0.75), 32),          # pad rows at both ends
])
def test_operand_taps_are_stage3_taps_of_the_matrix(raw_shape, true, spacing, width):
    """The taps preprocess_stage12 builds beside the width matrix are, bit
    for bit, the ones stage3_taps reads from that matrix: K9 takes them
    without the matrix check's host sync."""
    raw = np.random.default_rng(2).integers(-24, 3000, size=raw_shape).astype(np.float32)
    pre = PreprocessConfig(target_shape=(4, 4, width))
    ops = preprocess_stage12(raw, 1.0, -1024.0, spacing, pre, src_shape=true, device="cpu")
    taps_i, taps_w, too_many = rp.stage3_taps(ops.wwp)
    assert not bool(too_many)
    assert ops.taps[0].dtype == torch.int32 and ops.taps[1].dtype == torch.float32
    assert torch.equal(ops.taps[0], taps_i)
    assert torch.equal(ops.taps[1].view(torch.int32), taps_w.view(torch.int32))
    assert bool((ops.wwp == 0).all(1).any()) == (width == 32)     # the pad case has empty rows


# -------------------------------------------------- the wrapper's checks

def _k9_args(**over):
    ops = _ops("crop_pad", torch.float32)
    g, K = _gk()
    a = dict(x2=ops.x2, wwp=ops.wwp, vd=ops.vd, vh=ops.vh, vw=ops.vw, g=torch.tensor(g),
             kernel=torch.tensor(K), pt=PT, p1=P, p2=P, window=ops.window, out_dtype=torch.float32)
    a.update(over)
    return a


@pytest.mark.parametrize("bad, err", [
    (dict(x2=torch.zeros(16, 32)), ValueError),                           # not (D, H, ws)
    (dict(wwp=torch.zeros(32, 35)), ValueError),                          # ws mismatch
    (dict(x2=torch.zeros(14, 32, 36)), ValueError),                       # ragged depth patches
    (dict(vd=torch.ones(15, dtype=torch.bool)), ValueError),              # vd length
    (dict(vw=torch.ones(32)), ValueError),                                # vw not bool
    (dict(g=torch.ones(10)), ValueError),                                 # wrong patch_dim
    (dict(x2=torch.zeros(16, 32, 36, dtype=torch.float64)), TypeError),   # unsupported dtype
    (dict(wwp=torch.zeros(32, 36, dtype=torch.bfloat16)), TypeError),     # wwp not fp32
    (dict(x2=torch.zeros(36, 32, 16).transpose(0, 2)), ValueError),       # not contiguous
    (dict(g=torch.ones(256, device="meta")), ValueError),                 # mixed devices
])
def test_k9_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        rp.resample3_patchify_project(**_k9_args(**bad))


def test_k9_wrapper_refuses_grad():
    a = _k9_args()
    a["g"] = a["g"].requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        rp.resample3_patchify_project(**a)
    with torch.no_grad():
        rp.resample3_patchify_project(**a)


@pytest.mark.parametrize("bad, err", [
    (dict(x2=torch.zeros(16, 32, 36)), TypeError),                        # kernel is bf16
    (dict(out_dtype=torch.float32), TypeError),
    (dict(kernel=torch.zeros(256, 64)), ValueError),                      # dim % 128
    (dict(wwp=torch.zeros(200, 36), p2=8), ValueError),                   # W/p2 > 24
    (dict(wwp=torch.zeros(80, 36), p2=40), ValueError),                   # p2 > 32
])
def test_k9_kernel_limits(bad, err):
    a = dict(x2=torch.zeros(16, 32, 36, dtype=torch.bfloat16), wwp=torch.zeros(32, 36),
             kernel=torch.zeros(256, 128), p2=8, out_dtype=torch.bfloat16)
    rp.kernel_limits(**a)
    a.update(bad)
    with pytest.raises(err):
        rp.kernel_limits(**a)


def test_k9_wrapper_cpu_uses_plain_version_without_launch():
    a = _k9_args()
    before = rp.resample3_patchify_project.launches
    out = rp.resample3_patchify_project(**a)
    assert rp.resample3_patchify_project.launches == before
    assert out.shape == (4, 4, 4, DIM)
    torch.testing.assert_close(out, rp.resample3_patchify_project_plain(**a), atol=0, rtol=0)


# -------------------------------------- the raw-volume encode path (slice)

GAINS = {"gamma", "scale", "q_scale", "k_scale", "norm_in_scale"}


def _ctpa_params(jm, video, seed):
    """ctpa's parameter tree filled from numpy: gains near 1, Dense kernels
    at 1/sqrt(fan_in), everything else 0.1 (biases too).  The port's
    ``convert`` carries every parameter K9 reads (the patch embed's
    ``norm_in_scale``, ``norm_in_bias``, ``proj_kernel``, ``proj_bias``):
    the raw path needs no new weight."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), video, None))["params"]
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name in GAINS:
            val = 1 + 0.1 * rng.normal(size=shape)
        elif name.endswith("kernel") and len(shape) == 2:
            val = rng.normal(size=shape) / np.sqrt(shape[0])
        else:
            val = 0.1 * rng.normal(size=shape)
        return jnp.asarray(val, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def encode_pair():
    """ctpa's tiny CTViT with numpy weights (its plain patch embed), the
    port's with the same (bench's kernel switches on: the CPU takes their
    plain versions), a VQ codebook and a latent projection."""
    jcfg = jc.CTViTConfig(**{f.name: getattr(VIT, f.name) for f in dataclasses.fields(VIT)
                             if f.name not in ("pallas_patchify", "flash_axial")})
    jm = JViT(jcfg)
    params = _ctpa_params(jm, jnp.zeros((1, 1) + GRID, jnp.float32), 30)
    vit = load_flax_params(CTViT(dataclasses.replace(VIT, pallas_patchify=True, flash_axial=True),
                                 device="cpu"), jax.tree.map(np.asarray, params)).eval()
    rng = np.random.default_rng(31)
    cb = rng.normal(size=(VIT.codebook_size, DIM)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=-1, keepdims=True)
    vq = (cb, np.zeros(VIT.codebook_size, np.float32), cb.copy())
    w_latent = rng.normal(0, 0.02, size=(GRID[1] * GRID[2] // P ** 2 * DIM, 32)).astype(np.float32)
    return jm, params, vit, vq, w_latent


def _ctpa_bench_latent(encode_pair, raw, spacing, with_vq):
    """bench.py's pipeline_fn in fp32: preprocess_volume -> CTViT ->
    temporal mean -> latent -> l2norm."""
    jm, params, _, vq, w_latent = encode_pair
    video = ctpa_preprocess(jnp.asarray(raw), jnp.float32(1.0), jnp.float32(-1024.0),
                            jnp.asarray(spacing, jnp.float32), cfg=JPRE)
    state = JVQState(*map(jnp.asarray, vq)) if with_vq else None
    tokens, _ = jm.apply({"params": params}, video[None], state)
    pooled = tokens.mean(axis=1).reshape(tokens.shape[0], -1)
    return np.asarray(jl2norm(pooled @ jnp.asarray(w_latent))[0])


@pytest.mark.parametrize("with_vq", [False, True])
@pytest.mark.parametrize("front_end", bench_torch.FRONT_ENDS)
@pytest.mark.parametrize("name", ["crop_pad", "padded_patches"])
def test_bench_pipeline_matches_ctpa_bench_composition(encode_pair, name, front_end, with_vq):
    raw, _, spacing, _ = _raw(name, seed=32)
    ref = _ctpa_bench_latent(encode_pair, raw, spacing, with_vq)
    _, _, vit, vq, w_latent = encode_pair
    with torch.no_grad():
        got = bench_torch.pipeline(vit, torch.tensor(w_latent),
                                   vq_state_from_numpy(vq, device="cpu") if with_vq else None,
                                   torch.tensor(raw), front_end, spacing, PRE)
    assert got.shape == (32,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=SLICE_TOL[name])


def test_bench_pipeline_rejects_an_unknown_front_end(encode_pair):
    _, _, vit, _, w_latent = encode_pair
    raw, _, spacing, _ = _raw("crop_pad")
    with pytest.raises(ValueError, match="front_end"):
        bench_torch.pipeline(vit, torch.tensor(w_latent), None, torch.tensor(raw), "k9", spacing,
                             PRE)


def test_bench_exits_nonzero_without_a_card(capsys):
    assert not torch.cuda.is_available()
    assert bench_torch.main([]) == 1
    assert capsys.readouterr().out == ""


def _bench_py():
    """bench.py's result keys, in the order its main() prints them, and its
    pinned CPU-reference seconds, read from its source (it imports ctpa)."""
    tree = ast.parse((Path(__file__).resolve().parents[1] / "bench.py").read_text())
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "main")
    line = next(node for node in ast.walk(main) if isinstance(node, ast.Dict))
    ref = next(node.value.value for node in tree.body if isinstance(node, ast.Assign)
               and [t.id for t in node.targets] == ["CPU_REF_S_PER_VOLUME"])
    return [k.value for k in line.keys], ref


def test_bench_line_has_bench_py_keys_in_order():
    keys, cpu_ref_s = _bench_py()
    assert keys[:5] == ["metric", "value", "unit", "vs_baseline", "vs_baseline_live_cpu_leg"]
    assert bench_torch.CPU_REF_S_PER_VOLUME == cpu_ref_s
    line = bench_torch.result_line(0.025, 0.03125, 50.0, "resample_patchify", "card", 0.5)
    assert list(line) == keys + ["front_end", "device"]
    assert line["value"] == 40.0 and line["clip_pairs_per_sec_incl_text"] == 32.0
    assert line["vs_baseline"] == pytest.approx(40.0 * cpu_ref_s, rel=1e-12)
    assert line["vs_baseline_live_cpu_leg"] == pytest.approx(80.0, rel=1e-12)
    assert json.loads(json.dumps(line)) == line


@pytest.mark.parametrize("cpu_vps", [float("nan"), 0.0, -1.0, float("inf")])
def test_bench_line_refuses_a_failed_cpu_leg(cpu_vps):
    with pytest.raises(ValueError, match="CPU reference"):
        bench_torch.result_line(0.025, 0.03125, 50.0, "patchify", "card", cpu_vps)
