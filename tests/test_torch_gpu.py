"""Hand-written CUDA kernels against their plain PyTorch versions on the
card.  Marked ``gpu``: each test decides in the ``cuda`` fixture whether a
card is present and skips otherwise (a CUDA kernel has no CPU mode).  Run on
the card with
    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
(``--noconftest``: the repository's tests/conftest.py sets up JAX, which
the card's machine does not have)

Tolerances: kernel and plain version sum the same rounded products in fp32
in another order; in bf16 the result is rounded once more (2e-2 abs + rel),
in fp32 they agree to 1e-4.  The logsumexp is fp32 in both dtypes (1e-4).
At the fused encoder's 13,824 tokens the bf16 outputs are small, and the
absolute limit scales with the reference's RMS (chip_smoke.fused_tolerance).
"""

import dataclasses

import pytest
import torch

from ctpa_torch.core.config import CTViTConfig, PreprocessConfig
from ctpa_torch.core.init import random_init_
from ctpa_torch.models.ctvit import CTViT
from ctpa_torch.models.layers import set_compute_dtype
from ctpa_torch.ops.attention_ops import l2norm
from ctpa_torch.ops import flash_attention as fa
from ctpa_torch.ops.flash_attention import (
    LAUNCHES,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from ctpa_torch.ops.patchify import patchify_project, patchify_project_plain
from ctpa_torch.ops import resample_patchify as rp
from ctpa_torch.ops.preprocess import preprocess_stage12, resample_stage3

pytestmark = pytest.mark.gpu
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    # fp32 references in full fp32, not TF32 (chip_smoke.main does the same)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", [(240, 480, 480, 10, 20, 512), (16, 48, 40, 4, 8, 128),
                                   (12, 36, 48, 4, 12, 256), (9, 60, 60, 3, 12, 128),
                                   (10, 30, 30, 2, 5, 128)])
def test_patchify_kernel_matches_plain(cuda, shape):
    # the third: odd h, a ragged feature chunk; the fourth: h 5 (a ragged
    # last tile of 4 slab rows), 120-byte image rows (no bulk copies), a
    # ragged last k-block (pd 432); the last: p2 5 (the scalar staging path)
    T, H, W, pt, p, dim = shape
    bf16 = torch.bfloat16
    vol = (torch.rand(T, H, W, generator=cuda, device="cuda") * 2 - 1).to(bf16)
    g = (1 + 0.1 * torch.randn(pt * p * p, generator=cuda, device="cuda")).to(bf16)
    K = (0.02 * torch.randn(pt * p * p, dim, generator=cuda, device="cuda")).to(bf16)
    before = patchify_project.launches
    got = patchify_project(vol, g, K, pt, p, p, out_dtype=bf16)
    torch.cuda.synchronize()
    assert patchify_project.launches == before + 1
    ref = patchify_project_plain(vol, g, K, pt, p, p, out_dtype=bf16)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[bf16], rtol=TOL[bf16])


@pytest.mark.parametrize("shape", [(240, 480, 480, 10, 20, 512), (12, 36, 48, 4, 12, 256)])
def test_patchify_kernel_is_deterministic(cuda, shape):
    """Two calls on one volume give the same bits: the per-patch LayerNorm
    sums are added in a fixed order (the shipped shape and a ragged one)."""
    T, H, W, pt, p, dim = shape
    bf16 = torch.bfloat16
    vol = (torch.rand(T, H, W, generator=cuda, device="cuda") * 2 - 1).to(bf16)
    g = (1 + 0.1 * torch.randn(pt * p * p, generator=cuda, device="cuda")).to(bf16)
    K = (0.02 * torch.randn(pt * p * p, dim, generator=cuda, device="cuda")).to(bf16)
    first = patchify_project(vol, g, K, pt, p, p, out_dtype=bf16)
    second = patchify_project(vol, g, K, pt, p, p, out_dtype=bf16)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_patchify_kernel_refuses_fp32(cuda):
    vol = torch.zeros(16, 48, 48, device="cuda")
    with pytest.raises(TypeError):
        patchify_project(vol, torch.ones(256, device="cuda"), torch.zeros(256, 128, device="cuda"),
                         4, 8, 8, out_dtype=torch.float32)


# raw shape, true extents or None, spacing, (D, H, W) target, pt, p, dim, window_first
K9_CASES = {
    "shipped": ((160, 512, 512), None, (2.0, 0.75, 0.75), (240, 480, 480), 10, 20, 512, False),
    "bucketed": ((160, 512, 640), (150, 500, 600), (2.0, 0.8, 0.7), (240, 480, 480), 10, 20, 512,
                 False),
    "tiny": ((12, 40, 36), None, (2.0, 0.75, 0.6), (16, 32, 32), 4, 8, 128, False),
    "tiny window_first": ((12, 40, 36), None, (2.0, 0.75, 0.6), (16, 32, 32), 4, 8, 128, True),
    "odd ws, ragged chunk": ((12, 40, 37), None, (2.0, 0.75, 0.6), (16, 48, 48), 4, 12, 256,
                             False),
    "padded patches": ((6, 40, 28), None, (1.5, 0.75, 0.75), (16, 32, 32), 4, 8, 128, False),
    "wide raw, over 48 KB of shared memory": ((12, 40, 1200), None, (2.0, 0.75, 0.02),
                                              (16, 32, 32), 4, 8, 128, False),
    "odd patch run, odd h": ((12, 40, 36), None, (2.0, 0.75, 0.6), (16, 35, 35), 4, 5, 128,
                             False),
    "dim 128, ragged k-block": ((12, 40, 36), None, (2.0, 0.75, 0.6), (18, 36, 36), 3, 12, 128,
                                False),
}


def _k9_operands(gen, case):
    raw_shape, true, spacing, target, pt, p, dim, window_first = K9_CASES[case]
    raw = torch.zeros(raw_shape, device="cuda")
    real = true or raw_shape
    raw[tuple(slice(0, n) for n in real)] = torch.randint(-24, 3000, real, generator=gen,
                                                          device="cuda").float()
    ops = preprocess_stage12(raw, 1.0, -1024.0, spacing, PreprocessConfig(target_shape=target),
                             window_first, true, dtype=torch.bfloat16)
    g = 1 + 0.1 * torch.randn(pt * p * p, generator=gen, device="cuda")
    K = 0.02 * torch.randn(pt * p * p, dim, generator=gen, device="cuda")
    return ops, g, K, pt, p


@pytest.mark.parametrize("case", list(K9_CASES))
def test_resample_patchify_kernel_matches_plain(cuda, case):
    ops, g, K, pt, p = _k9_operands(cuda, case)
    args = (*ops[:5], g, K, pt, p, p)
    kw = dict(window=ops.window, pad_value=ops.pad_value)
    before = (rp.resample3_patchify_project.launches, patchify_project.launches)
    got = rp.resample3_patchify_project(*args, **kw)
    torch.cuda.synchronize()
    assert (rp.resample3_patchify_project.launches, patchify_project.launches) == (
        before[0] + 1, before[1])
    ref = rp.resample3_patchify_project_plain(*args, **kw)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


@pytest.mark.parametrize("case", ["shipped", "odd ws, ragged chunk"])
def test_resample_patchify_kernel_is_deterministic(cuda, case):
    ops, g, K, pt, p = _k9_operands(cuda, case)
    args = (*ops[:5], g, K, pt, p, p)
    kw = dict(window=ops.window, pad_value=ops.pad_value)
    first = rp.resample3_patchify_project(*args, **kw)
    second = rp.resample3_patchify_project(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("case", ["shipped", "dim 128, ragged k-block"])
def test_resample_patchify_kernel_with_operand_taps_waits_for_nothing(cuda, case):
    """With the taps preprocess_stage12 builds beside the matrix, a K9 call
    enqueues without a host sync, and gives the bits of a call that derives
    the taps from the matrix."""
    ops, g, K, pt, p = _k9_operands(cuda, case)
    args = (*ops[:5], g, K, pt, p, p)
    kw = dict(window=ops.window, pad_value=ops.pad_value)
    ref = rp.resample3_patchify_project(*args, **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rp.resample3_patchify_project(*args, taps=ops.taps, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_resample_patchify_kernel_refuses_what_it_does_not_take(cuda):
    ops, g, K, pt, p = _k9_operands(cuda, "tiny")
    kw = dict(window=ops.window, pad_value=ops.pad_value)
    with pytest.raises(TypeError):                       # fp32 x2
        rp.resample3_patchify_project(ops.x2.float(), *ops[1:5], g, K, pt, p, p, **kw)
    with pytest.raises(TypeError):                       # fp32 output
        rp.resample3_patchify_project(*ops[:5], g, K, pt, p, p, out_dtype=torch.float32, **kw)
    with pytest.raises(ValueError):                      # dim % 128
        rp.resample3_patchify_project(*ops[:5], g, K[:, :64], pt, p, p, **kw)
    wwp = ops.wwp.clone()
    wwp[3, :3] = 0.25
    with pytest.raises(ValueError, match="more than two"):
        rp.resample3_patchify_project(ops.x2, wwp, *ops[2:5], g, K, pt, p, p, **kw)
    with pytest.raises(RuntimeError, match="forward-only"):
        rp.resample3_patchify_project(*ops[:5], g.requires_grad_(), K, pt, p, p, **kw)


def test_ctvit_fused_resample_front_end_matches_plain_path(cuda):
    """CTViT from a raw's stage-1/2 operands through K9 against the plain
    model on the resampled volume, bf16, at a small geometry: they differ by
    bf16 rounding at other places (x2 rounded before stage 3, the LN-folded
    patch embed), so tokens after the final LayerNorm agree to 5e-2."""
    cfg = CTViTConfig(dim=128, codebook_size=64, image_size=48, patch_size=8,
                      temporal_size=16, temporal_patch_size=4, spatial_depth=2,
                      temporal_depth=1, dim_head=32, heads=4)
    bf16 = torch.bfloat16
    plain = random_init_(CTViT(cfg, device="cuda", dtype=bf16), cuda).eval()
    fast = CTViT(dataclasses.replace(cfg, pallas_patchify=True, flash_axial=True),
                 device="cuda", dtype=bf16).eval()
    fast.load_state_dict(plain.state_dict())
    raw = torch.randint(-24, 3000, (12, 60, 52), generator=cuda, device="cuda").float()
    pre = PreprocessConfig(target_shape=(16, 48, 48))
    ops = preprocess_stage12(raw, 1.0, -1024.0, (2.0, 0.75, 0.6), pre, dtype=bf16)
    k9, k1, k2 = (rp.resample3_patchify_project.launches, patchify_project.launches,
                  LAUNCHES["flash_attention_fwd"])
    with torch.no_grad():
        got, _ = fast.forward_stage3(ops)
        ref, _ = plain(resample_stage3(*ops)[None, None].to(bf16))
    assert (rp.resample3_patchify_project.launches - k9, patchify_project.launches - k1,
            LAUNCHES["flash_attention_fwd"] - k2) == (1, 0, cfg.spatial_depth)
    torch.testing.assert_close(got.float(), ref.float(), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias_form", ["h", "1", "bh", None])
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_flash_kernel_matches_plain(cuda, dtype, bias_form, bounded, d):
    b, h, n, m = 3, 4, 100, 90       # ragged against the 64-row and 32-key tiles
    q = l2norm(torch.randn(b, h, n, d, generator=cuda, device="cuda")).to(dtype)
    k = l2norm(torch.randn(b, h, m, d, generator=cuda, device="cuda")).to(dtype)
    v = torch.randn(b, h, m, d, generator=cuda, device="cuda").to(dtype)
    shape = {"h": (h, n, m), "1": (1, n, m), "bh": (b, h, n, m), None: None}[bias_form]
    bias = None if shape is None else torch.randn(shape, generator=cuda, device="cuda").to(dtype)
    bound = None
    if bounded:
        bound = torch.tensor(8.0, device="cuda") + (0 if bias is None else bias.max().float())
    got = flash_attention(q, k, v, bias=bias, scale=8.0, logit_bound=bound)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v, bias, 8.0, bound)
    torch.testing.assert_close(got.float(), ref.float(), atol=TOL[dtype], rtol=TOL[dtype])


def test_ctvit_kernel_path_matches_plain_path(cuda):
    """Both CTViT paths in bf16 at a small geometry the kernels take: they
    differ by bf16 rounding at other places (the LN-folded patch embed), so
    tokens after the final LayerNorm agree to 5e-2."""
    cfg = CTViTConfig(dim=128, codebook_size=64, image_size=48, patch_size=8,
                      temporal_size=16, temporal_patch_size=4, spatial_depth=2,
                      temporal_depth=1, dim_head=32, heads=4)
    bf16 = torch.bfloat16
    plain = random_init_(CTViT(cfg, device="cuda", dtype=bf16), cuda).eval()
    fast = CTViT(dataclasses.replace(cfg, pallas_patchify=True, flash_axial=True),
                 device="cuda", dtype=bf16).eval()
    fast.load_state_dict(plain.state_dict())
    video = torch.rand(2, 1, cfg.temporal_size, cfg.image_size, cfg.image_size,
                       generator=cuda, device="cuda") * 2 - 1
    k1, k2 = patchify_project.launches, LAUNCHES["flash_attention_fwd"]
    with torch.no_grad():
        got, _ = fast(video)
        ref, _ = plain(video)
    assert (patchify_project.launches - k1,
            LAUNCHES["flash_attention_fwd"] - k2) == (2, cfg.spatial_depth)
    torch.testing.assert_close(got.float(), ref.float(), atol=5e-2, rtol=5e-2)


def _attn(gen, dtype, bias_form, bounded, d, b=3, h=4, n=100, m=90):
    """Inputs ragged against every tile (64/32 rows, 32/64 keys)."""
    q = l2norm(torch.randn(b, h, n, d, generator=gen, device="cuda")).to(dtype)
    k = l2norm(torch.randn(b, h, m, d, generator=gen, device="cuda")).to(dtype)
    v = torch.randn(b, h, m, d, generator=gen, device="cuda").to(dtype)
    do = torch.randn(b, h, n, d, generator=gen, device="cuda").to(dtype)
    shape = {"h": (h, n, m), "1": (1, n, m), "bh": (b, h, n, m), None: None}[bias_form]
    bias = None if shape is None else torch.randn(shape, generator=gen, device="cuda").to(dtype)
    bound = None
    if bounded:
        bound = torch.tensor(8.0, device="cuda") + (0 if bias is None else bias.max().float())
    return q, k, v, bias, bound, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias_form", ["h", "1", "bh", None])
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_flash_lse_and_backward_kernels_match_plain(cuda, dtype, bias_form, bounded, d):
    q, k, v, bias, bound, do = _attn(cuda, dtype, bias_form, bounded, d)
    before = dict(LAUNCHES)
    out, lse = flash_attention(q, k, v, bias=bias, scale=8.0, logit_bound=bound, return_lse=True)
    got = flash_attention_bwd(q, k, v, bias, out, lse, do, 8.0)
    torch.cuda.synchronize()
    launched = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
    assert launched == dict(dict.fromkeys(LAUNCHES, 0), flash_attention_fwd_lse=1,
                            flash_attention_bwd_delta=1, flash_attention_bwd_dq=1,
                            flash_attention_bwd_dkv=1,
                            flash_attention_bwd_dbias=int(bias is not None))
    ref_out, ref_lse = flash_attention_plain(q, k, v, bias, 8.0, bound, return_lse=True)
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    ref = flash_attention_bwd_plain(q, k, v, bias, out, lse, do, 8.0)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if r is None:
            assert g is None
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, name
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol, msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_autograd_on_the_card(cuda, dtype):
    """torch.autograd through flash_attention launches K2-with-lse and K3 and
    returns exactly what the backward kernels give for its saved output and
    logsumexp; in fp32 it also agrees with autograd through the plain
    forward (in bf16 the kernels' delta is taken from the rounded output,
    which autograd through the fp32 plain forward never sees)."""
    q, k, v, bias, bound, do = _attn(cuda, dtype, "h", True, 32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    before = dict(LAUNCHES)
    out = flash_attention(*leaves[:3], bias=leaves[3], scale=8.0, logit_bound=bound)
    got = torch.autograd.grad(out, leaves, grad_outputs=do)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_fwd_lse"] - before["flash_attention_fwd_lse"] == 1
    assert LAUNCHES["flash_attention_bwd_dbias"] - before["flash_attention_bwd_dbias"] == 1
    out2, lse = flash_attention(q, k, v, bias=bias, scale=8.0, logit_bound=bound,
                                return_lse=True)
    for g, r in zip(got, flash_attention_bwd(q, k, v, bias, out2, lse, do, 8.0)):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    if dtype == torch.float32:
        plain_leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        ref_out = flash_attention_plain(*plain_leaves[:3], plain_leaves[3], 8.0, bound)
        ref = torch.autograd.grad(ref_out, plain_leaves, grad_outputs=do)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, atol=TOL[dtype], rtol=TOL[dtype])


# ------------------------------------- K2 and K3: the masked forms, head dim 128

# q_offset 1 puts the last causal key of a block of 64 rows on the first key
# of a tile: an off-by-one in the tile skips shows there
MASK_FORMS = ("causal", "causal q_offset 1", "causal q_offset 7", "causal q_offset -5",
              "kv holes", "causal kv holes", "kv dead row")


def _masked(gen, dtype, d, form, bias_form, b=2, h=3, n=100, m=90):
    """Inputs ragged against every tile and masks of one form: kv holes put
    a hole at key 0 (so causal row 0 has no valid key) and inside the
    sequence; "kv dead row" masks every key of batch item 1."""
    q, k, v, bias, _, do = _attn(gen, dtype, bias_form, False, d, b=b, h=h, n=n, m=m)
    q, k = q * 4, k * 4                                   # logits of order 1
    kv = qo = None
    if "holes" in form:
        kv = torch.rand(b, m, generator=gen, device="cuda") > 0.25
        kv[:, 0] = False
        kv[1, m - 17:] = False
    if "dead" in form:
        kv = torch.ones(b, m, dtype=torch.bool, device="cuda")
        kv[1] = False
    if "q_offset" in form:
        qo = torch.tensor(int(form.split()[-1]), dtype=torch.int32, device="cuda")
    masks = fa.make_masks(form.startswith("causal"), kv, qo, b, m, "cuda")
    return q, k, v, bias, do, masks


MASKED_CASES = [(dt, form, bias_form, d) for d in (16, 32, 64, 128)
                for dt in ((torch.bfloat16, torch.float32) if d < 128 else (torch.bfloat16,))
                for form in MASK_FORMS for bias_form in (None, "h", "1", "bh")]


@pytest.mark.parametrize("dtype, form, bias_form, d", MASKED_CASES)
def test_flash_masked_kernels_match_plain(cuda, dtype, form, bias_form, d):
    """Every masked form of K2 (with and without the logsumexp) and of the K3
    passes against the plain versions; d(bias) has no kernel at d = 128."""
    q, k, v, bias, do, masks = _masked(cuda, dtype, d, form, bias_form)
    scale = d ** -0.5
    before = dict(LAUNCHES)
    out, lse = fa._forward(q, k, v, bias, scale, None, True, masks)
    out2, _ = fa._forward(q, k, v, bias, scale, None, False, masks)
    delta = fa.flash_attention_bwd_delta(out, do)
    args = (q, k, v, bias, lse, delta, do, scale, masks)
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    dbias = fa.flash_attention_bwd_dbias(*args) if bias is not None and d < 128 else None
    torch.cuda.synchronize()
    suffix = "_d128" if d == 128 else ""
    launched = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
    assert launched == dict(dict.fromkeys(LAUNCHES, 0), **{
        "flash_attention_fwd" + suffix: 1, "flash_attention_fwd_lse" + suffix: 1,
        "flash_attention_bwd_delta": 1, "flash_attention_bwd_dq" + suffix: 1,
        "flash_attention_bwd_dkv" + suffix: 1,
        "flash_attention_bwd_dbias": int(dbias is not None)})
    tol = TOL[dtype]
    ref_out, ref_lse = flash_attention_plain(q, k, v, bias, scale, return_lse=True, masks=masks)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(out2, out, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    refs = {"dq": fa.flash_attention_bwd_dq_plain(*args),
            "dkv": fa.flash_attention_bwd_dkv_plain(*args)}
    for name, g, r in (("dq", dq, refs["dq"]), ("dk", dk, refs["dkv"][0]),
                       ("dv", dv, refs["dkv"][1])):
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol, msg=name)
    if dbias is not None:
        torch.testing.assert_close(dbias.float(), fa.flash_attention_bwd_dbias_plain(*args).float(),
                                   atol=tol, rtol=tol)


# (n, m): neither a multiple of 16 nor of 64; m % 8 == 0 (the bias rows
# arrive by 16-byte copies, the last key tile part-filled); m < 16
EDGE_SHAPES = [(77, 141), (130, 136), (9, 250), (64, 13)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("form", ["none", "causal q_offset 1", "causal kv holes"])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("d", [16, 32, 64])
def test_flash_bf16_kernel_edge_shapes(cuda, d, shape, form, offset):
    """The bf16 tensor-core forward at ragged n and m with a bias (h, n, m),
    with and without the logsumexp; offset 1 puts q, k and v one element off
    a 16-byte boundary, so every row takes the element copies."""
    n, m = shape
    q, k, v, bias, do, masks = _masked(cuda, torch.bfloat16, d, form, "h", n=n, m=m)
    if form == "none":
        masks = fa.NO_MASKS
    if offset:
        q, k, v = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape) for t in (q, k, v))
        assert q.data_ptr() % 16
    scale = d ** -0.5
    before = LAUNCHES["flash_attention_fwd"], LAUNCHES["flash_attention_fwd_lse"]
    out, lse = fa._forward(q, k, v, bias, scale, None, True, masks)
    out2, _ = fa._forward(q, k, v, bias, scale, None, False, masks)
    torch.cuda.synchronize()
    assert (LAUNCHES["flash_attention_fwd"], LAUNCHES["flash_attention_fwd_lse"]) == (
        before[0] + 1, before[1] + 1)
    ref_out, ref_lse = flash_attention_plain(q, k, v, bias, scale, return_lse=True, masks=masks)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(out2, out, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_flash_bf16_kernel_skips_a_dead_key_tile_inside_live_rows(cuda, d, causal):
    """Keys 64..127 (a whole key tile) masked, every other key real: the
    tile is skipped, the rows keep the keys on both sides of it."""
    b, h, n, m = 2, 3, 150, 200
    q, k, v, bias, do, _ = _masked(cuda, torch.bfloat16, d, "none", "bh", b=b, h=h, n=n, m=m)
    kv = torch.ones(b, m, dtype=torch.bool, device="cuda")
    kv[:, 64:128] = False
    masks = fa.make_masks(causal, kv, None, b, m, "cuda")
    out, lse = fa._forward(q, k, v, bias, d ** -0.5, None, True, masks)
    ref_out, ref_lse = flash_attention_plain(q, k, v, bias, d ** -0.5, return_lse=True,
                                             masks=masks)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("form", ["none", "causal kv holes"])
def test_flash_bf16_kernel_is_deterministic(cuda, form):
    """At the serving shape (bias rows by 16-byte copies) and a ragged masked
    one, two calls give the same bits."""
    if form == "none":
        q, k, v, bias, bound, _ = _attn(cuda, torch.bfloat16, "h", True, 32, b=24, h=8, n=576,
                                        m=576)
        masks = fa.NO_MASKS
    else:
        q, k, v, bias, _, masks = _masked(cuda, torch.bfloat16, 64, form, "h")
        bound = None
    runs = [fa._forward(q, k, v, bias, 8.0, bound, True, masks) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


# ----------------------------------- K3: the bf16 backward on the tensor cores

def _odd(t):
    """t one element off a 16-byte boundary: every row takes the element copies."""
    return torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)


def _bwd_vs_plain(q, k, v, bias, do, masks, scale, odd=False):
    """The forward by K2, then the four K3 passes against the plain backward
    on the same output and logsumexp; with ``odd`` q, k, v, dO and O sit off
    16-byte boundaries.  Checks one launch of each pass."""
    if odd:
        q, k, v, do = (_odd(t) for t in (q, k, v, do))
        assert q.data_ptr() % 16 and do.data_ptr() % 16
    out, lse = fa._forward(q, k, v, bias, scale, None, True, masks)
    if odd:
        out = _odd(out)
    before = dict(LAUNCHES)
    got = flash_attention_bwd(q, k, v, bias, out, lse, do, scale, masks=masks)
    torch.cuda.synchronize()
    launched = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
    assert launched == dict(dict.fromkeys(LAUNCHES, 0), flash_attention_bwd_delta=1,
                            flash_attention_bwd_dq=1, flash_attention_bwd_dkv=1,
                            flash_attention_bwd_dbias=int(bias is not None))
    ref = flash_attention_bwd_plain(q, k, v, bias, out, lse, do, scale, masks=masks)
    tol = TOL[torch.bfloat16]
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if r is None:
            assert g is None
            continue
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol, msg=name)


# (n, m): not multiples of 16 or of 64 (13, 77, 141, 577), n < 16, m < 16,
# m % 8 == 0 (the bias rows by 16-byte copies, the last tile part-filled)
BWD_EDGE_SHAPES = [(13, 77), (77, 141), (130, 136), (577, 577), (64, 13)]
# (mask form, bias form): every bias form; q_offset 1 puts a block's last
# causal key on a tile's first key; kv holes mask key 0, so with causal
# row 0 has no valid key; kv dead row masks every key of batch item 1
BWD_EDGE_FORMS = [("none", "h"), ("none", "1"), ("none", None), ("causal q_offset 1", "bh"),
                  ("causal kv holes", "h"), ("kv dead row", "1")]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("form, bias_form", BWD_EDGE_FORMS)
@pytest.mark.parametrize("shape", BWD_EDGE_SHAPES)
@pytest.mark.parametrize("d", [16, 32, 64])
def test_flash_bwd_bf16_kernels_edge_shapes(cuda, d, shape, form, bias_form, offset):
    """The bf16 tensor-core backward at ragged n and m, with each bias form
    and mask form, at aligned and odd offsets."""
    n, m = shape
    q, k, v, bias, do, masks = _masked(cuda, torch.bfloat16, d, form, bias_form, n=n, m=m)
    if form == "none":
        masks = fa.NO_MASKS
    _bwd_vs_plain(q, k, v, bias, do, masks, d ** -0.5, odd=bool(offset))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64])
def test_flash_bwd_bf16_kernels_skip_a_dead_key_tile_inside_live_rows(cuda, d, causal):
    """Keys 64..127 (a whole key tile, and a whole dK/dV block) masked,
    every other key real: dQ and d(bias) skip the tile, its dk rows are zero
    and its dv rows hold only the empty rows' share."""
    b, h, n, m = 2, 3, 150, 200
    q, k, v, bias, do, _ = _masked(cuda, torch.bfloat16, d, "none", "bh", b=b, h=h, n=n, m=m)
    kv = torch.ones(b, m, dtype=torch.bool, device="cuda")
    kv[:, 64:128] = False
    _bwd_vs_plain(q, k, v, bias, do, fa.make_masks(causal, kv, None, b, m, "cuda"), d ** -0.5)


@pytest.mark.parametrize("form", ["none", "causal kv holes"])
def test_flash_bwd_kernels_are_deterministic(cuda, form):
    """At the CLIP training shape (bias (h, n, m)) and a ragged masked one,
    two calls of each K3 pass give the same bits: no pass adds with atomics."""
    if form == "none":
        q, k, v, bias, _, do = _attn(cuda, torch.bfloat16, "h", False, 32, b=48, h=8, n=576,
                                     m=576)
        masks, scale = fa.NO_MASKS, 8.0
    else:
        q, k, v, bias, do, masks = _masked(cuda, torch.bfloat16, 64, form, "h")
        scale = 64 ** -0.5
    out, lse = fa._forward(q, k, v, bias, scale, None, True, masks)
    delta = fa.flash_attention_bwd_delta(out, do)
    args = (q, k, v, bias, lse, delta, do, scale, masks)
    for fn in (lambda: (fa.flash_attention_bwd_delta(out, do),),
               lambda: (fa.flash_attention_bwd_dq(*args),),
               lambda: fa.flash_attention_bwd_dkv(*args),
               lambda: (fa.flash_attention_bwd_dbias(*args),)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_flash_d128_training_shape_autograd(cuda):
    """Report training's attention (causal, right padding 512/384) at b 2,
    h 4, n 512, d 128 through torch.autograd: one K2-lse and one each of the
    K3 passes, against autograd through the plain forward in fp32 from the
    same bf16 inputs."""
    b, h, n, d = 2, 4, 512, 128
    q, k, v, _, _, do = _attn(cuda, torch.bfloat16, None, False, d, b=b, h=h, n=n, m=n)
    q, k = q * 4, k * 4
    kv = torch.arange(n, device="cuda")[None] < torch.tensor([[n], [384]], device="cuda")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(LAUNCHES)
    out = flash_attention(*leaves, causal=True, kv_mask=kv, scale=d ** -0.5)
    got = torch.autograd.grad(out, leaves, grad_outputs=do)
    torch.cuda.synchronize()
    launched = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
    assert launched == dict(dict.fromkeys(LAUNCHES, 0), flash_attention_fwd_lse_d128=1,
                            flash_attention_bwd_delta=1, flash_attention_bwd_dq_d128=1,
                            flash_attention_bwd_dkv_d128=1)
    ref_leaves = [t.float().clone().requires_grad_() for t in (q, k, v)]
    ref_out = flash_attention_plain(*ref_leaves, None, d ** -0.5,
                                    masks=fa.make_masks(True, kv, None, b, n, "cuda"))
    ref = torch.autograd.grad(ref_out, ref_leaves, grad_outputs=do.float())
    torch.testing.assert_close(out.float(), ref_out, atol=2e-2, rtol=2e-2)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r, atol=2e-2, rtol=2e-2)


def test_flash_d128_refuses_what_it_does_not_take(cuda):
    q, k, v, bias, _, _ = _attn(cuda, torch.float32, "h", False, 128, n=64, m=64)
    with pytest.raises(TypeError):
        flash_attention(q, k, v)                              # fp32 at head dim 128
    qb, kb, vb, bb = (t.to(torch.bfloat16) for t in (q, k, v, bias))
    with pytest.raises(NotImplementedError):                  # d(bias) at head dim 128
        flash_attention(qb, kb, vb, bias=bb.requires_grad_())
    with pytest.raises(ValueError):                           # rows off 16-byte boundaries
        b, h, n, d = qb.shape
        flash_attention(qb.flatten()[4:4 + b * h * (n - 1) * d].view(b, h, n - 1, d), kb, vb)


# (n, m, mask form, bias form) at head dim 128: ragged n and m; q_offset 1
# (a block's last causal key on a tile's first key); kv holes with causal
# (row 0 has no valid key); keys 64..127 dead inside live rows (a whole key
# tile and dK/dV block); a batch item with no real key; each bias form
D128_BWD_CASES = [(77, 141, "causal q_offset 1", None), (130, 200, "causal kv holes", "h"),
                  (150, 200, "dead key tile", "bh"), (64, 13, "kv dead row", None),
                  (200, 150, "causal q_offset 1", "1")]


@pytest.mark.parametrize("n, m, form, bias_form", D128_BWD_CASES)
def test_flash_d128_backward_ragged_masked_autograd(cuda, n, m, form, bias_form):
    """K3 at head dim 128 (the bf16 mma.sync kernels at D = 128) through
    torch.autograd at ragged shapes, each mask form and a bias (which takes
    no gradient there), against the plain backward on the kernel forward's
    output and logsumexp (2e-2 abs + rel)."""
    b, d = 2, 128
    scale = d ** -0.5
    q, k, v, bias, do, masks = _masked(cuda, torch.bfloat16, d,
                                       "none" if form == "dead key tile" else form, bias_form,
                                       n=n, m=m)
    if form == "dead key tile":
        kv = torch.ones(b, m, dtype=torch.bool, device="cuda")
        kv[:, 64:128] = False
        masks = fa.make_masks(False, kv, None, b, m, "cuda")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(LAUNCHES)
    out, lse = fa._FlashAttentionFn.apply(*leaves, bias, scale, None, masks)
    got = torch.autograd.grad(out, leaves, grad_outputs=do)
    torch.cuda.synchronize()
    launched = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
    assert launched == dict(dict.fromkeys(LAUNCHES, 0), flash_attention_fwd_lse_d128=1,
                            flash_attention_bwd_delta=1, flash_attention_bwd_dq_d128=1,
                            flash_attention_bwd_dkv_d128=1)
    ref = flash_attention_bwd_plain(q, k, v, bias, out.detach(), lse, do, scale, masks=masks)
    tol = TOL[torch.bfloat16]
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=tol, msg=name)


# (n, m, mask form, bias form, logit bound) of K2 at head dim 128: report
# training's shape (b 2, h 32, causal, lengths 512/384), then the ragged
# masked forms of the backward's cases, each bias form, the flat softmax
D128_FWD_CASES = [(512, 512, "training", None, False)] + [
    (n, m, form, bias_form, False) for n, m, form, bias_form in D128_BWD_CASES] + [
    (150, 200, "none", "h", True), (100, 90, "causal kv holes", "bh", False)]


@pytest.mark.parametrize("n, m, form, bias_form, bounded", D128_FWD_CASES)
def test_flash_d128_forward_matches_plain(cuda, n, m, form, bias_form, bounded):
    """K2 at head dim 128 (flash_fwd_mma_kernel at D = 128), with and without
    the logsumexp, against the plain forward: out within 2e-2 abs + rel, the
    lse within 1e-4; one launch of each launcher."""
    b, d = 2, 128
    scale = d ** -0.5
    if form == "training":
        q, k, v, bias, _, _ = _attn(cuda, torch.bfloat16, None, False, d, b=b, h=32, n=n, m=m)
        q, k = q * 4, k * 4                               # logits of order 1
        kv = torch.arange(n, device="cuda")[None] < torch.tensor([[512], [384]], device="cuda")
        masks = fa.make_masks(True, kv, None, b, m, "cuda")
    elif form == "dead key tile":
        q, k, v, bias, _, _ = _masked(cuda, torch.bfloat16, d, "none", bias_form, n=n, m=m)
        kv = torch.ones(b, m, dtype=torch.bool, device="cuda")
        kv[:, 64:128] = False
        masks = fa.make_masks(False, kv, None, b, m, "cuda")
    else:
        q, k, v, bias, _, masks = _masked(cuda, torch.bfloat16, d, form, bias_form, n=n, m=m)
        if form == "none":
            masks = fa.NO_MASKS
    bound = None
    if bounded:
        bound = (fa._scores(q, k, bias, scale).amax() + 0.5).reshape(())
    before = dict(LAUNCHES)
    out, lse = fa._forward(q, k, v, bias, scale, bound, True, masks)
    out2, _ = fa._forward(q, k, v, bias, scale, bound, False, masks)
    torch.cuda.synchronize()
    launched = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
    assert launched == dict(dict.fromkeys(LAUNCHES, 0), flash_attention_fwd_d128=1,
                            flash_attention_fwd_lse_d128=1)
    ref_out, ref_lse = flash_attention_plain(q, k, v, bias, scale, bound, return_lse=True,
                                             masks=masks)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(out2, out, atol=0, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("form", ["causal padded", "kv holes, bias"])
def test_flash_d128_forward_is_deterministic(cuda, form):
    """K2 at head dim 128, called twice, gives the same bits (out and lse)."""
    d, scale = 128, 128 ** -0.5
    if form == "causal padded":
        b, n = 2, 512
        q, k, v, bias, _, _ = _attn(cuda, torch.bfloat16, None, False, d, b=b, h=32, n=n, m=n)
        kv = torch.arange(n, device="cuda")[None] < torch.tensor([[n], [384]], device="cuda")
        masks = fa.make_masks(True, kv, None, b, n, "cuda")
    else:
        q, k, v, bias, _, masks = _masked(cuda, torch.bfloat16, d, "causal kv holes", "h")
    first = fa._forward(q, k, v, bias, scale, None, True, masks)
    second = fa._forward(q, k, v, bias, scale, None, True, masks)
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("form", ["causal padded", "kv holes, bias"])
def test_flash_d128_backward_is_deterministic(cuda, form):
    """dQ and dK/dV at head dim 128, called twice, give the same bits: every
    sum runs inside one block in a fixed order."""
    d, scale = 128, 128 ** -0.5
    if form == "causal padded":
        b, h, n = 2, 4, 512
        q, k, v, bias, _, do = _attn(cuda, torch.bfloat16, None, False, d, b=b, h=h, n=n, m=n)
        kv = torch.arange(n, device="cuda")[None] < torch.tensor([[n], [384]], device="cuda")
        masks = fa.make_masks(True, kv, None, b, n, "cuda")
    else:
        q, k, v, bias, do, masks = _masked(cuda, torch.bfloat16, d, "causal kv holes", "h")
    out, lse = fa._forward(q, k, v, bias, scale, None, True, masks)
    delta = fa.flash_attention_bwd_delta(out, do)
    args = (q, k, v, bias, lse, delta, do, scale, masks)
    for fn in (lambda: (fa.flash_attention_bwd_dq(*args),),
               lambda: fa.flash_attention_bwd_dkv(*args)):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(first, second))


def is_spatial_fold_param(name: str) -> bool:
    """The attention projections and scales of the spatial fold and the CPB
    MLP, whose gradients pass through the flash kernels.  The CPB's
    ``to_heads.bias`` is left out: it shifts every logit of a head alike, so
    softmax ignores it and its gradient is zero up to rounding noise."""
    attn = "enc_spatial_transformer" in name and any(
        key in name for key in ("attn.to_q", "attn.to_kv", "attn.q_scale", "attn.k_scale"))
    return attn or ("spatial_rel_pos_bias" in name and not name.endswith("to_heads.bias"))


def test_ctvit_training_gradients_kernel_path_vs_plain_path(cuda):
    """fp32 parameters, bf16 compute, remat on: the spatial fold's gradients
    through K2-with-lse and K3 point the same way as through the plain
    attention (bf16 rounds at other places on the two paths)."""
    cfg = CTViTConfig(dim=128, codebook_size=64, image_size=48, patch_size=8,
                      temporal_size=16, temporal_patch_size=4, spatial_depth=2,
                      temporal_depth=1, dim_head=32, heads=4)
    bf16 = torch.bfloat16
    plain = set_compute_dtype(random_init_(CTViT(cfg, device="cuda", remat=True), cuda), bf16)
    fast = set_compute_dtype(CTViT(dataclasses.replace(cfg, flash_axial=True), device="cuda",
                                   remat=True), bf16)
    fast.load_state_dict(plain.state_dict())
    video = torch.rand(2, 1, cfg.temporal_size, cfg.image_size, cfg.image_size,
                       generator=cuda, device="cuda") * 2 - 1
    # a fixed random projection of the tokens (their mean square after the
    # final LayerNorm would be constant, with no gradient to compare)
    target = torch.randn(2, cfg.temporal_tokens, 6, 6, cfg.dim, generator=cuda, device="cuda")
    grads = []
    before = dict(LAUNCHES)
    for model in (fast, plain):
        tokens, _ = model(video.to(bf16))
        (tokens.float() * target).sum().backward()
        grads.append({n: p.grad.float() for n, p in model.named_parameters()
                      if is_spatial_fold_param(n)})
    assert LAUNCHES["flash_attention_fwd_lse"] - before["flash_attention_fwd_lse"] == 2 * 2
    assert LAUNCHES["flash_attention_bwd_dkv"] - before["flash_attention_bwd_dkv"] == 2
    for name, g in grads[0].items():
        cos = torch.nn.functional.cosine_similarity(g.flatten(), grads[1][name].flatten(), dim=0)
        assert cos >= 0.99, (name, cos.item())


# ------------------------------------- K2-lse and K3 at the fused sequence

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fused_sequence_kernels_match_plain(cuda, dtype):
    """The fused encoder's form: no bias, no mask, n = m = 13,824, head dim
    32, the cosine bound; K2-lse and the delta, dQ and dK/dV passes of K3
    against their plain versions (one head at a time: the (1, 8, n, n) fp32
    scores are 6.1 GB) under chip_smoke.py's fused-form limits, each called
    twice for the same bits.  The limits must reject what kernels that skip
    the last keys (out, dQ) or queries (dK, dV) would return."""
    import chip_smoke as cs

    b, h, n, d = cs.FUSED_SHAPE
    q = l2norm(torch.randn(b, h, n, d, generator=cuda, device="cuda")).to(dtype)
    k = l2norm(torch.randn(b, h, n, d, generator=cuda, device="cuda")).to(dtype)
    v, do = (torch.randn(b, h, n, d, generator=cuda, device="cuda").to(dtype) for _ in range(2))
    bound = torch.tensor(8.0, device="cuda")
    out, lse = flash_attention(q, k, v, scale=8.0, logit_bound=bound, return_lse=True)
    again = flash_attention(q, k, v, scale=8.0, logit_bound=bound, return_lse=True)
    delta = fa.flash_attention_bwd_delta(out, do)
    args = (q, k, v, None, lse, delta, do, 8.0)
    dq, (dk, dv) = fa.flash_attention_bwd_dq(*args), fa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    assert torch.equal(delta, fa.flash_attention_bwd_delta(out, do))
    assert torch.equal(dq, fa.flash_attention_bwd_dq(*args))
    assert all(torch.equal(x, y) for x, y in zip((dk, dv), fa.flash_attention_bwd_dkv(*args)))
    ref_out, ref_lse = cs.by_head(lambda *a: flash_attention_plain(*a, return_lse=True),
                                  q, k, v, None, 8.0, bound)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(delta, fa.flash_attention_bwd_delta_plain(out, do), atol=1e-4,
                               rtol=1e-4)
    rdk, rdv = cs.by_head(fa.flash_attention_bwd_dkv_plain, *args)
    fault = cs.fused_faults(q, k, v, lse, delta, do, 8.0, bound)
    for name, got, ref in (("out", out, ref_out),
                           ("dq", dq, cs.by_head(fa.flash_attention_bwd_dq_plain, *args)),
                           ("dk", dk, rdk), ("dv", dv, rdv)):
        atol, rtol = cs.fused_tolerance(ref, dtype)
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol, msg=name)
        assert cs.rejects(fault[name], ref, atol, rtol), name


def test_ctvit_fused_encoder_kernel_path_vs_plain_path(cuda):
    """The shipped CTViT with fused_attention at fused_depth 1, one volume,
    fp32 parameters and bf16 compute: tokens and every gradient of the
    fused stack through K2-lse and K3 against the same stack with its
    attention taken by the plain cosine attention."""
    cfg = dataclasses.replace(CTViTConfig(), fused_attention=True, fused_depth=1)
    bf16 = torch.bfloat16
    fast = set_compute_dtype(random_init_(CTViT(cfg, device="cuda"), cuda), bf16)
    plain = set_compute_dtype(CTViT(cfg, device="cuda"), bf16)
    plain.load_state_dict(fast.state_dict())
    for block in plain.enc_fused_transformer.blocks:
        block.attn.use_flash = False
    video = torch.rand(1, 1, cfg.temporal_size, cfg.image_size, cfg.image_size,
                       generator=cuda, device="cuda") * 2 - 1
    t, hh, ww = plain.grid
    target = torch.randn(1, t, hh, ww, cfg.dim, generator=cuda, device="cuda")
    before = dict(LAUNCHES)
    outs, grads = [], []
    for model in (fast, plain):
        tokens, _ = model(video.to(bf16))
        (tokens.float() * target).sum().backward()
        outs.append(tokens.float())
        grads.append({n: p.grad.float() for n, p in model.named_parameters()
                      if "enc_fused_transformer" in n})
    launched = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
    assert launched["flash_attention_fwd_lse"] == launched["flash_attention_bwd_dq"] == 1
    assert launched["flash_attention_bwd_dbias"] == 0
    cos = torch.nn.functional.cosine_similarity(outs[0].flatten(), outs[1].flatten(), dim=0)
    assert cos >= 0.999, cos.item()
    for name, g in grads[0].items():
        cos = torch.nn.functional.cosine_similarity(g.flatten(), grads[1][name].flatten(), dim=0)
        assert cos >= 0.99, (name, cos.item())


# ------------------------------------------- K2-lse and K3 in the VQGAN step

def test_vqgan_step_kernel_path_vs_plain_path(cuda):
    """The VQGAN step (train/vqgan_trainer.py) at CTViTConfig()'s width
    with the decoder, one block a fold and one volume: the spatial fold on
    K2-lse and K3 with d(bias) against the plain cosine attention, both
    quantizing to the plain path's codes, with R1 and without, under phase
    vqgan's gates (chip_smoke.vqgan_steps: in bf16 each loss term within
    0.05 and each group's gradient cosine >= 0.99, in fp32 1e-4 and 0.9999;
    exact launches); the kernel path with chip_smoke's planted flash faults
    (causal on; in fp32 also the last 32 keys masked) must fail them."""
    import chip_smoke as cs

    cfg = cs.vqgan_config(flash_axial=True, spatial_depth=1, temporal_depth=1)
    cs.vqgan_steps("cuda", cfg, batch=1)


# ------------------------------------------------------- K8: decode attention

def _decode(gen, q_dtype, cache_dtype, hd, rep, m, b=3, kvh=4, L=3):
    """A cache with holes, a ragged tail and one empty row."""
    h = kvh * rep
    q = torch.randn(b, h, hd, generator=gen, device="cuda").to(q_dtype)
    shape = (L, b, kvh, m, hd)
    ks = vs = None
    if cache_dtype == torch.int8:
        ck, cv = (torch.randint(-127, 128, shape, generator=gen, device="cuda").to(torch.int8)
                  for _ in range(2))
        ks, vs = (0.001 + 0.02 * torch.rand(shape[:4], generator=gen, device="cuda")
                  for _ in range(2))
    else:
        ck, cv = (torch.randn(shape, generator=gen, device="cuda").to(cache_dtype)
                  for _ in range(2))
    valid = torch.rand(b, m, generator=gen, device="cuda") > 0.3
    valid[0, m // 2:] = False
    valid[-1] = False
    return q, ck, cv, valid, ks, vs


@pytest.mark.parametrize("types", [(torch.bfloat16, torch.bfloat16),
                                   (torch.float32, torch.float32),
                                   (torch.bfloat16, torch.int8), (torch.float32, torch.int8)])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("m", [37, 608, 2432])
def test_decode_attention_kernel_matches_plain(cuda, types, hd, rep, m):
    from ctpa_torch.ops import decode_attention as da

    q, ck, cv, valid, ks, vs = _decode(cuda, *types, hd, rep, m)
    before = da.LAUNCHES["decode_attention"]
    got = da.decode_attention(q, ck, cv, valid, 1, ks, vs, scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert da.LAUNCHES["decode_attention"] == before + 1
    ref = da.decode_attention_plain(q, ck, cv, valid, 1, ks, vs, scale=hd ** -0.5)
    tol = TOL[types[0]]
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    assert not got[-1].any()                                  # the empty row


def _prompt_validity(b, m):
    """chip_smoke's last-step validity: prompts of 512/448/384/320 tokens
    padded to 512, repeated over the batch, then the decode slots."""
    slot = torch.arange(m, device="cuda")
    lens = torch.tensor([512, 448, 384, 320], device="cuda").repeat(b // 4 + 1)[:b]
    return (slot[None] < lens[:, None]) | (slot[None] >= 512)


@pytest.mark.parametrize("types", [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
                                   (torch.float32, torch.int8)])
@pytest.mark.parametrize("case", ["b32", "m2432", "rank empty", "row empty", "one slot"])
def test_decode_attention_kernel_split_edges(cuda, types, case):
    """The split-KV cluster's edges at head dim 128: batch 32 (one block a
    head), a 2,432-slot plane, a cluster rank whose whole range holds no
    valid slot (it must add exactly nothing), rows with no valid slot (zeros,
    no NaN) and a single valid slot in the last tile."""
    from ctpa_torch.ops import decode_attention as da

    b, m = (32, 608) if case == "b32" else (4, 2432 if case == "m2432" else 608)
    q, ck, cv, _, ks, vs = _decode(cuda, *types, 128, 1, m, b=b, kvh=4, L=2)
    valid = _prompt_validity(b, m)
    splits = da.split_count(b * 4, m, 128, torch.cuda.get_device_properties(0).multi_processor_count)
    if case == "rank empty":
        assert splits > 1
        lo, hi = da.rank_slots(m, 128, splits)[splits // 2]
        valid[:, lo:hi] = False
    elif case == "row empty":
        valid[1] = False
        valid[3] = False
    elif case == "one slot":
        valid[:] = False
        valid[:, m - 1] = True
    got = da.decode_attention(q, ck, cv, valid, 1, ks, vs, scale=128 ** -0.5)
    ref = da.decode_attention_plain(q, ck, cv, valid, 1, ks, vs, scale=128 ** -0.5)
    torch.cuda.synchronize()
    tol = TOL[types[0]]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    assert not got[~valid.any(1)].any()


@pytest.mark.parametrize("types", [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
                                   (torch.float32, torch.float32)])
@pytest.mark.parametrize("b", [4, 32])
def test_decode_attention_kernel_is_deterministic(cuda, types, b):
    """Every sum runs in a fixed order (slots in a group, groups in a block,
    ranks in a cluster): two calls give the same bits."""
    from ctpa_torch.ops import decode_attention as da

    q, ck, cv, _, ks, vs = _decode(cuda, *types, 128, 1, 608, b=b, kvh=4, L=2)
    valid = _prompt_validity(b, 608)
    first = da.decode_attention(q, ck, cv, valid, 1, ks, vs, scale=128 ** -0.5)
    second = da.decode_attention(q, ck, cv, valid, 1, ks, vs, scale=128 ** -0.5)
    assert torch.equal(first, second)


def test_decode_attention_kernel_refuses_what_it_does_not_take(cuda):
    from ctpa_torch.ops import decode_attention as da

    q, ck, cv, valid, _, _ = _decode(cuda, torch.bfloat16, torch.float32, 32, 1, 40)
    with pytest.raises(TypeError):
        da.decode_attention(q, ck, cv, valid, 0)              # bf16 q on an fp32 cache
    q, ck, cv, valid, _, _ = _decode(cuda, torch.float32, torch.float32, 48, 1, 40)
    with pytest.raises(ValueError):
        da.decode_attention(q, ck, cv, valid, 0)              # head dim 48
    q, ck, cv, valid, _, _ = _decode(cuda, torch.float32, torch.float32, 32, 1, 40)
    with pytest.raises(ValueError):
        da.decode_attention(q, ck.transpose(3, 4).contiguous().transpose(3, 4), cv, valid, 0)


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_report_generator_kernel_path_matches_plain_path(cuda, kv_quant):
    """A small report generator in bf16, as chip_smoke.py's report phases at
    Meditron width: every decode step launches the kernel once per layer,
    the kernel path teacher-forced on its own tokens gives them back, and
    the dense path's fused logits on the same tokens agree with it.  At two
    layers bf16 noise stays small: every step's max |diff| within 5e-2 of
    its max |logit|, top-1 agreement >= 0.8."""
    import chip_smoke as cs
    from ctpa_torch.core.config import LLMConfig, ReportGenConfig
    from ctpa_torch.models.report_generator import CTReportGenerator
    from ctpa_torch.ops import decode_attention as da

    llm = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                    intermediate_size=512, max_seq_len=128, kv_quant=kv_quant, flash_decode=True)
    vit = CTViTConfig(dim=128, codebook_size=64, image_size=48, patch_size=8, temporal_size=16,
                      temporal_patch_size=4, spatial_depth=1, temporal_depth=1, dim_head=32,
                      heads=4, pallas_patchify=True)
    bf16 = torch.bfloat16
    model = random_init_(CTReportGenerator(llm, vit, ReportGenConfig(vision_dim=64),
                                           device="cuda", dtype=bf16), cuda).eval()
    video = (torch.rand(2, 1, 16, 48, 48, generator=cuda, device="cuda") * 2 - 1).to(bf16)
    ids = torch.randint(1, 512, (2, 9), generator=cuda, device="cuda")
    mask = torch.ones_like(ids)
    mask[1, 6:] = 0
    inputs = (video, ids * mask, mask)
    before = da.LAUNCHES["decode_attention"]
    with torch.inference_mode():
        tokens = model.generate(*inputs, 8, -1, greedy=True).tokens
        assert da.LAUNCHES["decode_attention"] - before == llm.num_layers * 7
        kernel = cs.teacher_forced_logits(model, *inputs, tokens)
        plain = cs.teacher_forced_logits(cs.twin(model, flash_decode=False), *inputs, tokens)
    assert torch.equal(kernel.argmax(-1), tokens)
    rel, _, top1 = cs.logit_distance(kernel, plain)
    assert rel <= 5e-2 and top1 >= 0.8, (rel, top1)


def test_report_lora_step_kernel_path_vs_plain_path(cuda):
    """One partitioned LoRA step of a small report generator (fp32
    parameters, bf16 compute, head dim 128, GQA rep 2, sequences 64/40
    right-padded to 64) with flash_prefill against the dense path from the
    same state: one forward (with the logsumexp) and one each of the K3
    passes per layer, the losses within 2e-2 and every LoRA and head
    gradient with cosine >= 0.99 (bf16 rounds at other places)."""
    from ctpa_torch.core.config import LLMConfig, LoRAConfig, ReportGenConfig
    from ctpa_torch.models.report_generator import CTReportGenerator
    from ctpa_torch.train.report_trainer import make_partitioned_report_step, trainable_labels
    from ctpa_torch.train.train_state import SimpleTrainState

    vit = CTViTConfig(dim=128, codebook_size=64, image_size=48, patch_size=8, temporal_size=16,
                      temporal_patch_size=4, spatial_depth=1, temporal_depth=1, dim_head=32,
                      heads=4)
    lora = LoRAConfig(rank=4, alpha=8.0)
    gen = ReportGenConfig(vision_dim=64, lora=lora)
    video = torch.rand(2, 1, 16, 48, 48, generator=cuda, device="cuda") * 2 - 1
    ids = torch.randint(1, 512, (2, 64), generator=cuda, device="cuda")
    mask = (torch.arange(64, device="cuda")[None] < torch.tensor([[64], [40]], device="cuda"))
    batch = {"video": video, "input_ids": ids * mask, "attention_mask": mask.long()}
    models = []
    for flash in (True, False):
        llm = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2,
                        num_kv_heads=1, intermediate_size=512, max_seq_len=128,
                        flash_prefill=flash, flash_min_len=16)
        models.append(set_compute_dtype(CTReportGenerator(llm, vit, gen, lora=lora,
                                                          device="cuda"), torch.bfloat16))
    random_init_(models[0], cuda)
    models[1].load_state_dict(models[0].state_dict())
    grads, losses = [], []
    before = dict(LAUNCHES)
    for model in models:
        step, tx = make_partitioned_report_step(model, gen, total_steps=4)
        _, m = step(SimpleTrainState.create(model, tx), batch)
        if not grads:
            torch.cuda.synchronize()
            launched = {key: LAUNCHES[key] - before[key] for key in LAUNCHES}
            assert launched == dict(dict.fromkeys(LAUNCHES, 0), flash_attention_fwd_lse_d128=2,
                                    flash_attention_bwd_delta=2, flash_attention_bwd_dq_d128=2,
                                    flash_attention_bwd_dkv_d128=2)
        labels = trainable_labels(model)
        losses.append(float(m["loss"]))
        # the step clips in place; both paths' norms are close, compare directions
        grads.append({n: p.grad.float() for n, p in model.named_parameters()
                      if labels[n] != "frozen" and p.grad.abs().max() > 0})
    assert abs(losses[0] - losses[1]) <= 2e-2, losses
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) > 16
    for name, g in grads[0].items():
        cos = torch.nn.functional.cosine_similarity(g.flatten(), grads[1][name].flatten(), dim=0)
        assert cos >= 0.99, (name, cos.item())


# (m, in, out): decode and prefill row counts, ragged rows and columns,
# groups of 128, 64 (in 192) and 32 (in 160)
INT4_MATMUL_SHAPES = [(4, 4096, 4096), (32, 512, 1000), (5, 256, 200), (70, 192, 136),
                      (17, 160, 64), (300, 1024, 768)]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("shape", INT4_MATMUL_SHAPES)
def test_int4_matmul_kernel_matches_plain(cuda, shape, act_quant):
    """K5 against its plain version in bf16: both round the same dequantized
    weights and sum in fp32 (w4), or sum the same exact int32 group dots
    times their scales in fp32 (w4a8), in another order (2e-2 abs + rel)."""
    from ctpa_torch.ops import quant

    m, d_in, d_out = shape
    w4, s = quant.quantize_int4(0.05 * torch.randn(d_in, d_out, generator=cuda, device="cuda"))
    x = torch.randn(m, d_in, generator=cuda, device="cuda").to(torch.bfloat16)
    name = quant.kernel_name("int4_matmul_a8" if act_quant else "int4_matmul", m)
    before = quant.LAUNCHES[name]
    got = quant.int4_matmul(x, w4, s, act_quant=act_quant)
    torch.cuda.synchronize()
    assert quant.LAUNCHES[name] == before + 1
    ref = quant.int4_matmul_plain(x, w4, s, act_quant=act_quant)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


# (m, in, out) around K5's decode kernel: 1, 3, 4, 17, 31 and 32 rows take
# it, 33 the prefill kernel; groups of 128, 64 (in 192) and 32 (in 160); a
# ragged width (1000, 520); 11 groups (in 1408), whose splits cannot all be
# equal
INT4_DECODE_SHAPES = [(1, 4096, 4096), (3, 160, 1000), (4, 1408, 4096), (4, 4096, 12288),
                      (17, 192, 1000), (31, 192, 4096), (32, 4096, 1000), (32, 160, 520),
                      (33, 4096, 4096)]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("shape", INT4_DECODE_SHAPES)
def test_int4_matmul_decode_kernel_matches_plain(cuda, shape, act_quant):
    """K5 around the decode/prefill threshold against its plain version: w4
    in bf16's bound (2e-2 abs + rel), w4a8 in one bf16 ulp of |p| plus 1e-3
    of max|p| (its group dots are exact, the split partials change the fp32
    order of the group sum).  One launch (and the activation quantization
    for w4a8); the split decode kernel adds its partials itself."""
    from ctpa_torch.ops import quant

    m, d_in, d_out = shape
    w4, s = quant.quantize_int4(0.05 * torch.randn(d_in, d_out, generator=cuda, device="cuda"))
    x = torch.randn(m, d_in, generator=cuda, device="cuda").to(torch.bfloat16)
    g = quant._int4_group(d_in, quant.GROUP)
    plan = quant.int4_matmul_plan_on(x, d_out, g, act_quant)
    assert plan[0] == ("stream" if m <= 32 else "wgmma")
    if plan[0] == "stream":
        _, splits, per = plan
        assert (splits - 1) * per < d_in // g <= splits * per
    before = dict(quant.LAUNCHES)
    got = quant.int4_matmul(x, w4, s, act_quant=act_quant)
    torch.cuda.synchronize()
    launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
    want = quant.int4_matmul_launches(m, act_quant)
    assert launched == dict(dict.fromkeys(quant.LAUNCHES, 0), **want)
    _int8_close(got, quant.int4_matmul_plain(x, w4, s, act_quant=act_quant), act_quant)


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("m", [4, 32])
def test_int4_matmul_decode_kernel_is_deterministic(cuda, m, act_quant):
    """The split decode kernel at the fused qkv_proj's width, called twice,
    gives the same bits: the last block of a strip adds the splits in order."""
    from ctpa_torch.ops import quant

    w4, s = quant.quantize_int4(0.05 * torch.randn(4096, 12288, generator=cuda, device="cuda"))
    x = torch.randn(m, 4096, generator=cuda, device="cuda").to(torch.bfloat16)
    assert quant.int4_matmul_plan_on(x, 12288, 128, act_quant)[1] > 1
    first = quant.int4_matmul(x, w4, s, act_quant=act_quant)
    second = quant.int4_matmul(x, w4, s, act_quant=act_quant)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# (m, in, out, group) of K5's prefill kernel: 33, 70 and 2,053 rows at
# Meditron-7B's qkv_proj and o_proj; small ragged widths (n % 16 != 0: the
# producer copies the packed rows and scales), groups of 32, 64 and 128, one
# and two column strips, a partial ring stage (192 at group 64)
INT4_PREFILL_SHAPES = [(33, 4096, 12288, 128), (70, 4096, 4096, 128), (2053, 4096, 12288, 128),
                       (33, 4096, 4096, 128), (70, 384, 520, 128), (300, 512, 200, 32),
                       (65, 192, 136, 64), (129, 1024, 256, 32)]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("shape", INT4_PREFILL_SHAPES)
def test_int4_matmul_prefill_kernel_matches_plain(cuda, shape, act_quant):
    """K5's prefill kernel (``prefill_wgmma.cuh``) against its plain version:
    w4 in bf16's bound, w4a8 in the int8 bound (its group dots are exact; a
    split contraction changes the fp32 order of the group sum).  Exactly one
    K5 launch, and the activation quantization for w4a8: no reduction."""
    from ctpa_torch.ops import quant

    m, d_in, d_out, group = shape
    w4, s = quant.quantize_int4(0.05 * torch.randn(d_in, d_out, generator=cuda, device="cuda"),
                                group)
    x = torch.randn(m, d_in, generator=cuda, device="cuda").to(torch.bfloat16)
    g = quant._int4_group(d_in, group)
    assert quant.int4_matmul_plan_on(x, d_out, g, act_quant)[0] == "wgmma"
    before = dict(quant.LAUNCHES)
    got = quant.int4_matmul(x, w4, s, group, act_quant=act_quant)
    torch.cuda.synchronize()
    launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
    assert launched == dict(dict.fromkeys(quant.LAUNCHES, 0), **quant.int4_matmul_launches(
        m, act_quant))
    _int8_close(got, quant.int4_matmul_plain(x, w4, s, group, act_quant=act_quant), act_quant)


@pytest.mark.parametrize("act_quant", [False, True])
def test_int4_matmul_prefill_kernel_is_deterministic(cuda, act_quant):
    """K5's prefill kernel at the fused qkv_proj and 2,048 rows, called twice,
    gives the same bits (each output tile is one block's), and so does its
    split form at 33 rows of o_proj (a cluster adds the splits in order)."""
    from ctpa_torch.ops import quant

    for m, d_out in ((2048, 12288), (33, 4096)):
        w4, s = quant.quantize_int4(0.05 * torch.randn(4096, d_out, generator=cuda,
                                                       device="cuda"))
        x = torch.randn(m, 4096, generator=cuda, device="cuda").to(torch.bfloat16)
        first = quant.int4_matmul(x, w4, s, act_quant=act_quant)
        second = quant.int4_matmul(x, w4, s, act_quant=act_quant)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
    assert quant.int4_matmul_plan_on(x, 4096, 128, act_quant)[3] > 1


# the last, 513 columns (K4's ragged d_in), takes the element loads
@pytest.mark.parametrize("shape", [(1, 4096), (4, 4096), (32, 160), (2048, 4096), (3, 11008),
                                   (5, 513)])
def test_int4_act_quant_kernel_gives_quantize_act_int8_bits(cuda, shape):
    """The one-launch activation quantization of every int8-activation form
    equals quantize_act_int8 on the card bit for bit: x8 and the row
    scales."""
    from ctpa_torch.ops import quant

    x = (3 * torch.randn(*shape, generator=cuda, device="cuda")).to(torch.bfloat16)
    x[0, :7] = 0                                     # a row with zeros
    before = quant.LAUNCHES["int4_act_quant"]
    x8, sx = quant._quantize_act_kernel(x)
    torch.cuda.synchronize()
    assert quant.LAUNCHES["int4_act_quant"] == before + 1
    ref8, ref_s = quant.quantize_act_int8(x)
    assert torch.equal(x8, ref8)
    assert torch.equal(sx, ref_s.reshape(-1))


# (m, hidden, inter): decode and prefill rows; a padded last j-block (384),
# groups of 64 (hidden 192, inter 320) and 32 (hidden 160), a j-block
# narrower than 128 (inter 64)
INT4_FFN_SHAPES = [(4, 1024, 2048), (40, 256, 384), (5, 192, 320), (20, 160, 64),
                   (130, 512, 768)]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("shape", INT4_FFN_SHAPES)
def test_int4_ffn_kernel_matches_plain(cuda, shape, act_quant):
    """K7 against its plain version in bf16 (2e-2 abs + rel); the w4a8 form
    requantizes h per row per j-block in both, and a different fp32 summation
    order can flip one level of h's int8 grid, well inside the bound."""
    from ctpa_torch.ops import quant

    m, hidden, inter = shape
    ws = []
    for a, b in ((hidden, inter), (hidden, inter), (inter, hidden)):
        ws += list(quant.quantize_int4(0.05 * torch.randn(a, b, generator=cuda, device="cuda")))
    x = torch.randn(m, hidden, generator=cuda, device="cuda").to(torch.bfloat16)
    before = dict(quant.LAUNCHES)
    got = quant.int4_ffn(x, *ws, act_quant=act_quant)
    torch.cuda.synchronize()
    launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
    want = quant.int4_ffn_launches(m, hidden, inter, quant.GROUP, act_quant)
    assert launched == dict(dict.fromkeys(quant.LAUNCHES, 0), **want)
    ref = quant.int4_ffn_plain(x, *ws, act_quant=act_quant)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


# (m, hidden, inter) at K7's decode kernels: 1, 4, 5 and 32 rows at
# Meditron-7B's width (43 whole j-blocks of 256), and INT4_FFN_SHAPES' odd
# widths at decode rows: a padded last j-block (384), groups of 64 (hidden
# 192, inter 320), 32 (hidden 160) and a j-block narrower than 128 (inter
# 64), a hidden size not a multiple of 128 (192, 160), and groups 64 inside
# a j-block of 192 (inter 192: three down groups a j-block)
INT4_FFN_DECODE_SHAPES = [(1, 4096, 11008), (4, 4096, 11008), (5, 4096, 11008),
                          (32, 4096, 11008), (4, 256, 384), (5, 192, 320), (20, 160, 64),
                          (32, 1024, 2048), (17, 192, 192)]


def _int4_ffn_weights(gen, hidden, inter, scale=0.05):
    from ctpa_torch.ops import quant

    ws = []
    for a, b in ((hidden, inter), (hidden, inter), (inter, hidden)):
        ws += list(quant.quantize_int4(scale * torch.randn(a, b, generator=gen, device="cuda")))
    return ws


def _prefill_scale(hidden):
    """Weights of 0.02 at Meditron-7B's width (chip_smoke.py's), else 0.05:
    with 0.05 at hidden 4096 |p| reaches 200, and rounding h to bf16 after
    tensor-core sums, as any tensor-core kernel of this FFN does, moves
    outputs near 0 by more than bf16's 2e-2 + 2e-2 |p|."""
    return 0.02 if hidden >= 1024 else 0.05


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("shape", INT4_FFN_DECODE_SHAPES)
def test_int4_ffn_decode_kernel_matches_plain(cuda, shape, act_quant):
    """K7's decode kernels (two launches: gate/up, its splits added in order
    in each j-block's cluster, then down, its splits added in each strip's
    cluster; no reduction) against the plain version: w4 in bf16's bound,
    w4a8 in one bf16 ulp of |p| plus 1e-3 of max|p| (the group dots are
    exact; the splits change the fp32 order of the group sums, which can
    flip one level of h's int8 grid)."""
    from ctpa_torch.ops import quant

    m, hidden, inter = shape
    ws = _int4_ffn_weights(cuda, hidden, inter)
    x = torch.randn(m, hidden, generator=cuda, device="cuda").to(torch.bfloat16)
    kind, gu, gu_per, dn, dn_per = quant.int4_ffn_plan_on(x, inter, quant.GROUP, act_quant)
    g_h, g_i = quant._int4_group(hidden, quant.GROUP), quant._int4_group(inter, quant.GROUP)
    bj = quant.ffn_block_j(inter, g_i)
    n_j = -(-inter // bj)
    assert kind == "stream"
    assert (gu - 1) * gu_per < hidden // g_h <= gu * gu_per
    assert (dn - 1) * dn_per < n_j <= dn * dn_per
    before = dict(quant.LAUNCHES)
    got = quant.int4_ffn(x, *ws, act_quant=act_quant)
    torch.cuda.synchronize()
    launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
    name = "int4_ffn_a8" if act_quant else "int4_ffn"
    assert launched == dict(dict.fromkeys(quant.LAUNCHES, 0), **{name: 2},
                            int4_act_quant=int(act_quant))
    _int8_close(got, quant.int4_ffn_plain(x, *ws, act_quant=act_quant), act_quant)


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("m", [4, 32])
def test_int4_ffn_decode_kernel_is_deterministic(cuda, m, act_quant):
    """K7 at decode at Meditron-7B's width, called twice, gives the same
    bits: both kernels add their splits in order, with no float atomics."""
    from ctpa_torch.ops import quant

    ws = _int4_ffn_weights(cuda, 4096, 11008)
    x = torch.randn(m, 4096, generator=cuda, device="cuda").to(torch.bfloat16)
    plan = quant.int4_ffn_plan_on(x, 11008, quant.GROUP, act_quant)
    assert plan[1] > 1 and plan[3] > 1
    first = quant.int4_ffn(x, *ws, act_quant=act_quant)
    second = quant.int4_ffn(x, *ws, act_quant=act_quant)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# (m, hidden, inter) at K7's prefill kernels (m > 32): the first row count
# past the decode kernels, a token tile and a ragged 2,048 + 5 at
# Meditron-7B's width; a j-block of 64 (inter 64, hidden groups of 32), one
# of 192 (inter 192: the window's last 64 columns lie past it) and two
# j-blocks, the last padded (inter 384)
INT4_FFN_PREFILL_SHAPES = [(33, 4096, 11008), (70, 4096, 11008), (2053, 4096, 11008),
                           (70, 160, 64), (37, 128, 192), (70, 256, 384)]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("shape", INT4_FFN_PREFILL_SHAPES)
def test_int4_ffn_prefill_kernels_match_plain(cuda, shape, act_quant):
    """K7's prefill kernels (wgmma fed by TMA: gate/up, then down; two
    launches, no reduction) against the plain version: w4 in bf16's bound,
    w4a8 in one bf16 ulp of |p| plus 1e-3 of max|p|."""
    from ctpa_torch.ops import quant

    m, hidden, inter = shape
    ws = _int4_ffn_weights(cuda, hidden, inter, _prefill_scale(hidden))
    x = torch.randn(m, hidden, generator=cuda, device="cuda").to(torch.bfloat16)
    assert quant.int4_ffn_plan_on(x, inter, quant.GROUP, act_quant)[0] == "wgmma"
    before = dict(quant.LAUNCHES)
    got = quant.int4_ffn(x, *ws, act_quant=act_quant)
    torch.cuda.synchronize()
    launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
    name = "int4_ffn_a8_prefill" if act_quant else "int4_ffn_prefill"
    assert launched == dict(dict.fromkeys(quant.LAUNCHES, 0), **{name: 2},
                            int4_act_quant=int(act_quant))
    _int8_close(got, quant.int4_ffn_plain(x, *ws, act_quant=act_quant), act_quant)


def test_int4_kernels_refuse_what_they_do_not_take(cuda):
    from ctpa_torch.ops import quant

    w4, s = quant.quantize_int4(torch.randn(40, 64, device="cuda"))      # group 40
    with pytest.raises(ValueError):
        quant.int4_matmul(torch.randn(2, 40, device="cuda").to(torch.bfloat16), w4, s)
    w4, s = quant.quantize_int4(torch.randn(128, 64, device="cuda"))
    with pytest.raises(TypeError):
        quant.int4_matmul(torch.randn(2, 128, device="cuda"), w4, s)   # fp32 activations


@pytest.mark.parametrize("act_quant", [False, True])
def test_int4_report_generator_kernel_path_matches_plain_path(cuda, act_quant):
    """A small int4 report generator (fused qkv, the fused FFN, int8 KV cache,
    flash_decode) in bf16: one K5 launch per qkv and o projection and one
    for the lm_head, one K7 launch per layer, per prefill and per decode
    step; the kernel path teacher-forced on its tokens gives them back, and
    the same bundle with quant_impl="xla" agrees with it (every step's max
    |diff| within 5e-2 of its max |logit|, top-1 agreement >= 0.8).  The
    launches, w4a8's activation quantization included, are those
    ``chip_smoke.quant_kernel_launches`` gives: no reduction kernel."""
    import chip_smoke as cs
    from ctpa_torch.core.config import LLMConfig, ReportGenConfig
    from ctpa_torch.models.layers import set_compute_dtype
    from ctpa_torch.models.report_generator import CTReportGenerator
    from ctpa_torch.ops import quant

    base = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                     intermediate_size=768, max_seq_len=128)
    vit = CTViTConfig(dim=128, codebook_size=64, image_size=48, patch_size=8, temporal_size=16,
                      temporal_patch_size=4, spatial_depth=1, temporal_depth=1, dim_head=32,
                      heads=4)
    gen_cfg = ReportGenConfig(vision_dim=64)
    bf16 = torch.bfloat16
    float_model = random_init_(CTReportGenerator(base, vit, gen_cfg, device="cuda", dtype=bf16),
                               cuda)
    state = quant.quantize_tree(float_model.state_dict(), bits=4, ffn_kernel=True)
    cfg = dataclasses.replace(base, weight_quant="int4", quant_ffn_kernel=True,
                              quant_act=act_quant, kv_quant="int8", flash_decode=True)
    model = CTReportGenerator(cfg, vit, gen_cfg, device="meta", dtype=bf16)
    model.load_state_dict(state, assign=True)
    model = set_compute_dtype(model, bf16).eval()
    video = (torch.rand(2, 1, 16, 48, 48, generator=cuda, device="cuda") * 2 - 1).to(bf16)
    ids = torch.randint(1, 512, (2, 9), generator=cuda, device="cuda")
    mask = torch.ones_like(ids)
    mask[1, 6:] = 0
    inputs = (video, ids * mask, mask)
    k5, k7 = ("int4_matmul_a8", "int4_ffn_a8") if act_quant else ("int4_matmul", "int4_ffn")
    prefill, step = cs.quant_kernel_launches(cfg, 18, 2), cs.quant_kernel_launches(cfg, 2, 2)
    assert prefill[k5] == step[k5] == 2 * base.num_layers + 1
    # 18 prompt rows and 2 decode rows: K7's two decode launches a layer
    assert prefill[k7] == step[k7] == 2 * base.num_layers
    before = dict(quant.LAUNCHES)
    with torch.inference_mode():
        tokens = model.generate(*inputs, 8, -1, greedy=True).tokens
        launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
        assert launched == {k: prefill.get(k, 0) + 7 * step.get(k, 0) for k in quant.LAUNCHES}
        # one activation quantization per K5 and per K7 call with w4a8
        assert launched["int4_act_quant"] == (
            launched[k5] + launched[k7] // 2 if act_quant else 0)
        kernel = cs.teacher_forced_logits(model, *inputs, tokens)
        plain = cs.teacher_forced_logits(cs.twin(model, quant_impl="xla"), *inputs, tokens)
    assert torch.equal(kernel.argmax(-1), tokens)
    rel, _, top1 = cs.logit_distance(kernel, plain)
    assert rel <= 5e-2 and top1 >= 0.8, (rel, top1)


# (m, in, out): decode and prefill row counts, ragged rows, columns and
# contraction (k not a multiple of 16 or of 8), a split contraction, the
# down projection's 11008
INT8_MATMUL_SHAPES = [(4, 4096, 4096), (32, 512, 1000), (5, 256, 200), (70, 200, 136),
                      (17, 513, 33), (300, 1024, 768), (3, 11008, 256), (2, 72, 40)]
A8_ATOL, A8_RTOL = 1e-3, 2.0 ** -7


def _int8_close(got, ref, act_quant):
    """bf16's bound for w8; with int8 activations one bf16 ulp of |p| plus
    1e-3 of max|p| (chip_smoke.py's QUANT_A8_* bound)."""
    if act_quant:
        torch.testing.assert_close(got.float(), ref.float(),
                                   atol=A8_ATOL * ref.float().abs().max().item(), rtol=A8_RTOL)
    else:
        tol = TOL[torch.bfloat16]
        torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("shape", INT8_MATMUL_SHAPES)
def test_int8_matmul_kernel_matches_plain(cuda, shape, act_quant):
    """K4 against its plain version in bf16: both sum the same exact products
    in fp32 and scale the columns after (w8), or take the same exact int32
    sums times the same scales (w8a8), and round to bf16."""
    from ctpa_torch.ops import quant

    m, d_in, d_out = shape
    w8, s = quant.quantize_int8(0.05 * torch.randn(d_in, d_out, generator=cuda, device="cuda"))
    x = torch.randn(m, d_in, generator=cuda, device="cuda").to(torch.bfloat16)
    before = dict(quant.LAUNCHES)
    got = quant.int8_matmul(x, w8, s, act_quant=act_quant)
    torch.cuda.synchronize()
    launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
    want = quant.int8_matmul_launches(m, act_quant)
    assert launched == dict(dict.fromkeys(quant.LAUNCHES, 0), **want)
    _int8_close(got, quant.int8_matmul_plain(x, w8, s, act_quant=act_quant), act_quant)


# (m, in, out) around K4's decode kernel: 1, 4, 17 and 32 rows take it, 33
# the prefill kernel; Meditron-7B's qkv_proj (12288), o_proj and lm_head
# (32000) and the unfused FFN's down projection (11008 -> 4096); a ragged
# contraction (513: x's element loads, a last ring stage of 1 row), ragged
# widths (1000: byte copies of the weights; 33), a short contraction (72)
INT8_DECODE_SHAPES = [(1, 4096, 4096), (4, 4096, 12288), (4, 4096, 32000), (17, 513, 1000),
                      (32, 4096, 12288), (32, 11008, 4096), (33, 4096, 4096), (5, 513, 33),
                      (4, 72, 40), (32, 4096, 1000)]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("shape", INT8_DECODE_SHAPES)
def test_int8_matmul_decode_kernel_matches_plain(cuda, shape, act_quant):
    """K4 around the decode/prefill threshold against its plain version: w8
    in bf16's bound; w8a8 bit for bit at decode (exact int32 sums, scaled in
    the plain version's order), in the int8 bound above.  One launch (and
    the activation quantization for w8a8); the decode kernel adds its
    splits in its clusters."""
    from ctpa_torch.ops import quant

    m, d_in, d_out = shape
    w8, s = quant.quantize_int8(0.05 * torch.randn(d_in, d_out, generator=cuda, device="cuda"))
    x = torch.randn(m, d_in, generator=cuda, device="cuda").to(torch.bfloat16)
    kernel, *_, splits, per = quant.int8_matmul_plan_on(x, d_out, act_quant)
    assert kernel == ("stream" if m <= 32 else "wgmma")
    if kernel == "stream":
        stages = -(-d_in // quant.INT8_STREAM_KC)
        assert (splits - 1) * per < stages <= splits * per
    before = dict(quant.LAUNCHES)
    got = quant.int8_matmul(x, w8, s, act_quant=act_quant)
    torch.cuda.synchronize()
    launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
    want = quant.int8_matmul_launches(m, act_quant)
    assert launched == dict(dict.fromkeys(quant.LAUNCHES, 0), **want)
    ref = quant.int8_matmul_plain(x, w8, s, act_quant=act_quant)
    if act_quant:
        assert torch.equal(got, ref)
    _int8_close(got, ref, act_quant)


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("m", [4, 32])
def test_int8_matmul_decode_kernel_is_deterministic(cuda, m, act_quant):
    """K4's decode kernel at o_proj's width (32 strips, the most splits),
    called twice, gives the same bits: each strip's cluster adds its splits
    in order."""
    from ctpa_torch.ops import quant

    w8, s = quant.quantize_int8(0.05 * torch.randn(4096, 4096, generator=cuda, device="cuda"))
    x = torch.randn(m, 4096, generator=cuda, device="cuda").to(torch.bfloat16)
    assert quant.int8_matmul_plan_on(x, 4096, act_quant)[1] > 1
    first = quant.int8_matmul(x, w8, s, act_quant=act_quant)
    second = quant.int8_matmul(x, w8, s, act_quant=act_quant)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# (m, in, out) of K4's prefill kernel: 33, 70 and 2,053 rows at Meditron-7B's
# qkv_proj and o_proj and the unfused FFN's gateup and down shapes; small
# ragged widths: k 100 and 513 (x's rows copied by the producer for both
# forms), n % 16 != 0 (the weight rows copied), n odd, one and two strips
INT8_PREFILL_SHAPES = [(33, 4096, 12288), (70, 4096, 4096), (2053, 4096, 12288),
                       (33, 4096, 4096), (300, 4096, 22016), (70, 11008, 4096), (70, 100, 300),
                       (130, 513, 1000), (40, 256, 45), (2053, 384, 520)]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("shape", INT8_PREFILL_SHAPES)
def test_int8_matmul_prefill_kernel_matches_plain(cuda, shape, act_quant):
    """K4's prefill kernel (``prefill_wgmma.cuh``) against its plain version:
    w8 in bf16's bound, w8a8 bit for bit (one exact int32 dot over the whole
    contraction, split or not, scaled in the plain version's order).
    Exactly one K4 launch, and the activation quantization for w8a8: no
    reduction."""
    from ctpa_torch.ops import quant

    m, d_in, d_out = shape
    w8, s = quant.quantize_int8(0.05 * torch.randn(d_in, d_out, generator=cuda, device="cuda"))
    x = torch.randn(m, d_in, generator=cuda, device="cuda").to(torch.bfloat16)
    assert quant.int8_matmul_plan_on(x, d_out, act_quant)[0] == "wgmma"
    before = dict(quant.LAUNCHES)
    got = quant.int8_matmul(x, w8, s, act_quant=act_quant)
    torch.cuda.synchronize()
    launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
    assert launched == dict(dict.fromkeys(quant.LAUNCHES, 0), **quant.int8_matmul_launches(
        m, act_quant))
    ref = quant.int8_matmul_plain(x, w8, s, act_quant=act_quant)
    if act_quant:
        assert torch.equal(got, ref)
    _int8_close(got, ref, act_quant)


@pytest.mark.parametrize("act_quant", [False, True])
def test_int8_matmul_prefill_kernel_is_deterministic(cuda, act_quant):
    """K4's prefill kernel at the fused qkv_proj and 2,048 rows, called twice,
    gives the same bits, and so does its split form at 33 rows of o_proj."""
    from ctpa_torch.ops import quant

    for m, d_out in ((2048, 12288), (33, 4096)):
        w8, s = quant.quantize_int8(0.05 * torch.randn(4096, d_out, generator=cuda,
                                                       device="cuda"))
        x = torch.randn(m, 4096, generator=cuda, device="cuda").to(torch.bfloat16)
        first = quant.int8_matmul(x, w8, s, act_quant=act_quant)
        second = quant.int8_matmul(x, w8, s, act_quant=act_quant)
        torch.cuda.synchronize()
        assert torch.equal(first, second)
    assert quant.int8_matmul_plan_on(x, 4096, act_quant)[3] > 1


# (m, hidden, inter): decode and prefill rows; a padded last j-block (384,
# 300), a j-block narrower than 128 (inter 64), inter not a multiple of 16
INT8_FFN_SHAPES = [(4, 1024, 2048), (40, 256, 384), (5, 192, 300), (20, 64, 64),
                   (130, 512, 768)]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("shape", INT8_FFN_SHAPES)
def test_int8_ffn_kernel_matches_plain(cuda, shape, act_quant):
    """K6 against its plain version; the w8a8 form requantizes h per row per
    256-column j-block in both, and a different fp32 summation order can
    flip one level of h's int8 grid, inside the bound."""
    from ctpa_torch.ops import quant

    m, hidden, inter = shape
    ws = []
    for a, b in ((hidden, inter), (hidden, inter), (inter, hidden)):
        ws += list(quant.quantize_int8(0.05 * torch.randn(a, b, generator=cuda, device="cuda")))
    x = torch.randn(m, hidden, generator=cuda, device="cuda").to(torch.bfloat16)
    before = dict(quant.LAUNCHES)
    got = quant.int8_ffn(x, *ws, act_quant=act_quant)
    torch.cuda.synchronize()
    launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
    want = quant.int8_ffn_launches(m, hidden, inter, act_quant)
    assert launched == dict(dict.fromkeys(quant.LAUNCHES, 0), **want)
    _int8_close(got, quant.int8_ffn_plain(x, *ws, act_quant=act_quant), act_quant)


# (m, hidden, inter) at K6's decode kernels: 1, 4, 5 and 32 rows at
# Meditron-7B's width (43 whole j-blocks) and at ragged ones: hidden 80
# (a last ring stage of 16 rows), inter 300 (not a multiple of 16: byte
# copies, a padded j-block), 1000, and a single narrow j-block (inter 64)
INT8_FFN_DECODE_SHAPES = [(1, 4096, 11008), (4, 4096, 11008), (5, 4096, 11008),
                          (32, 4096, 11008), (4, 80, 520), (5, 192, 300), (32, 96, 1000),
                          (17, 64, 64)]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("shape", INT8_FFN_DECODE_SHAPES)
def test_int8_ffn_decode_kernel_matches_plain(cuda, shape, act_quant):
    """K6's decode kernels (two launches: gate/up with split partials added
    in order by the last block of each j-block, then down) against the plain
    version, in K6's bounds; the plan fills the card with whole splits."""
    from ctpa_torch.ops import quant

    m, hidden, inter = shape
    ws = []
    for a, b in ((hidden, inter), (hidden, inter), (inter, hidden)):
        ws += list(quant.quantize_int8(0.05 * torch.randn(a, b, generator=cuda, device="cuda")))
    x = torch.randn(m, hidden, generator=cuda, device="cuda").to(torch.bfloat16)
    kind, gu, gu_per, dn, dn_per = quant.int8_ffn_plan_on(x, inter, act_quant)
    stages, n_j = -(-hidden // quant.FFN_STREAM_KC), -(-inter // quant.INT8_BLOCK_J)
    assert kind == "stream"
    assert (gu - 1) * gu_per < stages <= gu * gu_per and (dn - 1) * dn_per < n_j <= dn * dn_per
    before = dict(quant.LAUNCHES)
    got = quant.int8_ffn(x, *ws, act_quant=act_quant)
    torch.cuda.synchronize()
    launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
    name = "int8_ffn_a8" if act_quant else "int8_ffn"
    assert launched == dict(dict.fromkeys(quant.LAUNCHES, 0), **{name: 2},
                            int4_act_quant=int(act_quant))
    _int8_close(got, quant.int8_ffn_plain(x, *ws, act_quant=act_quant), act_quant)


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("m", [4, 32])
def test_int8_ffn_decode_kernel_is_deterministic(cuda, m, act_quant):
    """K6 at decode at Meditron-7B's width, called twice, gives the same
    bits: both kernels add their splits in order, with no float atomics."""
    from ctpa_torch.ops import quant

    ws = []
    for a, b in ((4096, 11008), (4096, 11008), (11008, 4096)):
        ws += list(quant.quantize_int8(0.05 * torch.randn(a, b, generator=cuda, device="cuda")))
    x = torch.randn(m, 4096, generator=cuda, device="cuda").to(torch.bfloat16)
    plan = quant.int8_ffn_plan_on(x, 11008, act_quant)
    assert plan[1] > 1 and plan[3] > 1
    first = quant.int8_ffn(x, *ws, act_quant=act_quant)
    second = quant.int8_ffn(x, *ws, act_quant=act_quant)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# (m, hidden, inter) at K6's prefill kernels (m > 32): as K7's, and small
# widths: a last j-block 8 columns wide (inter 520, not a multiple of 16:
# the producer copies the gate/up rows TMA cannot read), hidden 48 (below
# one ring stage) with inter 300, two output strips (hidden 320)
INT8_FFN_PREFILL_SHAPES = [(33, 4096, 11008), (70, 4096, 11008), (2053, 4096, 11008),
                           (70, 128, 520), (40, 48, 300), (130, 320, 384)]


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("shape", INT8_FFN_PREFILL_SHAPES)
def test_int8_ffn_prefill_kernels_match_plain(cuda, shape, act_quant):
    """K6's prefill kernels (wgmma fed by TMA: gate/up, then down; two
    launches, no reduction) against the plain version, in K6's bounds."""
    from ctpa_torch.ops import quant

    m, hidden, inter = shape
    ws = []
    for a, b in ((hidden, inter), (hidden, inter), (inter, hidden)):
        ws += list(quant.quantize_int8(_prefill_scale(hidden) *
                                       torch.randn(a, b, generator=cuda, device="cuda")))
    x = torch.randn(m, hidden, generator=cuda, device="cuda").to(torch.bfloat16)
    assert quant.int8_ffn_plan_on(x, inter, act_quant)[0] == "wgmma"
    before = dict(quant.LAUNCHES)
    got = quant.int8_ffn(x, *ws, act_quant=act_quant)
    torch.cuda.synchronize()
    launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
    name = "int8_ffn_a8_prefill" if act_quant else "int8_ffn_prefill"
    assert launched == dict(dict.fromkeys(quant.LAUNCHES, 0), **{name: 2},
                            int4_act_quant=int(act_quant))
    _int8_close(got, quant.int8_ffn_plain(x, *ws, act_quant=act_quant), act_quant)


@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_ffn_prefill_kernels_are_deterministic(cuda, bits, act_quant):
    """K6 and K7 at prefill (2,048 rows at Meditron-7B's width), called
    twice, give the same bits: each output tile is one block's, with no
    split of the contraction and no atomics."""
    from ctpa_torch.ops import quant

    q = quant.quantize_int4 if bits == 4 else quant.quantize_int8
    ws = []
    for a, b in ((4096, 11008), (4096, 11008), (11008, 4096)):
        ws += list(q(0.05 * torch.randn(a, b, generator=cuda, device="cuda")))
    x = torch.randn(2048, 4096, generator=cuda, device="cuda").to(torch.bfloat16)
    ffn = quant.int4_ffn if bits == 4 else quant.int8_ffn
    first = ffn(x, *ws, act_quant=act_quant)
    second = ffn(x, *ws, act_quant=act_quant)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_int8_kernels_refuse_what_they_do_not_take(cuda):
    from ctpa_torch.ops import quant

    w8, s = quant.quantize_int8(torch.randn(128, 64, device="cuda"))
    with pytest.raises(TypeError):
        quant.int8_matmul(torch.randn(2, 128, device="cuda"), w8, s)   # fp32 activations
    ws = []
    for a, b in ((40, 64), (40, 64), (64, 40)):
        ws += list(quant.quantize_int8(torch.randn(a, b, device="cuda")))
    with pytest.raises(ValueError):                                    # hidden 40
        quant.int8_ffn(torch.randn(2, 40, device="cuda").to(torch.bfloat16), *ws)


@pytest.mark.parametrize("act_quant", [False, True])
def test_int8_report_generator_kernel_path_matches_plain_path(cuda, act_quant):
    """A small int8 report generator (fused qkv, the fused FFN, int8 KV cache,
    flash_decode) in bf16: the launches of K4 and K6 per prefill and per
    decode step are those ``chip_smoke.quant_kernel_launches`` gives (no
    reduction kernel); the kernel path teacher-forced on its tokens gives them back,
    and the same bundle with quant_impl="xla" agrees with it (every step's
    max |diff| within 5e-2 of its max |logit|, top-1 agreement >= 0.8)."""
    import chip_smoke as cs
    from ctpa_torch.core.config import LLMConfig, ReportGenConfig
    from ctpa_torch.models.layers import set_compute_dtype
    from ctpa_torch.models.report_generator import CTReportGenerator
    from ctpa_torch.ops import quant

    base = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
                     intermediate_size=688, max_seq_len=128)
    vit = CTViTConfig(dim=128, codebook_size=64, image_size=48, patch_size=8, temporal_size=16,
                      temporal_patch_size=4, spatial_depth=1, temporal_depth=1, dim_head=32,
                      heads=4)
    gen_cfg = ReportGenConfig(vision_dim=64)
    bf16 = torch.bfloat16
    float_model = random_init_(CTReportGenerator(base, vit, gen_cfg, device="cuda", dtype=bf16),
                               cuda)
    state = quant.quantize_tree(float_model.state_dict(), bits=8, ffn_kernel=True)
    cfg = dataclasses.replace(base, weight_quant="int8", quant_ffn_kernel=True,
                              quant_act=act_quant, kv_quant="int8", flash_decode=True)
    model = CTReportGenerator(cfg, vit, gen_cfg, device="meta", dtype=bf16)
    model.load_state_dict(state, assign=True)
    model = set_compute_dtype(model, bf16).eval()
    video = (torch.rand(2, 1, 16, 48, 48, generator=cuda, device="cuda") * 2 - 1).to(bf16)
    ids = torch.randint(1, 512, (2, 9), generator=cuda, device="cuda")
    mask = torch.ones_like(ids)
    mask[1, 6:] = 0
    inputs = (video, ids * mask, mask)
    mm, ffn = cs.quant_kernel_names(cfg)
    prefill, step = cs.quant_kernel_launches(cfg, 18, 2), cs.quant_kernel_launches(cfg, 2, 2)
    assert prefill[mm] == step[mm] == 2 * base.num_layers + 1
    # 18 prompt rows and 2 decode rows: K6's two decode launches a layer
    assert prefill[ffn] == step[ffn] == 2 * base.num_layers
    before = dict(quant.LAUNCHES)
    with torch.inference_mode():
        tokens = model.generate(*inputs, 8, -1, greedy=True).tokens
        launched = {k: quant.LAUNCHES[k] - before[k] for k in quant.LAUNCHES}
        assert launched == {k: prefill.get(k, 0) + 7 * step.get(k, 0) for k in quant.LAUNCHES}
        # one activation quantization per K4 and per K6 call with w8a8
        assert launched["int4_act_quant"] == (
            launched[mm] + launched[ffn] // 2 if act_quant else 0)
        kernel = cs.teacher_forced_logits(model, *inputs, tokens)
        plain = cs.teacher_forced_logits(cs.twin(model, quant_impl="xla"), *inputs, tokens)
    assert torch.equal(kernel.argmax(-1), tokens)
    rel, _, top1 = cs.logit_distance(kernel, plain)
    assert rel <= 5e-2 and top1 >= 0.8, (rel, top1)


def test_zeroshot_from_files_kernel_path_matches_plain_path(cuda, tmp_path):
    """build_ctclip on a reference-layout .pt (chip_smoke.reference_ctclip_state at small
    widths the kernels take) in bf16 with the patchify and flash kernels, and
    run_zeroshot over npz files: one K1 launch a volume, spatial_depth K2
    launches a batch, and probabilities within chip_smoke's PROB_ATOL of the
    same weights on the plain path."""
    import numpy as np

    import chip_smoke as cs
    from ctpa_torch.cli.zeroshot_infer import run_zeroshot
    from ctpa_torch.core.config import BertConfig, CTCLIPConfig
    from ctpa_torch.data.datasets import CTReportInferenceDataset
    from ctpa_torch.data.manifests import write_csv
    from ctpa_torch.data.tokenizer import SimpleWordTokenizer
    from ctpa_torch.eval.zeroshot import PATHOLOGIES
    from ctpa_torch.models.ctclip import CTCLIP
    from ctpa_torch.models.pretrained import build_ctclip

    vit = CTViTConfig(dim=128, codebook_size=64, image_size=48, patch_size=8, temporal_size=16,
                      temporal_patch_size=4, spatial_depth=2, temporal_depth=1, dim_head=32,
                      heads=4, pallas_patchify=True, flash_axial=True, peg_reference_layout=True)
    bert = BertConfig.tiny()
    clip = CTCLIPConfig.tiny(vit, bert)
    sd = cs.reference_ctclip_state(vit, bert, clip, cuda, "cuda", std=0.05)
    torch.save({k: v.cpu() for k, v in sd.items()}, str(tmp_path / "CT-CLIP_v2.pt"))
    rng = np.random.default_rng(0)
    names = [f"v{i}" for i in range(5)]
    for name in names:
        np.savez(tmp_path / f"{name}.npz", rng.uniform(-1.1, 0.3, (50, 44, 20)).astype(np.float32))
    write_csv(str(tmp_path / "reports.csv"), [{"impression_id": n, "impressions": n} for n in names])
    write_csv(str(tmp_path / "labels.csv"),
              [{"VolumeName": n, **{p: (i + j) % 2 for j, p in enumerate(PATHOLOGIES)}}
               for i, n in enumerate(names)])
    dataset = CTReportInferenceDataset(str(tmp_path), str(tmp_path / "reports.csv"),
                                       str(tmp_path / "labels.csv"), PATHOLOGIES)
    pre_cfg = dataclasses.replace(PreprocessConfig.inference(), target_shape=(16, 48, 48))
    tok = SimpleWordTokenizer(bert.vocab_size, 64)
    pre = build_ctclip(str(tmp_path / "CT-CLIP_v2.pt"), vit_cfg=vit, bert_cfg=bert,
                       clip_cfg=clip, dtype=torch.bfloat16)
    assert pre.skipped == []
    plain = CTCLIP(clip, dataclasses.replace(vit, pallas_patchify=False, flash_axial=False),
                   bert, device="cuda", dtype=torch.bfloat16)
    plain.load_state_dict(pre.model.state_dict())
    k1, k2 = patchify_project.launches, LAUNCHES["flash_attention_fwd"]
    got = run_zeroshot(pre.model, pre.vq_state, dataset, tok, str(tmp_path / "k"),
                       pre_cfg=pre_cfg, batch_size=2)
    assert patchify_project.launches - k1 == len(names)
    assert LAUNCHES["flash_attention_fwd"] - k2 == vit.spatial_depth * 3
    ref = run_zeroshot(plain, pre.vq_state, dataset, tok, str(tmp_path / "p"),
                       pre_cfg=pre_cfg, batch_size=2)
    assert got["n"] == ref["n"] == len(names) and np.isfinite(got["mean_auc"])
    pk = np.load(tmp_path / "k" / "predicted_weights.npz")["data"]
    pp = np.load(tmp_path / "p" / "predicted_weights.npz")["data"]
    assert pk.shape == (len(names), len(PATHOLOGIES))
    assert np.abs(pk - pp).max() <= cs.PROB_ATOL


@pytest.mark.parametrize("source", ["bundle-w8a8", "quant-int4", "quant-int4-a8"])
def test_generate_report_kernel_path_matches_plain_path(cuda, tmp_path, monkeypatch, source):
    """generate_report.main on a small report generator the kernels take (the
    CLI's configurations replaced by it): from a w8a8 bundle (fused FFN,
    int8 KV cache, flash_decode), where K4, K6 and K8 launch, or from the
    checkpoint directory with --quant int4, weight-only or w4a8, where K5
    launches (--quant sets no fused FFN, as in ctpa, so K7 does not; the
    FFN width 768 gives K5 its 128-column scale groups); the
    CLI's greedy tokens, teacher-forced, come back from the kernel path, and
    the same model on the plain path (quant_impl "xla", flash_decode off)
    agrees with it (every step's max |diff| within 5e-2 of its max |logit|,
    top-1 agreement >= 0.8)."""
    import json

    import numpy as np

    import chip_smoke as cs
    from ctpa_torch.cli import export_serving, generate_report
    from ctpa_torch.core.checkpoint import CheckpointManager, load_base, save_base
    from ctpa_torch.core.config import LLMConfig, ReportGenConfig
    from ctpa_torch.data.datasets import ReportGenDataset
    from ctpa_torch.models.report_generator import CTReportGenerator
    from ctpa_torch.ops import decode_attention as da
    from ctpa_torch.ops import quant
    from ctpa_torch.ops.preprocess import preprocess_volume_inference

    llm = LLMConfig(vocab_size=512, hidden_size=256, num_layers=2, num_heads=2, num_kv_heads=2,
                    intermediate_size=768, max_seq_len=256)
    vit = CTViTConfig(dim=128, codebook_size=64, image_size=48, patch_size=8, temporal_size=16,
                      temporal_patch_size=4, spatial_depth=1, temporal_depth=1, dim_head=32,
                      heads=4)
    pre = dataclasses.replace(PreprocessConfig.inference(), target_shape=(16, 48, 48))
    monkeypatch.setattr(generate_report, "LLMConfig", lambda: llm)
    monkeypatch.setattr(generate_report, "CTViTConfig", lambda: vit)
    monkeypatch.setattr(generate_report.PreprocessConfig, "inference", staticmethod(lambda: pre))
    base = random_init_(CTReportGenerator(llm, vit, ReportGenConfig(), device="cuda",
                                          dtype=torch.bfloat16), cuda)
    ckpt = str(tmp_path / "ckpt")
    save_base(ckpt, base.state_dict())
    CheckpointManager(ckpt).save(1, {"params": {}, "step": 1})
    if source == "bundle-w8a8":
        bundle = str(tmp_path / "bundle")
        assert export_serving.main(["--checkpoint-dir", ckpt, "--out", bundle, "--ffn-kernel",
                                    "--act-quant", "--kv-quant", "int8", "--flash-decode",
                                    "--lora-rank", "0"]) == 0
        flags = ["--serving-bundle", bundle]
        need = ("int8_matmul_a8", "int8_matmul_a8_prefill", "int8_ffn_a8",
                "int8_ffn_a8_prefill", "decode_attention")
    else:
        a8 = source.endswith("-a8")
        flags = ["--checkpoint-dir", ckpt, "--quant", "int4", "--lora-rank", "0"]
        flags += ["--act-quant"] if a8 else []
        need = (("int4_matmul_a8", "int4_matmul_a8_prefill", "int4_act_quant") if a8
                else ("int4_matmul", "int4_matmul_prefill"))
    rng = np.random.default_rng(0)
    with open(tmp_path / "gen.jsonl", "w") as f:
        for i in range(3):
            np.savez(tmp_path / f"v{i}.npz", rng.uniform(-1, 1, (50, 44, 20)).astype(np.float32))
            f.write(json.dumps({"image_path": str(tmp_path / f"v{i}.npz"), "report": "x"}) + "\n")
    before = {**quant.LAUNCHES, **da.LAUNCHES}
    with cs.recording_decode() as decoded:
        assert generate_report.main(["--jsonl", str(tmp_path / "gen.jsonl"), *flags,
                                     "--greedy", "--max-new-tokens", "12",
                                     "--out-dir", str(tmp_path / "out")]) == 0
    launched = {k: v - before[k] for k, v in {**quant.LAUNCHES, **da.LAUNCHES}.items()}
    for key in need:
        assert launched[key] > 0, launched
    if source == "bundle-w8a8":
        model, _ = export_serving.load_serving_bundle(bundle, llm, vit, ReportGenConfig())
    else:
        cfg = dataclasses.replace(llm, weight_quant="int4", quant_act=a8)
        model = generate_report.quantized_model(load_base(ckpt, map_location="cuda"), cfg, vit,
                                                ReportGenConfig(), None)
    items = [ReportGenDataset(str(tmp_path / "gen.jsonl"))[i] for i in range(3)]
    video = torch.stack([preprocess_volume_inference(it["volume"], pre) for it in items])
    toks = cs.stable_word_tokenizer()(vocab_size=512)([it["prompt"] for it in items],
                                                      max_length=64)
    ids, mask = (torch.as_tensor(toks[k], device="cuda").long()
                 for k in ("input_ids", "attention_mask"))
    steps = min(len(t) for t in decoded)
    tokens = torch.tensor([t[:steps] for t in decoded], device="cuda")
    with torch.inference_mode():
        vision = model.extract_vision(video)
        kernel = cs.teacher_forced_logits(model, video, ids, mask, tokens, vision)
        plain = cs.teacher_forced_logits(cs.twin(model, quant_impl="xla", flash_decode=False),
                                         video, ids, mask, tokens, vision)
    assert (kernel.argmax(-1) == tokens).float().mean() >= 0.8
    rel, _, top1 = cs.logit_distance(kernel, plain)
    assert rel <= 5e-2 and top1 >= 0.8, (rel, top1)


def test_prefetch_stages_batches_on_a_side_stream(cuda):
    """PrefetchIterator on the card: host arrays arrive on the device from
    pinned memory, device work of the source runs on the side stream, and
    the consumer's stream waits for it (the batch reads back exactly)."""
    import numpy as np

    from ctpa_torch.data.prefetch import PrefetchIterator

    def source():
        for i in range(4):
            host = np.full((1024, 1024), i, np.float32)
            dev = torch.full((4096, 1024), float(i), device="cuda")
            for _ in range(8):          # queue some work on the producer's stream
                dev = dev * 1.0
            assert torch.cuda.current_stream() != torch.cuda.default_stream()
            yield {"host": host, "dev": dev, "tag": i}

    got = list(PrefetchIterator(source(), device="cuda", depth=2))
    assert [b["tag"] for b in got] == [0, 1, 2, 3]
    for i, b in enumerate(got):
        assert b["host"].is_cuda and b["dev"].is_cuda
        assert bool((b["host"] == i).all()) and bool((b["dev"] == i).all())


# --------------------------- context parallelism: K2/K3 at one rank's form

# (label, (b, h, n, d), causal): the fused encoder's form (no bias, the
# cosine bound) and the LLM's causal forms; n = 300 splits into 150 or 75
# rows a rank, so the offsets fall inside key tiles
CP_FORMS = [("fused d32", (1, 4, 512, 32), False), ("causal d128", (2, 4, 300, 128), True),
            ("causal d64", (2, 3, 300, 64), True)]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("label, shape, causal", CP_FORMS)
def test_flash_cp_rank_forms_match_plain(cuda, label, shape, causal, p):
    """Each of p ranks' n/p query rows over all n keys (rectangular), causal
    at q_offset r n/p, through parallel/context.py:rank_attention: K2-lse
    and K3 by autograd against the plain versions; then the ranks' outputs
    concatenated and their dK/dV partials summed against the unsharded
    kernel call.  A rank at q_offset 0 and a partial left unsummed must
    miss."""
    from ctpa_torch.parallel.context import rank_attention, rank_offset

    b, h, n, d = shape
    nl, bf16 = n // p, torch.bfloat16
    q, k = (torch.randn(b, h, n, d, generator=cuda, device="cuda") for _ in "qk")
    if not causal:
        q, k = l2norm(q), l2norm(k)
    q, k = q.to(bf16), k.to(bf16)
    v, do = (torch.randn(b, h, n, d, generator=cuda, device="cuda").to(bf16) for _ in "vd")
    scale = 8.0 if not causal else d ** -0.5
    bound = None if causal else torch.tensor(8.0, device="cuda")
    tol = TOL[bf16]

    def rank(r, offset=True):
        rows = slice(r * nl, (r + 1) * nl)
        off = rank_offset(r, nl, "cuda") if causal and offset else None
        leaves = [q[:, :, rows].clone().requires_grad_(), k.clone().requires_grad_(),
                  v.clone().requires_grad_()]
        out, lse = rank_attention(*leaves, scale=scale, causal=causal, q_offset=off,
                                  logit_bound=bound, return_lse=True)
        out.backward(do[:, :, rows])
        masks = fa.make_masks(causal, None, off, b, n, "cuda")
        ref_out, ref_lse = flash_attention_plain(q[:, :, rows], k, v, None, scale, bound,
                                                 return_lse=True, masks=masks)
        ref = flash_attention_bwd_plain(q[:, :, rows], k, v, None, ref_out, ref_lse,
                                        do[:, :, rows], scale, masks)
        return (out.detach(), lse, *(t.grad for t in leaves)), (ref_out, ref_lse, *ref[:3])

    before = dict(LAUNCHES)
    runs = [rank(r) for r in range(p)]
    torch.cuda.synchronize()
    suffix = "_d128" if d == 128 else ""
    assert LAUNCHES["flash_attention_fwd_lse" + suffix] - before["flash_attention_fwd_lse"
                                                                 + suffix] == p
    for r, (got, ref) in enumerate(runs):
        for name, g, e in zip(("out", "lse", "dq", "dk", "dv"), got, ref):
            atol = 1e-4 if name == "lse" else tol
            torch.testing.assert_close(g.float(), e.float(), atol=atol, rtol=atol,
                                       msg=f"{label} p {p} rank {r} {name}")
    full = _unsharded(q, k, v, do, scale, bound, causal)
    out = torch.cat([g[0] for g, _ in runs], 2)
    dk, dv = sum(g[3] for g, _ in runs), sum(g[4] for g, _ in runs)
    for name, g, e in (("out", out, full[0]), ("dk", dk, full[3]), ("dv", dv, full[4])):
        torch.testing.assert_close(g.float(), e.float(), atol=tol, rtol=tol, msg=name)
    if causal:
        fault, _ = rank(p - 1, offset=False)
        assert not torch.allclose(fault[0].float(), runs[-1][1][0].float(), atol=tol, rtol=tol)
    assert not torch.allclose(runs[0][0][3].float(), full[3].float(), atol=tol, rtol=tol)


def _unsharded(q, k, v, do, scale, bound, causal):
    masks = fa.make_masks(causal, None, None, q.shape[0], k.shape[2], "cuda")
    out, lse = fa._forward(q, k, v, None, scale, bound, True, masks)
    dq, dk, dv, _ = flash_attention_bwd(q, k, v, None, out, lse, do, scale, masks=masks)
    return out, lse, dq, dk, dv
