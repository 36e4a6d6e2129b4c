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
"""

import dataclasses

import pytest
import torch

from ctpa_torch.core.config import CTViTConfig
from ctpa_torch.core.init import random_init_
from ctpa_torch.core.precision import Policy
from ctpa_torch.models.ctvit import CTViT
from ctpa_torch.ops.attention_ops import l2norm
from ctpa_torch.ops.flash_attention import (
    LAUNCHES,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_plain,
)
from ctpa_torch.ops.patchify import patchify_project, patchify_project_plain

pytestmark = pytest.mark.gpu
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("shape", [(240, 480, 480, 10, 20, 512), (16, 48, 40, 4, 8, 128),
                                   (12, 36, 48, 4, 12, 256)])
def test_patchify_kernel_matches_plain(cuda, shape):
    T, H, W, pt, p, dim = shape          # the last two: odd h, a ragged feature chunk
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


def test_patchify_kernel_refuses_fp32(cuda):
    vol = torch.zeros(16, 48, 48, device="cuda")
    with pytest.raises(TypeError):
        patchify_project(vol, torch.ones(256, device="cuda"), torch.zeros(256, 128, device="cuda"),
                         4, 8, 8, out_dtype=torch.float32)


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
    assert launched == {"flash_attention_fwd": 0, "flash_attention_fwd_lse": 1,
                        "flash_attention_bwd_delta": 1, "flash_attention_bwd_dq": 1,
                        "flash_attention_bwd_dkv": 1,
                        "flash_attention_bwd_dbias": int(bias is not None)}
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


def is_spatial_fold_param(name: str) -> bool:
    """The attention projections and scales of the spatial fold and the CPB
    MLP, whose gradients pass through the flash kernels.  The CPB's
    ``to_heads.bias`` is left out: it shifts every logit of a head alike, so
    softmax ignores it and its gradient is zero up to rounding noise."""
    attn = "enc_spatial_transformer" in name and any(
        key in name for key in ("attn.to_q", "attn.to_kv", "attn.q_scale", "attn.k_scale"))
    return attn or ("spatial_rel_pos_bias" in name and not name.endswith("to_heads.bias"))


def test_ctvit_training_gradients_kernel_path_vs_plain_path(cuda):
    """fp32 parameters, bf16 autocast, remat on: the spatial fold's gradients
    through K2-with-lse and K3 point the same way as through the plain
    attention (bf16 rounds at other places on the two paths)."""
    cfg = CTViTConfig(dim=128, codebook_size=64, image_size=48, patch_size=8,
                      temporal_size=16, temporal_patch_size=4, spatial_depth=2,
                      temporal_depth=1, dim_head=32, heads=4)
    plain = random_init_(CTViT(cfg, device="cuda", remat=True), cuda)
    fast = CTViT(dataclasses.replace(cfg, flash_axial=True), device="cuda", remat=True)
    fast.load_state_dict(plain.state_dict())
    video = torch.rand(2, 1, cfg.temporal_size, cfg.image_size, cfg.image_size,
                       generator=cuda, device="cuda") * 2 - 1
    # a fixed random projection of the tokens (their mean square after the
    # final LayerNorm would be constant, with no gradient to compare)
    target = torch.randn(2, cfg.temporal_tokens, 6, 6, cfg.dim, generator=cuda, device="cuda")
    grads = []
    before = dict(LAUNCHES)
    for model in (fast, plain):
        with Policy().autocast("cuda"):
            tokens, _ = model(video.to(torch.bfloat16))
        (tokens.float() * target).sum().backward()
        grads.append({n: p.grad.float() for n, p in model.named_parameters()
                      if is_spatial_fold_param(n)})
    assert LAUNCHES["flash_attention_fwd_lse"] - before["flash_attention_fwd_lse"] == 2 * 2
    assert LAUNCHES["flash_attention_bwd_dkv"] - before["flash_attention_bwd_dkv"] == 2
    for name, g in grads[0].items():
        cos = torch.nn.functional.cosine_similarity(g.flatten(), grads[1][name].flatten(), dim=0)
        assert cos >= 0.99, (name, cos.item())
