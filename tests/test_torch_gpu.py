"""Hand-written CUDA kernels against their plain PyTorch versions on the
card.  Marked ``gpu``: each test decides in the ``cuda`` fixture whether a
card is present and skips otherwise (a CUDA kernel has no CPU mode).  Run on
the card with
    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
(``--noconftest``: the repository's tests/conftest.py sets up JAX, which
the card's machine does not have)

Tolerances: kernel and plain version sum the same rounded products in fp32
in another order; in bf16 the result is rounded once more (2e-2 abs + rel),
in fp32 they agree to 1e-4.
"""

import dataclasses

import pytest
import torch

from ctpa_torch.core.config import CTViTConfig
from ctpa_torch.core.init import random_init_
from ctpa_torch.models.ctvit import CTViT
from ctpa_torch.ops.attention_ops import l2norm
from ctpa_torch.ops.flash_attention import flash_attention, flash_attention_plain
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
    k1, k2 = patchify_project.launches, flash_attention.launches
    with torch.no_grad():
        got, _ = fast(video)
        ref, _ = plain(video)
    assert (patchify_project.launches - k1, flash_attention.launches - k2) == (2, cfg.spatial_depth)
    torch.testing.assert_close(got.float(), ref.float(), atol=5e-2, rtol=5e-2)
