"""Fused patchify + LayerNorm + projection (kernel K1).

Replaces the TPU kernel ``ctpa/ops/pallas/patchify.py:patchify_project``.
The CUDA kernel is ``ctpa_torch/csrc/patchify.cu`` (its header states the
bound it faces on the H100 and what its design does about it).
``patchify_project`` launches it for CUDA tensors and takes the plain
PyTorch version, ``patchify_project_plain``, only for CPU tensors.

The kernel is forward-only, as ctpa's is (a Pallas call has no VJP): under
grad mode with an input that requires grad, ``patchify_project`` raises on
every device, instead of returning an output that silently carries no
gradient.  Training keeps ``pallas_patchify`` off.
"""

from __future__ import annotations

import torch

from ctpa_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)


def _check(volume, g, kernel, pt, p1, p2, out_dtype):
    if volume.ndim != 3:
        raise ValueError(f"volume must be (T, H, W), got {tuple(volume.shape)}")
    T, H, W = volume.shape
    if T % pt or H % p1 or W % p2:
        raise ValueError(f"volume {tuple(volume.shape)} is not a whole number of "
                         f"({pt}, {p1}, {p2}) patches")
    pd = pt * p1 * p2
    if g.shape != (pd,) or kernel.ndim != 2 or kernel.shape[0] != pd:
        raise ValueError(f"g {tuple(g.shape)} / kernel {tuple(kernel.shape)} do not "
                         f"match patch_dim {pd}")
    if out_dtype not in _DTYPES or volume.dtype != out_dtype:
        raise TypeError(f"volume dtype {volume.dtype} must be the compute dtype "
                        f"{out_dtype}, one of {_DTYPES}")
    if not volume.is_contiguous():
        raise ValueError("volume must be contiguous")
    if len({volume.device, g.device, kernel.device}) != 1:
        raise ValueError("volume, g and kernel must be on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (volume, g, kernel)):
        raise RuntimeError("patchify_project is forward-only (no backward, as ctpa's kernel has "
                           "no VJP): call it under torch.no_grad() or torch.inference_mode(), "
                           "or train with pallas_patchify=False")


def kernel_limits(volume, kernel, p2, out_dtype):
    """Raise for what the CUDA kernel does not take (its tiles are sized for
    the CTViT geometry; the plain version takes any patch grid)."""
    W, dim = volume.shape[-1], kernel.shape[1]
    if out_dtype != torch.bfloat16:
        raise TypeError(f"the patchify kernel computes in bf16, not {out_dtype}")
    if W // p2 > 24 or p2 > 32 or dim % 128:
        raise ValueError(f"patchify kernel limits: W/p2 <= 24, p2 <= 32, dim % 128 == 0; "
                         f"got W={W}, p2={p2}, dim={dim}")


def _device(t: torch.Tensor) -> str:
    """"cpu" (the plain version) or "cuda" (the kernel)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _fold_terms(g, kernel, out_dtype):
    """(g in fp32, K in the compute dtype, v2 = g @ K in fp32)."""
    gf = g.to(torch.float32).contiguous()
    return gf, kernel.to(out_dtype).contiguous(), gf @ kernel.to(torch.float32)


def patchify_project_plain(volume, g, kernel, pt: int, p1: int, p2: int,
                           eps: float = 1e-5, out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with the same roundings: fp32
    statistics, the scaled patch rounded to ``out_dtype``, fp32 sums."""
    T, H, W = volume.shape
    t, h, w = T // pt, H // p1, W // p2
    gf, kv, v2 = _fold_terms(g, kernel, out_dtype)
    x = (volume.reshape(t, pt, h, p1, w, p2).permute(0, 2, 4, 1, 3, 5)
         .reshape(t, h, w, pt * p1 * p2).to(torch.float32))
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    rsig = torch.rsqrt(var + eps)
    acc = (x * gf).to(out_dtype).to(torch.float32) @ kv.to(torch.float32)
    return (rsig * acc - (mu * rsig) * v2).to(out_dtype)


def patchify_project(volume, g, kernel, pt: int, p1: int, p2: int,
                     eps: float = 1e-5, out_dtype=torch.bfloat16) -> torch.Tensor:
    """(T, H, W) volume in ``out_dtype`` -> (t, h, w, dim) patch embeddings,
    pre-bias and pre-norm_out; on the card in bf16 only.  ``g`` is the (patch_dim,) LayerNorm scale and
    ``kernel`` the (patch_dim, dim) projection, features ordered (pt, p1, p2)."""
    _check(volume, g, kernel, pt, p1, p2, out_dtype)
    if _device(volume) == "cpu":
        return patchify_project_plain(volume, g, kernel, pt, p1, p2, eps, out_dtype)
    kernel_limits(volume, kernel, p2, out_dtype)
    T, H, W = volume.shape
    dim = kernel.shape[1]
    gf, kv, v2 = _fold_terms(g, kernel, out_dtype)
    out = torch.empty((T // pt, H // p1, W // p2, dim), dtype=out_dtype, device=volume.device)
    rc = build.library().lib.patchify_project_launch(
        volume.data_ptr(), gf.data_ptr(), kv.data_ptr(), v2.data_ptr(), out.data_ptr(),
        T, H, W, pt, p1, p2, dim, eps, _stream(volume))
    build.check_launch(rc, "patchify_project")
    patchify_project.launches += 1
    return out


patchify_project.launches = 0
