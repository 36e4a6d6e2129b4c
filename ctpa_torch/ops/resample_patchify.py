"""Fused stage-3 resample + HU window + pad mask + patchify + LayerNorm +
projection (kernel K9).

Replaces the TPU kernel
``ctpa/ops/pallas/resample_patchify.py:resample3_patchify_project``.  It
reads the stage-1/2 intermediate ``x2 = (D, H, ws)`` of
``ops/preprocess.py:preprocess_stage12`` and never writes the resampled
``(D, H, W)`` volume: each output column is a two-tap interpolation of an
``x2`` row, windowed, masked to ``pad_value`` outside the resampled extent,
and the patches are projected through the LayerNorm-folded patch embed, as
``ops/patchify.py`` (K1) does for a resampled volume.

The CUDA kernel is ``ctpa_torch/csrc/resample_patchify.cu`` (its header
states the bound it faces on the H100 and what its design does about it).
``resample3_patchify_project`` launches it for CUDA tensors and takes the
plain PyTorch version, ``resample3_patchify_project_plain``, only for CPU
tensors.  The kernel is forward-only, as ctpa's is: under grad mode with an
input that requires grad, the wrapper raises on every device.

Roundings, as ctpa's kernel makes them: the stage-3 product of the ``x2``
values as given (bf16 on the serving path) against fp32 ``wwp`` in fp32;
fp32 statistics with no clamp of ``m2 - mu^2``; the projection of ``y``
rounded to ``x2``'s dtype against ``kg = g * K`` rounded to that dtype,
summed in fp32; ``v2 = sum(g * K)`` from the unrounded fp32 products.  A
fully padded patch therefore gets ``rsig * (sum(g*K) - sum(kg))`` with
``rsig = 1/sqrt(eps)``, not 0, wherever ``g * K`` does not round exactly.
"""

from __future__ import annotations

import torch

from ctpa_torch.kernels import build
from ctpa_torch.ops.patchify import _device, _stream
from ctpa_torch.ops.preprocess import resample_stage3

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x2, wwp, vd, vh, vw, g, kernel, pt, p1, p2, out_dtype):
    if x2.ndim != 3 or wwp.ndim != 2 or wwp.shape[1] != x2.shape[2]:
        raise ValueError(f"x2 must be (D, H, ws) and wwp (W, ws), got {tuple(x2.shape)} "
                         f"and {tuple(wwp.shape)}")
    D, H, _ = x2.shape
    W = wwp.shape[0]
    if D % pt or H % p1 or W % p2:
        raise ValueError(f"(D, H, W) = ({D}, {H}, {W}) is not a whole number of "
                         f"({pt}, {p1}, {p2}) patches")
    for name, mask, n in (("vd", vd, D), ("vh", vh, H), ("vw", vw, W)):
        if mask.shape != (n,) or mask.dtype != torch.bool:
            raise ValueError(f"{name} must be ({n},) bool, got {tuple(mask.shape)} {mask.dtype}")
    pd = pt * p1 * p2
    if g.shape != (pd,) or kernel.ndim != 2 or kernel.shape[0] != pd:
        raise ValueError(f"g {tuple(g.shape)} / kernel {tuple(kernel.shape)} do not "
                         f"match patch_dim {pd}")
    if x2.dtype not in _DTYPES or out_dtype not in _DTYPES or wwp.dtype != torch.float32:
        raise TypeError(f"x2 {x2.dtype} and out_dtype {out_dtype} must be one of {_DTYPES}, "
                        f"wwp fp32 (got {wwp.dtype})")
    if not x2.is_contiguous():
        raise ValueError("x2 must be contiguous")
    if len({t.device for t in (x2, wwp, vd, vh, vw, g, kernel)}) != 1:
        raise ValueError("x2, wwp, vd, vh, vw, g and kernel must be on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x2, wwp, g, kernel)):
        raise RuntimeError("resample3_patchify_project is forward-only (no backward, as ctpa's "
                           "kernel has no VJP): call it under torch.no_grad() or "
                           "torch.inference_mode()")


def kernel_limits(x2, wwp, kernel, p2, out_dtype):
    """Raise for what the CUDA kernel does not take (its tiles are K1's; the
    plain version takes any patch grid)."""
    W, dim = wwp.shape[0], kernel.shape[1]
    if x2.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise TypeError(f"the resample-patchify kernel reads bf16 x2 and writes bf16, "
                        f"not {x2.dtype} -> {out_dtype}")
    if W // p2 > 24 or p2 > 32 or dim % 128:
        raise ValueError(f"resample-patchify kernel limits: W/p2 <= 24, p2 <= 32, "
                         f"dim % 128 == 0; got W={W}, p2={p2}, dim={dim}")


def stage3_taps(wwp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each output column's source columns and weights, ``(W, 2)`` int32 and
    fp32, from the stage-3 matrix, and a device bool that is True where a
    row has more than two non-zeros (which the kernel does not take).  A
    trilinear row has two non-zeros, an edge-clamped row one (the second tap
    then has weight 0) and a pad row none (both 0); with at most two terms
    the two-tap sum is the dense fp32 dot.  Nothing here waits for the
    device."""
    nz = wwp != 0
    cols = torch.arange(wwp.shape[1], device=wwp.device)
    i0 = torch.where(nz, cols, wwp.shape[1]).amin(1)
    i1 = torch.where(nz, cols, -1).amax(1)
    i0 = torch.where(i1 < 0, 0, i0)
    i1 = torch.where(i1 < 0, i0, i1)
    w0 = wwp.gather(1, i0[:, None])[:, 0]
    w1 = torch.where(i1 != i0, wwp.gather(1, i1[:, None])[:, 0], 0.0)
    return (torch.stack([i0, i1], 1).to(torch.int32), torch.stack([w0, w1], 1).contiguous(),
            (nz.sum(1) > 2).any())


def _check_taps(taps, wwp) -> tuple[torch.Tensor, torch.Tensor]:
    """Given taps ((W, 2) int32 columns, (W, 2) fp32 weights) on wwp's
    device, as ``ops/preprocess.py`` builds them with the matrix; checked by
    their shapes alone (reading their values would wait for the device)."""
    taps_i, taps_w = taps
    W = wwp.shape[0]
    if (taps_i.shape != (W, 2) or taps_w.shape != (W, 2) or taps_i.dtype != torch.int32
            or taps_w.dtype != torch.float32):
        raise ValueError(f"taps must be ({W}, 2) int32 and ({W}, 2) fp32, got "
                         f"{tuple(taps_i.shape)} {taps_i.dtype} and {tuple(taps_w.shape)} "
                         f"{taps_w.dtype}")
    if taps_i.device != wwp.device or taps_w.device != wwp.device:
        raise ValueError("taps must be on wwp's device")
    return taps_i.contiguous(), taps_w.contiguous()


def _fold_terms(g, kernel, dtype):
    """(kg = g * K rounded to ``dtype``, v2 = sum over features of the fp32
    g * K), as ctpa folds them on the host."""
    k3 = g.to(torch.float32)[:, None] * kernel.to(torch.float32)
    return k3.to(dtype).contiguous(), k3.sum(0)


def resample3_patchify_project_plain(x2, wwp, vd, vh, vw, g, kernel, pt: int, p1: int, p2: int,
                                     eps: float = 1e-5, window=None, pad_value: float = -1.0,
                                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with ctpa's roundings (see the
    module docstring)."""
    D, H, _ = x2.shape
    W = wwp.shape[0]
    t, h, w = D // pt, H // p1, W // p2
    y = resample_stage3(x2, wwp, vd, vh, vw, window, pad_value)        # (D, H, W) fp32
    y = (y.reshape(t, pt, h, p1, w, p2).permute(0, 2, 4, 1, 3, 5)
         .reshape(t, h, w, pt * p1 * p2))
    mu = y.mean(-1, keepdim=True)
    rsig = torch.rsqrt((y * y).mean(-1, keepdim=True) - mu * mu + eps)
    kg, v2 = _fold_terms(g, kernel, x2.dtype)
    acc = y.to(x2.dtype).to(torch.float32) @ kg.to(torch.float32)
    return (rsig * acc - (mu * rsig) * v2).to(out_dtype)


def resample3_patchify_project(x2, wwp, vd, vh, vw, g, kernel, pt: int, p1: int, p2: int,
                               eps: float = 1e-5, window=None, pad_value: float = -1.0,
                               out_dtype=torch.bfloat16, taps=None) -> torch.Tensor:
    """(D, H, ws) stage-1/2 intermediate -> (t, h, w, dim) patch embeddings,
    pre-bias and pre-norm_out; on the card bf16 in and out only.  ``wwp`` is
    the (W, ws) fp32 stage-3 matrix, ``vd``/``vh``/``vw`` the bool extents,
    ``window`` (hu_min, hu_max, hu_shift, hu_scale) or None, ``g`` the
    (patch_dim,) LayerNorm scale and ``kernel`` the (patch_dim, dim)
    projection, features ordered (pt, p1, p2).  ``taps``, wwp's two taps a
    row as ``ops/preprocess.py`` builds them with the matrix
    (``Stage3Operands.taps``), lets the call enqueue with no host sync;
    without them the wrapper derives them from wwp and waits for the check
    that no row has more than two non-zeros.  The plain version reads wwp."""
    _check(x2, wwp, vd, vh, vw, g, kernel, pt, p1, p2, out_dtype)
    if _device(x2) == "cpu":
        return resample3_patchify_project_plain(x2, wwp, vd, vh, vw, g, kernel, pt, p1, p2, eps,
                                                window, pad_value, out_dtype)
    kernel_limits(x2, wwp, kernel, p2, out_dtype)
    D, H, ws = x2.shape
    W, dim = wwp.shape[0], kernel.shape[1]
    if taps is None:
        taps_i, taps_w, too_many = stage3_taps(wwp)
    else:
        (taps_i, taps_w), too_many = _check_taps(taps, wwp), None
    kg, v2 = _fold_terms(g, kernel, x2.dtype)
    vd8, vh8, vw8 = (m.to(torch.uint8).contiguous() for m in (vd, vh, vw))
    lo, hi, shift, scale = window if window is not None else (0.0, 0.0, 0.0, 1.0)
    out = torch.empty((D // pt, H // p1, W // p2, dim), dtype=out_dtype, device=x2.device)
    # without taps, the call's one host sync, after everything else is enqueued
    if too_many is not None and bool(too_many):
        raise ValueError("stage-3 matrix has a row with more than two non-zeros; the "
                         "resample-patchify kernel takes two-tap (trilinear) rows only")
    rc = build.library().lib.resample3_patchify_project_launch(
        x2.data_ptr(), taps_i.data_ptr(), taps_w.data_ptr(), vd8.data_ptr(), vh8.data_ptr(),
        vw8.data_ptr(), kg.data_ptr(), v2.data_ptr(), out.data_ptr(),
        D, H, ws, W, pt, p1, p2, dim, int(window is not None),
        lo, hi, shift, scale, pad_value, eps, _stream(x2))
    build.check_launch(rc, "resample3_patchify_project")
    resample3_patchify_project.launches += 1
    return out


resample3_patchify_project.launches = 0
