"""Canonical CT preprocessing — HU rescale/window, trilinear resample and
center crop/pad — in PyTorch (port of ``ctpa/ops/preprocess.py``).

Trilinear interpolation is separable: each axis is resampled by a dense
``(target, source)`` interpolation matrix with at most two non-zeros per row,
and the crop/pad offset is folded into the matrix rows, so the resampled
volume is never formed.  The resample is three matrix contractions, which
``torch.einsum`` runs.  ``preprocess_stage12`` stops after the depth and
height contractions and returns what the fused stage-3 kernel (K9,
``ops/resample_patchify.py``) reads; ``resample_stage3`` finishes the
volume from the same operands, so the two paths share one construction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ctpa_torch.core.config import PreprocessConfig


def hu_rescale(x: torch.Tensor, slope, intercept) -> torch.Tensor:
    """DICOM rescale: HU = slope * stored + intercept."""
    return x * slope + intercept


def hu_window(x: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """Clip to [hu_min, hu_max], shift, scale."""
    x = torch.clamp(x, cfg.hu_min, cfg.hu_max)
    return (x + cfg.hu_shift) / cfg.hu_scale


def _resampled_len(extent: int, spacing: float, target_spacing: float) -> int:
    """floor(extent * spacing / target_spacing) in float32, as ctpa's jitted
    preprocess computes it: XLA turns the division by the constant target
    spacing into a product with its fp32 reciprocal, which decides the
    length where extent * ratio lands within an ulp of an integer."""
    ratio = np.float32(spacing) * (np.float32(1.0) / np.float32(target_spacing))
    return int(np.float32(extent) * ratio)


def _interp_rows(source: int, n: int, target: int, true_len: int | None, device):
    """Each target row's two source columns (i0c <= i1c, edge-clamped), the
    fraction of the second, and whether the row lies inside the virtual
    resampled extent."""
    eff = source if true_len is None else int(true_len)
    offset = (n - target) // 2 if n >= target else -((target - n) // 2)
    idx = torch.arange(target, device=device) + offset
    valid = (idx >= 0) & (idx < n)
    ratio = float(np.float32(eff) / np.float32(n))
    src = (idx.to(torch.float32) + 0.5) * ratio - 0.5
    i0 = torch.floor(src)
    frac = src - i0
    i0c = torch.clamp(i0, 0, eff - 1).long()
    i1c = torch.clamp(i0 + 1, 0, eff - 1).long()
    return i0c, i1c, frac, valid


def _interp_matrix_and_taps(source: int, n: int, target: int, *, pad_mask_out: bool = True,
                            true_len: int | None = None, device="cuda"):
    """``_interp_matrix`` and its taps from the same rows: (W, valid, taps)
    with taps = ((target, 2) int32 source columns, (target, 2) fp32 weights),
    the values ``ops/resample_patchify.py:stage3_taps`` reads from W.  The
    matrix is built from these two taps a row, so no row of it has more than
    two non-zeros; nothing here waits for the device."""
    i0c, i1c, frac, valid = _interp_rows(source, n, target, true_len, device)
    s = torch.arange(source, device=device)
    # when i0c == i1c (edge clamp) the two weights add up to 1
    w = (torch.where(s[None, :] == i0c[:, None], 1.0 - frac[:, None], 0.0)
         + torch.where(s[None, :] == i1c[:, None], frac[:, None], 0.0))
    # the same entries, one a tap: the merged weight where the columns meet
    merged = i0c == i1c
    a0 = torch.where(merged, (1.0 - frac) + frac, 1.0 - frac)
    a1 = torch.where(merged, 0.0, frac)
    if pad_mask_out:
        w = w * valid[:, None]
        a0, a1 = a0 * valid, a1 * valid
    # stage3_taps' reading: the first and last non-zero column (both 0 in an
    # empty row), the second weight 0 where they are one column
    nz0, nz1 = a0 != 0, a1 != 0
    i0 = torch.where(nz0, i0c, torch.where(nz1, i1c, 0))
    i1 = torch.where(nz1, i1c, torch.where(nz0, i0c, 0))
    w0 = torch.where(nz0, a0, torch.where(nz1, a1, 0.0))
    w1 = torch.where(nz0 & nz1, a1, 0.0)
    taps = (torch.stack([i0, i1], 1).to(torch.int32),
            torch.stack([w0, w1], 1).to(torch.float32).contiguous())
    return w.to(torch.float32), valid, taps


def _interp_matrix(source: int, n: int, target: int, *, pad_mask_out: bool = True,
                   true_len: int | None = None, device="cuda"):
    """Dense (target, source) trilinear-interp matrix for one axis with the
    crop/pad offset folded in; half-pixel centers (align_corners=False) with
    edge clamping.  ``true_len`` (<= source) marks how many leading source
    entries are real when the axis is end-padded to a bucket size.

    Returns (W, valid): W float32 (target, source); valid (target,) bool marks
    rows inside the virtual resampled extent."""
    w, valid, _ = _interp_matrix_and_taps(source, n, target, pad_mask_out=pad_mask_out,
                                          true_len=true_len, device=device)
    return w, valid


class Stage3Operands(NamedTuple):
    """The stage-1/2 intermediate and what the width resample (stage 3) needs;
    ``resample_stage3(*ops)`` finishes the volume."""

    x2: torch.Tensor                # (D, H, ws): depth and height resampled, width the raw's
    wwp: torch.Tensor               # (W, ws) fp32 width interp matrix, crop/pad folded in
    vd: torch.Tensor                # (D,) bool: rows inside the resampled extent
    vh: torch.Tensor                # (H,) bool
    vw: torch.Tensor                # (W,) bool
    window: tuple | None            # (hu_min, hu_max, hu_shift, hu_scale); None: not applied
    pad_value: float
    taps: tuple | None = None       # wwp's two taps a row, ((W, 2) int32, (W, 2) fp32), for K9


def resample_stage12(volume: torch.Tensor, spacing, cfg: PreprocessConfig, *,
                     apply_window: bool = True, src_shape=None,
                     dtype=torch.float32) -> Stage3Operands:
    """Resample (d, h, w) in depth and height to ``cfg.target_spacing`` with
    the center crop/pad folded in; the width's matrix and the window are
    returned for stage 3.  The contractions run in fp32; ``x2`` is then cast
    to ``dtype`` (the compute dtype of the fused kernel's path).

    ``spacing`` is the source voxel spacing (z, y, x) in mm; ``src_shape``
    the true extents when ``volume`` is end-padded to a shape bucket."""
    d, h, w = volume.shape
    td, th, tw = cfg.target_shape
    sp = [float(s) for s in torch.as_tensor(spacing).tolist()]
    if src_shape is None:
        true = (None, None, None)
        ext = (d, h, w)
    else:
        true = tuple(int(s) for s in torch.as_tensor(src_shape).tolist())
        ext = true
    n = [_resampled_len(e, s, t) for e, s, t in zip(ext, sp, cfg.target_spacing)]
    dev = volume.device
    wd, vd = _interp_matrix(d, n[0], td, true_len=true[0], device=dev)
    wh, vh = _interp_matrix(h, n[1], th, true_len=true[1], device=dev)
    ww, vw, taps = _interp_matrix_and_taps(w, n[2], tw, true_len=true[2], device=dev)

    x = volume.to(torch.float32)
    x = torch.einsum("Dd,dhw->Dhw", wd, x)
    # (H, h) @ (D, h, w): the product comes out contiguous, as the kernel reads x2
    x = torch.matmul(wh, x)
    window = (cfg.hu_min, cfg.hu_max, cfg.hu_shift, cfg.hu_scale) if apply_window else None
    return Stage3Operands(x.to(dtype), ww, vd, vh, vw, window, cfg.pad_value, taps)


def resample_stage3(x2, wwp, vd, vh, vw, window, pad_value, taps=None) -> torch.Tensor:
    """Stage 3 in fp32 (the width contraction of ``x2`` as it is, against
    fp32 ``wwp``), then the window and the pad mask -> (D, H, W) fp32.
    ``taps`` (K9's form of ``wwp``) is not read: the dense product is the
    plain one."""
    x = torch.einsum("Ww,DHw->DHW", wwp, x2.to(torch.float32))
    if window is not None:
        lo, hi, shift, scale = window
        x = (torch.clamp(x, lo, hi) + shift) / scale
    valid = vd[:, None, None] & vh[None, :, None] & vw[None, None, :]
    return torch.where(valid, x, torch.full_like(x, pad_value))


def resample_crop_pad(volume: torch.Tensor, spacing, cfg: PreprocessConfig, *,
                      apply_window: bool = True, src_shape=None) -> torch.Tensor:
    """Resample (d, h, w) to ``cfg.target_spacing`` and center crop/pad to
    ``cfg.target_shape``; out-of-extent voxels get ``cfg.pad_value``.

    ``spacing`` is the source voxel spacing (z, y, x) in mm; ``src_shape``
    the true extents when ``volume`` is end-padded to a shape bucket."""
    return resample_stage3(*resample_stage12(volume, spacing, cfg, apply_window=apply_window,
                                             src_shape=src_shape))


def crop_or_pad(volume: torch.Tensor, target_shape: tuple[int, int, int],
                pad_value: float) -> torch.Tensor:
    """Center crop/pad each axis to ``target_shape`` (no resample)."""
    out = volume
    for axis, tgt in enumerate(target_shape):
        size = out.shape[axis]
        if size > tgt:
            start = (size - tgt) // 2
            out = out.narrow(axis, start, tgt)
        elif size < tgt:
            before = (tgt - size) // 2
            pads = [0, 0] * out.ndim          # F.pad lists the last axis first
            j = 2 * (out.ndim - 1 - axis)
            pads[j], pads[j + 1] = before, tgt - size - before
            out = F.pad(out, pads, value=pad_value)
    return out


def _as_tensor(x, device) -> torch.Tensor:
    """A tensor stays where it is; an array goes to ``device``."""
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x), device=device)


def preprocess_stage12(raw, slope, intercept, spacing,
                       cfg: PreprocessConfig = PreprocessConfig.train(),
                       window_first: bool = False, src_shape=None, dtype=torch.float32,
                       device="cuda") -> Stage3Operands:
    """``preprocess_volume`` up to the width resample: the operands of the
    fused stage-3 kernel (K9), ``x2`` in ``dtype``.

    ``window_first=True`` is the offline order (rescale -> window ->
    resample, and ``window`` None); the default is the online order (rescale
    -> resample -> window).  A raw array that is not a tensor yet is placed
    on ``device``."""
    raw = _as_tensor(raw, device)
    x = hu_rescale(raw.to(torch.float32), slope, intercept)
    if window_first:
        return resample_stage12(hu_window(x, cfg), spacing, cfg, apply_window=False,
                                src_shape=src_shape, dtype=dtype)
    return resample_stage12(x, spacing, cfg, apply_window=True, src_shape=src_shape, dtype=dtype)


def preprocess_volume(raw, slope, intercept, spacing,
                      cfg: PreprocessConfig = PreprocessConfig.train(),
                      window_first: bool = False, src_shape=None,
                      device="cuda") -> torch.Tensor:
    """Train-path operator: raw (z, y, x) volume -> (1, D, H, W) model input.

    ``window_first=True`` is the offline order (rescale -> window ->
    resample); the default is the online order (rescale -> resample ->
    window).  A raw array that is not a tensor yet is placed on ``device``."""
    return resample_stage3(*preprocess_stage12(raw, slope, intercept, spacing, cfg, window_first,
                                               src_shape, device=device))[None]


def preprocess_volume_inference(vol, cfg: PreprocessConfig = PreprocessConfig.inference(),
                                prescale: float = 1000.0, device="cuda") -> torch.Tensor:
    """Inference-path operator: a pre-normalised (h, w, d) volume -> (1, D, H, W).

    The input is multiplied back by ``prescale``, windowed to [-1000, 200]
    and mapped by (x+400)/600, then center cropped/padded in (h, w, d) order
    and permuted to (d, h, w)."""
    vol = _as_tensor(vol, device)
    x = hu_window(vol.to(torch.float32) * prescale, cfg)
    th, tw, td = cfg.target_shape[1], cfg.target_shape[2], cfg.target_shape[0]
    x = crop_or_pad(x, (th, tw, td), cfg.pad_value)
    return x.permute(2, 0, 1).contiguous()[None]


def preprocess_batch(raws, slopes, intercepts, spacings,
                     cfg: PreprocessConfig = PreprocessConfig.train(), window_first: bool = False,
                     device="cuda") -> torch.Tensor:
    """``preprocess_volume`` over a batch of same-shape raw volumes (B, z, y, x)
    with per-volume slope, intercept and (z, y, x) spacing -> (B, 1, D, H, W)."""
    return preprocess_batch_bucketed(raws, slopes, intercepts, spacings, None, cfg,
                                     window_first, device)


def preprocess_batch_bucketed(raws, slopes, intercepts, spacings, src_shapes,
                              cfg: PreprocessConfig = PreprocessConfig.train(),
                              window_first: bool = False, device="cuda") -> torch.Tensor:
    """The batch of bucket-padded raw volumes (B, db, hb, wb) with their true
    (B, 3) extents ``src_shapes`` (None: the whole volume) -> (B, 1, D, H, W);
    exact for every raw shape inside the bucket."""
    return torch.stack([
        preprocess_volume(raws[i], float(slopes[i]), float(intercepts[i]), spacings[i], cfg,
                          window_first, None if src_shapes is None else src_shapes[i],
                          device=device)
        for i in range(len(raws))])
