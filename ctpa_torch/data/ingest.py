"""Unified scan ingest for the serving pipeline (BASELINE config 5: DICOM
ingest -> device preprocess -> encode -> continuous-batched report serving),
an own copy of ``ctpa/data/ingest.py`` (the port imports nothing of ``ctpa``).

`load_scan` decodes ONE source into the canonical scan dict the streaming
pipeline consumes — {volume: (z, y, x) raw stored values, slope, intercept,
spacing} — from any of:

  * a DICOM series DIRECTORY (ctpa_torch.data.dicom.load_series: slice sort by
    through-plane position, geometric z spacing, rescale tags),
  * a NIfTI file (.nii / .nii.gz, ctpa_torch.data.nifti),
  * an .npz / .npy volume (slope/intercept/spacing from kwargs or stored
    npz keys).

Raw stored values travel to the device (int16 for CT — half the bytes of
fp32 over the host link) and the HU rescale runs inside the fused device
preprocess (ops/preprocess.preprocess_volume), so every source format feeds
the identical compute path.

`scan_stream` decodes ahead on a thread pool so host decode overlaps device
work — the serving analog of the offline `multiprocessing.Pool` in the
reference's preprocess CLI (preprocess_train.py:165-170).  The reference's
serving-side analog loads one NIfTI scan inline with nibabel
(ct_scan_inference.py:18-29) and supports no DICOM at all; this module is
the config-5 capability gap called out in BASELINE.md.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np


def load_scan(
    path: str,
    *,
    slope: Optional[float] = None,
    intercept: Optional[float] = None,
    spacing: Optional[tuple[float, float, float]] = None,
) -> dict:
    """Decode one scan source into {volume, slope, intercept, spacing}.

    Explicit kwargs override header/tag values (npz files usually carry no
    metadata, so callers pass the manifest's values — the reference keeps
    them in a metadata CSV, data_prep.py:6-40)."""
    if os.path.isdir(path):
        from ctpa_torch.data.dicom import load_series

        s = load_series(path)
        return {
            "volume": s.data,
            "slope": s.slope if slope is None else slope,
            "intercept": s.intercept if intercept is None else intercept,
            "spacing": tuple(spacing or s.spacing),
        }
    low = path.lower()
    if low.endswith((".nii", ".nii.gz")):
        from ctpa_torch.data import nifti

        img = nifti.load(path)
        sl = img.scl_slope if img.scl_slope not in (0.0,) else 1.0
        # ONE canonical orientation operator shared with the offline CLI
        # (nifti.to_canonical): axis-true (z, y, x).  The reference instead
        # transposes (2, 0, 1) — (z, x, y), preprocess_train.py:104 —
        # indistinguishable on its square 480x480 slices but wrong for
        # asymmetric grids; to_canonical(reference_orientation=True)
        # reproduces it for parity runs.
        vol, sp = nifti.to_canonical(img)
        return {
            "volume": vol,
            "slope": sl if slope is None else slope,
            "intercept": img.scl_inter if intercept is None else intercept,
            "spacing": tuple(spacing or sp),
        }
    if low.endswith(".npz"):
        with np.load(path) as z:
            vol = z[z.files[0]]
            meta = {k: z[k] for k in z.files[1:]} if len(z.files) > 1 else {}
        return {
            "volume": vol,
            "slope": float(meta.get("slope", 1.0)) if slope is None else slope,
            "intercept": (float(meta.get("intercept", 0.0))
                          if intercept is None else intercept),
            "spacing": tuple(spacing
                             or tuple(np.asarray(meta.get("spacing",
                                                          (1.0, 1.0, 1.0)),
                                                 float))),
        }
    if low.endswith(".npy"):
        return {
            "volume": np.load(path),
            "slope": 1.0 if slope is None else slope,
            "intercept": 0.0 if intercept is None else intercept,
            "spacing": tuple(spacing or (1.0, 1.0, 1.0)),
        }
    raise ValueError(f"unrecognized scan source: {path} (expected a DICOM "
                     "series directory or a .nii/.nii.gz/.npz/.npy file)")


def scan_stream(
    paths: Iterable[str],
    num_threads: int = 4,
    **defaults,
) -> Iterator[dict]:
    """Decode-ahead iterator over scan sources, in submission order.

    A thread pool runs `load_scan` for up to `num_threads` upcoming sources
    while the consumer (StreamingReportPipeline.run) drives the device, so
    host-side decode — the whole CPU cost of DICOM parsing — overlaps
    encode/decode instead of serializing with them.  Ordering is preserved;
    a failed decode raises at ITS yield point (fail-loud, no dummy scans —
    SURVEY.md §7 quirks: fix)."""
    paths = list(paths)
    with ThreadPoolExecutor(max_workers=max(1, num_threads)) as pool:
        futures = [pool.submit(load_scan, p, **defaults) for p in paths]
        for f in futures:
            yield f.result()
