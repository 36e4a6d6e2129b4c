"""Offline preprocessing CLI — NIfTI / DICOM -> canonical npz volumes +
metadata CSVs (port of ``ctpa/cli/preprocess.py``).

Walk a directory of .nii/.nii.gz scans (or DICOM series sub-directories),
extract acquisition metadata, run the canonical preprocess (HU window ->
resample -> crop/pad, ``ops.preprocess.preprocess_volume``) on the device,
and write npz volumes in the reference's sharded folder layout
``{split}_{id[:2]}/{split}_{id}/{id}.npz``.  Both ingest paths produce the
same canonical npz for the same underlying volume.  No interactive
destructive prompt and no source deletion.

    python -m ctpa_torch.cli.preprocess --input-dir IN --output-dir OUT \\
        [--split train] [--window inference]

The command line runs on the card; ``main(argv, device="cpu")`` runs on the
CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from collections import defaultdict

import numpy as np

from ctpa_torch.core.config import PreprocessConfig
from ctpa_torch.data import dicom, nifti
from ctpa_torch.data.manifests import (
    extract_metadata, extract_metadata_dicom, volume_stem, write_split_metadata,
)
from ctpa_torch.ops.preprocess import preprocess_volume


def find_nii_files(root: str) -> list[str]:
    out = []
    for r, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith((".nii", ".nii.gz")):
                out.append(os.path.join(r, f))
    return out


def find_dicom_series(root: str) -> list[str]:
    """Directories under `root` (inclusive) that directly contain DICOM files;
    each is treated as one series/volume named by its basename."""
    out = []
    for r, _, _files in os.walk(root):
        if dicom.find_series_files(r):
            out.append(r)
    return sorted(out)


def sharded_output_path(out_dir: str, split: str, vid: str) -> str:
    sub = f"{split}_{vid[:2]}"
    subsub = f"{split}_{vid}"
    return os.path.join(out_dir, sub, subsub, f"{vid}.npz")


def _save(out_dir: str, split: str, vid: str, out) -> str:
    dst = sharded_output_path(out_dir, split, vid)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    np.savez(dst, out[0].cpu().numpy().astype(np.float32))
    return dst


def process_one(path: str, out_dir: str, split: str, cfg: PreprocessConfig,
                window_first: bool = True, reference_orientation: bool = False,
                device="cuda") -> str:
    img = nifti.load(path)
    # one canonical orientation operator shared with the serving ingest
    # (data/ingest.load_scan): axis-true (z, y, x).  reference_orientation
    # reproduces the reference's (2, 0, 1) transpose for bit-parity runs
    # against reference-preprocessed npz.
    raw, sp = nifti.to_canonical(img, reference_orientation=reference_orientation)
    slope = img.scl_slope if img.scl_slope not in (0.0,) else 1.0
    out = preprocess_volume(
        raw.astype(np.float32), float(np.float32(slope)), float(np.float32(img.scl_inter)),
        np.asarray(sp, np.float32), cfg=cfg, window_first=window_first, device=device)
    return _save(out_dir, split, volume_stem(path), out)


def process_one_dicom(series_dir: str, out_dir: str, split: str, cfg: PreprocessConfig,
                      window_first: bool = True, device="cuda") -> str:
    """DICOM-series analog of `process_one`: load_series already yields
    (z, y, x) with (z, y, x) spacing, so the same canonical preprocess runs
    with no transpose."""
    series = dicom.load_series(series_dir)
    out = preprocess_volume(
        series.data.astype(np.float32), float(np.float32(series.slope)),
        float(np.float32(series.intercept)), np.asarray(series.spacing, np.float32),
        cfg=cfg, window_first=window_first, device=device)
    return _save(out_dir, split, os.path.basename(os.path.normpath(series_dir)), out)


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--split", default="train", choices=["train", "valid", "test"])
    p.add_argument("--train-frac", type=float, default=0.8)
    p.add_argument("--target-shape", type=int, nargs=3, default=[240, 480, 480])
    p.add_argument("--window", default="train", choices=["train", "inference"])
    p.add_argument("--reference-orientation", action="store_true",
                   help="use the reference's NIfTI transpose (2, 0, 1) — (z, x, y) — "
                        "instead of the canonical axis-true (z, y, x), for bit-parity "
                        "runs against reference-preprocessed data")
    args = p.parse_args(argv)

    cfg = (PreprocessConfig.train() if args.window == "train"
           else PreprocessConfig.inference())
    cfg = dataclasses.replace(cfg, target_shape=tuple(args.target_shape))

    files = find_nii_files(args.input_dir)
    series_dirs = find_dicom_series(args.input_dir)
    print(f"found {len(files)} NIfTI volumes, {len(series_dirs)} DICOM series",
          file=sys.stderr)
    metas = extract_metadata(files) + extract_metadata_dicom(series_dirs)
    if not metas:
        print("nothing to do", file=sys.stderr)
        return
    write_split_metadata(metas, args.output_dir, train_frac=args.train_frac)

    by_shape = defaultdict(list)   # shape buckets, as ctpa's (its jit reuses executables)
    for f in files:
        by_shape[nifti.load(f).shape].append(f)
    n, total = 0, len(files) + len(series_dirs)
    for bucket in by_shape.values():
        for f in bucket:
            dst = process_one(f, args.output_dir, args.split, cfg,
                              reference_orientation=args.reference_orientation,
                              device=device)
            n += 1
            if n % 25 == 0:
                print(f"{n}/{total} -> {dst}", file=sys.stderr)
    for d in series_dirs:
        dst = process_one_dicom(d, args.output_dir, args.split, cfg, device=device)
        n += 1
        if n % 25 == 0:
            print(f"{n}/{total} -> {dst}", file=sys.stderr)
    print(f"wrote {n} volumes to {args.output_dir}", file=sys.stderr)


if __name__ == "__main__":
    main()
