"""Dataset manifests: NIfTI/DICOM metadata extraction, split CSVs, VQA JSONL
(a pandas-free copy of ``ctpa/data/manifests.py``; the port imports nothing
of ``ctpa``).

Where ctpa passes DataFrames, the port passes rows: lists of dicts in column
order.  ``read_csv`` and ``write_csv`` read and write CSV files the way
ctpa's ``pd.read_csv`` and ``DataFrame.to_csv(index=False)`` do for the
columns these modules use, so the port reads the same ids and writes the
same bytes:

* a column whose cells are all integers is read as int (``"00123"`` ->
  123), one with an empty cell among numbers as float (``"123"`` -> 123.0);
  ``"True"``/``"false"`` columns as bool; pandas' NA strings as NaN;
* ``iterrows`` gives the values ``DataFrame.iterrows`` gives: in a frame of
  numeric columns only, every value of a row is upcast to float, so an int
  id reads ``"123.0"`` there;
* the writer quotes fields with commas, quotes or newlines, writes floats
  in ``repr`` form, NaN and None as empty fields, other values by ``str``
  (a list as ``"[0.75, 0.75]"``).

Parity targets of the reference: VolumeName/RescaleSlope/RescaleIntercept/
XYSpacing/ZSpacing metadata CSV with NaN -> (1.0, 0.0) defaults, reports CSV
+ image dir -> JSONL, and the XYSpacing parsing quirks (values arrive as
floats, lists, or stringified lists).
"""

from __future__ import annotations

import ast
import csv
import json
import math
import os
import re
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np

from ctpa_torch.data import nifti

# pandas' default NA strings (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_INT = re.compile(r"\s*[+-]?[0-9]+\s*", re.ASCII)
_FLOAT = re.compile(r"\s*[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
                    r"|inf|infinity)\s*", re.ASCII | re.IGNORECASE)
_BOOLS = {"True": True, "TRUE": True, "true": True,
          "False": False, "FALSE": False, "false": False}


class CsvTable(NamedTuple):
    """A CSV file as pandas reads it: the column names, each column's kind
    ("int", "float", "bool" or "object") and the rows, each value typed by
    its column (NaN for a missing cell)."""

    columns: list[str]
    kinds: dict[str, str]
    rows: list[dict]


def _is_missing(value) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def _column(cells: list[str]) -> tuple[str, list]:
    """One column's kind and typed values, by pandas' inference."""
    present = [c for c in cells if c not in NA_STRINGS]
    has_na = len(present) < len(cells)
    if present and not has_na and all(_INT.fullmatch(c) for c in present):
        return "int", [int(c) for c in cells]
    if all(_FLOAT.fullmatch(c) for c in present):      # an all-NA column too
        return "float", [float("nan") if c in NA_STRINGS else float(c) for c in cells]
    if all(c in _BOOLS for c in present):
        if not has_na:
            return "bool", [_BOOLS[c] for c in cells]
        return "object", [float("nan") if c in NA_STRINGS else _BOOLS[c] for c in cells]
    return "object", [float("nan") if c in NA_STRINGS else c for c in cells]


def read_csv(path: str) -> CsvTable:
    """Read ``path`` as ``pd.read_csv(path)`` does with its defaults: a
    header line, quoted fields that may hold commas and newlines, blank
    lines skipped, short rows padded with NaN, unnamed columns named
    ``Unnamed: i``."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        lines = [row for row in csv.reader(f) if row]
    if not lines:
        raise ValueError(f"{path}: no columns to parse")
    columns = [name or f"Unnamed: {i}" for i, name in enumerate(lines[0])]
    body = lines[1:]
    for i, row in enumerate(body):
        if len(row) > len(columns):
            raise ValueError(f"{path}: line {i + 2} has {len(row)} fields, "
                             f"the header {len(columns)}")
    kinds, values = {}, {}
    for j, name in enumerate(columns):
        kinds[name], values[name] = _column([row[j] if j < len(row) else "" for row in body])
    rows = [{name: values[name][i] for name in columns} for i in range(len(body))]
    return CsvTable(columns, kinds, rows)


def iterrows(table: CsvTable) -> list[dict]:
    """The rows as ``DataFrame.iterrows`` gives them: all-int frames keep
    ints, all-numeric frames upcast every value to float, all-bool frames
    keep bools, and any other frame keeps each value as its column has it."""
    kinds = set(table.kinds.values())
    if kinds <= {"int", "float"} and "float" in kinds:
        return [{k: float(v) for k, v in row.items()} for row in table.rows]
    return [dict(row) for row in table.rows]


def _kind(values: list) -> str:
    """pandas' dtype for a column built from Python values: int, float (ints
    and floats, missing allowed), bool, else object."""
    present = [v for v in values if not _is_missing(v)]
    numeric = all(isinstance(v, (int, float, np.integer, np.floating))
                  and not isinstance(v, (bool, np.bool_)) for v in present)
    if numeric and present and len(present) == len(values) and all(
            isinstance(v, (int, np.integer)) for v in present):
        return "int"
    if numeric:
        return "float"
    if len(present) == len(values) and all(isinstance(v, (bool, np.bool_)) for v in present):
        return "bool"
    return "object"


def _cell(value, kind: str) -> str:
    if _is_missing(value):
        return ""
    if kind == "float":
        return repr(float(value))
    if kind == "int":
        return str(int(value))
    return str(value)


def table_columns(rows: Sequence[dict]) -> list[str]:
    """Column names in order of first appearance, as a DataFrame built from
    the rows has them."""
    return list(dict.fromkeys(k for row in rows for k in row))


def column_kinds(rows: Sequence[dict], columns: Optional[Sequence[str]] = None) -> dict:
    columns = table_columns(rows) if columns is None else columns
    return {c: _kind([row.get(c) for row in rows]) for c in columns}


def write_csv(path: str, rows: Sequence[dict], columns: Optional[Sequence[str]] = None,
              kinds: Optional[dict] = None) -> None:
    """Write ``rows`` as ``pd.DataFrame(rows, columns=columns).to_csv(path,
    index=False)`` writes them.  ``kinds`` (``column_kinds`` of the frame the
    rows were taken from) keeps a subset's formatting that of the whole."""
    columns = table_columns(rows) if columns is None else list(columns)
    kinds = column_kinds(rows, columns) if kinds is None else kinds
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for row in rows:
            w.writerow([_cell(row.get(c), kinds[c]) for c in columns])


def parse_xy_spacing(value: object) -> float:
    """Accept float, list, or stringified list."""
    if isinstance(value, (int, float)):
        return float(value)
    if isinstance(value, (list, tuple)) and value:
        return float(value[0])
    if isinstance(value, str):
        try:
            parsed = ast.literal_eval(value)
            if isinstance(parsed, (list, tuple)) and parsed:
                return float(parsed[0])
            if isinstance(parsed, (int, float)):
                return float(parsed)
        except (ValueError, SyntaxError):
            pass
        try:
            return float(value)
        except ValueError:
            pass
    raise ValueError(f"cannot parse XYSpacing value: {value!r}")


def extract_metadata(nii_paths: Iterable[str]) -> list[dict]:
    """Per-volume acquisition metadata rows.  Missing slope/intercept default
    to (1.0, 0.0) like the reference's NaN handling."""
    rows = []
    for path in nii_paths:
        img = nifti.load(path)
        slope = img.scl_slope if img.scl_slope not in (0.0,) and np.isfinite(img.scl_slope) else 1.0
        inter = img.scl_inter if np.isfinite(img.scl_inter) else 0.0
        sp = img.spacing + (1.0, 1.0, 1.0)
        rows.append({
            "VolumeName": os.path.basename(path),
            "RescaleSlope": slope,
            "RescaleIntercept": inter,
            "XYSpacing": [sp[0], sp[1]],
            "ZSpacing": sp[2] if len(img.spacing) > 2 else 1.0,
            "NumSlices": img.shape[2] if img.data.ndim > 2 else 1,
        })
    return rows


def extract_metadata_dicom(series_dirs: Iterable[str]) -> list[dict]:
    """Per-series acquisition metadata, the columns of `extract_metadata`, so
    downstream CSV consumers are ingest-agnostic.  VolumeName is the series
    directory basename."""
    from ctpa_torch.data import dicom

    rows = []
    for d in series_dirs:
        series = dicom.load_series(d)
        dz, dy, dx = series.spacing
        rows.append({
            "VolumeName": os.path.basename(os.path.normpath(d)),
            "RescaleSlope": series.slope,
            "RescaleIntercept": series.intercept,
            "XYSpacing": [dy, dx],
            "ZSpacing": dz,
            "NumSlices": series.shape[0],
        })
    return rows


def write_split_metadata(rows: Sequence[dict], out_dir: str, train_frac: float = 0.8,
                         seed: int = 0) -> tuple[str, str]:
    """Shuffled train/test metadata CSVs (the rows in
    ``default_rng(seed).permutation`` order).  (The reference intended an
    80/20 split but wrote 100% to the train CSV; fixed here.)"""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(rows))
    k = int(len(rows) * train_frac)
    columns = table_columns(rows)
    kinds = column_kinds(rows, columns)
    tr = os.path.join(out_dir, "train_metadata.csv")
    te = os.path.join(out_dir, "test_metadata.csv")
    write_csv(tr, [rows[i] for i in perm[:k]], columns, kinds)
    write_csv(te, [rows[i] for i in perm[k:]], columns, kinds)
    return tr, te


def volume_stem(name: str) -> str:
    """Normalize a volume identifier: basename without .npz/.nii/.nii.gz."""
    base = os.path.basename(str(name))
    for suffix in (".nii.gz", ".nii", ".npz", ".gz"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    return base


def metadata_lookup(rows: Iterable[dict]) -> dict[str, dict]:
    """Volume stem -> {slope, intercept, spacing(z,y,x)} resolved once at
    dataset construction (the reference re-reads the CSV per item).  Keys
    are extension-normalized so 'scan0.nii.gz' metadata matches 'scan0.npz'
    volumes.  ``rows``: ``iterrows(read_csv(path))`` or
    ``extract_metadata``'s rows."""
    out = {}
    for row in rows:
        xy = parse_xy_spacing(row["XYSpacing"])
        out[volume_stem(row["VolumeName"])] = {
            "slope": float(row["RescaleSlope"]),
            "intercept": float(row["RescaleIntercept"]),
            "spacing": (float(row["ZSpacing"]), xy, xy),
        }
    return out


def generate_vqa_manifest(
    reports_csv: str,
    image_dir: str,
    out_jsonl: str,
    id_column: str = "impression_id",
    text_column: str = "impressions",
    image_suffix: str = ".npz",
) -> int:
    """reports CSV + image dir -> JSONL {image_id, image_path, report}."""
    n = 0
    with open(out_jsonl, "w") as f:
        for row in iterrows(read_csv(reports_csv)):
            image_id = str(row[id_column])
            path = os.path.join(image_dir, image_id + image_suffix)
            if not os.path.exists(path):
                continue
            f.write(json.dumps({
                "image_id": image_id,
                "image_path": path,
                "report": str(row[text_column]),
            }) + "\n")
            n += 1
    return n


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
