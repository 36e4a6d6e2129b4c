"""Pure-Python DICOM series reader/writer (CT), an own copy of
``ctpa/data/dicom.py`` (the port imports nothing of ``ctpa``).

The reference ingests NIfTI only (preprocess_train.py:22-29); BASELINE
config 5 asks for DICOM ingest, which neither the reference nor round 1
shipped.  pydicom is not in this environment and the subset needed for CT
series is small, so — like `data/nifti.py` — the parser lives here:

  * Part-10 files (128-byte preamble + 'DICM' + group-0002 meta) and bare
    datasets, Explicit and Implicit VR Little Endian transfer syntaxes
    (compressed syntaxes raise, loudly — no silent fallback, per the
    framework's failure posture).
  * Pixel data (16-bit signed/unsigned, MONOCHROME), RescaleSlope/Intercept,
    PixelSpacing / SliceThickness / SpacingBetweenSlices tags.
  * Slice ordering by ImagePositionPatient projected on the slice normal
    (from ImageOrientationPatient), falling back to InstanceNumber; z spacing
    from adjacent projected positions (the geometric truth), falling back to
    SpacingBetweenSlices then SliceThickness.

The writer produces Explicit-VR-LE files for tests and synthetic fixtures.
`load_series(dir)` returns the volume as raw stored values in (z, y, x) order
plus (slope, intercept, spacing) — the same contract the NIfTI path feeds
into `ctpa_torch.ops.preprocess.preprocess_volume`.
"""

from __future__ import annotations

import math
import os
import struct
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
IMPLICIT_VR_LE = "1.2.840.10008.1.2"

# tags we parse: (group, element) -> (name, implicit-VR fallback)
_TAGS = {
    (0x0002, 0x0010): ("TransferSyntaxUID", "UI"),
    (0x0008, 0x0018): ("SOPInstanceUID", "UI"),
    (0x0018, 0x0050): ("SliceThickness", "DS"),
    (0x0018, 0x0088): ("SpacingBetweenSlices", "DS"),
    (0x0020, 0x000E): ("SeriesInstanceUID", "UI"),
    (0x0020, 0x0013): ("InstanceNumber", "IS"),
    (0x0020, 0x0032): ("ImagePositionPatient", "DS"),
    (0x0020, 0x0037): ("ImageOrientationPatient", "DS"),
    (0x0028, 0x0010): ("Rows", "US"),
    (0x0028, 0x0011): ("Columns", "US"),
    (0x0028, 0x0030): ("PixelSpacing", "DS"),
    (0x0028, 0x0100): ("BitsAllocated", "US"),
    (0x0028, 0x0103): ("PixelRepresentation", "US"),
    (0x0028, 0x1052): ("RescaleIntercept", "DS"),
    (0x0028, 0x1053): ("RescaleSlope", "DS"),
    (0x7FE0, 0x0010): ("PixelData", "OW"),
}
_NAME_TO_TAG = {v[0]: k for k, v in _TAGS.items()}

# VRs whose explicit form uses a 2-byte reserved field + 4-byte length
_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR", b"UT", b"UN"}


@dataclass
class DicomSlice:
    """One parsed file; `values` holds decoded tag values by name."""

    values: dict
    pixels: Optional[np.ndarray]  # (rows, cols) raw stored values


@dataclass
class DicomSeries:
    data: np.ndarray                 # (z, y, x) raw stored values
    spacing: tuple[float, float, float]   # (z, y, x) mm
    slope: float
    intercept: float

    def get_fdata(self) -> np.ndarray:
        """HU volume: slope * stored + intercept (DICOM rescale semantics,
        mirrors NiftiImage.get_fdata)."""
        return self.data.astype(np.float64) * self.slope + self.intercept

    @property
    def shape(self):
        return self.data.shape


def _decode(vr: str, raw: bytes):
    if vr in ("DS", "IS"):
        parts = raw.decode("ascii", "ignore").strip("\x00 ").split("\\")
        parts = [p for p in (q.strip() for q in parts) if p]
        nums = [float(p) for p in parts] if vr == "DS" else [int(p) for p in parts]
        return nums[0] if len(nums) == 1 else nums
    if vr == "US":
        return struct.unpack(f"<{len(raw) // 2}H", raw)[0]
    if vr == "UL":
        return struct.unpack("<I", raw[:4])[0]
    if vr in ("UI", "SH", "LO", "CS", "PN", "DA", "TM", "AE", "AS", "LT", "ST"):
        return raw.decode("ascii", "ignore").rstrip("\x00 ")
    return raw


def _parse_dataset(buf: bytes, pos: int, explicit: bool,
                   stop_after_pixels: bool = True) -> dict:
    out: dict = {}
    n = len(buf)
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        pos += 4
        if explicit or group == 0x0002:  # meta group is always explicit LE
            vr = buf[pos:pos + 2]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                pos += 4
            vr_s = vr.decode("ascii", "ignore")
        else:
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
            vr_s = _TAGS.get((group, elem), ("", "UN"))[1]
        if length == 0xFFFFFFFF:
            raise ValueError(
                "undefined-length element (encapsulated/compressed pixel data "
                "or sequence) — only uncompressed LE transfer syntaxes are "
                "supported")
        raw = buf[pos:pos + length]
        pos += length
        tag = (group, elem)
        if tag in _TAGS:
            name = _TAGS[tag][0]
            if name == "PixelData":
                out[name] = raw
                if stop_after_pixels:
                    break
            else:
                out[name] = _decode(vr_s, raw)
    return out


def load_file(path: str) -> DicomSlice:
    """Parse one DICOM file into the tags the CT pipeline needs."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    ts = EXPLICIT_VR_LE
    if len(buf) > 132 and buf[128:132] == b"DICM":
        pos = 132
        # meta group (0002) is explicit LE; parse until the group changes
        end = pos
        meta: dict = {}
        while end + 8 <= len(buf):
            group = struct.unpack_from("<H", buf, end)[0]
            if group != 0x0002:
                break
            g, e = struct.unpack_from("<HH", buf, end)
            vr = buf[end + 4:end + 6]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, end + 8)[0]
                vstart = end + 12
            else:
                length = struct.unpack_from("<H", buf, end + 6)[0]
                vstart = end + 8
            if (g, e) in _TAGS:
                meta[_TAGS[(g, e)][0]] = _decode(vr.decode("ascii", "ignore"),
                                                 buf[vstart:vstart + length])
            end = vstart + length
        pos = end
        ts = meta.get("TransferSyntaxUID", EXPLICIT_VR_LE)
    if ts not in (EXPLICIT_VR_LE, IMPLICIT_VR_LE):
        raise ValueError(f"{path}: unsupported transfer syntax {ts!r} "
                         "(only uncompressed little-endian is supported)")
    values = _parse_dataset(buf, pos, explicit=(ts == EXPLICIT_VR_LE))

    pixels = None
    if "PixelData" in values:
        rows, cols = int(values.get("Rows", 0)), int(values.get("Columns", 0))
        bits = int(values.get("BitsAllocated", 16))
        signed = int(values.get("PixelRepresentation", 0)) == 1
        if bits == 16:
            dt = np.int16 if signed else np.uint16
        elif bits == 8:
            dt = np.int8 if signed else np.uint8
        else:
            raise ValueError(f"{path}: unsupported BitsAllocated={bits}")
        arr = np.frombuffer(values.pop("PixelData"), dtype=dt,
                            count=rows * cols)
        pixels = arr.reshape(rows, cols)
    return DicomSlice(values=values, pixels=pixels)


def _slice_position(values: dict) -> Optional[float]:
    """Projection of ImagePositionPatient on the slice normal (the DICOM-
    correct through-plane coordinate); None if geometry tags are absent."""
    ipp = values.get("ImagePositionPatient")
    if not isinstance(ipp, list) or len(ipp) != 3:
        return None
    iop = values.get("ImageOrientationPatient")
    if isinstance(iop, list) and len(iop) == 6:
        r, c = iop[:3], iop[3:]
        normal = (r[1] * c[2] - r[2] * c[1],
                  r[2] * c[0] - r[0] * c[2],
                  r[0] * c[1] - r[1] * c[0])
        nn = math.sqrt(sum(x * x for x in normal)) or 1.0
        return sum(p * q for p, q in zip(ipp, normal)) / nn
    return float(ipp[2])


def find_series_files(directory: str) -> list[str]:
    """All DICOM files directly in `directory` (by .dcm suffix or DICM magic)."""
    out = []
    for f in sorted(os.listdir(directory)):
        p = os.path.join(directory, f)
        if not os.path.isfile(p):
            continue
        if f.lower().endswith(".dcm"):
            out.append(p)
            continue
        with open(p, "rb") as fh:
            head = fh.read(132)
        if len(head) == 132 and head[128:132] == b"DICM":
            out.append(p)
    return out


def load_series(directory: str) -> DicomSeries:
    """Read a single-series directory into a (z, y, x) volume.

    Slices sort by through-plane position (fallback InstanceNumber); the
    z spacing is the median adjacent position delta (fallback
    SpacingBetweenSlices, then SliceThickness, then 1.0)."""
    files = find_series_files(directory)
    if not files:
        raise FileNotFoundError(f"no DICOM files in {directory}")
    slices = [load_file(p) for p in files]
    slices = [s for s in slices if s.pixels is not None]
    if not slices:
        raise ValueError(f"{directory}: no slices with pixel data")
    series_ids = {s.values.get("SeriesInstanceUID") for s in slices}
    if len(series_ids - {None}) > 1:
        raise ValueError(f"{directory}: multiple series {series_ids}")

    positions = [_slice_position(s.values) for s in slices]
    if all(p is not None for p in positions):
        order = np.argsort(positions)
        sorted_pos = np.asarray(positions, float)[order]
        dz_candidates = np.abs(np.diff(sorted_pos))
        dz = float(np.median(dz_candidates)) if len(dz_candidates) else 0.0
    else:
        order = np.argsort([
            int(s.values.get("InstanceNumber", i)) for i, s in enumerate(slices)])
        dz = 0.0
    slices = [slices[i] for i in order]

    first = slices[0].values
    if dz <= 0.0:
        dz = float(first.get("SpacingBetweenSlices",
                             first.get("SliceThickness", 1.0)) or 1.0)
    ps = first.get("PixelSpacing", [1.0, 1.0])
    if not isinstance(ps, list):
        ps = [float(ps), float(ps)]
    slope = float(first.get("RescaleSlope", 1.0) or 1.0)
    intercept = float(first.get("RescaleIntercept", 0.0))

    shapes = {s.pixels.shape for s in slices}
    if len(shapes) > 1:
        raise ValueError(f"{directory}: inconsistent slice shapes {shapes}")
    vol = np.stack([s.pixels for s in slices], axis=0)
    return DicomSeries(data=vol, spacing=(dz, float(ps[0]), float(ps[1])),
                       slope=slope, intercept=intercept)


# ------------------------------------------------------------------ writer


def _encode_element(group: int, elem: int, vr: str, value) -> bytes:
    if vr in ("DS", "IS"):
        vals = value if isinstance(value, (list, tuple)) else [value]
        s = "\\".join(
            (f"{v:g}" if vr == "DS" else str(int(v))) for v in vals)
        raw = s.encode("ascii")
    elif vr == "US":
        raw = struct.pack("<H", int(value))
    elif vr == "UI":
        raw = str(value).encode("ascii")
    elif vr in ("OW", "OB"):
        raw = bytes(value)
    elif vr == "UL":
        raw = struct.pack("<I", int(value))
    else:
        raise ValueError(f"writer does not support VR {vr}")
    if len(raw) % 2:
        raw += b"\x00" if vr in ("OW", "OB") else b" "
    head = struct.pack("<HH", group, elem) + vr.encode("ascii")
    if vr.encode("ascii") in _LONG_VRS:
        head += b"\x00\x00" + struct.pack("<I", len(raw))
    else:
        head += struct.pack("<H", len(raw))
    return head + raw


def save_slice(path: str, pixels: np.ndarray, *, slice_index: int,
               position_z: float, pixel_spacing: tuple[float, float],
               slice_thickness: float, slope: float = 1.0,
               intercept: float = 0.0, series_uid: str = "1.2.3.4") -> None:
    """Write one Explicit-VR-LE Part-10 CT slice (tests/fixtures)."""
    pixels = np.ascontiguousarray(pixels, np.int16)
    meta = _encode_element(0x0002, 0x0010, "UI", EXPLICIT_VR_LE)
    meta = (_encode_element(0x0002, 0x0000, "UL", len(meta)) + meta)
    body = b"".join([
        _encode_element(0x0008, 0x0018, "UI", f"{series_uid}.{slice_index}"),
        _encode_element(0x0018, 0x0050, "DS", slice_thickness),
        _encode_element(0x0020, 0x000E, "UI", series_uid),
        _encode_element(0x0020, 0x0013, "IS", slice_index),
        _encode_element(0x0020, 0x0032, "DS", [0.0, 0.0, position_z]),
        _encode_element(0x0020, 0x0037, "DS", [1, 0, 0, 0, 1, 0]),
        _encode_element(0x0028, 0x0010, "US", pixels.shape[0]),
        _encode_element(0x0028, 0x0011, "US", pixels.shape[1]),
        _encode_element(0x0028, 0x0030, "DS", list(pixel_spacing)),
        _encode_element(0x0028, 0x0100, "US", 16),
        _encode_element(0x0028, 0x0103, "US", 1),
        _encode_element(0x0028, 0x1052, "DS", intercept),
        _encode_element(0x0028, 0x1053, "DS", slope),
        _encode_element(0x7FE0, 0x0010, "OW", pixels.astype("<i2").tobytes()),
    ])
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def save_series(directory: str, volume: np.ndarray,
                spacing: tuple[float, float, float],
                slope: float = 1.0, intercept: float = 0.0,
                shuffle: bool = False) -> list[str]:
    """Write a (z, y, x) volume as one slice file per z (tests/fixtures).
    `shuffle=True` writes files in scrambled order to exercise position-based
    sorting."""
    os.makedirs(directory, exist_ok=True)
    dz, dy, dx = spacing
    idxs: Iterable[int] = range(volume.shape[0])
    if shuffle:
        idxs = list(idxs)
        rng = np.random.default_rng(0)
        rng.shuffle(idxs)
    paths = []
    for file_no, z in enumerate(idxs):
        p = os.path.join(directory, f"slice_{file_no:04d}.dcm")
        save_slice(p, volume[z], slice_index=z + 1, position_z=z * dz,
                   pixel_spacing=(dy, dx), slice_thickness=dz,
                   slope=slope, intercept=intercept)
        paths.append(p)
    return paths
