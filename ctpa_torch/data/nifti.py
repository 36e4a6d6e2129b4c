"""Pure-Python NIfTI-1 reader/writer (an own copy of ``ctpa/data/nifti.py``;
the port imports nothing of ``ctpa``).

The reference ingests scans with nibabel (preprocess_train.py:22-29:
`nib.load(...).get_fdata()`); nibabel is not part of this environment, and the
subset of NIfTI-1 needed for CT volumes is small, so the parser lives here:
348-byte header (both endiannesses), gzip transparently handled, scl_slope/
scl_inter rescaling, voxel spacing from pixdim.  The writer exists for tests
and for the preprocess CLI's roundtrip checks.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from typing import BinaryIO

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64, 1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class NiftiImage:
    data: np.ndarray                 # raw stored values (apply slope/inter yourself
                                     # or use get_fdata)
    spacing: tuple[float, ...]       # voxel size per dim (x, y, z) mm
    scl_slope: float
    scl_inter: float

    def get_fdata(self) -> np.ndarray:
        """Float data with slope/intercept applied (nibabel get_fdata parity)."""
        slope = self.scl_slope if self.scl_slope not in (0.0,) else 1.0
        return self.data.astype(np.float64) * slope + self.scl_inter

    @property
    def shape(self):
        return self.data.shape


def to_canonical(img: "NiftiImage", *, reference_orientation: bool = False
                 ) -> tuple[np.ndarray, tuple[float, float, float]]:
    """The ONE NIfTI -> canonical (z, y, x) orientation operator, shared by
    the offline CLI (cli/preprocess.py) and the serving ingest
    (data/ingest.load_scan) so both paths produce identically-oriented
    volumes (SURVEY §3.5: one canonical preprocessing operator).

    NIfTI stores data and spacing as (x, y, z); the canonical order is the
    axis-true transpose (2, 1, 0) -> (z, y, x) with spacing reordered the
    same way.  `reference_orientation=True` reproduces the reference's
    (2, 0, 1) transpose — (z, x, y), preprocess_train.py:104 — for
    bit-parity runs against reference-preprocessed data; the two differ
    only on asymmetric in-plane grids (the reference's own 480x480 slices
    are square, which is how the bug survived there).

    Returns (volume raw stored values, (z, y, x) spacing)."""
    perm = (2, 0, 1) if reference_orientation else (2, 1, 0)
    sp = img.spacing + (1.0, 1.0, 1.0)
    z_sp = sp[2] if len(img.spacing) > 2 else 1.0
    in_plane = (sp[0], sp[1]) if reference_orientation else (sp[1], sp[0])
    return np.transpose(img.data, perm), (z_sp, in_plane[0], in_plane[1])


def _open_maybe_gz(path: str) -> BinaryIO:
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.open(f)  # type: ignore[return-value]
    return f


def load(path: str) -> NiftiImage:
    with _open_maybe_gz(path) as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        endian = "<"
        if sizeof_hdr != 348:
            sizeof_hdr = struct.unpack(">i", hdr[0:4])[0]
            endian = ">"
            if sizeof_hdr != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
        magic = hdr[344:348]
        if magic[:3] not in (b"n+1", b"ni1"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

        dim = struct.unpack(endian + "8h", hdr[40:56])
        ndim = dim[0]
        if not 1 <= ndim <= 7:
            raise ValueError(f"{path}: bad ndim {ndim}")
        shape = tuple(int(d) for d in dim[1 : 1 + ndim])
        datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        if datatype not in _DTYPES:
            raise ValueError(f"{path}: unsupported datatype code {datatype}")
        dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
        pixdim = struct.unpack(endian + "8f", hdr[76:108])
        vox_offset = struct.unpack(endian + "f", hdr[108:112])[0]
        scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
        scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]

        f.seek(int(vox_offset))
        count = int(np.prod(shape))
        buf = f.read(count * dtype.itemsize)
        if len(buf) < count * dtype.itemsize:
            raise ValueError(f"{path}: truncated voxel data")
        data = np.frombuffer(buf, dtype=dtype, count=count).reshape(shape, order="F")

    spacing = tuple(float(p) for p in pixdim[1 : 1 + ndim])
    return NiftiImage(data=data, spacing=spacing, scl_slope=float(scl_slope),
                      scl_inter=float(scl_inter))


def save(
    path: str,
    data: np.ndarray,
    spacing: tuple[float, ...] = (1.0, 1.0, 1.0),
    scl_slope: float = 1.0,
    scl_inter: float = 0.0,
):
    """Minimal single-file (.nii / .nii.gz) NIfTI-1 writer."""
    data = np.ascontiguousarray(data)
    code = _CODES.get(np.dtype(data.dtype.newbyteorder("=")))
    if code is None:
        raise ValueError(f"unsupported dtype {data.dtype}")
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    pixdim = [0.0] + list(spacing) + [0.0] * (7 - len(spacing))

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)   # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)                    # vox_offset
    struct.pack_into("<f", hdr, 112, scl_slope)
    struct.pack_into("<f", hdr, 116, scl_inter)
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(data).tobytes(order="F")
    if path.endswith(".gz"):
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
