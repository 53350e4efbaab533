"""Point-cloud array (de)serialization.

A copy of cslam_tpu/utils/pointcloud.py (numpy only; the port imports
nothing of the reference package). It stands in for the Swarm-SLAM
reference's vendored ROS PointCloud2 numpy codec with a native array
format: a small header (field names/types) + contiguous
float32 records. Covers the operations the reference uses: field-filtered
read to an (N, 3) xyz array and cloud creation from arrays.
"""

import io
import struct
from typing import List, Optional, Sequence

import numpy as np

_MAGIC = b"CSPC"


def create_cloud(points: np.ndarray,
                 fields: Sequence[str] = ("x", "y", "z")) -> bytes:
    """Pack an (N, F) float32 array with named fields."""
    points = np.ascontiguousarray(points, dtype=np.float32)
    if points.ndim != 2 or points.shape[1] != len(fields):
        raise ValueError(f"points {points.shape} vs fields {fields}")
    buf = io.BytesIO()
    buf.write(_MAGIC)
    name_blob = ",".join(fields).encode()
    buf.write(struct.pack("<II", len(name_blob), points.shape[0]))
    buf.write(name_blob)
    buf.write(points.tobytes())
    return buf.getvalue()


def read_points_numpy_filtered(
        data: bytes,
        field_names: Optional[Sequence[str]] = ("x", "y", "z"),
        skip_nans: bool = True) -> np.ndarray:
    """Unpack selected fields to an (N, len(field_names)) float32 array
    (point_cloud2.read_points_numpy_filtered semantics: optional NaN
    row filtering)."""
    buf = io.BytesIO(data)
    if buf.read(4) != _MAGIC:
        raise ValueError("not a cslam pointcloud blob")
    name_len, n = struct.unpack("<II", buf.read(8))
    names = buf.read(name_len).decode().split(",")
    arr = np.frombuffer(buf.read(4 * n * len(names)),
                        dtype=np.float32).reshape(n, len(names))
    if field_names is not None:
        cols = [names.index(f) for f in field_names]
        arr = arr[:, cols]
    if skip_nans and len(arr):
        arr = arr[~np.isnan(arr).any(axis=1)]
    return arr.copy()
