"""Pure-Python PLY I/O.

The port's own copy of ``edgegaussians_tpu/io/ply.py`` (NumPy only): the
port imports nothing of the JAX package, so the two stay in step by
tests/test_torch_common.py's parity tests, not by import.

Replaces the reference's ``plyfile`` + Open3D usage with a dependency-free
reader/writer. The Gaussian-parameter schema is byte-compatible with the
reference contract so its downstream ``fit_edges.py`` could consume our
training output unchanged: an 11-field little-endian float32 vertex element
``x,y,z,scale1..3,quat1..4,opacity``
(reference: edgegaussians/utils/io_utils.py:4-39).
"""

from __future__ import annotations

import io as _io
from typing import Dict, List, Tuple

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the ``vertex`` element of a PLY file into a dict of 1-D arrays.

    Supports ascii, binary_little_endian, and binary_big_endian formats;
    list properties (e.g. face indices) in trailing elements are ignored.
    """
    with open(path, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    # body starts after the newline terminating 'end_header'
    body_start = data.find(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace")

    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if not elements:
                continue
            if parts[1] == "list":
                elements[-1][2].append(("__list__", " ".join(parts[2:])))
            else:
                elements[-1][2].append((parts[-1], _PLY_TO_NP[parts[1]]))

    if fmt is None or not elements:
        raise ValueError(f"{path}: malformed PLY header")

    name, count, props = elements[0]
    if name != "vertex":
        raise ValueError(f"{path}: first element is {name!r}, expected 'vertex'")
    if any(p[0] == "__list__" for p in props):
        raise ValueError(f"{path}: list properties in vertex element unsupported")

    if fmt == "ascii":
        text = data[body_start:].decode("ascii")
        rows = np.loadtxt(_io.StringIO(text), max_rows=count, ndmin=2)
        return {p[0]: rows[:, i].astype(p[1]) for i, p in enumerate(props)}

    endian = "<" if fmt == "binary_little_endian" else ">"
    dtype = np.dtype([(n, endian + t) for n, t in props])
    arr = np.frombuffer(data, dtype=dtype, count=count, offset=body_start)
    return {n: np.ascontiguousarray(arr[n]) for n, _ in props}


def write_ply(path: str, fields: Dict[str, np.ndarray],
              binary: bool = True) -> None:
    """Write 1-D float32 arrays as a single ``vertex`` element."""
    names = list(fields.keys())
    n = len(next(iter(fields.values())))
    dtype = np.dtype([(name, "<f4") for name in names])
    arr = np.zeros(n, dtype=dtype)
    for name in names:
        v = np.asarray(fields[name]).reshape(-1)
        if len(v) != n:
            raise ValueError("field length mismatch")
        arr[name] = v.astype(np.float32)

    header = ["ply",
              "format binary_little_endian 1.0" if binary else "format ascii 1.0",
              f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header += ["end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(arr.tobytes())
        else:
            np.savetxt(f, np.stack([arr[name] for name in names], axis=1),
                       fmt="%.8g")


def write_gaussian_params_as_ply(means, scales, quats, opacities,
                                 ply_path: str) -> None:
    """Reference-contract Gaussian PLY export (io_utils.py:4-25).

    ``scales`` and ``opacities`` must already be in linear space
    (exp / sigmoid applied — edge_gs.py:635-642).
    """
    means = np.asarray(means); scales = np.asarray(scales)
    quats = np.asarray(quats); opacities = np.asarray(opacities).reshape(-1, 1)
    write_ply(ply_path, {
        "x": means[:, 0], "y": means[:, 1], "z": means[:, 2],
        "scale1": scales[:, 0], "scale2": scales[:, 1], "scale3": scales[:, 2],
        "quat1": quats[:, 0], "quat2": quats[:, 1],
        "quat3": quats[:, 2], "quat4": quats[:, 3],
        "opacity": opacities[:, 0],
    })


def read_gaussian_params_from_ply(ply_path: str):
    """Inverse of :func:`write_gaussian_params_as_ply` (io_utils.py:29-39)."""
    d = read_ply(ply_path)
    pos = np.stack([d["x"], d["y"], d["z"]], axis=1)
    scales = np.stack([d["scale1"], d["scale2"], d["scale3"]], axis=1)
    quats = np.stack([d["quat1"], d["quat2"], d["quat3"], d["quat4"]], axis=1)
    opacities = d["opacity"][:, None]
    return pos, scales, quats, opacities


def write_pts_with_major_dirs_as_ply(pos, dirs, ply_path: str) -> None:
    """Points + major directions PLY (io_utils.py:41-58)."""
    pos = np.asarray(pos); dirs = np.asarray(dirs)
    write_ply(ply_path, {
        "x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2],
        "dir_x": dirs[:, 0], "dir_y": dirs[:, 1], "dir_z": dirs[:, 2],
    })


def read_pts_with_major_dirs_from_ply(ply_path: str):
    d = read_ply(ply_path)
    pos = np.stack([d["x"], d["y"], d["z"]], axis=1)
    dirs = np.stack([d["dir_x"], d["dir_y"], d["dir_z"]], axis=1)
    return pos, dirs


def read_point_cloud(ply_path: str) -> np.ndarray:
    """Read just xyz from a PLY point cloud (replaces o3d.io.read_point_cloud)."""
    d = read_ply(ply_path)
    return np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float64)


def write_point_cloud(ply_path: str, points: np.ndarray) -> None:
    points = np.asarray(points)
    write_ply(ply_path, {"x": points[:, 0], "y": points[:, 1], "z": points[:, 2]})
