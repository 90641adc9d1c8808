"""COLMAP sparse-model I/O (cameras / images / points3D, .txt and .bin).

The port's own copy of ``edgegaussians_tpu/io/colmap.py`` (NumPy only): the
port imports nothing of the JAX package, so the two stay in step by
tests/test_torch_common.py's parity tests, not by import.

Fresh implementation of the documented COLMAP export formats
(https://colmap.github.io/format.html), covering the read paths the framework
needs (the reference vendors colmap_read_write_model.py for the same purpose —
reference: edgegaussians/utils/colmap_read_write_model.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# model_id -> (name, num_params) per the COLMAP camera-model table
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass(frozen=True)
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass(frozen=True)
class ColmapImage:
    id: int
    qvec: np.ndarray   # wxyz
    tvec: np.ndarray
    camera_id: int
    name: str


@dataclass(frozen=True)
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float


def _data_lines(path):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    cameras = {}
    for line in _data_lines(path):
        el = line.split()
        cam_id = int(el[0])
        cameras[cam_id] = ColmapCamera(
            id=cam_id, model=el[1], width=int(el[2]), height=int(el[3]),
            params=np.array([float(p) for p in el[4:]]))
    return cameras


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cam_id, model_id, width, height = struct.unpack("<iiQQ", f.read(24))
            name, n_params = CAMERA_MODELS[model_id]
            params = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            cameras[cam_id] = ColmapCamera(
                id=cam_id, model=name, width=width, height=height,
                params=np.array(params))
    return cameras


def read_images_text(path) -> Dict[int, ColmapImage]:
    images = {}
    lines = list(_data_lines(path))
    # images.txt alternates pose lines and 2D-point lines
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        im_id = int(el[0])
        images[im_id] = ColmapImage(
            id=im_id,
            qvec=np.array([float(x) for x in el[1:5]]),
            tvec=np.array([float(x) for x in el[5:8]]),
            camera_id=int(el[8]),
            name=el[9])
    return images


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            im_id = struct.unpack("<i", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name_bytes = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name_bytes += c
            (n_pts2d,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n_pts2d, 1)  # skip (x f64, y f64, point3D_id i64)
            images[im_id] = ColmapImage(
                id=im_id, qvec=qvec, tvec=tvec, camera_id=cam_id,
                name=name_bytes.decode("utf-8"))
    return images


def read_points3D_text(path) -> Dict[int, ColmapPoint3D]:
    points = {}
    for line in _data_lines(path):
        el = line.split()
        pid = int(el[0])
        points[pid] = ColmapPoint3D(
            id=pid,
            xyz=np.array([float(x) for x in el[1:4]]),
            rgb=np.array([int(x) for x in el[4:7]], dtype=np.uint8),
            error=float(el[7]))
    return points


def read_points3D_binary(path) -> Dict[int, ColmapPoint3D]:
    points = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            pid = struct.unpack("<Q", f.read(8))[0]
            xyz = np.array(struct.unpack("<3d", f.read(24)))
            rgb = np.array(struct.unpack("<3B", f.read(3)), dtype=np.uint8)
            (error,) = struct.unpack("<d", f.read(8))
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.seek(8 * track_len, 1)  # skip (image_id i32, point2D_idx i32)
            points[pid] = ColmapPoint3D(id=pid, xyz=xyz, rgb=rgb, error=error)
    return points


def points3D_xyz(points: Dict[int, ColmapPoint3D]) -> np.ndarray:
    return np.stack([p.xyz for p in points.values()]) if points else \
        np.zeros((0, 3))


# --- writers (round-trip support; COLMAP text export format) ---------------

def write_cameras_text(cameras: Dict[int, ColmapCamera], path) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cameras.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} "
                    f"{params}\n")


def write_images_text(images: Dict[int, ColmapImage], path) -> None:
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(repr(float(v)) for v in im.qvec)
            t = " ".join(repr(float(v)) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n\n")


def write_points3D_text(points: Dict[int, ColmapPoint3D], path) -> None:
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for p in points.values():
            xyz = " ".join(repr(float(v)) for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            f.write(f"{p.id} {xyz} {rgb} {repr(float(p.error))}\n")
