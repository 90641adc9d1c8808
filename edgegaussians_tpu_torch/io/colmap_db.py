"""COLMAP SQLite database I/O.

The port's own copy of ``edgegaussians_tpu/io/colmap_db.py`` (NumPy and
sqlite3 only): the port imports nothing of the JAX package, so the two
stay in step by tests/test_torch_common.py's parity tests, not by import.

Counterpart of the reference's ``edgegaussians/utils/colmap_database.py``
(dead code there — imported nowhere — but part of its component inventory).
Implements the public COLMAP database schema
(https://colmap.github.io/database.html) with the handful of operations an
edge-reconstruction pipeline needs: registering cameras/images and reading
or writing keypoints/matches. Arrays are stored as raw little-endian blobs,
matching COLMAP's on-disk convention, so databases written here open in
COLMAP and vice versa.
"""

from __future__ import annotations

import sqlite3
from typing import Optional, Tuple

import numpy as np

MAX_IMAGE_ID = 2 ** 31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < {maxid}),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
""".format(maxid=MAX_IMAGE_ID)


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    """COLMAP's symmetric pair key (order-independent)."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int) -> Tuple[int, int]:
    image_id2 = pair_id % MAX_IMAGE_ID
    return (pair_id - image_id2) // MAX_IMAGE_ID, image_id2


def array_to_blob(array: np.ndarray) -> bytes:
    return np.ascontiguousarray(array).tobytes()


def blob_to_array(blob: Optional[bytes], dtype, shape=(-1,)) -> np.ndarray:
    if blob is None:
        return np.zeros(shape if -1 not in shape else (0,), dtype=dtype)
    return np.frombuffer(blob, dtype=dtype).reshape(*shape)


class ColmapDatabase:
    """Thin typed wrapper over a COLMAP ``database.db``."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)

    # --- lifecycle -------------------------------------------------------
    def commit(self):
        self.conn.commit()

    def close(self):
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.commit()
        self.close()

    # --- writers ---------------------------------------------------------
    def add_camera(self, model: int, width: int, height: int,
                   params, prior_focal_length: bool = False,
                   camera_id: Optional[int] = None) -> int:
        params = np.asarray(params, np.float64)
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model, width, height, array_to_blob(params),
             int(prior_focal_length)))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int,
                  prior_q=(np.nan,) * 4, prior_t=(np.nan,) * 3,
                  image_id: Optional[int] = None) -> int:
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *map(float, prior_q),
             *map(float, prior_t)))
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray):
        keypoints = np.asarray(keypoints, np.float32)
        assert keypoints.ndim == 2 and keypoints.shape[1] in (2, 4, 6)
        self.conn.execute(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, *keypoints.shape, array_to_blob(keypoints)))

    def add_descriptors(self, image_id: int, descriptors: np.ndarray):
        descriptors = np.asarray(descriptors, np.uint8)
        self.conn.execute(
            "INSERT INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, *descriptors.shape, array_to_blob(descriptors)))

    def add_matches(self, image_id1: int, image_id2: int,
                    matches: np.ndarray):
        matches = np.asarray(matches, np.uint32)
        assert matches.ndim == 2 and matches.shape[1] == 2
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        self.conn.execute(
            "INSERT INTO matches VALUES (?, ?, ?, ?)",
            (image_ids_to_pair_id(image_id1, image_id2), *matches.shape,
             array_to_blob(matches)))

    def add_two_view_geometry(self, image_id1: int, image_id2: int,
                              matches: np.ndarray, F=np.eye(3), E=np.eye(3),
                              H=np.eye(3), config: int = 2):
        matches = np.asarray(matches, np.uint32)
        if image_id1 > image_id2:
            matches = matches[:, ::-1]
        qvec = np.array([1.0, 0, 0, 0], np.float64)
        tvec = np.zeros(3, np.float64)
        self.conn.execute(
            "INSERT INTO two_view_geometries VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_ids_to_pair_id(image_id1, image_id2), *matches.shape,
             array_to_blob(matches), config,
             array_to_blob(np.asarray(F, np.float64)),
             array_to_blob(np.asarray(E, np.float64)),
             array_to_blob(np.asarray(H, np.float64)),
             array_to_blob(qvec), array_to_blob(tvec)))

    # --- readers ---------------------------------------------------------
    def cameras(self):
        """{camera_id: (model, width, height, params[np.float64])}"""
        out = {}
        for cid, model, w, h, params, _ in self.conn.execute(
                "SELECT * FROM cameras"):
            out[cid] = (model, w, h, blob_to_array(params, np.float64))
        return out

    def images(self):
        """{image_id: (name, camera_id)}"""
        return {row[0]: (row[1], row[2]) for row in
                self.conn.execute(
                    "SELECT image_id, name, camera_id FROM images")}

    def keypoints(self, image_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (image_id,)).fetchone()
        if row is None:
            return np.zeros((0, 2), np.float32)
        return blob_to_array(row[2], np.float32, (row[0], row[1]))

    def matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        pair = image_ids_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?",
            (pair,)).fetchone()
        if row is None or row[0] == 0:
            return np.zeros((0, 2), np.uint32)
        m = blob_to_array(row[2], np.uint32, (row[0], row[1]))
        return m[:, ::-1] if image_id1 > image_id2 else m
