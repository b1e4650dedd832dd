"""RIEGL RDBX scanner-format reading for offline data preparation.

Port of the read side of the JAX package's ``dataset/rdb_tools.py``:
chunked attribute reads (``RDB_import``), the bounding-box database's
read and its JSON export (``BBX_HANDLER``), and the npy/JSON glue between
box dicts and the ``_bbx.npy`` disk contract.  The vendor ``riegl.rdb``
binding is not redistributable: every RDBX entry point raises
``ImportError`` without it, and the npy/JSON helpers work without it.
The RDBX writers (``RDB_export``, ``BBX_HANDLER.create_BBX`` /
``insert_BBX``) are not ported.
"""

import json
import os

import numpy as np


def _require_riegl():
    try:
        import riegl.rdb  # noqa: F401

        return __import__("riegl.rdb", fromlist=["rdb"])
    except ImportError as e:  # pragma: no cover - vendor library
        raise ImportError(
            "riegl.rdb (vendor RDBX binding) is required for RDBX I/O; "
            "install RIEGL's RDB library to use this offline tool") from e


class RDB_import:
    """Chunked RDBX attribute reader: ``riegl.xyz`` plus any further
    univariate attributes under an optional selection condition, as an
    (N, 3+A) matrix and the file's geo tag."""

    def __init__(self, filepath, attributes, condition, chunk_size,
                 only_xyz=False):
        if not (isinstance(filepath, str) and os.path.exists(filepath)):
            raise FileNotFoundError(f"RDBX file {filepath!r} does not exist")
        if not (isinstance(attributes, list) and attributes):
            raise ValueError("attributes has to be a non-empty list of "
                             "strings")
        if not isinstance(condition, str):
            raise TypeError("condition has to be a string")
        if not isinstance(chunk_size, int):
            raise TypeError("chunk_size has to be an int")
        self.path = filepath
        self.attributes = attributes
        self.condition = condition
        self.chunk_size = chunk_size
        self.only_xyz = bool(only_xyz)

    def get_features(self):
        rdb_mod = _require_riegl()
        with rdb_mod.rdb.rdb_open(self.path) as rdb:
            xyz_chunks, attr_chunks = [], []
            for points in rdb.select(selection=self.condition,
                                     attributes=self.attributes,
                                     chunk_size=self.chunk_size):
                xyz_chunks.append(np.asarray(points["riegl.xyz"],
                                             np.float64))
                if not self.only_xyz:
                    attr_chunks.append(np.stack(
                        [np.asarray(points[a], np.float64)
                         for a in self.attributes[1:]], axis=-1))
            gtag = rdb.meta_data["riegl.geo_tag"]

        xyz = (np.concatenate(xyz_chunks, 0) if xyz_chunks
               else np.zeros((0, 3)))
        if self.only_xyz:
            return xyz, gtag
        attrs = (np.concatenate(attr_chunks, 0) if attr_chunks
                 else np.zeros((0, len(self.attributes) - 1)))
        return np.concatenate([xyz, attrs], axis=1), gtag


_BBX_ATTRS = ["riegl.bbx_angle_a", "riegl.bbx_angle_b", "riegl.bbx_angle_c",
              "riegl.bbx_length_a", "riegl.bbx_length_b",
              "riegl.bbx_length_c"]


class BBX_HANDLER:
    """Bounding-box database read and JSON export."""

    def __init__(self, filepath):
        if not isinstance(filepath, str):
            raise TypeError("BBX file path has to be a string")
        self.path = filepath

    def _read_raw(self):
        rdb_mod = _require_riegl()
        with rdb_mod.rdb.rdb_open(self.path) as rdb:
            bbx = []
            for points in rdb.select(
                    "", ["riegl.xyz", "riegl.id"] + _BBX_ATTRS[3:]
                    + _BBX_ATTRS[:3], chunk_size=1):
                def value(name):
                    return np.asarray(points[name]).squeeze().tolist()

                bbx.append({
                    "id": value("riegl.id"),
                    "center": value("riegl.xyz"),
                    "length_x": value("riegl.bbx_length_a"),
                    "length_y": value("riegl.bbx_length_b"),
                    "length_z": value("riegl.bbx_length_c"),
                    "angle_x": value("riegl.bbx_angle_a"),
                    "angle_y": value("riegl.bbx_angle_b"),
                    "angle_z": value("riegl.bbx_angle_c"),
                })
        return bbx

    def bbx_json_convert(self):
        """Write the boxes as a list of dicts to ``<path stem>.json``."""
        bbx_list = self._read_raw()
        out = "{}.json".format(self.path.split(".")[0])
        with open(out, mode="w", encoding="utf-8") as f:
            json.dump(bbx_list, f)

    def collect_bbx_data(self):
        return self._read_raw()


# --- npy/json glue (works without riegl.rdb) ---------------------------

def bbx_dicts_to_npy(bbx_list):
    """BBX dicts -> the `_bbx.npy` (M, 9) disk contract
    (x, y, z_center, dx, dy, dz, rx_deg, ry_deg, rz_deg)."""
    rows = []
    for b in bbx_list:
        rows.append(list(b["center"])
                    + [b["length_x"], b["length_y"], b["length_z"],
                       b["angle_x"], b["angle_y"], b["angle_z"]])
    return np.asarray(rows, np.float64).reshape(-1, 9)


def npy_to_bbx_dicts(boxes):
    """(M, 9) disk-contract boxes -> BBX dicts."""
    out = []
    for i, b in enumerate(np.asarray(boxes).reshape(-1, 9)):
        out.append({
            "id": i,
            "center": [float(b[0]), float(b[1]), float(b[2])],
            "length_x": float(b[3]), "length_y": float(b[4]),
            "length_z": float(b[5]),
            "angle_x": float(b[6]), "angle_y": float(b[7]),
            "angle_z": float(b[8]),
        })
    return out
