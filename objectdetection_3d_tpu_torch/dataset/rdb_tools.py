"""RIEGL RDBX scanner-format reading and writing for offline data
preparation.

Port of the JAX package's ``dataset/rdb_tools.py``: chunked attribute
reads (``RDB_import``), RDBX creation with custom per-point attributes
(``RDB_export``), the bounding-box database's read, JSON export, creation
and insertion (``BBX_HANDLER``), and the npy/JSON glue between box dicts
and the ``_bbx.npy`` disk contract.  The vendor ``riegl.rdb`` binding is
not redistributable: every RDBX entry point raises ``ImportError``
without it, and the npy/JSON helpers work without it.
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


def _xyz_settings(rdbp, context, chunk_size, compression_level):
    """Create settings whose primary attribute is ``riegl.xyz`` (metres,
    0.25 mm resolution, +-535 km)."""
    settings = rdbp.CreateSettings(context)
    pa = settings.primary_attribute
    pa.name = "riegl.xyz"
    pa.title = "XYZ"
    pa.description = "Cartesian point coordinates"
    pa.unit_symbol = "m"
    pa.length = 3
    pa.resolution = 0.00025
    pa.minimum_value = -535000.0
    pa.maximum_value = +535000.0
    pa.default_value = 0.0
    pa.storage_class = rdbp.PointAttribute.StorageClass.VARIABLE
    settings.chunk_size = chunk_size
    settings.compression_level = compression_level
    return settings


def _scalar_attribute(rdb, rdbp, name, description, unit, resolution,
                      limits):
    """A univariate point attribute ``name`` with its range ``limits``."""
    var = rdbp.PointAttribute(rdb)
    var.name = name
    var.title = name
    var.description = description
    var.unit_symbol = unit
    var.length = 1
    var.resolution = resolution
    var.minimum_value = limits[0]
    var.maximum_value = limits[1]
    var.default_value = 0.0
    var.storage_class = rdbp.PointAttribute.StorageClass.VARIABLE
    return var


class RDB_export:
    """RDBX writer with custom per-point attributes.

    Args:
        filepath: the RDBX file to create.
        attributes: ``{"BuiltIn": [...], "Custom": [...]}``, the built-in
            list starting with ``riegl.xyz``.
        attributes_dtype: the same two keys, each ``{name: numpy dtype}``.
        attributes_matrix: (N, 3 + A) xyz then the attributes' columns.
        chunk_size: points per insert.
        geo_tag: the file's ``riegl.geo_tag``.
    """

    def __init__(self, filepath, attributes, attributes_dtype,
                 attributes_matrix, chunk_size, geo_tag):
        if not isinstance(filepath, str):
            raise TypeError("output path has to be a string")
        if not (isinstance(attributes, dict) and len(attributes) == 2
                and isinstance(attributes.get("BuiltIn"), list)
                and isinstance(attributes.get("Custom"), list)
                and attributes["BuiltIn"]):
            raise ValueError("attributes has to be {'BuiltIn': [...], "
                             "'Custom': [...]} with built-ins")
        if not (isinstance(attributes_matrix, np.ndarray)
                and attributes_matrix.ndim == 2):
            raise ValueError("attributes_matrix has to be a 2-D array")
        if not isinstance(chunk_size, int):
            raise TypeError("chunk_size has to be an int")
        self.path = filepath
        self.attributes = attributes
        self.attributes_dtype = attributes_dtype
        self.mat = attributes_matrix
        self.chunk_size = chunk_size
        self.gtag = geo_tag

    @staticmethod
    def chunk(mat, n):
        """The rows of ``mat`` in blocks of ``n``."""
        for i in range(0, mat.shape[0], n):
            yield mat[i:i + n, :]

    def create_RDB(self):
        """Write the matrix's points with every attribute, then the geo
        tag, in one transaction."""
        rdbp = _require_riegl().rdb
        context = rdbp.Context()
        rdb = rdbp.Pointcloud(context)
        rdb.create(self.path, _xyz_settings(rdbp, context, 50000, 50))

        attr_list = self.attributes["BuiltIn"] + self.attributes["Custom"]
        data_types = {**self.attributes_dtype["BuiltIn"],
                      **self.attributes_dtype["Custom"]}
        with rdbp.Transaction(rdb, "Initialization",
                              "Custom RDBX point cloud featurization"
                              ) as transaction:
            for built_in in self.attributes["BuiltIn"][1:]:
                rdb.point_attributes.add(built_in)
            for custom in self.attributes["Custom"]:
                rdb.point_attributes.add(_scalar_attribute(
                    rdb, rdbp, custom, f"Feature: {custom}", "", 0.001,
                    (-1e5, 1e5)))

            with rdb.insert() as insert:
                for chunk in self.chunk(self.mat, self.chunk_size):
                    buffers = rdbp.PointBuffer(rdb, count=chunk.shape[0],
                                               attributes=attr_list)
                    np.copyto(buffers["riegl.xyz"].data, chunk[:, :3])
                    for i, attr in enumerate(attr_list[1:]):
                        np.copyto(buffers[attr].data,
                                  chunk[:, i + 3].astype(data_types[attr]))
                    insert.bind(buffers)
                    insert.next(chunk.shape[0])
                rdb.meta_data.set("riegl.geo_tag", self.gtag)
                transaction.commit()


_BBX_ATTRS = ["riegl.bbx_angle_a", "riegl.bbx_angle_b", "riegl.bbx_angle_c",
              "riegl.bbx_length_a", "riegl.bbx_length_b",
              "riegl.bbx_length_c"]


class BBX_HANDLER:
    """Bounding-box database: read, JSON export, creation and insert."""

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

    def create_BBX(self, geo_tag, bbxs):
        """Create the database with the box attributes (angles in
        degrees 0-360, lengths in metres 0-1000) and write ``bbxs``
        (box dicts) and ``geo_tag``."""
        rdbp = _require_riegl().rdb
        context = rdbp.Context()
        rdb = rdbp.Pointcloud(context)
        rdb.create(self.path, _xyz_settings(rdbp, context, 100000, 10))

        with rdbp.Transaction(rdb, "Initialization",
                              "Bounding boxes of trunks in point cloud"
                              ) as transaction:
            rdb.point_attributes.add("riegl.selected")
            rdb.point_attributes.add("riegl.visible")
            for attr in _BBX_ATTRS:
                angle = "angle" in attr
                rdb.point_attributes.add(_scalar_attribute(
                    rdb, rdbp, attr, attr, "deg" if angle else "m",
                    0.0001 if angle else 0.001,
                    (0, 360) if angle else (0, 1000)))
            self._insert(rdb, rdbp, bbxs)
            rdb.meta_data.set("riegl.geo_tag", geo_tag)
            transaction.commit()

    def insert_BBX(self, bbxs, add_filename):
        """Append ``bbxs`` (box dicts from the file ``add_filename``) to
        the database in a transaction of their own."""
        rdbp = _require_riegl().rdb
        with rdbp.rdb_open(self.path) as rdb:
            with rdbp.Transaction(
                    rdb, f"Insert of BBX from file: {add_filename}",
                    "BBX_HANDLER.insert_BBX") as transaction:
                self._insert(rdb, rdbp, bbxs)
                transaction.commit()

    @staticmethod
    def _insert(rdb, rdbp, bbxs):
        """One point per box: its centre, then angles and lengths."""
        with rdb.insert() as insert:
            for raw in bbxs:
                values = [*raw["center"][:3],
                          raw["angle_x"], raw["angle_y"], raw["angle_z"],
                          raw["length_x"], raw["length_y"], raw["length_z"]]
                chunk = np.array(values)
                buffers = rdbp.PointBuffer(
                    rdb, count=1, attributes=["riegl.xyz"] + _BBX_ATTRS)
                np.copyto(buffers["riegl.xyz"].data,
                          chunk[:3].reshape(1, -1))
                # _BBX_ATTRS: the angles, then the lengths
                for i, attr in enumerate(_BBX_ATTRS):
                    np.copyto(buffers[attr].data,
                              chunk[3 + i].reshape(-1, 1).astype(np.float64))
                insert.bind(buffers)
                insert.next(1)


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
