"""The RDBX writers of the port (``dataset/rdb_tools.py``: ``RDB_export.
create_RDB``, ``BBX_HANDLER.create_BBX`` / ``insert_BBX``) against the
JAX package's, through one recording stand-in of the vendor
``riegl.rdb`` binding (installed in ``sys.modules`` by ``monkeypatch``;
nothing installs the real one).  The stand-in logs every call, every
attribute set on its objects and a copy of every point buffer bound for
insertion; the two packages must leave equal logs.  Without the binding
both raise ``ImportError``.
"""

import sys
import types

import numpy as np
import pytest

from objectdetection_3d_tpu.dataset import rdb_tools as jax_rdb
from objectdetection_3d_tpu_torch.dataset import rdb_tools as port_rdb


class _Recorder:
    """An object of the stand-in: logs the attributes set on it."""

    def __init__(self, log, name):
        object.__setattr__(self, "_log", log)
        object.__setattr__(self, "_name", name)

    def __setattr__(self, key, value):
        self._log.append(("set", self._name, key, _plain(value)))
        object.__setattr__(self, key, value)


def _plain(value):
    """A comparable record of a value the writers hand the binding."""
    if isinstance(value, _Recorder):
        return ("object", value._name)
    if isinstance(value, np.ndarray):
        return ("array", value.dtype.str, value.shape, value.tobytes())
    return value


def _stand_in(log):
    """A ``riegl.rdb`` module whose ``rdb`` namespace records into
    ``log``."""
    rdb = types.SimpleNamespace()

    class Storage:
        VARIABLE = "VARIABLE"

    class PointAttribute(_Recorder):
        StorageClass = Storage

        def __init__(self, cloud):
            super().__init__(log, "PointAttribute")
            log.append(("PointAttribute", _plain(cloud)))

    class Context(_Recorder):
        def __init__(self):
            super().__init__(log, "Context")

    class CreateSettings(_Recorder):
        def __init__(self, context):
            super().__init__(log, "CreateSettings")
            object.__setattr__(self, "primary_attribute",
                               _Recorder(log, "primary_attribute"))

    class Attributes:
        def add(self, attr):
            log.append(("point_attributes.add", _plain(attr)))

    class MetaData:
        def set(self, key, value):
            log.append(("meta_data.set", key, value))

    class Insert:
        def __enter__(self):
            log.append(("insert",))
            return self

        def __exit__(self, *exc):
            log.append(("insert done",))

        def bind(self, buffers):
            log.append(("bind", [(k, _plain(v.data))
                                 for k, v in buffers.items()]))

        def next(self, n):
            log.append(("next", n))

    class Pointcloud(_Recorder):
        def __init__(self, context=None):
            super().__init__(log, "Pointcloud")
            object.__setattr__(self, "point_attributes", Attributes())
            object.__setattr__(self, "meta_data", MetaData())

        def create(self, path, settings):
            log.append(("create", path, _plain(settings)))

        def insert(self):
            return Insert()

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            log.append(("close",))

    class PointBuffer(dict):
        """Zeroed arrays each writer's copies fit: (count, 3) for xyz,
        (count,) for a scalar attribute (a single box: (1, 1))."""

        def __init__(self, cloud, count, attributes):
            log.append(("PointBuffer", count, list(attributes)))
            super().__init__({
                a: types.SimpleNamespace(data=np.zeros(
                    (count, 3) if a == "riegl.xyz"
                    else (1, 1) if count == 1 else (count,)))
                for a in attributes})

    class Transaction:
        def __init__(self, cloud, title, agent):
            log.append(("Transaction", title, agent))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            log.append(("Transaction done",))

        def commit(self):
            log.append(("commit",))

    def rdb_open(path):
        log.append(("rdb_open", path))
        return Pointcloud()

    rdb.__dict__.update(
        Context=Context, Pointcloud=Pointcloud, CreateSettings=CreateSettings,
        PointAttribute=PointAttribute, PointBuffer=PointBuffer,
        Transaction=Transaction, rdb_open=rdb_open)
    mod = types.ModuleType("riegl.rdb")
    mod.rdb = rdb
    return mod


@pytest.fixture
def riegl(monkeypatch):
    """Installs a fresh stand-in per call of the returned function and
    returns its log."""
    def install():
        log = []
        mod = _stand_in(log)
        pkg = types.ModuleType("riegl")
        pkg.rdb = mod
        monkeypatch.setitem(sys.modules, "riegl", pkg)
        monkeypatch.setitem(sys.modules, "riegl.rdb", mod)
        return log

    return install


def _boxes(n, seed):
    rng = np.random.default_rng(seed)
    boxes = np.concatenate([rng.uniform(0, 40, (n, 3)),
                            rng.uniform(0.2, 20, (n, 3)),
                            rng.uniform(0, 360, (n, 3))], 1)
    return port_rdb.npy_to_bbx_dicts(boxes)


def test_rdb_export_writes_as_the_jax_package(riegl):
    rng = np.random.default_rng(0)
    mat = np.concatenate([rng.uniform(-50, 50, (7, 3)),
                          rng.uniform(0, 1, (7, 3))], 1)
    attrs = {"BuiltIn": ["riegl.xyz", "riegl.reflectance"],
             "Custom": ["feat_a", "feat_b"]}
    dtypes = {"BuiltIn": {"riegl.reflectance": np.float32},
              "Custom": {"feat_a": np.float64, "feat_b": np.float32}}
    logs = []
    for mod in (jax_rdb, port_rdb):
        logs.append(riegl())
        mod.RDB_export("out.rdbx", attrs, dtypes, mat, 3,
                       "geo").create_RDB()
    assert logs[1] == logs[0]
    binds = [e for e in logs[0] if e[0] == "bind"]
    assert [e for e in logs[0] if e[0] == "next"] == [
        ("next", 3), ("next", 3), ("next", 1)]
    assert len(binds) == 3


def test_bbx_create_and_insert_write_as_the_jax_package(riegl):
    logs = []
    for mod in (jax_rdb, port_rdb):
        logs.append(riegl())
        handler = mod.BBX_HANDLER("boxes.rdbx")
        handler.create_BBX("geo", _boxes(3, seed=1))
        handler.insert_BBX(_boxes(2, seed=2), "more.npy")
    assert logs[1] == logs[0]
    assert sum(e[0] == "bind" for e in logs[0]) == 5


def test_writers_need_the_vendor_binding(monkeypatch):
    monkeypatch.setitem(sys.modules, "riegl", None)
    with pytest.raises(ImportError, match="riegl.rdb"):
        port_rdb.BBX_HANDLER("x.rdbx").create_BBX("geo", [])
    with pytest.raises(ImportError, match="riegl.rdb"):
        port_rdb.RDB_export("x.rdbx", {"BuiltIn": ["riegl.xyz"],
                                       "Custom": []},
                            {"BuiltIn": {}, "Custom": {}},
                            np.zeros((1, 3)), 1, "geo").create_RDB()
