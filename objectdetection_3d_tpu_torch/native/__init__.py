"""The host C++ passes of the data path, loaded with ``ctypes``.

* ``preprocess.cpp`` (``preprocess_cloud``): the fused 5-sigma outlier
  reject, range crop and column select of ``PointPillars.preprocess``;
* ``featurize.cpp`` (``featurize_cloud``): grid kNN, Jacobi PCA normals
  and FPFH-33, the ``Featurizer``'s ``"native"`` backend.

They are the port's own copies of the JAX package's ``native/`` sources,
with the same C interfaces and the same Python signatures.  Each is
compiled at first use, never at import, by ``g++ -O3 -march=native
-shared -fPIC -std=c++17 -pthread`` into ``build/torch_kernels/`` under a
name that carries a hash of the source, the flags and what
``-march=native`` means on this host, through a temporary
file and an atomic rename (``shared_lib.py``), so processes that build at
once never load a half-written library.  Where the JAX package logs a
warning and goes on with numpy when the build fails, the port raises with
the compiler's output (ROADMAP C12).
"""

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

from objectdetection_3d_tpu_torch.shared_lib import (
    compile_libraries,
    library_path,
)

_HERE = Path(__file__).resolve().parent
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")

_lock = threading.Lock()
_libs = {}

_F32 = ctypes.POINTER(ctypes.c_float)
_F64 = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "preprocess": ("preprocess_cloud", [
        _F32, ctypes.c_int64, ctypes.c_int64, _I64, ctypes.c_int64,
        _F32, _F32, ctypes.c_float, _F32, ctypes.c_int64]),
    "featurize": ("featurize_cloud", [
        _F64, ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
        ctypes.c_double, ctypes.c_int64, _F64, _F64, _F64]),
}


def source_path(name):
    return _HERE / f"{name}.cpp"


_TARGET = None


def _target():
    """What ``-march=native`` means on this host (``g++ -Q
    --help=target``), so a library built for another CPU is never
    loaded here."""
    global _TARGET
    if _TARGET is None:
        _TARGET = subprocess.run(
            ["g++", "-march=native", "-Q", "--help=target"],
            capture_output=True, text=True).stdout
    return _TARGET


def native_library_path(name):
    """Where the library of ``<name>.cpp`` is built: the name carries a
    hash of the source, the flags and the host's target."""
    return library_path(f"od{name}", [source_path(name)],
                        (*GXX_FLAGS, _target()))


def _load(name):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = native_library_path(name)
            if not path.exists():
                compile_libraries(
                    {name: (["g++", *GXX_FLAGS, str(source_path(name))],
                            path)}, "g++")
            lib = ctypes.CDLL(str(path))
            fn_name, argtypes = _SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int64
            fn.argtypes = argtypes
            _libs[name] = lib
        return lib


def load():
    """The preprocess library, built if needed; raises ``RuntimeError``
    with the compiler's output when the build fails."""
    return _load("preprocess")


def load_featurize():
    """The featurizer library, built if needed; raises like
    :func:`load`."""
    return _load("featurize")


def featurize_cloud(points, normal_rad, normal_max_nn, fpfh_rad,
                    fpfh_max_nn, normals=None):
    """Normals + FPFH-33 of one cloud through the native library.

    Semantics of the numpy path (``models/preprocess_tools.py``:
    ``estimate_normals`` + ``compute_fpfh``): radius-bounded kNN
    neighbourhoods (the k nearest within the radius, the point itself
    included), PCA normals flipped to z >= 0, simplified-PFH 11-bin
    histograms of the Darboux angles and the distance-weighted FPFH
    combine (reference model/utils.py:73-90 delegates this to open3d).

    Args:
        points: (N, >=3) array; its xyz columns are used.
        normals: optional (N, 3) normals (skips their estimation).
    Returns:
        (normals, fpfh): (N, 3) and (N, 33) float64, or None when the
        library declines the cloud (its neighbour grid cannot be built).
    """
    lib = load_featurize()
    xyz = np.ascontiguousarray(points[:, :3], np.float64)
    n = xyz.shape[0]
    normals_out = np.empty((n, 3), np.float64)
    fpfh_out = np.empty((n, 33), np.float64)
    nin = None
    if normals is not None:
        normals = np.ascontiguousarray(normals, np.float64)
        nin = normals.ctypes.data_as(_F64)
    rc = lib.featurize_cloud(
        xyz.ctypes.data_as(_F64), n, ctypes.c_double(normal_rad),
        int(normal_max_nn), ctypes.c_double(fpfh_rad), int(fpfh_max_nn),
        nin, normals_out.ctypes.data_as(_F64), fpfh_out.ctypes.data_as(_F64))
    if rc != 0:
        return None
    return normals_out, fpfh_out


def preprocess_cloud(points, input_features, point_cloud_range,
                     sigma_mult=5.0, max_points=None):
    """Fused outlier reject, range crop and column select of one cloud.

    Semantics of the numpy path of ``PointPillars._preprocess_points``:
    drop points whose distance from the centroid is >= mean + sigma_mult
    * std, keep xyz inside [range_min, range_max), then select the
    ``input_features`` columns, in the input's order.

    Args:
        points: (N, C) float32 array.
        input_features: column indices to keep.
        point_cloud_range: (x0, y0, z0, x1, y1, z1).
        max_points: output cap (default N).
    Returns:
        (M, len(input_features)) float32 array.
    """
    lib = load()
    pts = np.ascontiguousarray(points, np.float32)
    n, c = pts.shape
    if max_points is None:
        max_points = n
    sel = np.ascontiguousarray(input_features, np.int64)
    rmin = np.ascontiguousarray(point_cloud_range[:3], np.float32)
    rmax = np.ascontiguousarray(point_cloud_range[3:], np.float32)
    out = np.empty((max_points, len(sel)), np.float32)
    written = lib.preprocess_cloud(
        pts.ctypes.data_as(_F32), n, c, sel.ctypes.data_as(_I64), len(sel),
        rmin.ctypes.data_as(_F32), rmax.ctypes.data_as(_F32),
        ctypes.c_float(sigma_mult), out.ctypes.data_as(_F32), max_points)
    return out[:written]
