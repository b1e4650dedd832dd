"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` (``shared_lib.py``: the file name carries a hash
of the source, of the shared headers ``csrc/*.cuh`` and of the flags, and
the library is moved into place atomically) and loaded with ``ctypes``.
Nothing is compiled when a module is imported.
"""

import ctypes
import os
import shutil
import threading
from pathlib import Path

import torch

from objectdetection_3d_tpu_torch.shared_lib import (
    BUILD_DIR,
    compile_libraries,
)
from objectdetection_3d_tpu_torch.shared_lib import (
    library_path as _hashed_path,
)

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
KERNEL_SOURCES = ("voxel_scan", "grid_scatter", "assign_geometry",
                  "iou3d_clip", "subm_conv3d", "zfold_conv", "fused_stage")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# no fused multiply-add contraction: these kernels round operation for
# operation like their plain PyTorch versions (the conv kernels are held
# to a tolerance instead and keep the contraction)
SOURCE_FLAGS = {"assign_geometry": ("-fmad=false",),
                "iou3d_clip": ("-fmad=false",)}

_libs = {}
_lock = threading.Lock()


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _flags(name):
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name):
    """Path of the shared library built from ``csrc/<name>.cu``."""
    return _hashed_path(name, [CSRC_DIR / f"{name}.cu",
                               *sorted(CSRC_DIR.glob("*.cuh"))],
                        _flags(name))


def build(names=KERNEL_SOURCES):
    """Compile every named kernel that has no current build, one ``nvcc``
    per source, all started together.

    Returns:
        {name: compiler log} for the sources compiled by this call
        (``-Xptxas -v`` reports registers, shared memory and spills).
    """
    nvcc = None
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        jobs[name] = ([nvcc, *_flags(name), str(CSRC_DIR / f"{name}.cu")],
                      out)
    return compile_libraries(jobs, "nvcc")


def load(name):
    """The loaded ``ctypes`` library of kernel ``name``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def launch(name, fn_name, argtypes, args, device):
    """Call ``fn_name`` of kernel library ``name`` with ``args`` and the
    current CUDA stream of ``device`` as its last argument; raises if it
    returns a CUDA error."""
    fn = getattr(load(name), fn_name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error "
                           f"{err}")
