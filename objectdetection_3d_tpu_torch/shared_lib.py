"""Compile and cache the port's shared libraries: the CUDA kernels
(``ops/cuda_lib.py``) and the host C++ passes (``native/``).

A library is built at first use into ``build/torch_kernels/`` at the
repository root (listed in .gitignore).  Its file name carries a hash of
its sources and of the compiler flags, so an edited source is rebuilt and
a stale build is never loaded.  Each compiler writes a temporary file
named after its process and the finished library is moved into place by
``os.replace``, which is atomic: processes that build the same library
at once each load a whole file, never one that another is still writing.
"""

import hashlib
import os
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_kernels"


def library_path(stem, sources, flags):
    """``BUILD_DIR / lib<stem>-<hash>.so`` for the bytes of ``sources``
    (paths, hashed in the order given) compiled with ``flags``."""
    blob = b"".join(Path(s).read_bytes() for s in sources)
    digest = hashlib.sha1(blob + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{stem}-{digest[:12]}.so"


def compile_libraries(jobs, tool):
    """Run one compiler per job, all started together, and move each
    finished library into place.

    Args:
        jobs: {name: (command without its output, library path)}; the
            command's ``-o <temporary>`` is appended here.
        tool: the compiler's name in the error message.
    Returns:
        {name: compiler output}.
    Raises:
        RuntimeError with every failed compiler's output; the libraries
        of the jobs that succeeded are in place.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (cmd, out) in jobs.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen([*cmd, "-o", str(tmp)],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (rc={proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"{tool} failed for " + "\n".join(failed))
    return logs
