"""Start one process per rank on this host.

    results = spawn(fn, world_size, init_dir, args=(...))

Each rank joins a process group through ``init_method="file://..."`` in
the caller's ``init_dir`` (no TCP port, so concurrent runs do not clash),
runs ``fn(rank, *args)`` and sends back what it returns; ``spawn``
returns those values in rank order.  The ranks start with the ``spawn``
method and import torch and the module of ``fn`` only.  The backend is
:func:`default_backend`'s unless the caller names one.  Under
``torchrun`` no launcher is needed: ``parallel.make_mesh`` reads the
environment it sets.
"""

import datetime
import os
import pickle
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the collectives' timeout; the ranks are killed when they have not all
# ended a minute after it
TIMEOUT_S = 600


def default_backend(device):
    """nccl for ranks on CUDA devices, gloo on the CPU, and gloo where the
    ranks of this host (``LOCAL_WORLD_SIZE``) outnumber its cards: nccl
    cannot put two ranks on one card."""
    if torch.device(device).type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return "gloo" if local > torch.cuda.device_count() else "nccl"


def bind_local_device():
    """Make ``cuda:LOCAL_RANK % device_count()`` this process's current
    card (a no-op without a card): a model built on ``"cuda"`` then lands
    on its rank's card."""
    if torch.cuda.is_available() and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"])
                              % torch.cuda.device_count())


def _rank_main(rank, fn, world_size, init_dir, backend, args):
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world_size),
                      LOCAL_WORLD_SIZE=str(world_size))
    torch.set_num_threads(1)
    bind_local_device()
    backend = backend or default_backend(
        "cuda" if torch.cuda.is_available() else "cpu")
    out_path = os.path.join(init_dir, f"rank{rank}.pkl")
    try:
        dist.init_process_group(
            backend, init_method="file://" + os.path.join(init_dir,
                                                          "rendezvous"),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        result = ("ok", fn(rank, *args))
    except BaseException as e:  # sent back to the caller, which raises
        result = ("error", f"rank {rank}: {e!r}\n{traceback.format_exc()}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out_path + ".tmp", out_path)


def spawn(fn, world_size, init_dir, args=(), backend=None):
    """Run ``fn(rank, *args)`` on ``world_size`` new processes joined in
    one process group.

    Args:
        fn: a module-level function (it is pickled by name).
        init_dir: an empty directory for the rendezvous file and the
            results.
        backend: ``gloo`` or ``nccl``; by default
            :func:`default_backend` of the card, or of the CPU where
            there is none.
    Returns:
        [fn's return value of rank r for r in range(world_size)].
    Raises:
        RuntimeError with the failing ranks' tracebacks.
    """
    os.makedirs(init_dir, exist_ok=True)
    ctx = mp.start_processes(
        _rank_main, args=(fn, world_size, str(init_dir), backend,
                          tuple(args)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S + 60
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise RuntimeError(f"spawn: ranks still running after "
                                   f"{TIMEOUT_S + 60} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    results, errors = [], []
    for rank in range(world_size):
        with open(os.path.join(init_dir, f"rank{rank}.pkl"), "rb") as f:
            status, value = pickle.load(f)
        if status == "error":
            errors.append(value)
        results.append(value)
    if errors:
        raise RuntimeError("spawn: " + "\n".join(errors))
    return results
