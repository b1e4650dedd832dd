"""Training-state checkpoints as ``.pth`` files.

A checkpoint is ``torch.save`` of ``{epoch, model_state_dict,
optimizer_state_dict}``, with ``augment_rng_state`` (the state of the
train step's ``device_augment`` generator) when there is one, in
``ckpt_{epoch:05d}.pth`` (periodic) or
``ckpt_best.pth`` (best validation F1).  The state is copied to host
memory before a save returns, and written to a temporary file that is
then renamed, so a preemption mid-write never leaves a truncated file
under the final name.  Loading uses ``torch.load(weights_only=True)``.

The JAX package also offers an orbax backend; orbax is a JAX library, so
``ckpt_backend: orbax`` raises here (ROADMAP C6).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import torch


def check_backend(backend):
    """Raise ``ValueError`` unless ``backend`` is the port's ``pth``
    (``None`` and the JAX package's default ``pickle`` mean the same)."""
    if backend in (None, "pth", "pickle"):
        return
    if backend == "orbax":
        raise ValueError(
            "ckpt_backend: orbax is a JAX library; the PyTorch port writes "
            ".pth checkpoints only (ROADMAP C6)")
    raise ValueError(f"unknown ckpt_backend {backend!r}")


def _to_host(obj):
    """A host copy of a state dict: every tensor copied to the CPU, so
    later in-place updates of the live state do not reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def snapshot(epoch, net, optimizer=None, generator=None):
    """The checkpoint payload of ``net`` (and ``optimizer``, and the state
    of the ``torch.Generator`` ``generator``) on the host."""
    payload = {
        "epoch": int(epoch),
        "model_state_dict": _to_host(net.state_dict()),
        "optimizer_state_dict": (None if optimizer is None
                                 else _to_host(optimizer.state_dict())),
    }
    if generator is not None:
        payload["augment_rng_state"] = generator.get_state()
    return payload


def _write(path, payload):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(payload, f)
    os.replace(tmp, path)


def save_ckpt(path, epoch, net, optimizer=None, generator=None):
    """Write a checkpoint of ``net``, ``optimizer`` and ``generator``'s
    state to ``path``."""
    _write(path, snapshot(epoch, net, optimizer, generator))


class AsyncSaver:
    """Background checkpoint writer.

    ``save`` copies the state to host memory before it returns, so the
    caller may go on training; a single worker thread serializes and
    writes.  ``wait`` drains pending writes and re-raises the first write
    error.
    """

    def __init__(self):
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending = []

    def save(self, path, epoch, net, optimizer=None, generator=None):
        payload = snapshot(epoch, net, optimizer, generator)
        self._pending = [f for f in self._pending if not f.done()]
        self._pending.append(self._executor.submit(_write, path, payload))

    def wait(self):
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()


def load_ckpt(path, map_location="cpu"):
    """Read a checkpoint's payload dict."""
    return torch.load(path, weights_only=True, map_location=map_location)
