"""Training-state checkpoints: ``.pth`` files, or directories written
with ``torch.distributed.checkpoint`` (DCP).

A checkpoint holds ``{epoch, model_state_dict, optimizer_state_dict}``,
with ``augment_rng_state`` (the state of the train step's
``device_augment`` generator) when there is one, in
``ckpt_{epoch:05d}.pth`` (periodic) or ``ckpt_best.pth`` (best
validation F1).  The state is copied to host memory before a save
returns, and written under a temporary name that is then renamed, so a
preemption mid-write never leaves a truncated checkpoint under the final
name.  Loading a file uses ``torch.load(weights_only=True)``.

``ckpt_backend: orbax`` (the JAX package's directory backend, JAX's
async, multi-host-safe ``ckpt_*.orbax`` directories) selects DCP here:
``ckpt_{epoch:05d}.dcp`` and ``ckpt_best.dcp`` directories of the same
payload, the optimizer's state in DCP's parameter-name keyed form
(``get_optimizer_state_dict``).  One process writes each (``no_dist``:
the pipeline's rank 0 writes alone, with no collective).  A directory is
read back into a template made from its own metadata, so loading needs
no live model or optimizer; :func:`load_optimizer_state` puts either
form into an optimizer.  :func:`load_ckpt` tells the backends apart by
the path, as the JAX package's ``load_ckpt(backend=None)`` does.
"""

import os
import shutil
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import TensorStorageMetadata
from torch.distributed.checkpoint.state_dict import (
    get_optimizer_state_dict,
    set_optimizer_state_dict,
)

# the config's ckpt_backend -> the port's backend, and its file suffix
BACKENDS = {None: "pth", "pth": "pth", "pickle": "pth", "orbax": "dcp"}
SUFFIX = {"pth": ".pth", "dcp": ".dcp"}


def check_backend(backend):
    """The port's backend for the config's ``ckpt_backend``: ``"pth"``
    (``None``, ``pth`` and the JAX package's default ``pickle``) or
    ``"dcp"`` (``orbax``); ``ValueError`` otherwise."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown ckpt_backend {backend!r}")
    return BACKENDS[backend]


def backend_of(path):
    """``"dcp"`` for a checkpoint directory, else ``"pth"``."""
    return "dcp" if os.path.isdir(path) else "pth"


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


def _optimizer_state(net, optimizer, backend):
    if optimizer is None:
        return None
    if backend == "pth":
        return optimizer.state_dict()
    if not optimizer.state:
        # DCP's form would first give the optimizer a state of zeros
        return None
    return get_optimizer_state_dict(net, optimizer)


def snapshot(epoch, net, optimizer=None, generator=None, backend="pth"):
    """The checkpoint payload of ``net`` (and ``optimizer``, and the state
    of the ``torch.Generator`` ``generator``) on the host, in
    ``backend``'s form."""
    payload = {
        "epoch": int(epoch),
        "model_state_dict": _to_host(net.state_dict()),
        "optimizer_state_dict": _to_host(
            _optimizer_state(net, optimizer, backend)),
    }
    if generator is not None:
        payload["augment_rng_state"] = generator.get_state()
    return payload


def _write(path, payload, backend="pth"):
    tmp = path + ".tmp"
    if backend == "dcp":
        shutil.rmtree(tmp, ignore_errors=True)
        dcp.save(payload, checkpoint_id=tmp, no_dist=True)
        # a directory is not replaced by a rename: the old one goes first
        shutil.rmtree(path, ignore_errors=True)
    else:
        with open(tmp, "wb") as f:
            torch.save(payload, f)
    os.replace(tmp, path)


def save_ckpt(path, epoch, net, optimizer=None, generator=None,
              backend="pth"):
    """Write a checkpoint of ``net``, ``optimizer`` and ``generator``'s
    state to ``path`` (a ``backend`` of :data:`SUFFIX`)."""
    _write(path, snapshot(epoch, net, optimizer, generator, backend),
           backend)


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

    def save(self, path, epoch, net, optimizer=None, generator=None,
             backend="pth"):
        payload = snapshot(epoch, net, optimizer, generator, backend)
        self._pending = [f for f in self._pending if not f.done()]
        self._pending.append(self._executor.submit(_write, path, payload,
                                                   backend))

    def wait(self):
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()


def _nest(flat, paths):
    """DCP's flat {key: value} back in its nesting: ``paths`` maps each
    key to its path of dict keys and list indices."""
    root = {}
    for key, value in flat.items():
        node = root
        for part in paths[key][:-1]:
            node = node.setdefault(part, {})
        node[paths[key][-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            return [node[i] for i in range(len(node))]
        return node

    return lists(root)


def _load_dcp(path, map_location):
    meta = dcp.FileSystemReader(path).read_metadata()
    flat = {k: (torch.empty(m.size, dtype=m.properties.dtype)
                if isinstance(m, TensorStorageMetadata) else None)
            for k, m in meta.state_dict_metadata.items()}
    dcp.load(flat, checkpoint_id=path, no_dist=True)
    payload = _nest(flat, meta.planner_data)
    for key in ("model_state_dict", "optimizer_state_dict"):
        if payload.get(key) is not None:
            payload[key] = _to_device(payload[key], map_location)
    return payload


def _to_device(obj, device):
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_device(v, device) for v in obj]
    return obj


def load_ckpt(path, map_location="cpu"):
    """Read a checkpoint's payload dict: a ``.pth`` file's, or a DCP
    directory's (its tensors loaded into a template of its own metadata,
    then moved to ``map_location``; the generator state stays on the
    CPU)."""
    if backend_of(path) == "dcp":
        return _load_dcp(path, map_location)
    return torch.load(path, weights_only=True, map_location=map_location)


def load_optimizer_state(net, optimizer, state):
    """Put a payload's ``optimizer_state_dict`` into ``optimizer`` (over
    ``net``'s parameters): ``optimizer.state_dict()``'s form from a
    ``.pth``, DCP's parameter-name keyed form from a directory."""
    if state["param_groups"] and state["param_groups"][0]["params"] and \
            isinstance(state["param_groups"][0]["params"][0], str):
        set_optimizer_state_dict(net, optimizer, state)
    else:
        optimizer.load_state_dict(state)
