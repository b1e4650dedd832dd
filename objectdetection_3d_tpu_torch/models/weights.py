"""Weight bridge between the JAX package's flax variables and the port.

The JAX package keeps a ``{"params": ..., "batch_stats": ...}`` tree of
arrays; the port's module names follow that tree, so every leaf maps to one
parameter or buffer:

=============================  ==========================  ================
flax leaf                      port name                   layout change
=============================  ==========================  ================
``.../kernel`` (in, out)       ``.../weight``              (out, in)
``.../kernel`` HWIO            ``.../weight``              OIHW
``deconv_{i}/kernel`` HWIO     ``deconv_{i}.weight``       IOHW, kh, kw
                                                           reversed
``subm_{i}_kernel`` DHWIO      ``subm_{i}_kernel``         OIDHW
``down_{i}_kernel`` (3, c, o)  ``down_{i}_kernel``         (o, c, 3, 1, 1)
``.../scale``                  ``.../weight``              none
``.../bias``                   ``.../bias``                none
``batch_stats/.../mean|var``   ``.../running_mean|var``    none
=============================  ==========================  ================

Flax's ``ConvTranspose`` (the neck's ``deconv_{i}``, kernel = stride,
``padding="SAME"``) correlates the stride-dilated input with its kernel
unflipped; ``torch.nn.ConvTranspose2d`` (``padding=0``) is the transpose of
a conv, so the same map takes the kernel reversed in both spatial axes.

The same map carries the foreground filter's ``MLP`` (``dense_i``,
``bn_i``, ``out``); its ``BatchNorm1d`` counters
(``num_batches_tracked``) have no flax leaf and are left as they are.
"""

import numpy as np
import torch

_STATS = {"mean": "running_mean", "var": "running_var"}
_STATS_BACK = {v: k for k, v in _STATS.items()}
# BatchNorm1d's step counter: no flax leaf
_COUNTER = "num_batches_tracked"


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _leaf_to_port(collection, path, arr):
    """(port name, array in the port's layout) of one flax leaf."""
    *mods, leaf = path
    arr = np.asarray(arr, np.float32)
    if collection == "batch_stats":
        name = _STATS[leaf]
    elif leaf == "scale":
        name = "weight"
    elif leaf == "bias":
        name = "bias"
    elif leaf == "kernel":
        name = "weight"
        if arr.ndim == 2:           # Dense (in, out)
            arr = arr.T
        elif arr.ndim == 4 and mods and mods[-1].startswith("deconv_"):
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)  # -> IOHW, flipped
        elif arr.ndim == 4:         # Conv HWIO
            arr = arr.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"unexpected kernel rank at {path}")
    elif leaf.startswith("subm_") and leaf.endswith("_kernel"):
        name = leaf
        arr = arr.transpose(4, 3, 0, 1, 2)       # DHWIO -> OIDHW
    elif leaf.startswith("down_") and leaf.endswith("_kernel"):
        name = leaf
        arr = arr.transpose(2, 1, 0)[..., None, None]  # (3,c,o) -> OI311
    else:
        raise ValueError(f"unknown flax leaf {collection}/{'/'.join(path)}")
    return ".".join([*mods, name]), arr


def _port_to_leaf(name, arr):
    """(collection, flax path, array in the flax layout) of one port
    parameter or buffer."""
    *mods, leaf = name.split(".")
    if leaf in _STATS_BACK:
        return "batch_stats", (*mods, _STATS_BACK[leaf]), arr
    if leaf.startswith("subm_") and leaf.endswith("_kernel"):
        return "params", (*mods, leaf), arr.transpose(2, 3, 4, 1, 0)
    if leaf.startswith("down_") and leaf.endswith("_kernel"):
        return "params", (*mods, leaf), arr[:, :, :, 0, 0].transpose(2, 1, 0)
    if leaf == "bias":
        return "params", (*mods, "bias"), arr
    if leaf == "weight":
        if arr.ndim == 1:           # batch norm
            return "params", (*mods, "scale"), arr
        if arr.ndim == 2:
            return "params", (*mods, "kernel"), arr.T
        if arr.ndim == 4 and mods and mods[-1].startswith("deconv_"):
            return "params", (*mods, "kernel"), arr.transpose(
                2, 3, 0, 1)[::-1, ::-1]
        if arr.ndim == 4:
            return "params", (*mods, "kernel"), arr.transpose(2, 3, 1, 0)
    raise ValueError(f"unknown port parameter {name}")


def from_jax_variables(net, variables):
    """Load the JAX package's ``{"params", "batch_stats"}`` tree (numpy or
    array-like leaves) into the port's network module ``net``.

    Every leaf must map to a parameter or buffer of matching shape, and
    every parameter and buffer of ``net`` must be covered.
    """
    state = {k: v for k, v in net.state_dict().items()
             if not k.endswith(_COUNTER)}
    loaded = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(dict(variables.get(collection, {}))):
            name, val = _leaf_to_port(collection, path, arr)
            if name not in state:
                raise KeyError(f"{collection}/{'/'.join(path)} -> {name}: "
                               f"no such parameter in the port")
            if tuple(state[name].shape) != val.shape:
                raise ValueError(f"{name}: port shape "
                                 f"{tuple(state[name].shape)} vs JAX "
                                 f"{val.shape}")
            loaded[name] = torch.from_numpy(np.array(val, np.float32))
    missing = sorted(set(state) - set(loaded))
    if missing:
        raise KeyError(f"JAX variables lack {missing}")
    # every other entry is checked above; the counters keep their values
    net.load_state_dict(loaded, strict=False)


def to_jax_variables(net):
    """The port's weights as a JAX-package variable tree of numpy arrays
    (the inverse of :func:`from_jax_variables`)."""
    tree = {"params": {}, "batch_stats": {}}
    for name, val in net.state_dict().items():
        if name.endswith(_COUNTER):
            continue
        arr = val.detach().to("cpu", torch.float32).numpy()
        collection, path, arr = _port_to_leaf(name, arr)
        node = tree[collection]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return tree


def read_npz(path):
    """The flat ``params/a/b/c`` and ``batch_stats/a/b/c`` keys of a
    checkpoint npz as a nested variable tree; other keys are skipped."""
    tree = {"params": {}, "batch_stats": {}}
    with np.load(path) as z:
        for key in z.files:
            collection, *parts = key.split("/")
            if collection not in tree or not parts:
                continue
            node = tree[collection]
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = z[key]
    return tree


def load_npz(net, path):
    """Load a JAX-package checkpoint npz (e.g.
    ``artifacts/overfit_ckpt.npz``) into ``net``; returns the number of
    arrays loaded."""
    tree = read_npz(path)
    from_jax_variables(net, tree)
    return sum(1 for c in tree.values() for _ in _flatten(c))
