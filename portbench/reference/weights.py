"""The benchmark's weights, made or read once and handed to both sides.

:func:`read_npz` reads the trained flax-tree checkpoint (a raw file both
sides read) into a dict keyed by the program's state-dict names, in
PyTorch layouts; :func:`seeded` draws the leaves a configuration does not
take from the file, on the device, from ``--seed``.
"""

import hashlib

import numpy as np
import torch


def _port_name(path):
    """flax leaf path -> (state-dict name, layout) of the network."""
    coll, *mods, leaf = path.split("/")
    if coll == "batch_stats":
        return ".".join(mods + ["running_" + leaf]), None
    if leaf in ("scale", "bias"):
        return ".".join(mods + ["weight" if leaf == "scale" else "bias"]), None
    if leaf.startswith("subm_"):
        return ".".join(mods + [leaf]), "dhwio"
    if leaf.startswith("down_"):
        return ".".join(mods + [leaf]), "down"
    return ".".join(mods + ["weight"]), "kernel"


def _layout(arr, kind):
    if kind == "dhwio":                         # -> (O, I, D, H, W)
        return arr.permute(4, 3, 0, 1, 2)
    if kind == "down":                          # (3, I, O) -> (O, I, 3, 1, 1)
        return arr.permute(2, 1, 0)[..., None, None]
    if kind == "kernel" and arr.dim() == 2:     # (in, out) -> (out, in)
        return arr.t()
    if kind == "kernel" and arr.dim() == 4:     # HWIO -> OIHW
        return arr.permute(3, 2, 0, 1)
    return arr


def sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def read_npz(path, device, prefixes=None):
    """{state-dict name: float32 tensor on ``device``} of the checkpoint's
    leaves (those whose name starts with one of ``prefixes``, if given)."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            if not key.startswith(("params/", "batch_stats/")):
                continue
            name, kind = _port_name(key)
            if prefixes and not name.startswith(tuple(prefixes)):
                continue
            arr = torch.from_numpy(np.asarray(z[key], np.float32))
            out[name] = _layout(arr, kind).contiguous().to(device)
    return out


def seeded(shapes, seed, device):
    """Leaves of the given {name: shape} drawn from ``seed`` on
    ``device``: convolutions He normal, N(0, 2 / fan_in) (a transposed
    convolution's fan-in: its input channels); the head's cls
    and dir convolutions N(0, 1 / fan_in) and its reg convolution N(0,
    0.01 / fan_in), so that boxes stay near their anchors; biases 0; batch
    norms weight 1, bias 0, running mean 0, running var 1.

    One normal draw fills every weight (in name order), then each is
    scaled: a few large calls on the device.
    """
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    names = sorted(shapes)
    weights = [n for n in names if len(shapes[n]) > 1]
    total = sum(int(np.prod(shapes[n])) for n in weights)
    flat = torch.randn((total,), generator=gen, device=device)
    out, at = {}, 0
    for n in weights:
        shape = shapes[n]
        size = int(np.prod(shape))
        # a transposed conv of kernel = stride, (in, out, k, k): each output
        # takes one tap of every input channel
        fan_in = (shape[0] if ".deconv_" in n
                  else shape[1] * int(np.prod(shape[2:])))
        gain = 2.0
        if n.startswith("bbox_head.conv_reg"):
            gain = 0.01
        elif n.startswith("bbox_head."):
            gain = 1.0
        out[n] = (flat[at:at + size] * (gain / fan_in) ** 0.5).reshape(shape)
        at += size
    for n in names:
        if n in out:
            continue
        if n.endswith(("running_var", ".weight")):
            out[n] = torch.ones(shapes[n], device=device)
        else:
            out[n] = torch.zeros(shapes[n], device=device)
    return out
