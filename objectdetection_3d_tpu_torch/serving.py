"""Ahead-of-time export of predict for serving.

Port of the JAX package's ``serving.py``.  The whole predict — voxelize,
PFN, vertical encoder, RPN, head, decode, NMS — is traced by
``torch.export`` into one program, with the weights and the anchors baked
in, and saved as a self-contained artifact that a serving process reloads
and calls WITHOUT the model's code, its config system or the checkpoint
format: it needs only torch and the kernels' custom operators
(``ops/custom_ops.py``, which the artifact calls by name).  The artifact
pins the calling convention: static padded input shapes, on the device
it was exported on.

Artifact layout (a directory):
    model.pt2       the ``torch.export`` program (``torch.export.save``)
    manifest.json   input and output shapes, budgets, device, versions
"""

import json
import os

import torch
from torch.utils import _pytree as pytree

# registers the od3d operators that a loaded program calls
from objectdetection_3d_tpu_torch.ops import custom_ops  # noqa: F401

_MANIFEST = "manifest.json"
_PAYLOAD = "model.pt2"
_INPUT_DTYPES = {"points": torch.float32, "num_points": torch.int32}


class _Predict(torch.nn.Module):
    """``(points, num_points) -> detections`` of one model, the module
    that is exported; its parameters are the network's."""

    def __init__(self, model):
        super().__init__()
        self.net = model.net
        self.model = model

    def forward(self, points, num_points):
        return self.model.predict_traceable(
            {"points": points, "num_points": num_points})


def _spec(t):
    return [list(t.shape), str(t.dtype).replace("torch.", "")]


def export_predict(model, batch_size=1):
    """Export the model's predict at its knob set and compute type.

    Args:
        model: a constructed ``PointPillars`` detector with its weights
            loaded; the program runs on ``model.device``.
        batch_size: static serving batch size.
    Returns:
        (``torch.export.ExportedProgram``, manifest dict).  Inputs:
        ``points`` (B, P, C) float32 and ``num_points`` (B,) int32, P =
        ``tpu.max_points_static``.
    """
    b = int(batch_size)
    p = int(model.tpu_cfg["max_points_static"])
    c = len(model.input_features)
    dev = model.device
    inputs = {"points": torch.zeros((b, p, c), dtype=torch.float32,
                                    device=dev),
              "num_points": torch.zeros((b,), dtype=torch.int32,
                                        device=dev)}
    with torch.no_grad():
        program = torch.export.export(
            _Predict(model), (inputs["points"], inputs["num_points"]),
            strict=False)
    out_node = next(n for n in program.graph.nodes if n.op == "output")
    outputs = pytree.tree_unflatten(
        [a.meta["val"] for a in out_node.args[0]],
        program.call_spec.out_spec)
    manifest = {
        "framework": "objectdetection_3d_tpu_torch",
        "torch_version": torch.__version__,
        "device": dev.type,
        "batch_size": b,
        "inputs": {k: _spec(v) for k, v in inputs.items()},
        "outputs": {k: _spec(v) for k, v in outputs.items()},
        "max_points_static": p,
        "input_features": list(model.input_features),
        "classes": list(getattr(model, "classes", [])) or None,
    }
    if dev.type == "cuda":
        manifest["device_name"] = torch.cuda.get_device_name(dev)
    return program, manifest


def save_exported(program, manifest, out_dir):
    """Write ``model.pt2`` and ``manifest.json`` into ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(program, os.path.join(out_dir, _PAYLOAD))
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def load_serving(path):
    """Reload an exported artifact directory.

    Returns:
        (serve_fn, manifest): ``serve_fn(batch) -> detections`` takes a
        dict of ``points`` and ``num_points`` (tensors or arrays) of the
        manifest's static shapes and returns the dict of ``bbox``,
        ``label``, ``score`` and ``valid`` on the artifact's device.
    Raises:
        RuntimeError: for an artifact exported on CUDA where no card is
            present (it is never loaded onto the CPU instead).
    """
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    device = torch.device(manifest["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for CUDA "
                           f"({manifest.get('device_name')}) and CUDA is "
                           f"not available here")
    module = torch.export.load(os.path.join(path, _PAYLOAD)).module()

    def serve(batch):
        args = [torch.as_tensor(batch[k], dtype=dt, device=device)
                for k, dt in _INPUT_DTYPES.items()]
        with torch.no_grad():
            return module(*args)

    return serve, manifest
