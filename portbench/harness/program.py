"""What the benchmark takes from the program under test: the port's
``PointPillars`` built from a configuration file, its weights loaded from
the benchmark's own tensors, its train step and its tiled inference.
This is the only module of the harness that imports the port."""

import copy

import torch

from portbench.reference import weights as ref_weights


def model_cfg(conf):
    """The configuration's model dict as the port reads it: the frozen
    architecture and budgets of the file, with the lowering knobs that
    ``lowering_from_program`` names taken from the port's own defaults
    for its flagship (``configs.flagship_cfg()``), so that a lowering the
    port turns on by default is what is measured."""
    from objectdetection_3d_tpu_torch import configs

    cfg = copy.deepcopy(conf["model"])
    defaults = configs.flagship_cfg()["tpu"]
    for key in conf.get("lowering_from_program", ()):
        if key in defaults:
            cfg["tpu"][key] = defaults[key]
    return cfg


def make_weights(arch, conf, seed, root, device):
    """{state-dict name: float32 tensor on ``device``}: the checkpoint's
    leaves the configuration takes from its file (checked against the
    file's recorded hash), the others drawn from ``seed``; the leaves and
    their shapes are those of ``arch.param_shapes``, ``arch`` the
    configuration's reference module."""
    import os

    shapes = arch.param_shapes(arch.Spec(conf["model"]))
    w = conf.get("weights") or {}
    out = {}
    if w.get("file"):
        path = os.path.join(root, w["file"])
        digest = ref_weights.sha256(path)
        if digest != w["sha256"]:
            raise RuntimeError(f"{w['file']} has sha256 {digest}, the "
                               f"configuration was fixed on {w['sha256']}")
        prefixes = (None if w.get("leaves", "all") == "all"
                    else [p + "." for p in w["leaves"].split(",")])
        out = ref_weights.read_npz(path, device, prefixes)
    rest = {k: v for k, v in shapes.items() if k not in out}
    out.update(ref_weights.seeded(rest, seed, device))
    bad = {k for k in out if tuple(out[k].shape) != tuple(shapes[k])}
    if bad or set(out) != set(shapes):
        raise RuntimeError(f"weights do not match the configuration: "
                           f"{sorted(bad or set(out) ^ set(shapes))[:5]}")
    return out


def build_model(conf, weights, device="cuda"):
    """The port's ``PointPillars`` for ``conf`` with ``weights`` copied
    into its network."""
    from objectdetection_3d_tpu_torch.models.detector import PointPillars

    model = PointPillars(model_cfg(conf), device=device)
    state = model.net.state_dict()
    if set(state) != set(weights):
        raise RuntimeError(
            f"the port's network has other leaves than the configuration: "
            f"{sorted(set(state) ^ set(weights))[:5]}")
    with torch.no_grad():
        for k, v in state.items():
            v.copy_(weights[k])
    return model


def train_step(model, opt):
    """(the port's train step over ``model``, its optimizer)."""
    tx = model.get_optimizer(
        {"lr": opt["lr"], "betas": tuple(opt["betas"]),
         "weight_decay": opt["weight_decay"]},
        grad_clip_value=opt["grad_clip_value"])
    return model.make_train_step(tx), tx


def tiled(model, tiled_cfg, predict_fn=None):
    from objectdetection_3d_tpu_torch.pipeline.tiled_inference import (
        TiledInference,
    )

    return TiledInference(model, overlap=float(tiled_cfg["overlap"]),
                          batch_tiles=int(tiled_cfg["batch_tiles"]),
                          device_crop=bool(tiled_cfg["device_crop"]),
                          predict_fn=predict_fn)
