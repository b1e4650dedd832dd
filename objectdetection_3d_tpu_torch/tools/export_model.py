"""Export a trained run's predict as a self-contained serving artifact.

    python -m objectdetection_3d_tpu_torch.tools.export_model \
        config.yaml out_dir [--batch N] [--device cpu] [--ckpt path.pth]

``torch.export`` traces the whole predict (voxelize -> network -> decode
-> NMS, weights and anchors baked in, the kernels as ``torch.ops.od3d``
operators) and ``serving.save_exported`` writes it to ``out_dir``; a
serving process reloads it with
``objectdetection_3d_tpu_torch.serving.load_serving(out_dir)``, which
needs no config, checkpoint format or model code.

The config is the pipeline's (``entry test``'s) schema.  Without
``--ckpt`` the checkpoint is found as ``entry test`` finds it
(``pipeline.inference_mode: true`` with ``resume_from``: the run's best
checkpoint, else its latest).  The artifact runs on the device it is
exported on: the config's ``global_args.device`` (the card unless it says
``cpu``), or ``--device``.
"""

import argparse
import sys

from objectdetection_3d_tpu_torch import serving
from objectdetection_3d_tpu_torch.config import Config
from objectdetection_3d_tpu_torch.entry import (
    build_model,
    build_pipeline,
    require_mode,
)
from objectdetection_3d_tpu_torch.pipeline import checkpoint as ckpt_io


def export(cfg, out_dir, batch_size=1, device=None, ckpt=None):
    """Export the predict of ``cfg`` (a ``Config``) with the weights of
    ``ckpt`` (a ``.pth`` file or a ``.dcp`` directory), or of the run ``entry test`` would load, to
    ``out_dir``; returns the manifest."""
    if device is not None:
        cfg.global_args.device = device
    if ckpt:
        _, _, cfg_model = Config.initialize_params(cfg)
        model = build_model(cfg_model)
        payload = ckpt_io.load_ckpt(ckpt, map_location=model.device)
        model.net.load_state_dict(payload["model_state_dict"])
    else:
        require_mode(cfg.get("pipeline", {}), True, "export")
        pipeline, _ = build_pipeline(cfg=cfg)
        pipeline.load_ckpt()
        model = pipeline.model
    program, manifest = serving.export_predict(model, batch_size=batch_size)
    serving.save_exported(program, manifest, out_dir)
    return manifest


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m objectdetection_3d_tpu_torch.tools.export_model",
        description="Export predict as a torch.export serving artifact.")
    parser.add_argument("config")
    parser.add_argument("out_dir")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="cpu, or an accelerator name for the card "
                             "(default: the config's global_args.device)")
    parser.add_argument("--ckpt", default=None,
                        help="a .pth or .dcp checkpoint (default: the run that "
                             "'entry test' would load)")
    args = parser.parse_args(argv)
    manifest = export(Config.load_from_file(args.config), args.out_dir,
                      batch_size=args.batch, device=args.device,
                      ckpt=args.ckpt)
    print(f"export_model: wrote {args.out_dir} (device="
          f"{manifest['device']}, batch={manifest['batch_size']}, "
          f"points={manifest['inputs']['points'][0]})")
    print("reload with: objectdetection_3d_tpu_torch.serving."
          "load_serving(dir)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
