"""Command-line entry of the port: train, test or show one test cloud
from a YAML config.

    python -m objectdetection_3d_tpu_torch.entry train [config.yaml]
    python -m objectdetection_3d_tpu_torch.entry test [config.yaml]
    python -m objectdetection_3d_tpu_torch.entry show [config.yaml]

The config is the JAX package's schema: ``global_args`` / ``dataset`` /
``model`` / ``pipeline`` sections (plus the optional ``tpu`` section), and
``pipeline.inference_mode`` must agree with the command (false to train,
true to test or show).  ``global_args.device`` picks the device: ``cpu``,
or any accelerator name for the CUDA card.  The config path defaults to
``./config.yaml``.

With ``pipeline.data_parallel`` / ``spatial_parallel`` above 1, run one
process per rank, each on the card of its ``LOCAL_RANK``:

    torchrun --nproc_per_node=N -m objectdetection_3d_tpu_torch.entry \
        train config.yaml

The ranks join over nccl, or over gloo where they outnumber the host's
cards (several ranks sharing one card).
"""

import argparse
import logging
import sys

from objectdetection_3d_tpu_torch.config import Config
from objectdetection_3d_tpu_torch.dataset import Forest3D
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.parallel.launch import bind_local_device
from objectdetection_3d_tpu_torch.pipeline import ObjectDetection
from objectdetection_3d_tpu_torch.utils import convert_device_name


def build_pipeline(config_path="./config.yaml", cfg=None):
    """Assemble (pipeline, pipeline_cfg) from a YAML file, or from
    ``cfg``, a ``Config`` built from a dict."""
    if cfg is None:
        cfg = Config.load_from_file(config_path)
    for section in ("global_args", "dataset", "model", "pipeline"):
        if cfg.get(section) is None:
            raise ValueError(
                f"config is missing its '{section}' section: all of "
                "global_args/dataset/model/pipeline are required")

    global_cfg = cfg.dump()
    cfg_dataset, cfg_pipeline, cfg_model = Config.initialize_params(cfg)
    dataset = Forest3D(**cfg_dataset)
    pipeline = ObjectDetection(build_model(cfg_model), dataset, global_cfg,
                               **cfg_pipeline)
    return pipeline, cfg_pipeline


def build_model(cfg_model):
    """The detector of a config's ``model`` section, on the device it
    names: the card unless it says ``cpu``."""
    return PointPillars(cfg_model, device=convert_device_name(
        cfg_model.get("device", "cuda")))


def require_mode(cfg_pipeline, inference_mode, task):
    """Fail fast when ``pipeline.inference_mode`` contradicts the task."""
    actual = bool(cfg_pipeline.get("inference_mode"))
    if actual != inference_mode:
        raise ValueError(
            f"{task} needs pipeline.inference_mode: "
            f"{str(inference_mode).lower()} in the config "
            f"(found {str(actual).lower()})")


def init_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(levelname)s - %(asctime)s - %(module)s - %(message)s")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m objectdetection_3d_tpu_torch.entry",
        description="Train, test or show the PyTorch port from a YAML "
                    "config.")
    parser.add_argument("task", choices=("train", "test", "show"))
    parser.add_argument("config", nargs="?", default="./config.yaml")
    args = parser.parse_args(argv)
    init_logging()
    bind_local_device()
    pipeline, cfg_pipeline = build_pipeline(args.config)
    if args.task == "train":
        require_mode(cfg_pipeline, False, "training")
        pipeline.run_training()
    elif args.task == "test":
        require_mode(cfg_pipeline, True, "testing")
        pipeline.run_testing()
    else:
        require_mode(cfg_pipeline, True, "show_inference")
        pipeline.show_inference()
    return 0


if __name__ == "__main__":
    sys.exit(main())
