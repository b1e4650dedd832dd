"""Abstract pipeline: run-directory versioning, seed and device.

Runs write to timestamped folders ``<log_dir>/<version>/logs/``; a resume
takes an explicit or the newest version, and version names are checked
strictly.  The device is the config's ``device`` through
``utils.convert_device_name``: ``"cpu"`` or ``"cuda"``, and the latter
raises where CUDA is absent.  Over several ranks, rank 0 picks the run
directory and alone creates it.
"""

from abc import ABC, abstractmethod
import os
from datetime import datetime

import numpy as np

from objectdetection_3d_tpu_torch.config import Config
from objectdetection_3d_tpu_torch.models.detector import resolve_device
from objectdetection_3d_tpu_torch.pipeline.utils import (
    resume_training_process,
)
from objectdetection_3d_tpu_torch.utils import (
    convert_device_name,
    make_dir,
)

_VERSION_FMT = "%Y-%m-%d-%H-%M-%S"


def _checked_version(version):
    """Validate a run-folder version string, returning it unchanged."""
    if not isinstance(version, str):
        raise AssertionError("Invalid resume_from folder name format")
    datetime.strptime(version, _VERSION_FMT)  # ValueError if malformed
    return version


class BasePipeline(ABC):
    """Common state for concrete pipelines: config, RNG, device, run dir."""

    def __init__(self, model, dataset, global_cfg, **kwargs):
        if kwargs.get("name") is None:
            raise KeyError("Please give a name to the pipeline")

        self.cfg = Config(kwargs)
        self.global_cfg = global_cfg
        self.name = self.cfg.name
        self.model = model
        self.dataset = dataset
        self.rng = np.random.default_rng(kwargs.get("seed", None))
        self.device = resolve_device(
            convert_device_name(self.cfg.get("device", "cuda")))
        self.summary = {}
        # the process groups of a run over several ranks (None on one
        # device); rank 0 alone writes the run's files
        self.mesh = self._ensure_mesh()
        self.is_main = self.mesh is None or self.mesh.rank == 0

        self.cfg.log_dir = self._from_main(self._resolve_run_dir(
            self.cfg.get("log_dir", "./output/")))
        if self.is_main:
            make_dir(self.cfg.log_dir)

    def _ensure_mesh(self):
        """The run's ``parallel.Mesh``; None: one device."""
        return None

    def _from_main(self, value):
        """Rank 0's ``value`` on every rank (``value`` on one device)."""
        if self.mesh is None:
            return value
        import torch.distributed as dist

        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _resolve_run_dir(self, root):
        """Decide which ``<root>/<version>/logs/`` this run writes to.

        * inference: the version named by ``resume_from`` (required);
        * resume: ``resume_from`` if given, else the newest existing run;
        * fresh training: a new now-timestamped version.
        """
        if self.cfg.get("inference_mode"):
            version = self.cfg.get("resume_from", None)
            if version is None:
                raise ValueError(
                    "There is no model defined in config file for inference "
                    "(resume_from?)")
            version = _checked_version(version)
        elif self.cfg.get("is_resume"):
            named = self.cfg.get("resume_from", None)
            version = (_checked_version(named) if named
                       else resume_training_process(root))
        else:
            version = datetime.now().strftime(_VERSION_FMT)
        return os.path.join(root, version + "/logs/")

    @abstractmethod
    def run_inference(self, data):
        """Infer detections for one data item."""

    @abstractmethod
    def run_testing(self):
        """Evaluate on the test split."""

    @abstractmethod
    def run_training(self):
        """Train on the train split."""

    @abstractmethod
    def show_inference(self):
        """Visualize predictions on one test sample."""
