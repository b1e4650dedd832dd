"""Abstract model contract: the hooks the pipeline drives."""

from abc import ABC, abstractmethod

import numpy as np

from objectdetection_3d_tpu_torch.config import Config


class BaseModel(ABC):
    """Base class for detection models.

    Wraps the model's config dict into a ``Config`` and owns the per-model
    host RNG, seeded from the config's ``seed``.  Concrete models
    implement the preprocessing, training-loss and inference-end hooks
    the pipeline drives.
    """

    def __init__(self, cfg):
        self.cfg = Config(dict(cfg))
        self.name = self.cfg.get("name", type(self).__name__)
        self.rng = np.random.default_rng(self.cfg.get("seed", None))

    @abstractmethod
    def loss(self, results, inputs):
        """Compute training losses for a forward result and batch."""

    @abstractmethod
    def get_optimizer(self, cfg_pipeline):
        """Build the optimizer."""

    @abstractmethod
    def preprocess(self, data, attr):
        """Host-side per-cloud preprocessing."""

    @abstractmethod
    def transform(self, data, attr):
        """Host-side post-preprocess transform."""

    @abstractmethod
    def inference_end(self, results):
        """Convert raw network output into detection dicts."""
