"""Abstract dataset contract: splits and their items."""

from abc import ABC, abstractmethod
import logging

import numpy as np

from objectdetection_3d_tpu_torch.config import Config

log = logging.getLogger(__name__)


class BaseDataset(ABC):
    """Base class for datasets usable with the detection pipeline."""

    def __init__(self, **kwargs):
        if kwargs.get("dataset_path") is None:
            raise KeyError("Provide dataset_path to initialize the dataset")
        if kwargs.get("name") is None:
            raise KeyError("Provide dataset name to initialize it")
        self.cfg = Config(kwargs)
        self.name = self.cfg.name
        self.rng = np.random.default_rng(kwargs.get("seed", None))

    @staticmethod
    @abstractmethod
    def get_label_to_names():
        """Dict mapping label numbers to class names."""

    @abstractmethod
    def get_split(self, split):
        """Return a BaseDatasetSplit for 'training' / 'validation' /
        'testing'."""


class BaseDatasetSplit(ABC):
    """Access to one subset of a dataset."""

    def __init__(self, dataset, split="training"):
        self.cfg = dataset.cfg
        self.path_list = dataset.get_split_list(split)
        self.split = split
        self.dataset = dataset

    @abstractmethod
    def __len__(self):
        return 0

    @abstractmethod
    def get_data(self, idx):
        return {}

    @abstractmethod
    def get_attr(self, idx):
        return {}
