"""YAML config system: the JAX package's ``config.py`` schema.

A four-section YAML (``global_args`` / ``dataset`` / ``model`` /
``pipeline``) plus the ``tpu`` section of static budgets, parsed into
attribute-dicts that raise on missing keys, with the same cross-section
derivations in :meth:`Config.initialize_params`.  The ``tpu`` section's
defaults are the port's own ``configs.DEFAULT_TPU_CFG``.  PyYAML is
imported only by :meth:`Config.load_from_file`; a config built from a dict
needs none.
"""

import os
import copy

import numpy as np

from objectdetection_3d_tpu_torch.configs import DEFAULT_TPU_CFG


class ConfigDict(dict):
    """Attribute-style dict that raises on missing keys.

    Attribute access raises AttributeError and item access raises KeyError
    for unknown keys; nested dicts are wrapped recursively.
    """

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if arg is None:
                continue
            if isinstance(arg, dict):
                for k, v in arg.items():
                    self[k] = v
            else:
                raise TypeError(f"ConfigDict expects dicts, got {type(arg)}")
        for k, v in kwargs.items():
            self[k] = v

    @classmethod
    def _wrap(cls, value):
        if isinstance(value, ConfigDict):
            return value
        if isinstance(value, dict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"'{self.__class__.__name__}' object has no attribute "
                f"'{name}'")

    def __deepcopy__(self, memo):
        out = self.__class__()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo),
                             copy.deepcopy(v, memo))
        return out

    def to_dict(self):
        def convert(node):
            if isinstance(node, ConfigDict):
                return {k: convert(v) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(convert(v) for v in node)
            return node

        return convert(self)


class Config:
    """YAML-backed configuration."""

    def __init__(self, cfg_dict=None):
        if cfg_dict is None:
            cfg_dict = {}
        elif not isinstance(cfg_dict, dict):
            raise TypeError(
                f"cfg_dict should be a dict, but got {type(cfg_dict)}")
        object.__setattr__(self, "_cfg_dict", ConfigDict(cfg_dict))
        object.__setattr__(self, "cfg_dict", cfg_dict)

    def dump(self):
        """Return the configuration as plain nested dicts."""
        return self._cfg_dict.to_dict()

    @staticmethod
    def initialize_params(cfg):
        """Derive cross-section parameters.

        Fans out device/seed/paths, computes the voxel grid dims from range
        and voxel size, validates input features, shapes the vertical
        encoder, and shares box_params_num / model_dim with the head, then
        adds the ``tpu`` section of static budgets.
        Returns (dataset_cfg, pipeline_cfg, model_cfg).
        """
        if cfg.global_args.get("device") is not None:
            cfg.dataset.device = cfg.global_args.device
            cfg.pipeline.device = cfg.global_args.device
            cfg.model.device = cfg.global_args.device

        if cfg.global_args.get("output_path") is not None:
            os.makedirs(cfg.global_args.output_path, exist_ok=True)
            cfg.pipeline.log_dir = cfg.global_args.output_path

        if cfg.dataset.get("dataset_path") is not None:
            cfg.dataset.cache_dir = os.path.join(cfg.dataset.dataset_path,
                                                 "cache/")

        if cfg.global_args.get("seed") is not None:
            rng = np.random.default_rng(cfg.global_args.seed)
            cfg.dataset.seed = cfg.global_args.seed
            cfg.pipeline.seed = cfg.global_args.seed
            cfg.model.seed = cfg.global_args.seed
            # one shared host RNG, fanned out to every section
            cfg.dataset.rng = rng
            cfg.pipeline.rng = rng
            cfg.model.rng = rng

        cfg.pipeline.model_name = cfg.model.name
        cfg.pipeline.dataset_name = cfg.dataset.name
        cfg.pipeline.box_params_num = cfg.global_args.box_params_num
        cfg.pipeline.eval_dim = cfg.global_args.model_dim

        # voxel grid dims from range / voxel size
        pcr = np.array(cfg.model.point_cloud_range, dtype=np.float64)
        vsize = np.array(cfg.model.voxelize.voxel_size, dtype=np.float64)
        cfg.model.voxel_grid_dims = ((pcr[3:] - pcr[:3]) / vsize).tolist()

        input_feat = cfg.model.get("input_features", None)
        if input_feat is not None:
            # AssertionError, as the JAX package raises, but not an
            # assert: the check must hold under python -O too
            if len(input_feat) < 4:
                raise AssertionError("Not enough features, at least "
                                     "(x,y,z,reflectance) is required")
            if sum(i in input_feat for i in range(4)) != 4:
                raise AssertionError("Indexes (0,1,2,3) for "
                                     "(x,y,z,reflectance) have to be "
                                     "selected")
        else:
            cfg.model.input_features = [0, 1, 2, 3]

        # vertical encoder sparse shape, in [z, x, y] order
        cfg.model.vertical_encoder.output_shape = [
            cfg.model.voxel_grid_dims[i] for i in [2, 0, 1]
        ]

        cfg.model.head.box_params_num = cfg.global_args.box_params_num
        cfg.model.head.nms_dim = cfg.global_args.model_dim

        # --- static budgets (the schema's ``tpu`` section) ---------------
        tpu = ConfigDict(DEFAULT_TPU_CFG)
        tpu.update(cfg.get("tpu", {}) or {})
        cfg.tpu = tpu
        cfg.model.tpu = tpu
        cfg.pipeline.tpu = tpu

        return cfg.dataset, cfg.pipeline, cfg.model

    @staticmethod
    def merge_module_cfg_file(args):
        """Merge per-module YAML files."""
        cfg_dataset = Config.load_from_file(args.cfg_dataset)
        cfg_model = Config.load_from_file(args.cfg_model)
        cfg_pipeline = Config.load_from_file(args.cfg_pipeline)
        return Config({
            "dataset": cfg_dataset.cfg_dict,
            "model": cfg_model.cfg_dict,
            "pipeline": cfg_pipeline.cfg_dict,
        })

    @staticmethod
    def load_from_file(filename):
        if filename is None:
            raise FileExistsError("Config file is not defined")
        if not os.path.isfile(filename):
            raise FileNotFoundError(f"File {filename} not found")
        if not (filename.endswith(".yaml") or filename.endswith(".yml")):
            raise ImportError("Config file has to be a yaml or yml file")
        import yaml

        with open(filename) as f:
            cfg_dict = yaml.safe_load(f)
        return Config(cfg_dict)

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __getitem__(self, name):
        return self._cfg_dict[name]
