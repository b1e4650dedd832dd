"""Object-detection pipeline: training, validation, testing, inference.

The port of the JAX package's ``pipeline/pipeline.py`` with its artifact
set: ``process_config.json``, per-run ``log_train_*.txt`` /
``log_test_*.txt``, ``training_record.csv``, ``metrics.npy``,
``test_protocol.yaml``, periodic ``ckpt_{epoch:05d}.pth`` and the best-F1
``ckpt_best.pth`` (``.dcp`` directories of ``torch.distributed.checkpoint``
under ``ckpt_backend: orbax``; resume and testing read either, the
backend told by the path).  Batches come from the host data path
(``dataset/loader.py``: static shapes, host-thread prefetch) and go to the
model's train step (with gradient accumulation under ``tpu.microbatch``),
eval step and predict on the pipeline's device.

The state is the model's net and its optimizer.  ``data_parallel`` and
``spatial_parallel`` above 1 run one process per rank (``torchrun
--nproc_per_node=N`` or ``parallel.launch.spawn``; nccl on the cards,
gloo on the CPU or where a host's ranks outnumber its cards): each
rank's loader yields the same global batch of ``per replica x
data_parallel`` items, the sharded train and eval steps take their rows
(``parallel/data_parallel.py``), and rank 0 alone writes checkpoints,
``training_record.csv``, ``metrics.npy`` and the log files.
``show_inference`` draws with open3d where it imports, else writes a
matplotlib PNG.  Needs neither pandas nor PyYAML: the record is written
with ``csv``, the test protocol by hand.
"""

import csv
import json
import logging
import math
import os
import random
import re
import signal
from datetime import datetime
from os.path import join

import numpy as np
import torch

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    def tqdm(x, **kwargs):
        return x

from objectdetection_3d_tpu_torch.augment.numpy_ops import (
    bbox2corners3D_np,
    rotation_matrix_zyx,
)
from objectdetection_3d_tpu_torch.dataset.loader import (
    DataLoader,
    PreprocessedDataset,
    StaticBatcher,
)
from objectdetection_3d_tpu_torch.metrics import MetricEvaluator
from objectdetection_3d_tpu_torch.models.network import init_parameters
from objectdetection_3d_tpu_torch.ops.boxes import validate_boxes
from objectdetection_3d_tpu_torch.pipeline import checkpoint as ckpt_io
from objectdetection_3d_tpu_torch.pipeline.base_pipeline import BasePipeline
from objectdetection_3d_tpu_torch.pipeline.utils import latest_ckpt
from objectdetection_3d_tpu_torch.profiling import (
    StepTimer,
    TensorBoardLogger,
    trace,
)
from objectdetection_3d_tpu_torch.utils import make_dir

log = logging.getLogger(__name__)

RECORD_COLUMNS = ("epoch", "precision", "recall", "f1")


def _yaml_scalar(value):
    """One scalar in YAML that ``yaml.safe_load`` reads back as the same
    value: null, bool, int, float (always with a dot) or a JSON-quoted
    string."""
    if value is None:
        return "null"
    if isinstance(value, (bool, np.bool_)):
        return "true" if value else "false"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        value = float(value)
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mant, e, exp = text.partition("e")
        if "." not in mant:
            mant += ".0"
        if e and exp[0] not in "+-":
            exp = "+" + exp
        return mant + (e + exp if e else "")
    return json.dumps(str(value))


def write_flat_yaml(path, mapping):
    """Write a flat map of scalars as YAML, keys sorted."""
    with open(path, "w") as f:
        for key in sorted(mapping):
            value = _yaml_scalar(mapping[key])
            f.write(f"{json.dumps(str(key))}: {value}\n")


def read_flat_yaml(path):
    """Read back what :func:`write_flat_yaml` wrote (no PyYAML)."""
    special = {"null": None, "true": True, "false": False,
               ".nan": math.nan, ".inf": math.inf, "-.inf": -math.inf}
    out = {}
    with open(path) as f:
        for line in f:
            key, _, value = line.rstrip("\n").partition(": ")
            out[json.loads(key)] = (special[value] if value in special
                                    else json.loads(value))
    return out


def read_record(path):
    """The rows of a ``training_record.csv``: int epochs, float
    metrics."""
    with open(path, newline="") as f:
        return [{k: int(float(v)) if k == "epoch" else float(v)
                 for k, v in row.items()} for row in csv.DictReader(f)]


def write_record(path, rows):
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=RECORD_COLUMNS)
        writer.writeheader()
        writer.writerows(rows)


class ObjectDetection(BasePipeline):
    """Pipeline for object detection."""

    def __init__(self, model, dataset, global_cfg, **kwargs):
        super().__init__(model=model, dataset=dataset,
                         global_cfg=global_cfg, **kwargs)
        if model.device != self.device:
            raise ValueError(f"the model is on {model.device}, the "
                             f"pipeline on {self.device}")
        self.ckpt_backend = ckpt_io.check_backend(
            self.cfg.get("ckpt_backend", None))
        self.ME = MetricEvaluator(eval_dim=self.cfg.get("eval_dim", 3),
                                  device=self.device)

        tcfg = model.tpu_cfg
        self.batcher = StaticBatcher(
            max_points=tcfg["max_points_static"],
            max_gt=tcfg["max_gt_static"],
            num_features=len(model.input_features),
            box_params_num=model.box_params_num,
            seed=kwargs.get("seed", 0))

        self.optimizer = None
        self._eval_fn = None

    # ------------------------------------------------------------------
    # ranks
    # ------------------------------------------------------------------
    def _ensure_mesh(self):
        """The process groups of ``data_parallel`` x ``spatial_parallel``
        ranks (None when both are 1), joined through the environment that
        ``torchrun`` or ``parallel.launch.spawn`` sets; a world of another
        size raises ``ValueError``."""
        self.data_parallel = max(int(self.cfg.get("data_parallel", 1)
                                     or 1), 1)
        self.spatial_parallel = max(int(self.cfg.get("spatial_parallel", 1)
                                        or 1), 1)
        if self.data_parallel * self.spatial_parallel == 1:
            return None
        from objectdetection_3d_tpu_torch.parallel import make_mesh_2d

        mesh = make_mesh_2d(
            self.data_parallel, self.spatial_parallel,
            device="cpu" if self.device.type == "cpu" else None)
        log.info("Process mesh: %s", mesh.shape)
        return mesh

    def _global_batch(self, per_replica):
        """Loader batch size: per-replica size x data-parallel ranks."""
        return max(int(per_replica), 1) * self.data_parallel

    def _ensure_eval_fn(self):
        if self._eval_fn is None:
            if self.mesh is not None:
                from objectdetection_3d_tpu_torch.parallel import (
                    make_sharded_eval_fn,
                )
                self._eval_fn = make_sharded_eval_fn(self.model, self.mesh)
            else:
                self._eval_fn = self.model.make_eval_fn()
        return self._eval_fn

    def _make_train_step(self, microbatch):
        if self.mesh is None:
            return self.model.make_train_step(self.optimizer,
                                              microbatch=microbatch)
        from objectdetection_3d_tpu_torch.parallel import (
            make_sharded_train_step,
        )
        log.info("Training %d-way data-parallel%s (global batch %d)",
                 self.data_parallel,
                 (f" x {self.spatial_parallel}-way spatial"
                  if self.spatial_parallel > 1 else ""),
                 self._global_batch(self.cfg.get("training_batch_size", 1)))
        return make_sharded_train_step(
            self.model, self.optimizer, self.mesh,
            space_axis="space" if self.spatial_parallel > 1 else None,
            microbatch=microbatch)

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def save_ckpt(self, epoch, save_best=False):
        if not self.is_main:
            return
        ckpt_dir = join(self.cfg.log_dir, "checkpoint/")
        make_dir(ckpt_dir)
        suffix = ckpt_io.SUFFIX[self.ckpt_backend]
        path = join(ckpt_dir, f"ckpt_best{suffix}" if save_best
                    else f"ckpt_{epoch:05d}{suffix}")
        if self.cfg.get("async_ckpt", True):
            # the state is copied to the host before save() returns; the
            # write overlaps the next epoch
            if not hasattr(self, "_ckpt_saver"):
                self._ckpt_saver = ckpt_io.AsyncSaver()
            self._ckpt_saver.save(path, epoch, self.model.net,
                                  self.optimizer, self._augment_generator(),
                                  backend=self.ckpt_backend)
        else:
            ckpt_io.save_ckpt(path, epoch, self.model.net, self.optimizer,
                              self._augment_generator(),
                              backend=self.ckpt_backend)
        log.info(f"Epoch {epoch:3d}: save ckpt to {path:s}")

    def wait_for_ckpts(self):
        """Drain pending async checkpoint writes (no-op when sync)."""
        saver = getattr(self, "_ckpt_saver", None)
        if saver is not None:
            saver.wait()

    def load_ckpt(self):
        """Restore the state for this run: the latest periodic checkpoint
        on resume, the best one (else the latest) in inference mode.

        Returns:
            (first epoch to train, path loaded or None).
        """
        self.wait_for_ckpts()
        ckpt_dir = join(self.cfg.log_dir, "checkpoint/")
        epoch = 0

        if not self.cfg.get("inference_mode"):
            if self.cfg.get("is_resume"):
                last_ckpt_path = latest_ckpt(ckpt_dir)
                if last_ckpt_path:
                    epoch = int(re.findall(r"\d+", last_ckpt_path)[-1]) + 1
                    ckpt_path = last_ckpt_path
                    log.info("Model restored from the latest checkpoint: "
                             "{}".format(epoch))
                else:
                    log.info("Latest checkpoint was not found")
                    log.info("Initializing from scratch.")
                    return epoch, None
            else:
                log.info("Initializing from scratch.")
                return epoch, None
        else:
            ckpt_path = join(
                ckpt_dir, f"ckpt_best{ckpt_io.SUFFIX[self.ckpt_backend]}")
            if not os.path.exists(ckpt_path):
                # ckpt_best exists only once validation F1 has beaten 0;
                # a short run is still testable from its latest checkpoint
                fallback = latest_ckpt(ckpt_dir)
                if fallback:
                    log.warning(
                        "No best checkpoint at %s (validation F1 never "
                        "improved); falling back to the latest periodic "
                        "checkpoint %s", ckpt_path, fallback)
                    ckpt_path = fallback
                else:
                    raise ValueError(
                        "There is no pretrained model for inference. Best "
                        "output of training should be found as "
                        "{}".format(ckpt_path))

        log.info(f"Loading checkpoint {ckpt_path}")
        payload = ckpt_io.load_ckpt(ckpt_path, map_location=self.device)
        self.model.net.load_state_dict(payload["model_state_dict"])
        opt_state = payload.get("optimizer_state_dict")
        if opt_state is not None and self.optimizer is not None:
            log.info("Loading checkpoint optimizer state")
            try:
                ckpt_io.load_optimizer_state(self.model.net,
                                             self.optimizer, opt_state)
            except (ValueError, KeyError) as e:  # another optimizer layout
                log.warning("Could not restore optimizer state: %s", e)
        rng_state = payload.get("augment_rng_state")
        if rng_state is not None and self._augment_generator() is not None:
            self.model.augment_generator.set_state(rng_state.cpu())
        return epoch, ckpt_path

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def _init_state(self):
        """Fresh parameters and running statistics, drawn through a
        ``torch.Generator`` seeded from the pipeline's RNG; with
        ``device_augment``, the model's ``augment_generator`` seeded from
        the next draw of that RNG."""
        seed = int(self.rng.integers(np.iinfo(np.int32).max))
        init_parameters(self.model.net, torch.Generator().manual_seed(seed))
        if self.model.device_augment:
            self.model.augment_generator.manual_seed(
                int(self.rng.integers(np.iinfo(np.int32).max)))
        if self.mesh is not None:
            # rank 0's draws on every rank (equal already under a seed)
            import torch.distributed as dist

            for t in self.model.net.state_dict().values():
                dist.broadcast(t, 0)
            state = [self.model.augment_generator.get_state()]
            dist.broadcast_object_list(state, src=0)
            self.model.augment_generator.set_state(state[0])

    def _augment_generator(self):
        """The generator whose state a checkpoint carries: the model's
        ``augment_generator`` under ``device_augment``, else None."""
        return (self.model.augment_generator if self.model.device_augment
                else None)

    def _device_arrays(self, batch):
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.arrays.items()}

    def _attach_log_file(self, log_file_path):
        """Route module logs to a per-run file, replacing the file handler
        of an earlier run_training/run_testing call of this pipeline (rank
        0 only)."""
        if not self.is_main:
            return
        old = getattr(self, "_log_file_handler", None)
        if old is not None:
            log.removeHandler(old)
            old.close()
        handler = logging.FileHandler(log_file_path)
        log.addHandler(handler)
        self._log_file_handler = handler

    # ------------------------------------------------------------------
    # metric plumbing
    # ------------------------------------------------------------------
    @staticmethod
    def _target_for_metric(boxes, labels):
        return {"bbox": np.asarray(boxes, np.float32).reshape(-1, 9),
                "label": np.asarray(labels).reshape(-1),
                "score": np.ones((len(boxes),), np.float32)}

    @staticmethod
    def _pred_for_metric(preds, i):
        """Item ``i``'s valid detections of host (numpy) ``preds``."""
        valid = preds["valid"][i]
        return {"bbox": preds["bbox"][i][valid],
                "label": preds["label"][i][valid],
                "score": preds["score"][i][valid]}

    # ------------------------------------------------------------------
    # inference entry points
    # ------------------------------------------------------------------
    def run_inference(self, data, validate=False):
        """Detections of one preprocessed data item (or ``{"data": ...,
        "attr": ...}``) from this run's checkpoint.

        ``validate=True`` first checks the item's GT boxes
        (``ops.boxes.validate_boxes``, which raises ``ValueError``).
        """
        if validate:
            item = data["data"] if isinstance(data, dict) and "data" in data \
                else data
            if isinstance(item, dict) and item.get("bboxes") is not None:
                validate_boxes(item["bboxes"])
        self.load_ckpt()
        if isinstance(data, dict) and "data" in data:
            batch = self.batcher.collate([data])
        else:
            batch = self.batcher.collate([{"data": data, "attr": {}}])
        preds = self.model.predict(self._device_arrays(batch))
        return self.model.inference_end(preds)

    def show_inference(self):
        """Metric and visual check of one random test cloud from this
        run's checkpoint (reference pipeline/pipeline.py:160-229): prints
        its precision, recall and F1, draws it, and returns its
        detections ``{"bbox", "label", "score"}`` (numpy)."""
        test_dataset = self.dataset.get_split("test")
        test_split = PreprocessedDataset(dataset=test_dataset,
                                         preprocess=self.model.preprocess,
                                         transform=self.model.transform)
        idx = random.sample(range(0, len(test_dataset)), 1)
        print(idx)
        data_item = test_split[idx[0]]
        print(test_dataset.get_attr(idx[0]))

        self.load_ckpt()
        batch = self.batcher.collate([data_item])
        preds = self.model.predict(self._device_arrays(batch))
        preds = {k: v.cpu().numpy() for k, v in preds.items()}

        data = data_item["data"]
        target = [self._target_for_metric(data["bboxes"], data["labels"])]
        prediction = [self._pred_for_metric(preds, 0)]

        precision, recall = self.ME.evaluate(
            prediction, target, self.model.classes_ids,
            self.cfg.get("overlaps", [0.1]))

        print("")
        print(f' {" ": <9} "==== Precision ==== Recall ==== F1 ====" ')
        precision = np.mean(precision[:, -1])
        recall = np.mean(recall[:, -1])
        f1 = 2 * precision * recall / (precision + recall)
        print("Overall_precision: {:.2f}".format(precision))
        print("Overall_recall: {:.2f}".format(recall))
        print("F1: {:.2f}".format(f1))

        self._draw(data, prediction[0])
        return prediction[0]

    def _draw(self, data, prediction):
        """Open3D viewer with red predictions / green GT, if available;
        headless matplotlib PNG in the run directory otherwise."""
        try:
            import open3d as o3d
        except ImportError:
            log.info("open3d not available; rendering matplotlib PNG")
            self._draw_matplotlib(data, prediction)
            return

        geometries = []
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(data["point"][:, :3])
        geometries.append(pcd)

        for box in prediction["bbox"]:
            roll, pitch, yaw = rotation_matrix_zyx(*box[6:9])
            o3box = o3d.geometry.OrientedBoundingBox(
                box[:3], yaw @ pitch @ roll, box[3:6])
            o3box.color = (1, 0, 0)
            geometries.append(o3box)

        for box in np.array(data["bboxes"]):
            box = box.copy()
            box[2] = box[2] + box[5] / 2
            roll, pitch, yaw = rotation_matrix_zyx(*box[6:9])
            o3box = o3d.geometry.OrientedBoundingBox(
                box[:3], yaw @ pitch @ roll, box[3:6])
            o3box.color = (0, 1, 0)
            geometries.append(o3box)

        o3d.visualization.draw_geometries(geometries)

    def _draw_matplotlib(self, data, prediction, max_points=60_000):
        """Headless stand-in for the reference's open3d viewer: the cloud
        with red predicted and green GT wireframes, saved as
        ``show_inference_<time>.png`` in the run's log directory."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        pts = np.asarray(data["point"])[:, :3]
        if len(pts) > max_points:
            sel = np.random.default_rng(0).choice(len(pts), max_points,
                                                  replace=False)
            pts = pts[sel]

        fig = plt.figure(figsize=(10, 10))
        ax = fig.add_subplot(projection="3d")
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.3, c=pts[:, 2],
                   cmap="viridis", alpha=0.5, linewidths=0)

        # bottom ring, top ring, verticals of the 8-corner ordering
        edges = [(0, 1), (1, 2), (2, 3), (3, 0),
                 (4, 5), (5, 6), (6, 7), (7, 4),
                 (0, 4), (1, 5), (2, 6), (3, 7)]

        def wires(box, color):
            c = bbox2corners3D_np(np.asarray(box, np.float64))
            for a, b in edges:
                ax.plot(*zip(c[a], c[b]), color=color, linewidth=1.2)

        for box in np.asarray(prediction["bbox"]):
            box = np.array(box, np.float64).copy()
            box[2] -= box[5] / 2  # decode emits z at the centre
            wires(box, "red")
        for box in np.asarray(data["bboxes"]):
            wires(box, "green")  # GT z is at the bottom already

        ax.set_xlabel("x [m]")
        ax.set_ylabel("y [m]")
        ax.set_zlabel("z [m]")
        ax.set_title("red = predicted, green = ground truth")
        out = join(self.cfg.log_dir,
                   "show_inference_{}.png".format(
                       datetime.now().strftime("%Y-%m-%d_%H:%M:%S")))
        fig.savefig(out, dpi=130, bbox_inches="tight")
        plt.close(fig)
        log.info("visualization written to %s", out)
        print(f"visualization written to {out}")

    # ------------------------------------------------------------------
    # evaluation loops
    # ------------------------------------------------------------------
    def _eval_split(self, split_name, batch_size, compute_losses=True):
        """Shared valid/test loop: returns (losses_dict, pred, target)."""
        split = PreprocessedDataset(
            dataset=self.dataset.get_split(split_name),
            preprocess=self.model.preprocess,
            transform=self.model.transform,
            seed=self.cfg.get("seed", 0))
        loader = DataLoader(split, self.batcher,
                            batch_size=self._global_batch(batch_size),
                            prefetch=2,
                            num_workers=self.cfg.get("num_workers", 0))
        eval_fn = self._ensure_eval_fn()

        losses_acc = {}
        prediction, target = [], []
        for batch in tqdm(loader, desc=split_name):
            losses, preds = eval_fn(self._device_arrays(batch))
            if compute_losses:
                for k, v in losses.items():
                    losses_acc.setdefault(k, []).append(float(v))
            preds = {k: v.cpu().numpy() for k, v in preds.items()}
            for i in range(len(batch.attr)):
                if getattr(batch, "pad_flags", None) and batch.pad_flags[i]:
                    continue
                if batch.arrays["num_points"][i] == 0:
                    log.info("Invalid point cloud load: {}".format(
                        batch.attr[i].get("path")))
                    continue
                target.append(self._target_for_metric(
                    batch.unpadded_boxes(i), batch.unpadded_labels(i)))
                prediction.append(self._pred_for_metric(preds, i))
        return losses_acc, prediction, target

    def _log_pr(self, precision, recall):
        log.info("")
        log.info(f' {" ": <9} "==== Precision ==== Recall ==== F1 ====" ')
        for i, c in enumerate(self.model.classes):
            p = precision[i, 0]
            rec = recall[i, 0]
            f1 = 2 * p * rec / (p + rec) if (p + rec) > 0 else 0.0
            log.info(f' {c: <15} {p: <15.2f} {rec: <10.2f} {f1:.2f}')
        precision = np.mean(precision[:, -1])
        recall = np.mean(recall[:, -1])
        f1 = (2 * precision * recall / (precision + recall)
              if (precision + recall) > 0 else 0.0)
        log.info("")
        log.info("Overall_precision: {:.2f}".format(precision))
        log.info("Overall_recall: {:.2f}".format(recall))
        log.info("F1: {:.2f}".format(f1))
        return float(precision), float(recall), float(f1)

    def run_valid(self):
        """Validation losses and precision / recall / F1."""
        log.info("Started validation")
        losses_acc, prediction, target = self._eval_split(
            "validation", self.cfg.get("validation_batch_size", 1))

        sum_loss = 0.0
        desc = "validation - "
        valid_losses = {}
        for k, v in losses_acc.items():
            valid_losses[k] = np.mean(v)
            desc += " %s: %.03f" % (k, valid_losses[k])
            sum_loss += valid_losses[k]
        desc += " > loss: %.03f" % sum_loss
        log.info(desc)

        precision, recall = self.ME.evaluate(
            prediction, target, self.model.classes_ids,
            self.cfg.get("overlaps", [0.1]))
        p, r, f1 = self._log_pr(precision, recall)
        valid_losses["precision"] = p
        valid_losses["recall"] = r
        valid_losses["f1"] = f1
        return valid_losses

    def run_testing(self):
        """Test-split evaluation from this run's checkpoint, writing
        ``test/test_protocol.yaml``; returns the protocol dict."""
        test_folder = join(self.cfg.log_dir, "test/")
        if self.is_main:
            make_dir(test_folder)
        timestamp = datetime.now().strftime("%Y-%m-%d_%H:%M:%S")
        log.info("DEVICE : {}".format(self.device))
        log_file_path = join(test_folder, "log_test_" + timestamp + ".txt")
        log.info("Logging in file : {}".format(log_file_path))
        self._attach_log_file(log_file_path)

        self.load_ckpt()
        log.info("Started testing")

        _, prediction, target = self._eval_split(
            "testing", self.cfg.get("testing_batch_size", 1),
            compute_losses=False)

        precision, recall = self.ME.evaluate(
            prediction, target, self.model.classes_ids,
            self.cfg.get("overlaps", [0.1]))
        p, r, f1 = self._log_pr(precision, recall)

        test_protocol = {
            "0_model": self.cfg.get("model_name", None),
            "1_model_version": self.cfg.get("resume_from", None),
            "2_dataset": self.cfg.get("dataset_name", None),
            "3_date": datetime.now().strftime("%Y-%m-%d_%H:%M:%S"),
            "4_precision": p,
            "5_recall": r,
            "6_f1": f1,
        }
        if self.is_main:
            write_flat_yaml(join(test_folder, "test_protocol.yaml"),
                            test_protocol)
        return test_protocol

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def run_training(self):
        """Train from scratch or resume; returns the training record (a
        list of {epoch, precision, recall, f1} rows, as written to
        ``training_record.csv``)."""
        if self.is_main:
            with open(join(self.cfg.log_dir, "process_config.json"),
                      "w") as outfile:
                json.dump(dict(self.global_cfg), outfile, default=str)

        log.info("DEVICE : {}".format(self.device))
        timestamp = datetime.now().strftime("%Y-%m-%d_%H:%M:%S")
        log_file_path = join(self.cfg.log_dir,
                             "log_train_" + timestamp + ".txt")
        log.info("Logging in file : {}".format(log_file_path))
        self._attach_log_file(log_file_path)

        train_split = PreprocessedDataset(
            dataset=self.dataset.get_split("training"),
            preprocess=self.model.preprocess,
            transform=self.model.transform,
            seed=self.cfg.get("seed", 0))
        train_loader = DataLoader(
            train_split, self.batcher,
            batch_size=self._global_batch(
                self.cfg.get("training_batch_size", 1)),
            prefetch=2,
            num_workers=self.cfg.get("num_workers", 0))

        self._init_state()
        self.optimizer = self.model.get_optimizer(
            dict(self.cfg.get("optimizer", {})),
            grad_clip_value=self.cfg.get("grad_clip_norm", -1))
        # tpu.microbatch > 0 trains each batch as gradient accumulation
        # over chunks of that many items; 0 = one step over the batch
        mb = int(self.model.tpu_cfg.get("microbatch", 0) or 0)
        train_step = self._make_train_step(mb if mb > 0 else None)
        if mb > 0:
            log.info("Gradient accumulation: microbatch=%d", mb)
        start_ep, _ = self.load_ckpt()

        record_path = join(self.cfg.log_dir, "training_record.csv")
        training_record = (read_record(record_path)
                           if os.path.exists(record_path) else [])

        timer = StepTimer(log_every=self.cfg.get("log_step_freq", 50))
        tb = TensorBoardLogger(
            self.is_main and self.cfg.get("tensorboard", False),
            self.cfg.log_dir)
        # resume continues the scalar stream at the right step index
        global_step = max(start_ep - 1, 0) * len(train_loader)
        profile_dir = self.is_main and self.cfg.get("profile_dir", None)
        profile_steps = int(self.cfg.get("profile_steps", 0))
        profiled = 0

        # preemption safety: SIGTERM/SIGINT request a checkpoint and a
        # clean stop at the next epoch boundary (resume with is_resume)
        self._preempted = False

        def _request_stop(signum, frame):
            if self._preempted:
                # second signal: restore the original handler and re-raise
                log.warning("Second signal %s: aborting immediately",
                            signum)
                signal.signal(signum, old_handlers.get(signum,
                                                       signal.SIG_DFL))
                signal.raise_signal(signum)
                return
            log.warning("Signal %s received: will checkpoint and stop "
                        "after the current epoch (repeat to abort "
                        "immediately)", signum)
            self._preempted = True

        old_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                old_handlers[sig] = signal.signal(sig, _request_stop)
            except ValueError:  # not the main thread
                pass

        metrics_path = join(self.cfg.log_dir, "metrics.npy")
        best_f1 = (float(np.load(metrics_path)[2])
                   if os.path.exists(metrics_path) else 0.0)

        log.info("Started training")
        for epoch in range(start_ep, self.cfg.get("max_epoch", 1) + 1):
            log.info(f"================================ EPOCH {epoch:d}/"
                     f"{self.cfg.get('max_epoch', 1):d} "
                     f"================================")
            train_split.set_epoch(epoch)  # fresh augmentation stream
            self.losses = {}
            process_bar = tqdm(train_loader, desc="training")
            for batch in process_bar:
                arrays = self._device_arrays(batch)
                if profile_dir and profiled < profile_steps:
                    with trace(profile_dir):
                        losses = train_step(arrays)
                        if self.device.type == "cuda":
                            torch.cuda.synchronize(self.device)
                    profiled += 1
                else:
                    losses = train_step(arrays)
                losses.pop("num_pos")
                desc = "training - "
                vals = {k: float(v) for k, v in losses.items()}
                # the losses are on the host: the step has finished
                timer.step()
                for k, val in vals.items():
                    if np.isnan(val) and self.cfg.get("halt_on_nan", True):
                        raise FloatingPointError(
                            f"NaN in {k} at epoch {epoch} "
                            f"(batch {batch.attr}); halting: resume from "
                            f"the last checkpoint with is_resume: true")
                    self.losses.setdefault(k, []).append(val)
                    desc += " %s: %.03f" % (k, val)
                desc += " > loss: %.03f" % sum(vals.values())
                if hasattr(process_bar, "set_description"):
                    process_bar.set_description(desc)
                tb.scalars("train", vals, global_step)
                tb.scalar("train/loss_total", sum(vals.values()),
                          global_step)
                if timer.last_rate:
                    tb.scalar("train/steps_per_sec", timer.last_rate,
                              global_step)
                global_step += 1

            if (epoch % self.cfg.get("validation_freq", 1)) == 0:
                metrics = self.run_valid()
                row = {"epoch": epoch, "precision": metrics["precision"],
                       "recall": metrics["recall"], "f1": metrics["f1"]}
                training_record = [r for r in training_record
                                   if r["epoch"] != epoch] + [row]
                tb.scalars("valid", {k: metrics[k] for k in
                                     ("precision", "recall", "f1")},
                           epoch)
                if metrics["f1"] > best_f1:
                    best_f1 = metrics["f1"]
                    self.save_ckpt(epoch, save_best=True)
                    if self.is_main:
                        np.save(metrics_path,
                                np.array([metrics["precision"],
                                          metrics["recall"],
                                          metrics["f1"]]))

            if epoch % self.cfg.get("save_ckpt_freq", 5) == 0:
                self.save_ckpt(epoch, save_best=False)

            if self.is_main:
                write_record(record_path, training_record)
            if self._preempted:
                self.save_ckpt(epoch, save_best=False)
                log.warning("Preemption checkpoint written for epoch %d; "
                            "stopping", epoch)
                break

        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
        tb.close()
        self.wait_for_ckpts()
        return training_record
