"""The port's pipeline, checkpoints and metrics on the CPU, on the
synthetic forest workspace and config of ``tests/test_pipeline.py``
(``device: cpu``).

* ``run_training``: the artifact set, finite losses, resume from the
  latest checkpoint (the record appended, the optimizer restored), the
  preemption save on SIGINT, and ``tpu.microbatch`` routed to the
  accumulation step.
* ``run_testing``: the best checkpoint, else the latest; no checkpoint at
  all raises; ``test_protocol.yaml`` reads back with ``yaml.safe_load``.
* ``run_testing`` from the same weights in the port and in the JAX
  package (JAX variables -> ``weights.from_jax_variables`` -> a ``.pth``
  checkpoint): per-cloud detections equal (valid counts and labels exact,
  boxes atol 1e-4, scores atol 1e-5) and the protocol's precision, recall
  and F1 equal to 1e-9 relative.
* ``.pth`` checkpoints: round trip of the net and the optimizer, the
  host snapshot, the async writer's error propagation, the atomic write;
  an unknown ``ckpt_backend`` raises.
* ``ckpt_backend: orbax`` (``torch.distributed.checkpoint`` directories,
  ``tests/test_pipeline.py``'s orbax round trip): the round trip of the
  net, the optimizer, the epoch and a generator's state; training writes
  ``.dcp`` directories and is the ``.pth`` run step for step; resume
  starts at the next epoch with the optimizer restored; ``run_testing``
  from ``ckpt_best.dcp`` gives the ``.pth`` run's P/R/F1.
* ``show_inference`` from the same weights in both packages: with
  Python's ``random`` seeded alike, the same P/R/F1 block, detections
  equal to ``run_inference`` on the same item, a PNG in the run
  directory; ``entry show`` refuses ``inference_mode: false``.
* ``MetricEvaluator`` against the JAX package's on the cases of
  ``tests/test_metrics.py``, in 2D and 3D: precision and recall equal to
  1e-9 relative; ``validate_boxes`` raises where the JAX package's does.
"""

import glob
import json
import logging
import os
import random
import shutil
import signal
import threading
import time
import zlib

import jax
import numpy as np
import pytest
import torch

from objectdetection_3d_tpu.config import Config as JaxConfig
from objectdetection_3d_tpu.dataset import Forest3D as JaxForest3D
from objectdetection_3d_tpu.metrics import MetricEvaluator as JaxME
from objectdetection_3d_tpu.models import PointPillars as JaxPointPillars
from objectdetection_3d_tpu.ops.boxes import (
    corners_2d_envelope as jax_corners_2d_envelope,
)
from objectdetection_3d_tpu.ops.boxes import (
    validate_boxes as jax_validate_boxes,
)
from objectdetection_3d_tpu.pipeline import ObjectDetection as JaxPipeline
from objectdetection_3d_tpu.pipeline import checkpoint as jax_ckpt
from objectdetection_3d_tpu_torch.config import Config
from objectdetection_3d_tpu_torch.entry import build_pipeline
from objectdetection_3d_tpu_torch.entry import main as entry_main
from objectdetection_3d_tpu_torch.entry import require_mode
from objectdetection_3d_tpu_torch.metrics import MetricEvaluator
from objectdetection_3d_tpu_torch.models.weights import from_jax_variables
from objectdetection_3d_tpu_torch.ops.boxes import (
    corners_2d_envelope,
    validate_boxes,
)
from objectdetection_3d_tpu_torch.pipeline import checkpoint as ckpt_io
from objectdetection_3d_tpu_torch.pipeline.pipeline import (
    read_flat_yaml,
    read_record,
    write_flat_yaml,
)
from objectdetection_3d_tpu_torch.pipeline.utils import latest_ckpt
from test_metrics import box
from test_pipeline import make_cfg, write_scene
from test_torch_port_model import _random_variables

torch.set_num_threads(1)

VERSION = "2026-01-02-03-04-05"


def scene_seed(split):
    """The first scene seed of a split; the same in every process
    (``hash`` of a ``str`` is salted per process)."""
    return zlib.crc32(split.encode()) % 997


def make_workspace(root, testing_seed=None):
    """Two scenes per split under ``root/data``: seeds ``s`` and ``s + 1``,
    ``s`` = :func:`scene_seed`, or ``testing_seed`` for the testing
    split."""
    for split in ("training", "validation", "testing"):
        d = root / "data" / split
        d.mkdir(parents=True)
        first = (testing_seed if split == "testing"
                 and testing_seed is not None else scene_seed(split))
        for i in range(2):
            write_scene(d, f"{split}_{i}", seed=first + i)
    return root


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return make_workspace(tmp_path_factory.mktemp("ws"))


def port_cfg(root, out="output", **pipeline):
    """``test_pipeline.make_cfg``'s dict with the output under ``out``
    and ``pipeline`` keys overridden."""
    d = make_cfg(root).dump()
    d["global_args"]["output_path"] = str(root / out) + "/"
    d["pipeline"].update(pipeline)
    return Config(d)


def build(cfg):
    pipeline, _ = build_pipeline(cfg=cfg)
    return pipeline


def version_of(pipeline):
    return os.path.basename(os.path.dirname(
        os.path.dirname(pipeline.cfg.log_dir.rstrip("/") + "/")))


@pytest.fixture(scope="module")
def trained_run(workspace):
    pipeline = build(port_cfg(workspace))
    record = pipeline.run_training()
    return pipeline, record


def test_training_artifacts(trained_run):
    pipeline, record = trained_run
    log_dir = pipeline.cfg.log_dir
    files = os.listdir(log_dir)
    assert {"process_config.json", "training_record.csv",
            "checkpoint"} <= set(files)
    assert any(f.startswith("log_train_") for f in files)
    assert {"ckpt_00000.pth", "ckpt_00001.pth"} <= set(
        os.listdir(os.path.join(log_dir, "checkpoint")))
    assert [r["epoch"] for r in record] == [0, 1]
    assert read_record(os.path.join(log_dir, "training_record.csv")) == [
        {k: (v if k == "epoch" else pytest.approx(v, nan_ok=True))
         for k, v in r.items()} for r in record]
    if any(r["f1"] > 0 for r in record):
        assert "metrics.npy" in files
    try:
        import torch.utils.tensorboard  # noqa: F401
        assert os.listdir(os.path.join(log_dir, "tb"))
    except ImportError:
        pass
    for k, vals in pipeline.losses.items():
        assert np.all(np.isfinite(vals)), k
    assert set(pipeline.losses) == {"loss_cls", "loss_bbox", "loss_dir_x",
                                    "loss_dir_y", "loss_dir_z"}


def test_resume_appends_and_restores_the_optimizer(trained_run, workspace):
    pipeline, _ = trained_run
    cfg = port_cfg(workspace, is_resume=True, resume_from=version_of(
        pipeline), max_epoch=2)
    resumed = build(cfg)
    assert resumed.cfg.log_dir == pipeline.cfg.log_dir
    record = resumed.run_training()
    assert [r["epoch"] for r in record] == [0, 1, 2]
    ckpt = ckpt_io.load_ckpt(os.path.join(resumed.cfg.log_dir, "checkpoint",
                                          "ckpt_00002.pth"))
    assert ckpt["epoch"] == 2
    # two steps before the resume, one after: Adam's step count is 3
    steps = {int(s["step"]) for s in
             ckpt["optimizer_state_dict"]["state"].values()}
    assert steps == {3}


def _inference_pipeline(workspace, version, out="output", **pipeline):
    cfg = port_cfg(workspace, out=out, inference_mode=True,
                   resume_from=version, **pipeline)
    pipeline, cfg_pipeline = build_pipeline(cfg=cfg)
    require_mode(cfg_pipeline, True, "testing")
    with pytest.raises(ValueError, match="inference_mode"):
        require_mode(cfg_pipeline, False, "training")
    return pipeline


def test_run_testing_best_then_latest(trained_run, workspace):
    yaml = pytest.importorskip("yaml")
    pipeline, _ = trained_run
    ckpt_dir = os.path.join(pipeline.cfg.log_dir, "checkpoint")
    best = os.path.join(ckpt_dir, "ckpt_best.pth")
    stash = best + ".stash"
    had_best = os.path.exists(best)
    if had_best:
        shutil.move(best, stash)
    try:
        # no best checkpoint: the latest periodic one
        tester = _inference_pipeline(workspace, version_of(pipeline))
        assert tester.load_ckpt()[1].endswith(latest_ckpt(ckpt_dir))
        protocol = tester.run_testing()
    finally:
        if had_best:
            shutil.move(stash, best)
    shutil.copy(latest_ckpt(ckpt_dir), best)
    tester = _inference_pipeline(workspace, version_of(pipeline))
    assert tester.load_ckpt()[1] == best
    again = tester.run_testing()
    with open(os.path.join(tester.cfg.log_dir, "test",
                           "test_protocol.yaml")) as f:
        saved = yaml.safe_load(f)
    assert saved == {k: pytest.approx(v, nan_ok=True)
                     if isinstance(v, float) else v
                     for k, v in again.items()}
    assert set(saved) == {"0_model", "1_model_version", "2_dataset",
                          "3_date", "4_precision", "5_recall", "6_f1"}
    assert saved["1_model_version"] == version_of(pipeline)
    assert repr(read_flat_yaml(os.path.join(
        tester.cfg.log_dir, "test", "test_protocol.yaml"))) == repr(saved)
    for k in ("4_precision", "5_recall", "6_f1"):
        assert protocol[k] == pytest.approx(again[k], nan_ok=True)


def test_flat_yaml_round_trips_through_pyyaml(tmp_path):
    yaml = pytest.importorskip("yaml")
    values = {"a": None, "b": True, "c": 3, "d": 1e-05, "e": 2.5e20,
              "f": -0.0, "g": float("inf"), "h": "2026-01-02_03:04:05",
              "i": 'quote " and : colon', "j": 66.66666666666667,
              "k": np.float64(12.5), "l": np.int64(7)}
    path = str(tmp_path / "p.yaml")
    write_flat_yaml(path, values)
    with open(path) as f:
        assert yaml.safe_load(f) == values
    assert read_flat_yaml(path) == values
    write_flat_yaml(path, {"n": float("nan")})
    with open(path) as f:
        assert np.isnan(yaml.safe_load(f)["n"])
    assert np.isnan(read_flat_yaml(path)["n"])


def test_load_ckpt_raises_with_no_ckpts_at_all(workspace, tmp_path):
    tester = _inference_pipeline(workspace, VERSION, out="empty_out")
    tester.cfg.log_dir = str(tmp_path) + "/"
    with pytest.raises(ValueError, match="no pretrained model"):
        tester.load_ckpt()


def test_latest_ckpt_natural_sort(tmp_path):
    assert latest_ckpt(str(tmp_path / "nope")) is None
    for name in ("ckpt_00002.pth", "ckpt_00010.pth", "ckpt_best.pth",
                 "ckpt_00011.pth.tmp"):
        (tmp_path / name).write_bytes(b"x")
    assert latest_ckpt(str(tmp_path)).endswith("ckpt_00010.pth")
    # DCP directories take part; a directory being written does not
    for name in ("ckpt_00012.dcp", "ckpt_best.dcp", "ckpt_00013.dcp.tmp"):
        (tmp_path / name).mkdir()
    assert latest_ckpt(str(tmp_path)).endswith("ckpt_00012.dcp")


def test_preemption_checkpoints_and_stops(workspace, tmp_path):
    pipeline = build(port_cfg(workspace, out="preempt_out", max_epoch=30))
    handler = signal.getsignal(signal.SIGINT)

    def trigger():
        while not hasattr(pipeline, "_preempted"):
            time.sleep(0.05)
        time.sleep(0.3)
        signal.raise_signal(signal.SIGINT)

    t = threading.Thread(target=trigger, daemon=True)
    t.start()
    record = pipeline.run_training()      # returns, does not raise
    t.join(timeout=5)
    assert not t.is_alive()
    assert len(record) < 30
    ckpts = os.listdir(os.path.join(pipeline.cfg.log_dir, "checkpoint"))
    last = max(r["epoch"] for r in record)
    assert f"ckpt_{last:05d}.pth" in ckpts
    assert signal.getsignal(signal.SIGINT) is handler


def test_training_with_microbatch(workspace, caplog, tmp_path):
    """``tpu.microbatch`` trains in chunks; ``profile_dir`` traces the
    first ``profile_steps`` steps into Chrome traces."""
    cfg = port_cfg(workspace, out="accum_out", profile_steps=1,
                   profile_dir=str(tmp_path / "traces"))
    cfg.tpu["microbatch"] = 1             # batch 2 -> 2 chunks
    pipeline = build(cfg)
    with caplog.at_level(
            logging.INFO, logger="objectdetection_3d_tpu_torch.pipeline."
            "pipeline"):
        record = pipeline.run_training()
    assert any("Gradient accumulation: microbatch=1" in r.message
               for r in caplog.records)
    assert len(record) == 2
    for k, vals in pipeline.losses.items():
        assert np.all(np.isfinite(vals)), k
    (trace,) = os.listdir(tmp_path / "traces")
    with open(tmp_path / "traces" / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"forward", "loss+backward", "optimizer"} <= names


def test_entry_trains_and_tests_from_yaml(workspace, tmp_path):
    """``python -m objectdetection_3d_tpu_torch.entry {train,test}``."""
    yaml = pytest.importorskip("yaml")
    d = port_cfg(workspace, out="cli_out", max_epoch=0).dump()
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(d))
    assert entry_main(["train", str(path)]) == 0
    (version,) = os.listdir(workspace / "cli_out")
    with pytest.raises(ValueError, match="inference_mode: true"):
        entry_main(["test", str(path)])
    d["pipeline"].update(inference_mode=True, resume_from=version)
    path.write_text(yaml.safe_dump(d))
    assert entry_main(["test", str(path)]) == 0
    assert os.path.exists(workspace / "cli_out" / version / "logs" /
                          "test" / "test_protocol.yaml")


def test_unported_pipeline_options_raise(workspace):
    # one process without a process group is a world of one rank
    with pytest.raises(ValueError, match="world has 1"):
        build(port_cfg(workspace, out="dp_out", data_parallel=2))
    # orbax is ported (DCP directories); a backend neither package has
    # raises
    with pytest.raises(ValueError, match="unknown ckpt_backend"):
        build(port_cfg(workspace, out="bad_out", ckpt_backend="zarr"))


@pytest.fixture(scope="module")
def dcp_run(workspace):
    """``trained_run``'s configuration under ``ckpt_backend: orbax``."""
    pipeline = build(port_cfg(workspace, out="dcp_out",
                              ckpt_backend="orbax"))
    return pipeline, pipeline.run_training()


def test_dcp_training_writes_directories_and_equals_pth(dcp_run,
                                                        trained_run):
    pipeline, record = dcp_run
    ckpt_dir = os.path.join(pipeline.cfg.log_dir, "checkpoint")
    names = set(os.listdir(ckpt_dir))
    assert {"ckpt_00000.dcp", "ckpt_00001.dcp"} <= names
    assert not any(n.endswith((".pth", ".tmp")) for n in names)
    assert all(os.path.isdir(os.path.join(ckpt_dir, n)) for n in names)
    # the same run as the .pth one: the backend changes no step
    pth, pth_record = trained_run
    assert repr(record) == repr(pth_record)   # nan == nan here
    for k, v in pth.losses.items():
        assert pipeline.losses[k] == v, k
    got = ckpt_io.load_ckpt(os.path.join(ckpt_dir, "ckpt_00001.dcp"))
    want = ckpt_io.load_ckpt(os.path.join(pth.cfg.log_dir, "checkpoint",
                                          "ckpt_00001.pth"))
    assert got["epoch"] == want["epoch"] == 1
    for k, v in want["model_state_dict"].items():
        assert torch.equal(got["model_state_dict"][k], v), k


def test_dcp_resume_restores_the_optimizer(dcp_run, workspace):
    pipeline, _ = dcp_run
    resumed = build(port_cfg(workspace, out="dcp_out", ckpt_backend="orbax",
                             is_resume=True,
                             resume_from=version_of(pipeline), max_epoch=2))
    assert resumed.load_ckpt()[0] == 2
    record = resumed.run_training()
    assert [r["epoch"] for r in record] == [0, 1, 2]
    ckpt = ckpt_io.load_ckpt(os.path.join(resumed.cfg.log_dir, "checkpoint",
                                          "ckpt_00002.dcp"))
    assert ckpt["epoch"] == 2
    # two steps before the resume, one after: Adam's step count is 3
    steps = {int(s["step"]) for s in
             ckpt["optimizer_state_dict"]["state"].values()}
    assert steps == {3}


def test_dcp_run_testing_equals_pth(dcp_run, trained_run, workspace):
    """``run_testing`` from ``ckpt_best.dcp`` gives the P/R/F1 of the
    ``.pth`` run from ``ckpt_best.pth``; both bests are made the epoch-1
    checkpoint (whether validation F1 ever beat 0 depends on the random
    weights)."""
    got = {}
    for (pipeline, _), out, suffix in ((dcp_run, "dcp_out", ".dcp"),
                                       (trained_run, "output", ".pth")):
        ckpt_dir = os.path.join(pipeline.cfg.log_dir, "checkpoint")
        best = os.path.join(ckpt_dir, "ckpt_best" + suffix)
        epoch1 = os.path.join(ckpt_dir, "ckpt_00001" + suffix)
        if suffix == ".dcp":
            shutil.rmtree(best, ignore_errors=True)
            shutil.copytree(epoch1, best)
        else:
            shutil.copy(epoch1, best)
        extra = {"ckpt_backend": "orbax"} if suffix == ".dcp" else {}
        tester = _inference_pipeline(workspace, version_of(pipeline),
                                     out=out, **extra)
        assert tester.load_ckpt()[1] == best
        got[suffix] = tester.run_testing()
    for k in ("4_precision", "5_recall", "6_f1"):
        assert got[".dcp"][k] == pytest.approx(got[".pth"][k],
                                               nan_ok=True), k


# ---------------------------------------------------------------------------
# the same weights through both pipelines
# ---------------------------------------------------------------------------
def _jax_pipeline(workspace, inference_mode=True):
    cfg = make_cfg(workspace, inference_mode=inference_mode,
                   resume_from=VERSION)
    cfg.global_args["output_path"] = str(workspace / "jax_out") + "/"
    global_cfg = cfg.dump()
    ds, pl, md = JaxConfig.initialize_params(cfg)
    return JaxPipeline(JaxPointPillars(**md), JaxForest3D(**ds), global_cfg,
                       **pl)


# None: the workspace's own testing scenes (scene_seed), whose detections
# must find a tree; 255 and 731: testing scenes on which these random
# weights find none, so recall 0 is allowed there
@pytest.mark.parametrize("testing_seed", [None, 255, 731])
def test_run_testing_matches_the_jax_pipeline(workspace, tmp_path,
                                              testing_seed):
    if testing_seed is not None:
        workspace = make_workspace(tmp_path, testing_seed)
    found = testing_seed is None
    jp = _jax_pipeline(workspace)
    variables = _random_variables(
        jp.model.init_variables(jax.random.PRNGKey(1)), seed=3)
    jdir = os.path.join(jp.cfg.log_dir, "checkpoint")
    os.makedirs(jdir, exist_ok=True)
    jax_ckpt.save_ckpt(os.path.join(jdir, "ckpt_best.pkl"), 4,
                       {"params": variables["params"],
                        "batch_stats": variables["batch_stats"],
                        "opt_state": None})
    tp = _inference_pipeline(workspace, VERSION, out="port_out")
    from_jax_variables(tp.model.net, variables)
    tdir = os.path.join(tp.cfg.log_dir, "checkpoint")
    os.makedirs(tdir, exist_ok=True)
    ckpt_io.save_ckpt(os.path.join(tdir, "ckpt_best.pth"), 4, tp.model.net)
    tp._init_state()                      # fresh weights until the load

    want = jp.run_testing()
    got = tp.run_testing()
    for k in ("4_precision", "5_recall", "6_f1"):
        assert got[k] == pytest.approx(want[k], rel=1e-9, nan_ok=True), k
    if found:
        assert got["5_recall"] > 0

    _, want_p, want_t = jp._eval_split("testing", 2, compute_losses=False)
    _, got_p, got_t = tp._eval_split("testing", 2, compute_losses=False)
    assert len(got_p) == len(want_p) == 2
    for g, w in zip(got_t, want_t):
        np.testing.assert_array_equal(g["bbox"], w["bbox"])
    for g, w in zip(got_p, want_p):
        assert len(g["bbox"]) == len(w["bbox"])
        assert len(g["bbox"]) > 0 or not found
        np.testing.assert_array_equal(g["label"], w["label"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-4)
        np.testing.assert_allclose(g["score"], w["score"], atol=1e-5)

    # run_inference on one test cloud: the checkpoint's detections
    ds = tp.dataset.get_split("testing")
    data = tp.model.preprocess(ds.get_data(0), ds.get_attr(0))
    dets = tp.run_inference({"data": data, "attr": ds.get_attr(0)},
                            validate=True)
    batch = tp.batcher.collate([{"data": data, "attr": {}}])
    want_d = tp.model.inference_end(tp.model.predict(batch.arrays))
    assert len(dets) == 1 and len(dets[0]) == len(want_d[0])
    assert len(dets[0]) > 0 or not found
    for g, w in zip(dets[0], want_d[0]):
        np.testing.assert_array_equal(g["bbox"], w["bbox"])
        assert g["label"] == w["label"] and g["score"] == w["score"]
    data["bboxes"] = np.array([[1, 1, 0, 0, 1, 1, 0, 0, 0]], np.float32)
    with pytest.raises(ValueError, match="zero areas"):
        tp.run_inference(data, validate=True)


@pytest.fixture(scope="module")
def show_pair(workspace):
    """A JAX and a port pipeline in inference mode over the same random
    weights (a ``.pkl`` and a ``.pth`` best checkpoint)."""
    cfg = make_cfg(workspace, inference_mode=True, resume_from=VERSION)
    cfg.global_args["output_path"] = str(workspace / "jax_show") + "/"
    global_cfg = cfg.dump()
    ds, pl, md = JaxConfig.initialize_params(cfg)
    jp = JaxPipeline(JaxPointPillars(**md), JaxForest3D(**ds), global_cfg,
                     **pl)
    variables = _random_variables(
        jp.model.init_variables(jax.random.PRNGKey(1)), seed=3)
    jdir = os.path.join(jp.cfg.log_dir, "checkpoint")
    os.makedirs(jdir, exist_ok=True)
    jax_ckpt.save_ckpt(os.path.join(jdir, "ckpt_best.pkl"), 4,
                       {"params": variables["params"],
                        "batch_stats": variables["batch_stats"],
                        "opt_state": None})
    tp = _inference_pipeline(workspace, VERSION, out="port_show")
    from_jax_variables(tp.model.net, variables)
    tdir = os.path.join(tp.cfg.log_dir, "checkpoint")
    os.makedirs(tdir, exist_ok=True)
    ckpt_io.save_ckpt(os.path.join(tdir, "ckpt_best.pth"), 4, tp.model.net)
    tp._init_state()                      # fresh weights until the load
    return jp, tp


def _new_pngs(log_dir, since):
    """``show_inference`` PNGs in ``log_dir`` written at or after
    ``since`` (their names carry the time to the second, so a second
    drawing in the same second overwrites the first)."""
    return [p for p in glob.glob(os.path.join(log_dir,
                                              "show_inference_*.png"))
            if os.path.getmtime(p) >= since]


def _pr_block(out):
    """The header and the three lines of precision, recall and F1."""
    lines = out.splitlines()
    (i,) = [j for j, line in enumerate(lines) if "==== Precision" in line]
    return lines[i:i + 4]


def test_show_inference_matches_run_inference_and_jax(show_pair, capsys):
    jp, tp = show_pair
    since = time.time() - 0.1
    random.seed(11)
    got = tp.show_inference()
    out = capsys.readouterr().out
    random.seed(11)
    jp.show_inference()
    jax_out = capsys.readouterr().out
    assert set(got) == {"bbox", "label", "score"}
    block = _pr_block(out)
    assert block == _pr_block(jax_out)
    assert block[1].startswith("Overall_precision: ")
    assert block[3].startswith("F1: ")
    assert _new_pngs(tp.cfg.log_dir, since)

    random.seed(11)
    split = tp.dataset.get_split("test")
    (idx,) = random.sample(range(0, len(split)), 1)
    data = tp.model.preprocess(split.get_data(idx), split.get_attr(idx))
    dets = tp.run_inference({"data": data, "attr": split.get_attr(idx)})[0]
    assert len(dets) == len(got["bbox"]) > 0
    for j, d in enumerate(dets):
        np.testing.assert_array_equal(d["bbox"], got["bbox"][j])
        assert d["label"] == got["label"][j]
        assert d["score"] == got["score"][j]


def test_entry_show_needs_inference_mode(show_pair, workspace, tmp_path):
    """``python -m objectdetection_3d_tpu_torch.entry show``."""
    yaml = pytest.importorskip("yaml")
    _, tp = show_pair
    d = port_cfg(workspace, out="port_show", resume_from=VERSION).dump()
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(d))
    with pytest.raises(ValueError, match="inference_mode: true"):
        entry_main(["show", str(path)])
    d["pipeline"]["inference_mode"] = True
    path.write_text(yaml.safe_dump(d))
    since = time.time() - 0.1
    assert entry_main(["show", str(path)]) == 0
    assert _new_pngs(tp.cfg.log_dir, since)


def test_init_parameters_draws_from_the_generator_only():
    from objectdetection_3d_tpu_torch import configs
    from objectdetection_3d_tpu_torch.models.detector import PointPillars
    from objectdetection_3d_tpu_torch.models.network import init_parameters

    nets = [PointPillars(configs.tiny_model_cfg(), device="cpu").net
            for _ in range(3)]
    with torch.no_grad():
        nets[0].voxel_encoder.pfn_0.norm.running_var.fill_(7.0)
    rng_state = torch.get_rng_state()
    for net, seed in zip(nets, (5, 5, 6)):
        init_parameters(net, torch.Generator().manual_seed(seed))
    assert torch.equal(torch.get_rng_state(), rng_state)
    s0, s1, s2 = (n.state_dict() for n in nets)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert not torch.equal(s0["bbox_head.conv_reg.weight"],
                           s2["bbox_head.conv_reg.weight"])
    for k, v in s0.items():
        if k.endswith("running_var") or k.endswith("norm.weight"):
            assert bool((v == 1).all()), k
        elif k.endswith("running_mean"):
            assert bool((v == 0).all()), k
    assert float(s0["bbox_head.conv_cls.bias"][0]) == pytest.approx(
        -np.log(99.0))
    kernel = s0["pseudoimage_generator.subm_0_kernel"]
    assert float(kernel.std()) == pytest.approx(
        1 / np.sqrt(kernel[0].numel()), rel=0.1)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _tiny_state(seed=0):
    torch.manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Linear(3, 4),
                              torch.nn.BatchNorm1d(4))
    opt = torch.optim.AdamW(net.parameters(), lr=1e-2)
    net(torch.randn(5, 3)).sum().backward()
    opt.step()
    return net, opt


def test_pth_round_trip_and_snapshot(tmp_path):
    net, opt = _tiny_state()
    want = {k: v.clone() for k, v in net.state_dict().items()}
    path = str(tmp_path / "ckpt_00003.pth")
    saver = ckpt_io.AsyncSaver()
    saver.save(path, 3, net, opt)
    with torch.no_grad():                 # after save(): not in the file
        for p in net.parameters():
            p.add_(100.0)
    saver.wait()
    assert not os.path.exists(path + ".tmp")
    payload = ckpt_io.load_ckpt(path)
    assert payload["epoch"] == 3
    assert set(payload["model_state_dict"]) == set(want)
    for k, v in want.items():
        assert torch.equal(payload["model_state_dict"][k], v), k
    net2, opt2 = _tiny_state(seed=1)
    net2.load_state_dict(payload["model_state_dict"])
    opt2.load_state_dict(payload["optimizer_state_dict"])
    s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
    for i in s1:
        assert torch.equal(s1[i]["exp_avg"], s2[i]["exp_avg"])


def test_dcp_round_trip_and_snapshot(tmp_path):
    """The directory backend (``tests/test_pipeline.py``'s orbax round
    trip): the backend is told by the path; the model, the optimizer's
    state, the epoch and a generator's state come back."""
    net, opt = _tiny_state()
    gen = torch.Generator().manual_seed(7)
    torch.rand(3, generator=gen)          # a state other than the seed's
    want = {k: v.clone() for k, v in net.state_dict().items()}
    path = str(tmp_path / "ckpt_00003.dcp")
    saver = ckpt_io.AsyncSaver()
    saver.save(path, 3, net, opt, gen, backend="dcp")
    with torch.no_grad():                 # after save(): not in the files
        for p in net.parameters():
            p.add_(100.0)
    saver.wait()
    assert os.path.isdir(path) and not os.path.exists(path + ".tmp")
    assert ckpt_io.backend_of(path) == "dcp"
    payload = ckpt_io.load_ckpt(path)
    assert payload["epoch"] == 3 and isinstance(payload["epoch"], int)
    assert torch.equal(payload["augment_rng_state"], gen.get_state())
    for k, v in want.items():
        assert torch.equal(payload["model_state_dict"][k], v), k
    net2, opt2 = _tiny_state(seed=1)
    net2.load_state_dict(payload["model_state_dict"])
    ckpt_io.load_optimizer_state(net2, opt2, payload["optimizer_state_dict"])
    a, b = opt.state_dict(), opt2.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i in a["state"]:
        for k, v in a["state"][i].items():
            assert torch.equal(v, b["state"][i][k]), (i, k)
    # written again: the directory is replaced
    ckpt_io.save_ckpt(path, 4, net2, None, backend="dcp")
    again = ckpt_io.load_ckpt(path)
    assert again["epoch"] == 4 and again["optimizer_state_dict"] is None


def test_dcp_leaves_an_unstepped_optimizer_alone(tmp_path):
    net = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(net.parameters(), lr=1e-2)
    path = str(tmp_path / "ckpt_00000.dcp")
    ckpt_io.save_ckpt(path, 0, net, opt, backend="dcp")
    assert not opt.state
    assert ckpt_io.load_ckpt(path)["optimizer_state_dict"] is None


def test_async_saver_error_propagates(tmp_path):
    net, opt = _tiny_state()
    saver = ckpt_io.AsyncSaver()
    saver.save(str(tmp_path / "no_such_dir" / "x.pth"), 0, net, opt)
    with pytest.raises(OSError):
        saver.wait()
    ok = str(tmp_path / "ok.pth")        # the saver stays usable
    saver.save(ok, 1, net)
    saver.wait()
    payload = ckpt_io.load_ckpt(ok)
    assert payload["epoch"] == 1 and payload["optimizer_state_dict"] is None


def test_sync_write_is_atomic(tmp_path, monkeypatch):
    net, opt = _tiny_state()
    path = str(tmp_path / "ckpt.pth")
    ckpt_io.save_ckpt(path, 1, net, opt)

    def broken_save(obj, f):
        f.write(b"partial")
        raise RuntimeError("disk full")

    monkeypatch.setattr(ckpt_io.torch, "save", broken_save)
    with pytest.raises(RuntimeError, match="disk full"):
        ckpt_io.save_ckpt(path, 2, net, opt)
    monkeypatch.undo()
    assert ckpt_io.load_ckpt(path)["epoch"] == 1


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def _metric_cases():
    gt = np.array([box(2, 2), box(6, 6)], np.float32)
    one = np.array([box(2, 2)], np.float32)
    cases = {
        "perfect": ([{"bbox": gt.copy(), "label": np.zeros(2),
                      "score": np.ones(2)}],
                    [{"bbox": gt, "label": np.zeros(2)}], [0.5]),
        "fp-and-fn": ([{"bbox": np.array([box(2, 2), box(30, 30)],
                                         np.float32),
                        "label": np.zeros(2),
                        "score": np.array([0.9, 0.8])}],
                      [{"bbox": gt, "label": np.zeros(2)}], [0.5]),
        "best-match-only": ([{"bbox": np.array([box(2, 2), box(2.2, 2)],
                                               np.float32),
                              "label": np.zeros(2),
                              "score": np.array([0.9, 0.8])}],
                            [{"bbox": one, "label": np.zeros(1)}], [0.3]),
        "no-predictions": ([{"bbox": np.zeros((0, 9), np.float32),
                             "label": np.zeros(0), "score": np.zeros(0)}],
                           [{"bbox": one, "label": np.zeros(1)}], [0.5]),
        "two-clouds": ([{"bbox": one.copy(), "label": np.zeros(1),
                         "score": np.ones(1)},
                        {"bbox": np.array([box(20, 20)], np.float32),
                         "label": np.zeros(1), "score": np.ones(1)}],
                       [{"bbox": one, "label": np.zeros(1)},
                        {"bbox": np.array([box(6, 6)], np.float32),
                         "label": np.zeros(1)}], [0.5]),
        "rotated-partial": ([{"bbox": np.array(
            [box(2.3, 2.1, rz=0.5), box(6.4, 6, rz=1.2, dx=1.5),
             box(9, 9)], np.float32), "label": np.zeros(3),
            "score": np.array([0.9, 0.7, 0.4])}],
            [{"bbox": gt, "label": np.zeros(2)}], [0.3]),
    }
    return cases


@pytest.mark.parametrize("eval_dim", [2, 3])
@pytest.mark.parametrize("case", list(_metric_cases()))
def test_metric_evaluator_matches_jax(case, eval_dim):
    pred, target, overlap = _metric_cases()[case]
    want = JaxME(eval_dim=eval_dim).evaluate(pred, target, [0], overlap,
                                             validate=True)
    got = MetricEvaluator(eval_dim=eval_dim).evaluate(pred, target, [0],
                                                      overlap, validate=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-9)


@pytest.mark.parametrize("bad", ["zero-size", "nan"])
def test_validate_boxes_raises_like_jax(bad):
    boxes = np.array([box(2, 2), box(5, 5)], np.float32)
    boxes[1, 3 if bad == "zero-size" else 0] = (0.0 if bad == "zero-size"
                                                else np.nan)
    with pytest.raises(ValueError) as want:
        jax_validate_boxes(boxes)
    with pytest.raises(ValueError) as got:
        validate_boxes(boxes)
    assert str(got.value) == str(want.value)
    validate_boxes(boxes[:1])
    np.testing.assert_allclose(
        corners_2d_envelope(torch.from_numpy(boxes[:1])).numpy(),
        np.asarray(jax_corners_2d_envelope(boxes[:1])), rtol=1e-6)
