"""The port's host data path against the JAX package's, on the CPU.

Both are numpy on host threads, so every comparison here is exact
(``assert_array_equal``): the config derivations, the Forest disk fixups,
``StaticBatcher``'s padding and seeded point subsampling, ``DataLoader``'s
batches (serial, pooled, per epoch), ``ObjdetAugmentation`` for the same
seed, and ``PointPillars._preprocess_points`` / ``preprocess`` against the
JAX package's numpy path (its native library replaced by ``None``, the
value it returns where the library is absent).
"""

import numpy as np
import pytest
import torch

import objectdetection_3d_tpu.native as jax_native
from objectdetection_3d_tpu.augment import (
    ObjdetAugmentation as JaxAugmentation,
)
from objectdetection_3d_tpu.config import Config as JaxConfig
from objectdetection_3d_tpu.dataset import DataLoader as JaxDataLoader
from objectdetection_3d_tpu.dataset import Forest3D as JaxForest3D
from objectdetection_3d_tpu.dataset import (
    PreprocessedDataset as JaxPreprocessedDataset,
)
from objectdetection_3d_tpu.dataset import StaticBatcher as JaxStaticBatcher
from objectdetection_3d_tpu.models import PointPillars as JaxPointPillars
from objectdetection_3d_tpu_torch import configs
from objectdetection_3d_tpu_torch.augment import ObjdetAugmentation
from objectdetection_3d_tpu_torch.config import Config, ConfigDict
from objectdetection_3d_tpu_torch.dataset import (
    DataLoader,
    Forest3D,
    PreprocessedDataset,
    StaticBatcher,
)
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.utils import convert_device_name
from test_config import base_cfg
from test_dataset import _augmenting_preprocess, write_cloud
from tiny import tiny_model_cfg

torch.set_num_threads(1)


@pytest.fixture
def forest_dir(tmp_path):
    for split in ("training", "validation", "testing"):
        d = tmp_path / split
        d.mkdir()
        for i in range(3):
            write_cloud(d, f"{split}_{i}", n_points=400 + 150 * i,
                        n_boxes=1 + i, seed=17 * i + len(split))
    return tmp_path


def _plain(tree):
    """A config dump without its RNG objects."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items() if k != "rng"}
    return tree


def _assert_items_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


# ---------------------------------------------------------------------------
# config and device names
# ---------------------------------------------------------------------------
def test_initialize_params_matches_jax(tmp_path):
    d = base_cfg(tmp_path)
    d["tpu"] = {"microbatch": 2, "compute_dtype": "bfloat16"}
    want = JaxConfig(d)
    got = Config(d)
    want_secs = JaxConfig.initialize_params(want)
    got_secs = Config.initialize_params(got)
    for w, g in zip(want_secs, got_secs):
        assert _plain(g.to_dict()) == _plain(w.to_dict())
    ds, pl, md = got_secs
    assert ds.rng is pl.rng is md.rng
    assert md.tpu.microbatch == 2 and md.tpu.max_gt_static == 128
    assert _plain(got.dump()) == _plain(want.dump())


def test_config_dict_and_file_rules(tmp_path):
    cd = ConfigDict({"a": {"b": 1}})
    assert cd.a.b == 1 and isinstance(cd.a, ConfigDict)
    with pytest.raises(AttributeError):
        _ = cd.nope
    with pytest.raises(KeyError):
        _ = cd["nope"]
    bad = tmp_path / "c.json"
    bad.write_text("{}")
    with pytest.raises(ImportError):
        Config.load_from_file(str(bad))
    with pytest.raises(FileNotFoundError):
        Config.load_from_file(str(tmp_path / "missing.yaml"))
    yaml = pytest.importorskip("yaml")
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(base_cfg(tmp_path)))
    assert Config.load_from_file(str(path)).dump() == base_cfg(tmp_path)


@pytest.mark.parametrize("name,want", [
    ("cpu", "cpu"), ("cpu:0", "cpu"), ("tpu", "cuda"), ("tpu:3", "cuda"),
    ("gpu", "cuda"), ("cuda:0", "cuda"), ("accelerator", "cuda")])
def test_convert_device_name(name, want):
    assert convert_device_name(name) == want


def test_convert_device_name_rejects_unknown():
    with pytest.raises(KeyError):
        convert_device_name("npu")


def test_accelerator_name_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the rule needs none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PointPillars(configs.tiny_model_cfg(),
                     device=convert_device_name("tpu"))


# ---------------------------------------------------------------------------
# dataset and loader
# ---------------------------------------------------------------------------
def test_forest_splits_and_disk_fixups_match_jax(forest_dir):
    want = JaxForest3D(str(forest_dir), name="synthetic", seed=3)
    got = Forest3D(str(forest_dir), name="synthetic", seed=3)
    assert got.get_label_to_names() == want.get_label_to_names()
    for split in ("training", "validation", "testing"):
        ws, gs = want.get_split(split), got.get_split(split)
        assert gs.path_list == ws.path_list and len(gs) == 3
        for i in range(len(gs)):
            _assert_items_equal(gs.get_data(i), ws.get_data(i))
            assert gs.get_attr(i) == ws.get_attr(i)
    # the fixups themselves: origin shift, z centre -> bottom, radians
    split = got.get_split("training")
    data = split.get_data(0)
    np.testing.assert_allclose(data["point"][:, :3].min(0), 0.0, atol=1e-5)
    raw = np.load(split.path_list[0].replace(".npy", "_bbx.npy"))
    pts = np.load(split.path_list[0])
    want_z = raw[:, 2] - raw[:, 5] / 2 - pts[:, 2].min()
    np.testing.assert_allclose(data["bboxes"][:, 2], want_z, atol=1e-4)
    np.testing.assert_allclose(data["bboxes"][:, 6:],
                               np.deg2rad(raw[:, 6:]), atol=1e-6)


def test_static_batcher_matches_jax():
    rng = np.random.default_rng(4)
    items = []
    for n, g in ((300, 1), (90, 0), (200, 6)):
        items.append({"data": {
            "point": rng.random((n, 4)).astype(np.float32),
            "labels": np.zeros(g),
            "bboxes": rng.random((g, 9)).astype(np.float32)},
            "attr": {"name": f"c{n}"}})
    want = JaxStaticBatcher(max_points=128, max_gt=4, num_features=4,
                            seed=11)
    got = StaticBatcher(max_points=128, max_gt=4, num_features=4, seed=11)
    for _ in range(2):                  # the subsampling stream goes on
        wb, gb = want.collate(items), got.collate(items)
        _assert_items_equal(gb.arrays, wb.arrays)
        assert gb.attr == wb.attr
    assert gb.arrays["num_points"].tolist() == [128, 90, 128]
    assert gb.arrays["gt_mask"].sum(1).tolist() == [1, 0, 4]
    np.testing.assert_array_equal(gb.unpadded_boxes(2),
                                  items[2]["data"]["bboxes"][:4])


def _loader_batches(mod, forest_dir, num_workers, epoch=0, batch_size=2):
    forest, prep, batcher, loader = mod
    ds = forest(dataset_path=str(forest_dir), name="Forest3D", seed=123)
    split = prep(dataset=ds.get_split("training"),
                 preprocess=_augmenting_preprocess, seed=7)
    split.set_epoch(epoch)
    return list(loader(split, batcher(max_points=512, max_gt=4,
                                      num_features=4, seed=1),
                       batch_size=batch_size, prefetch=2,
                       num_workers=num_workers))


JAX_LOADER = (JaxForest3D, JaxPreprocessedDataset, JaxStaticBatcher,
              JaxDataLoader)
PORT_LOADER = (Forest3D, PreprocessedDataset, StaticBatcher, DataLoader)


@pytest.mark.parametrize("num_workers,batch_size,epoch",
                         [(0, 2, 0), (3, 2, 1), (2, 1, 0), (0, 4, 2)])
def test_loader_batches_match_jax(forest_dir, num_workers, batch_size,
                                  epoch):
    want = _loader_batches(JAX_LOADER, forest_dir, num_workers, epoch,
                           batch_size)
    got = _loader_batches(PORT_LOADER, forest_dir, num_workers, epoch,
                          batch_size)
    assert len(got) == len(want) == -(-3 // batch_size)
    for g, w in zip(got, want):
        _assert_items_equal(g.arrays, w.arrays)
        assert g.pad_flags == w.pad_flags and g.attr == w.attr


def test_pooled_loader_matches_serial_and_epochs_differ(forest_dir):
    serial = _loader_batches(PORT_LOADER, forest_dir, 0)
    pooled = _loader_batches(PORT_LOADER, forest_dir, 4)
    for a, b in zip(serial, pooled):
        _assert_items_equal(a.arrays, b.arrays)
    other = _loader_batches(PORT_LOADER, forest_dir, 4, epoch=1)
    assert any((a.arrays["points"] != b.arrays["points"]).any()
               for a, b in zip(pooled, other))
    (last,) = _loader_batches(PORT_LOADER, forest_dir, 0, batch_size=4)
    assert last.pad_flags == [False, False, False, True]
    assert last.arrays["item_valid"].tolist() == [True, True, True, False]


# ---------------------------------------------------------------------------
# augmentation and preprocessing
# ---------------------------------------------------------------------------
AUGMENT_CFGS = {
    "shuffle": {"PointShuffle": True},
    "recenter+rotate": {"recenter": {"dim": [0, 1]},
                        "rotate": {"method": "vertical"}},
    "rotate-all+scale": {"rotate": {"method": "all"},
                         "scale": {"min_s": 0.9, "max_s": 1.1,
                                   "scale_anisotropic": True}},
    "normalize+range": {"normalize": {"points": {"method": "linear"}},
                        "ObjectRangeFilter": {
                            "point_cloud_range": [0, 0, 0, 6, 6, 4]},
                        "PointShuffle": True},
}


@pytest.mark.parametrize("name", list(AUGMENT_CFGS))
def test_augmentation_matches_jax(name):
    cfg = AUGMENT_CFGS[name]
    rng = np.random.default_rng(8)
    boxes = np.concatenate([rng.uniform(1, 7, (5, 3)),
                            np.full((5, 3), 0.8), rng.normal(0, 0.1, (5, 3))],
                           1).astype(np.float32)
    data = {"point": rng.uniform(0, 8, (500, 3)).astype(np.float32),
            "labels": np.zeros(5), "bboxes": boxes}
    for seed in (None, 5):
        want = JaxAugmentation(cfg, seed=21).augment(
            {k: v.copy() for k, v in data.items()}, {}, seed=seed)
        got = ObjdetAugmentation(cfg, seed=21).augment(
            {k: v.copy() for k, v in data.items()}, {}, seed=seed)
        _assert_items_equal(got, want)


def test_object_sample_is_not_ported(tmp_path):
    """ObjectSample is ported (its parity tests are in
    ``test_torch_port_gt_sampling.py``): the augmentor and the model take
    it, and the database is read at the first augment, where a missing
    file raises."""
    cfg = {"ObjectSample": {"db_path": str(tmp_path / "none.pkl"),
                            "sample_dict": {0: 2}}}
    aug = ObjdetAugmentation(cfg)
    model_cfg = configs.tiny_model_cfg()
    model_cfg["augment"] = cfg
    PointPillars(model_cfg, device="cpu")
    data = {"point": np.zeros((4, 4), np.float32),
            "bboxes": np.zeros((0, 9), np.float32), "labels": np.zeros(0)}
    with pytest.raises(FileNotFoundError):
        aug.augment(data, {}, seed=0)


@pytest.fixture(scope="module")
def models():
    return (JaxPointPillars(**tiny_model_cfg()),
            PointPillars(configs.tiny_model_cfg(), device="cpu"))


def _cloud(seed, n=3000):
    rng = np.random.default_rng(seed)
    pts = rng.normal(4.0, 1.8, (n, 5)).astype(np.float32)
    pts[:5, :3] += 60.0                  # outliers beyond 5 sigma
    boxes = np.concatenate([rng.uniform(-1, 9, (6, 3)), np.full((6, 3), 1.0),
                            np.zeros((6, 3))], 1).astype(np.float32)
    return {"point": pts, "labels": np.zeros(6), "bboxes": boxes}


@pytest.mark.parametrize("seed", [0, 1])
def test_preprocess_points_matches_jax_numpy_path(models, monkeypatch, seed):
    jm, tm = models
    monkeypatch.setattr(jax_native, "preprocess_cloud", lambda *a, **k: None)
    pts = _cloud(seed)["point"]
    want = jm._preprocess_points(pts)
    got = tm._preprocess_points(pts)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == 4 and 0 < len(got) < len(pts) - 4


@pytest.mark.parametrize("split", ["training", "testing"])
def test_preprocess_matches_jax(models, monkeypatch, split):
    jm, tm = models
    monkeypatch.setattr(jax_native, "preprocess_cloud", lambda *a, **k: None)
    data = _cloud(3)
    attr = {"name": "c", "split": split}
    want = jm.preprocess(dict(data), attr, rng=np.random.default_rng(9))
    got = tm.preprocess(dict(data), attr, rng=np.random.default_rng(9))
    _assert_items_equal(got, want)
    assert tm.transform(got, attr) is got
