"""A configuration names its architecture, and a traffic mix its scene
generator, as files of their own: the configurations that name none
resolve to ``reference/model.py`` with today's sizes, leaves and counts;
a name that is no file fails with the path looked for; and a second
architecture with a generator of its own, added as files alone, runs
through the harness on the CPU, its work counted per call, its reference
the one the check uses."""

import json
import os
import re
import time
import types

import pytest
import torch

from conftest import REPO, make_root, tiny_model
from portbench.harness import cells, flops, main, plugins, scenes
from portbench.reference import model as ref_model

# forward GFLOP a cloud, counted dense
DENSE_GFLOP = {"flagship": 3695.3, "fpn": 3254.7}


def _conf(name):
    with open(os.path.join(REPO, "portbench", "configs",
                           name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(DENSE_GFLOP))
def test_configs_resolve_to_model(name):
    conf = _conf(name)
    model = conf["model"]
    arch = plugins.architecture(conf, REPO)
    assert "architecture" not in conf and arch is ref_model
    spec, direct = arch.Spec(model), ref_model.Spec(model)
    assert spec.__dict__.keys() == direct.__dict__.keys()
    for key, value in spec.__dict__.items():
        assert repr(value) == repr(direct.__dict__[key]), key
    assert arch.param_shapes(spec) == ref_model.param_shapes(direct)
    assert arch.forward_flops(model) == flops.forward_flops(model)
    assert round(arch.forward_flops(model)["total"] / 1e9, 1) == (
        DENSE_GFLOP[name])
    assert arch.encoder_bytes(model) == flops.encoder_bytes(model) == (
        770_098_624)


def test_unknown_architecture_names_the_path():
    conf = dict(_conf("flagship"), architecture="nosuch")
    want = re.escape(os.path.join(REPO, "portbench", "reference",
                                  "nosuch.py"))
    with pytest.raises(FileNotFoundError, match=want):
        plugins.architecture(conf, REPO)
    with pytest.raises(FileNotFoundError, match=want):
        cells.make("predict", conf, {}, 1, REPO, device="cpu")
    with pytest.raises(FileNotFoundError, match="looked for"):
        plugins.architecture(dict(conf, architecture="../model"), REPO)


def test_unknown_generator_names_the_path():
    want = re.escape(os.path.join(REPO, "portbench", "scenes",
                                  "nosuch.py"))
    with pytest.raises(FileNotFoundError, match=want):
        scenes.make_pool({"generator": "nosuch", "params": {}, "pool": 1},
                         1, REPO)
    assert scenes.generator("tree_scene", REPO) is scenes.tree_scene


# a second architecture: model.py's detector, its encoder's work counted
# at the call's occupied voxels alone
TINYARCH = '''
from portbench.harness.flops import encoder_bytes, forward_flops
from portbench.reference.model import (
    Spec, anchors, encode, forward, fp8, greedy_nms, identity,
    overlap_matrix, param_shapes, predict, top_lowest_index, voxelize)


def call_work(spec, cloud):
    sites = int(voxelize(cloud, len(cloud), spec)[3].sum())
    c_in = spec.pfn_units + 1
    enc = 2 * sites * 27 * c_in * spec.middle[0]
    return {"encoder": enc, "total": enc, "encoder_bytes": 4 * sites * c_in}
'''

# the same with every predicted box moved 1 m in x
SHIFTED = TINYARCH + '''

_predict = predict


def predict(points, n, p, spec, anc, quant=identity):
    moved = anc.clone()
    moved[:, 0] += 1.0
    return _predict(points, n, p, spec, moved, quant)
'''

# posts over clutter, the same sizes for every seed
TINYSCENE = '''
import numpy as np


def scene(rng, extent, n_posts, n_points):
    pts, boxes = [], []
    for _ in range(n_posts):
        cx, cy = rng.uniform(1.0, extent - 1.0, 2)
        k = 400
        ang = rng.uniform(0, 2 * np.pi, k)
        post = np.stack([cx + 0.3 * np.cos(ang), cy + 0.3 * np.sin(ang),
                         rng.uniform(0.2, 3.2, k), rng.uniform(0.5, 1, k)],
                        -1)
        pts.append(post)
        boxes.append([cx, cy, 0.2, 0.6, 0.6, 3.0, 0, 0, 0])
    n = n_points - n_posts * 400
    pts.append(np.concatenate([rng.uniform(0, [extent, extent, 4], (n, 3)),
                               rng.uniform(0, 0.3, (n, 1))], -1))
    cloud = np.concatenate(pts).astype(np.float32)
    return (cloud[rng.permutation(len(cloud))],
            np.asarray(boxes, np.float32).reshape(-1, 9))
'''

PARAMS = {"predict": {"extent": 8.0, "n_posts": 3, "n_points": 8000},
          "plot": {"extent": 18.0, "n_posts": 8, "n_points": 30000}}
SEED = 2 ** 34 + 5


def _root(tmp_path, arch_source):
    """A checkout root whose ``tinyarch`` configuration, ``tinyarch.py``
    and ``tinyscene.py`` exist only as files there."""
    root = make_root(tmp_path, {"tinyarch.predict": (tiny_model(),
                                                     "predict"),
                                "tinyarch.plot": (tiny_model(), "plot")})
    base = os.path.join(root, "portbench")
    path = os.path.join(base, "configs", "tinyarch.json")
    with open(path) as f:
        conf = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(conf, architecture="tinyarch"), f)
    for kind in PARAMS:
        path = os.path.join(base, "traffic", f"t{kind}.json")
        with open(path) as f:
            traffic = json.load(f)
        with open(path, "w") as f:
            json.dump(dict(traffic, generator="tinyscene",
                           params=PARAMS[kind]), f)
    os.makedirs(os.path.join(base, "reference"))
    os.makedirs(os.path.join(base, "scenes"))
    for folder, name, source in (("reference", "tinyarch", arch_source),
                                 ("scenes", "tinyscene", TINYSCENE)):
        with open(os.path.join(base, folder, name + ".py"), "w") as f:
            f.write(source)
    return root


def _run(root, cell, trace):
    args = types.SimpleNamespace(workload=cell, seed=SEED, seconds=0.3,
                                 trace=trace)
    return main.run(args, root, time.perf_counter(), "cpu")


def test_second_architecture_as_files(tmp_path):
    root = _root(tmp_path, TINYARCH)
    out = _run(root, "tinyarch.predict", 1)
    assert out["correct"], out
    # mfu.predict reads the mean of the profiled calls' own counts
    arch = plugins.load(root, "reference", "tinyarch")
    with open(os.path.join(root, "portbench", "traffic",
                           "tpredict.json")) as f:
        pool = scenes.make_pool(json.load(f), SEED, root)
    spec = arch.Spec(tiny_model())
    calls = cells.PROFILED_CALLS["predict"]
    counted = [arch.call_work(spec, torch.as_tensor(pool[i % len(pool)][0]))
               for i in range(calls)]
    per_call = sum(c["total"] for c in counted) / calls
    assert 0 < per_call < flops.forward_flops(tiny_model())["total"] / 2
    mfu = out["metrics"]["mfu.predict"]["value"]
    assert mfu == pytest.approx(100.0 * per_call * calls / (
        out["device"]["window_s"] * flops.PEAK_BF16_FLOPS), rel=1e-9)
    # and the encoder's count and bytes, which encoder_roofline reads
    driver = cells.make("predict", {"model": tiny_model(),
                                    "architecture": "tinyarch"}, {}, SEED,
                        root, device="cpu")
    driver.pool = pool
    work, encoder_bytes = driver.work(range(calls))
    assert work["encoder"] == per_call
    assert encoder_bytes == sum(c["encoder_bytes"] for c in counted) / calls
    out = _run(root, "tinyarch.plot", 1)
    assert out["correct"], out
    assert out["metrics"]["mfu.plot"]["value"] > 0


def test_second_architecture_is_the_one_checked(tmp_path):
    """A copy of the architecture whose predict moves every box 1 m
    fails ``correct``: the check took the configuration's module."""
    out = _run(_root(tmp_path, SHIFTED), "tinyarch.predict", 0)
    assert not out["correct"]
    assert out["compared"]["box_gap"]["value"] > (
        out["compared"]["box_gap"]["limit"])
