"""The port's spans and counter (``profiling``), on the CPU.

* A traced tiny predict emits every predict span, nested as
  ``profiling`` lists them; a traced tiled call emits ``plot``,
  ``plot.sort``, a ``plot.crop`` per chunk, a ``predict`` per tile and
  ``plot.merge``.
* ``nms.rounds`` counts every evaluation of the NMS fixpoint's condition.
* With no profiler recording, ``span`` never enters ``record_function`` and
  ``count`` records nothing; the exported predict holds no profiler op.
* The trace readings (``profiling.span_*``, ``profile_predict``'s tables)
  on a hand-built Chrome trace, with a nested span and idle gaps.
* ``StepTimer`` on ``perf_counter``.
"""

import json

import numpy as np
import pytest
import torch

from objectdetection_3d_tpu_torch import configs, profile_predict, profiling
from objectdetection_3d_tpu_torch.models.detector import PointPillars
from objectdetection_3d_tpu_torch.ops import nms
from objectdetection_3d_tpu_torch.pipeline.tiled_inference import (
    TiledInference,
)
from tiny import tiny_batch

torch.set_num_threads(2)

# span -> the span that holds it in a predict
PREDICT_PARENTS = {
    "predict.voxelize": "predict",
    "predict.pfn_grid": "predict",
    "predict.encoder": "predict",
    "encoder.norm": "predict.encoder",
    "predict.rpn_head": "predict",
    "predict.decode_nms": "predict",
    "predict.nms": "predict.decode_nms",
}


def _model(**tpu):
    cfg = configs.tiny_model_cfg()
    cfg["tpu"].update(tpu)
    model = PointPillars(cfg, device="cpu")
    with torch.no_grad():
        # every anchor scores sigmoid(2) > score_thr: the NMS has work
        model.net.bbox_head.conv_cls.weight.zero_()
        model.net.bbox_head.conv_cls.bias.fill_(2.0)
    return model


def _traced(fn, tmp_path):
    """The Chrome trace (a dict) of ``fn()`` under a CPU profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def _spans(trace):
    """{name: [(start, end)]} of the trace's spans."""
    out = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    return out


def _inside(child, parents):
    return any(a <= child[0] and child[1] <= b for a, b in parents)


@pytest.mark.parametrize("tpu", [{}, {"fused_stages": True}],
                         ids=["unfused", "fused_stages"])
def test_predict_emits_its_spans_nested(tpu, tmp_path):
    model = _model(**tpu)
    batch = tiny_batch(batch_size=1, seed=3)
    model.predict(batch)
    spans = _spans(_traced(lambda: model.predict(batch), tmp_path))
    assert len(spans["predict"]) == 1
    stages = len(model.net.pseudoimage_generator.out_channels)
    # two per unfused stage (after its subm conv, after its down conv);
    # a stage that K8 runs whole has none
    want_norm = 0 if tpu else 2 * stages
    assert len(spans.get("encoder.norm", [])) == want_norm
    for name, parent in PREDICT_PARENTS.items():
        if name == "encoder.norm" and not want_norm:
            continue
        assert len(spans[name]) >= 1, name
        for s in spans[name]:
            assert _inside(s, spans[parent]), (name, parent)
    # the outer spans follow one another
    outer = [spans[k][0] for k in ("predict.voxelize", "predict.pfn_grid",
                                   "predict.encoder", "predict.rpn_head",
                                   "predict.decode_nms")]
    assert all(a[1] <= b[0] for a, b in zip(outer, outer[1:]))


def _scene(seed=0, extent=20.0, n=6000):
    """Uniform clutter and a few trunk columns over an ``extent`` m
    square: larger than the tiny model's 8 m window."""
    rng = np.random.default_rng(seed)
    pts = [np.column_stack([rng.uniform(0, extent, (n, 2)),
                            rng.uniform(0, 4, n), rng.uniform(0, 1, n)])]
    for cx, cy in rng.uniform(1, extent - 1, (4, 2)):
        m = 300
        pts.append(np.column_stack([cx + rng.normal(0, 0.1, m),
                                    cy + rng.normal(0, 0.1, m),
                                    rng.uniform(0, 4, m),
                                    rng.uniform(0, 1, m)]))
    return np.concatenate(pts).astype(np.float32)


@pytest.mark.parametrize("device_crop,batch_tiles",
                         [(True, 1), (False, 1), (True, 2)],
                         ids=["device_crop", "host_crop", "device_crop_b2"])
def test_tiled_call_emits_its_spans(device_crop, batch_tiles, tmp_path):
    model = _model()
    tiler = TiledInference(model, overlap=2.0, batch_tiles=batch_tiles,
                           device_crop=device_crop)
    scene = _scene()
    dets = tiler(scene)
    assert dets, "the merge had nothing to merge"
    spans = _spans(_traced(lambda: tiler(scene), tmp_path))
    lo, hi = scene[:, :2].min(0), scene[:, :2].max(0)
    n_tiles = (len(tiler._tile_origins(lo[0], hi[0], 8.0, 2.0))
               * len(tiler._tile_origins(lo[1], hi[1], 8.0, 2.0)))
    n_chunks = -(-n_tiles // batch_tiles)
    assert len(spans["plot"]) == 1
    assert len(spans["plot.sort"]) == 1
    assert len(spans["plot.crop"]) == n_chunks
    assert len(spans["predict"]) == n_chunks
    assert len(spans["plot.merge"]) == 1
    for name in ("plot.sort", "plot.crop", "predict", "plot.merge"):
        assert all(_inside(s, spans["plot"]) for s in spans[name]), name
    # a chunk's crop comes before its predict, the merge after them all
    order = sorted((s[0], name) for name in ("plot.sort", "plot.crop",
                                             "predict", "plot.merge")
                   for s in spans[name])
    names = [name for _, name in order]
    assert names == (["plot.sort"] + ["plot.crop", "predict"] * n_chunks
                     + ["plot.merge"])


def _counting_cond(monkeypatch):
    calls = [0]
    cond = nms._keep_cond

    def counted(*args):
        calls[0] += 1
        return cond(*args)

    monkeypatch.setattr(nms, "_keep_cond", counted)
    return calls


def test_nms_rounds_counts_each_condition_evaluation(monkeypatch,
                                                     tmp_path):
    calls = _counting_cond(monkeypatch)
    # a chain of suppressions: box i overlaps box i + 1 only
    n = 12
    suppress = torch.zeros((n, n), dtype=torch.bool)
    idx = torch.arange(n - 1)
    suppress[idx, idx + 1] = True
    suppress[idx + 1, idx] = True
    valid = torch.ones((n,), dtype=torch.bool)
    rank = torch.arange(n)
    profiling.counters()
    _traced(lambda: nms._greedy_keep(suppress, valid, rank), tmp_path)
    got = profiling.counters()["nms.rounds"]
    assert got == calls[0] > 2
    model = _model()
    batch = tiny_batch(batch_size=1, seed=3)
    calls[0] = 0
    _traced(lambda: model.predict(batch), tmp_path)
    # and the tiny encoder's one stage runs its two eval norms as K11
    assert profiling.counters() == {"nms.rounds": calls[0],
                                    "encoder.norm_fused": 2}
    assert calls[0] > 2


def test_untraced_calls_enter_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered untraced")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.counters()
    model = _model()
    batch = tiny_batch(batch_size=1, seed=3)
    model.predict(batch)
    TiledInference(model, overlap=2.0)(_scene(n=2000))
    step = model.make_train_step(model.get_optimizer({},
                                                     grad_clip_value=2.0))
    step(tiny_batch(batch_size=1, seed=4))
    assert profiling.counters() == {}
    with pytest.raises(AssertionError, match="entered untraced"):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.span("predict"):
                pass


def test_exported_predict_holds_no_profiler_op():
    from objectdetection_3d_tpu_torch import serving

    program, _ = serving.export_predict(_model(), batch_size=1)
    targets = [str(n.target) for gm in program.graph_module.modules()
               if isinstance(gm, torch.fx.GraphModule)
               for n in gm.graph.nodes if n.op == "call_function"]
    assert targets
    assert not [t for t in targets if "profiler" in t
                or "record_function" in t]


# ---- the readings, on a hand-built Chrome trace ------------------------
def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _predict_trace():
    """Two predicts, trace microseconds.

    predict 1 [0, 1000]: voxelize [0, 100] launches k_vox (device
    [50, 150]); pfn_grid [100, 200] k_pfn ([150, 250]); encoder [200, 600]
    launches k_conv ([250, 450]) and, inside encoder.norm [300, 400],
    k_norm ([450, 550]); rpn_head [600, 700] k_rpn ([550, 600]);
    decode_nms [700, 1000] k_dec ([600, 640]), and inside predict.nms
    [750, 950] k_nms ([760, 790]).  The device idles [0, 50] (midpoint
    25, in voxelize), [640, 760] (700, in decode_nms, not in nms) and
    [790, 1005] (897.5, in nms).  A copy ([1005, 1015]) is launched
    outside every span.  predict 2 [2000, 2100]: voxelize [2000, 2050]
    launches k_vox ([2000, 2040]) from another thread; the device idles
    [2040, 2100] (2070, in nms [2050, 2100]).
    """
    return {"traceEvents": [
        _ev("user_annotation", "predict", 0, 1000),
        _ev("user_annotation", "predict.voxelize", 0, 100),
        _ev("user_annotation", "predict.pfn_grid", 100, 100),
        _ev("user_annotation", "predict.encoder", 200, 400),
        _ev("user_annotation", "encoder.norm", 300, 100),
        _ev("user_annotation", "predict.rpn_head", 600, 100),
        _ev("user_annotation", "predict.decode_nms", 700, 300),
        _ev("user_annotation", "predict.nms", 750, 200),
        _ev("user_annotation", "predict", 2000, 100),
        _ev("user_annotation", "predict.voxelize", 2000, 50),
        _ev("user_annotation", "predict.decode_nms", 2050, 50),
        _ev("user_annotation", "predict.nms", 2050, 50),
        _ev("gpu_user_annotation", "predict", 50, 900),
        _ev("cuda_runtime", "cudaLaunchKernel", 10, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 210, 5, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 310, 5, corr=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 610, 5, corr=5),
        _ev("cuda_runtime", "cudaLaunchKernel", 710, 5, corr=6),
        _ev("cuda_runtime", "cudaLaunchKernel", 755, 5, corr=7),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1003, 1, corr=8),
        _ev("cuda_driver", "cuLaunchKernel", 2010, 5, corr=9),
        _ev("kernel", "k_vox", 50, 100, corr=1),
        _ev("kernel", "k_pfn", 150, 100, corr=2),
        _ev("kernel", "k_conv", 250, 200, corr=3),
        _ev("kernel", "k_norm", 450, 100, corr=4),
        _ev("kernel", "k_rpn", 550, 50, corr=5),
        _ev("kernel", "k_dec", 600, 40, corr=6),
        _ev("gpu_memset", "k_nms", 760, 30, corr=7),
        _ev("gpu_memcpy", "copy", 1005, 10, corr=8),
        _ev("kernel", "k_vox", 2000, 40, corr=9),
    ]}


def test_span_readings_charge_launches_to_spans_and_their_children():
    tr = _predict_trace()
    got = {name: profiling.span_device_ms(tr, (name,))
           for name in ("predict", "predict.voxelize", "predict.encoder",
                        "encoder.norm", "predict.decode_nms",
                        "predict.nms")}
    assert got == pytest.approx({
        "predict": 0.66, "predict.voxelize": 0.14,
        "predict.encoder": 0.3, "encoder.norm": 0.1,
        "predict.decode_nms": 0.07, "predict.nms": 0.03})
    assert profiling.span_device_ms(
        tr, ("predict.voxelize", "predict.pfn_grid")) == pytest.approx(0.24)
    assert profiling.span_count(tr, "predict") == 2
    assert profiling.span_host_ms(tr, "predict.nms") == pytest.approx(0.25)
    # busy: [50, 640], [760, 790], [1005, 1015], [2000, 2040]
    assert profiling.device_busy_ms(tr) == pytest.approx(0.67)
    assert profiling.span_idle_ms(tr, "predict.nms") == pytest.approx(
        0.215 + 0.06)
    assert profiling.span_idle_ms(tr, "predict") == pytest.approx(
        0.05 + 0.12 + 0.215 + 0.06)
    assert profiling.span_idle_ms(
        tr, "predict", outside=("predict.decode_nms",)) == pytest.approx(
            0.05)


def test_predict_table_reads_a_trace_of_predicts():
    t = profile_predict.predict_table(_predict_trace(), nms_rounds=7)
    # per predict: the sums above over 2 predicts
    assert t["voxelize"] == pytest.approx(0.07)
    assert t["front"] == pytest.approx(0.12)
    assert t["encoder"] == pytest.approx(0.15)
    assert t["encoder.norm"] == pytest.approx(0.05)
    assert t["rpn_head"] == pytest.approx(0.025)
    assert t["decode_nms"] == pytest.approx(0.035)
    assert t["nms"] == pytest.approx(0.015)
    assert t["busy"] == pytest.approx(0.335)
    assert t["outer"] == pytest.approx(0.33 / 0.335)
    assert t["nms_idle"] == pytest.approx(0.1375)
    assert t["nms_rounds"] == 3.5


def test_plot_table_reads_a_trace_of_a_tiled_call():
    """A plot [0, 1000]: sort [0, 100] launches an upload ([20, 60]) and a
    sort ([60, 90]); two chunks, crop [100, 150] + predict [150, 400] and
    crop [400, 450] + predict [450, 700]; merge [700, 1000] reads back
    ([710, 720]).  The device idles [0, 20] (in sort), [90, 160] (midpoint
    125, in the first crop), [390, 420] (405, the second crop), [650, 710]
    (680, the second predict) and [720, 1000] (merge)."""
    tr = {"traceEvents": [
        _ev("user_annotation", "plot", 0, 1000),
        _ev("user_annotation", "plot.sort", 0, 100),
        _ev("user_annotation", "plot.crop", 100, 50),
        _ev("user_annotation", "predict", 150, 250),
        _ev("user_annotation", "plot.crop", 400, 50),
        _ev("user_annotation", "predict", 450, 250),
        _ev("user_annotation", "plot.merge", 700, 300),
        _ev("cuda_runtime", "cudaMemcpyAsync", 10, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 50, 5, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 160, 5, corr=4),
        _ev("cuda_runtime", "cudaLaunchKernel", 410, 5, corr=5),
        _ev("cuda_runtime", "cudaLaunchKernel", 460, 5, corr=6),
        _ev("cuda_runtime", "cudaMemcpyAsync", 705, 5, corr=7),
        _ev("gpu_memcpy", "upload", 20, 40, corr=1),
        _ev("kernel", "sort", 60, 30, corr=2),
        _ev("kernel", "crop", 160, 20, corr=3),
        _ev("kernel", "tile", 180, 210, corr=4),
        _ev("kernel", "crop", 420, 20, corr=5),
        _ev("kernel", "tile", 440, 210, corr=6),
        _ev("gpu_memcpy", "readback", 710, 10, corr=7),
    ]}
    t = profile_predict.plot_table(tr)
    assert t["sort_crop"] == pytest.approx(0.11)
    assert t["merge"] == pytest.approx(0.3)
    assert t["tiler_idle"] == pytest.approx(0.02 + 0.07 + 0.03 + 0.28)
    assert t["predicts"] == 2


def test_step_timer_rates_on_perf_counter(monkeypatch):
    clock = iter([10.0, 10.5, 11.5])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    timer = profiling.StepTimer(log_every=2)
    assert timer.step() is None
    assert timer.step() == pytest.approx(4.0)     # 2 steps in 0.5 s
    assert timer.step() is None
    assert timer.step() == pytest.approx(2.0)
    assert timer.last_rate == pytest.approx(2.0)
