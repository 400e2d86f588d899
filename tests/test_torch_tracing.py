"""The port's spans and counters (``lvc_tpu_torch/utils/tracing.py``) and the
benchmark's readers of them, on the CPU.

- With no profiler recording, a span is one shared no-op context: no
  ``record_function``, no lock, no CUDA event; a count does nothing.
- Under ``torch.profiler.profile`` spans nest, counts go to the innermost
  span of their thread, and timing events (stand-ins for CUDA's here) are
  resolved into stream milliseconds when the table is read; many threads
  recording at once lose nothing.
- The train loader's worker threads record ``loader.decode`` and
  ``loader.augment``, its consumer ``loader.wait`` and ``loader.collate``.
- ``nms.rounds`` counts the fixpoint's host reads.
- A tiny R-50-FPN training step still shows the five stage ranges in the
  Chrome trace, the eval forward the first three, and the RPN's split.
- ``ProfilerHook`` clears the table, records every thread's ranges and
  writes ``spans.json``.
- Each reader returns None on empty totals and its quotient on synthetic ones.
"""
import json
import logging
import sys
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from benchmark import spec
from lvc_tpu_torch.utils import tracing


def _trace_names(prof, tmp_path):
    """The ``user_annotation`` ranges of the profile's Chrome trace, in time order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = sorted((e for e in json.load(open(path))["traceEvents"] if e.get("cat") == "user_annotation"),
                    key=lambda e: e["ts"])
    return [e["name"] for e in events]


class _Raises:
    """Creating or entering one fails the test."""

    def __init__(self, *a, **k):
        raise AssertionError("created while tracing is off")

    def __enter__(self):
        raise AssertionError("entered while tracing is off")

    def __exit__(self, *exc):
        return False


def test_off_span_opens_nothing(monkeypatch):
    tracer = tracing.Tracer()
    monkeypatch.setattr(torch.profiler, "record_function", _Raises)
    monkeypatch.setattr(torch.cuda, "Event", _Raises)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    tracer._lock = object.__new__(_Raises)
    assert tracer.span("a") is tracer.span("b", device=False) is tracing.span("c")
    with tracer.span("a"):
        tracer.count("n", 3)
        tracer.count("read", _Raises)  # a device read is never made
    assert tracer._table == {} and tracer._pending == []


class _FakeEvent:
    """A CUDA timing event's interface: 2.5 ms from start to end; the end
    reads unfinished (``query``) until waited for."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.done = False

    def record(self):
        pass

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        assert end.done
        return 2.5


def test_spans_nest_counts_attribute_and_events_resolve(monkeypatch, tmp_path):
    tracer = tracing.Tracer()
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    _FakeEvent.made = 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracer.count("loose")
        for _ in range(3):
            with tracer.span("outer"):
                tracer.count("k")
                with tracer.span("inner"):
                    tracer.count("k", 2)
                    with tracer.span("host", device=False):
                        tracer.count("h")
                tracer.count("k")
    assert _FakeEvent.made == 12 and len(tracer._pending) == 6  # nothing waited for yet
    t = tracer.totals()
    assert tracer._pending == []
    assert t["outer"]["calls"] == t["inner"]["calls"] == t["host"]["calls"] == 3
    assert t["outer"]["counts"] == {"k": 6} and t["inner"]["counts"] == {"k": 6} and t["host"]["counts"] == {"h": 3}
    assert t[""] == {"calls": 0, "host_ms": 0.0, "stream_ms": None, "counts": {"loose": 1}}
    assert t["outer"]["stream_ms"] == t["inner"]["stream_ms"] == 7.5 and t["host"]["stream_ms"] is None
    assert t["outer"]["host_ms"] >= t["inner"]["host_ms"] >= t["host"]["host_ms"] > 0
    assert _trace_names(prof, tmp_path).count("inner") == 3
    tracer.reset()
    assert tracer.totals() == {}


def test_many_threads_lose_no_span_or_count():
    tracer = tracing.Tracer()
    threads, per = 16, 200
    barrier = threading.Barrier(threads)

    def work():
        barrier.wait(timeout=30)
        for _ in range(per):
            with tracer.span("w", device=False):
                tracer.count("c")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in pool)
    t = tracer.totals()["w"]
    assert t["calls"] == threads * per and t["counts"] == {"c": threads * per}


def _mini_loader(tmp_path, n=4):
    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.data.build import TrainLoader
    from lvc_tpu_torch.data.dataset_mapper import DatasetMapper
    from lvc_tpu_torch.structures.boxes import BoxMode

    rng = np.random.RandomState(0)
    dicts = []
    for i in range(n):
        path = tmp_path / f"{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).save(path, quality=90)
        dicts.append({"file_name": str(path), "image_id": i, "height": 48, "width": 64,
                      "annotations": [{"bbox": [4.0, 4.0, 20.0, 16.0], "bbox_mode": BoxMode.XYWH_ABS,
                                       "category_id": 0}]})
    cfg = get_cfg()
    cfg.INPUT.MIN_SIZE_TRAIN = (48,)
    cfg.INPUT.MAX_SIZE_TRAIN = 96
    cfg.PAD.CANVAS_BUCKETS = ((64, 96), (96, 64))
    cfg.PAD.MAX_GT_PER_IMAGE = 4
    return TrainLoader(dicts, DatasetMapper(cfg, is_train=True), batch_size=2, num_workers=2,
                       sampler=range(n))  # n // 2 batches, then the loader ends


def test_loader_worker_spans_land_in_totals(tmp_path):
    main = threading.get_ident()
    seen = set()
    real = tracing.Tracer.span

    def spy(self, name, device=True):
        seen.add((name, threading.get_ident() == main))
        return real(self, name, device)

    tracing.reset()
    it = iter(_mini_loader(tmp_path))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tracing.Tracer, "span", spy)
            with profile(activities=[ProfilerActivity.CPU]):
                batches = [next(it), next(it)]
    finally:
        it.close()
    t = tracing.totals()
    assert [b["image"].shape for b in batches] == [(2, 64, 96, 3)] * 2
    assert t["loader.collate"]["calls"] == 2 and t["loader.wait"]["calls"] >= 4
    assert t["loader.decode"]["calls"] >= 4 and t["loader.augment"]["calls"] >= 4
    assert t["loader.take"]["calls"] == 2
    assert all(v["stream_ms"] is None and v["host_ms"] > 0 for v in t.values())
    # the workers and the assembler thread map and collate; the iterating
    # thread only takes finished batches
    assert {("loader.decode", False), ("loader.augment", False), ("loader.wait", False),
            ("loader.collate", False), ("loader.take", True)} == seen


def test_nms_rounds_count_the_host_reads(monkeypatch):
    from lvc_tpu_torch.ops.nms import nms_mask

    # a chain: box i overlaps box i + 1 (IoU 0.6), scores descending, so
    # each round settles one more box
    n = 7
    x = torch.arange(n, dtype=torch.float32) * 4.0
    boxes = torch.stack([x, torch.zeros(n), x + 16.0, torch.full((n,), 10.0)], -1)[None]
    scores = torch.linspace(1.0, 0.1, n)[None]
    reads = []
    real_equal = torch.equal
    monkeypatch.setattr(torch, "equal", lambda a, b: reads.append(1) or real_equal(a, b))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("rpn.nms"):
            keep = nms_mask(boxes, scores, torch.ones(1, n, dtype=torch.bool), 0.5)
    assert keep[0].tolist() == [True, False, True, False, True, False, True]
    assert len(reads) >= 3
    assert tracing.totals()["rpn.nms"]["counts"] == {"nms.rounds": len(reads)}


def _tiny_detector():
    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.engine.train_loop import make_train_step
    from lvc_tpu_torch.modeling.meta_arch.build import build_model
    from lvc_tpu_torch.solver.build import build_lr_schedule, build_optimizer
    from lvc_tpu_torch.utils.init import damped_init

    cfg = get_cfg()
    cfg.merge_from_file("configs/Base-RCNN-FPN.yaml")
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 8
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 32
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 8
    cfg.MODEL.FPN.OUT_CHANNELS = 32
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 32
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 50
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 20
    cfg.TEST.DETECTIONS_PER_IMAGE = 10
    model = damped_init(build_model(cfg, device="cpu")).train()
    optimizer = build_optimizer(cfg, model)
    return model, make_train_step(model, optimizer, build_lr_schedule(cfg, optimizer))


def test_r50_step_and_eval_forward_show_their_stages(tmp_path):
    model, step = _tiny_detector()
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.rand(1, 64, 96, 3, generator=g) * 255, "image_size": torch.tensor([[64, 96]]),
             "gt_boxes": torch.tensor([[[10.0, 10.0, 40.0, 50.0], [0.0, 0.0, 0.0, 0.0]]]),
             "gt_classes": torch.tensor([[1, 0]]), "gt_valid": torch.tensor([[True, False]])}
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch, 1)
    train_names = _trace_names(prof, tmp_path)
    train = tracing.totals()
    tracing.reset()
    model.eval()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(batch)
    eval_names = _trace_names(prof, tmp_path)
    infer = tracing.totals()
    stages = ["backbone", "rpn", "roi_heads", "backward", "optimizer"]
    assert [n for n in train_names if n in stages] == stages
    assert [n for n in eval_names if n in stages] == stages[:3]
    for name in ("rpn.match", "rpn.select", "rpn.nms"):
        assert train[name]["calls"] == 1 and name in train_names
    assert "rpn.match" not in infer and infer["roi_heads.nms"]["calls"] == 1
    assert train["rpn.nms"]["counts"]["nms.rounds"] >= 1 and infer["roi_heads.nms"]["counts"]["nms.rounds"] >= 1
    # the stage spans enclose their parts
    assert train["rpn"]["host_ms"] >= train["rpn.match"]["host_ms"] + train["rpn.nms"]["host_ms"]


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_profiler_hook_writes_spans_of_every_thread(tmp_path):
    from lvc_tpu_torch.engine import hooks

    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("before"):
            pass
    hook = hooks.ProfilerHook(0, 0, str(tmp_path))
    hook.trainer = types.SimpleNamespace(iter=0)

    def worker():
        with tracing.span("worker", device=False):
            tracing.count("items", 2)

    log, lines = logging.getLogger(hooks.__name__), _Lines()
    level = log.level
    log.addHandler(lines)
    log.setLevel(logging.INFO)
    try:
        hook.before_step()
        with tracing.span("step"):
            with ThreadPoolExecutor(1) as pool:
                pool.submit(worker).result(timeout=30)
        hook.after_step()
    finally:
        log.removeHandler(lines)
        log.setLevel(level)
    spans = json.load(open(tmp_path / "profiler" / "spans.json"))
    assert set(spans) == {"step", "worker"} and spans["worker"]["counts"] == {"items": 2}
    events = json.load(open(tmp_path / "profiler" / "trace.json"))["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"step", "worker"} <= names  # the worker thread's range too
    assert any(line.startswith("span worker: 1 calls") for line in lines.lines)


SYNTHETIC = {
    "rpn.match": {"calls": 4, "host_ms": 9.0, "stream_ms": 120.0, "counts": {}},
    "rpn.select": {"calls": 4, "host_ms": 9.0, "stream_ms": 20.0, "counts": {}},
    "rpn.nms": {"calls": 4, "host_ms": 9.0, "stream_ms": 60.0, "counts": {"nms.rounds": 36}},
    "roi_heads.nms": {"calls": 4, "host_ms": 9.0, "stream_ms": 16.0, "counts": {"nms.rounds": 28}},
    "loader.decode": {"calls": 80, "host_ms": 400.0, "stream_ms": None, "counts": {}},
    "loader.augment": {"calls": 80, "host_ms": 1000.0, "stream_ms": None, "counts": {}},
    "loader.collate": {"calls": 4, "host_ms": 100.0, "stream_ms": None, "counts": {}},
    "loader.wait": {"calls": 64, "host_ms": 480.0, "stream_ms": None, "counts": {}},
    "loader.take": {"calls": 4, "host_ms": 2.0, "stream_ms": None, "counts": {"loader.ready": 3}},
}
READERS = [  # (metric, mode, value from SYNTHETIC over 4 traced steps)
    ("rpn_match_ms.train", "train", 30.0), ("rpn_select_ms.train", "train", 5.0),
    ("rpn_nms_ms.train", "train", 15.0), ("rpn_nms_rounds.train", "train", 9.0),
    ("rpn_nms_ms.infer", "infer", 15.0), ("rpn_nms_rounds.infer", "infer", 9.0),
    ("det_nms_ms.infer", "infer", 4.0), ("det_nms_rounds.infer", "infer", 7.0),
    ("loader_decode_ms.train", "train", 5.0), ("loader_augment_ms.train", "train", 12.5),
    ("loader_collate_ms.train", "train", 25.0), ("loader_starved_ms.train", "train", 120.0),
    ("loader_ready_pct.train", "train", 75.0),
]


@pytest.mark.parametrize("metric,mode,value", READERS)
def test_span_readers(monkeypatch, metric, mode, value):
    read = spec.reader(metric)
    other = "infer" if mode == "train" else "train"
    ctx = spec.Context(mode, {}, None, 4)
    monkeypatch.setattr(tracing, "totals", lambda: {})
    assert read(ctx) is None
    monkeypatch.setattr(tracing, "totals", lambda: SYNTHETIC)
    assert read(ctx) == pytest.approx(value)
    assert read(spec.Context(other, {}, None, 4)) is None
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == metric)
    assert entry["workloads"] and all(mode in w for w in entry["workloads"])
