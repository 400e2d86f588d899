"""The train loader's assembler thread (``TrainLoader`` in
``lvc_tpu_torch/data/build.py``).

A stand-in mapper makes each example from its dataset dict alone, so the
batches can be held to ``collate()`` of the same in-order examples, bucketed
by canvas as the loader buckets them. Also: a batch the caller keeps is not
overwritten by later ones, closing the iterator stops its threads, a
mapper's exception reaches ``next()``, and the take span and its counter
land in the tracing table. The file imports no JAX; with a CUDA card the
batches are page-locked (marker ``cuda``), and the CPU tests run on that path:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_loader_assembler.py
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lvc_tpu_torch.data.build import TrainLoader
from lvc_tpu_torch.data.dataset_mapper import collate
from lvc_tpu_torch.data.samplers import TrainingSampler
from lvc_tpu_torch.utils import tracing

CANVASES = ((16, 24), (24, 16))
DICTS = [{"image_id": i} for i in range(40)]
G = 3


def fake_map(d):
    """An example of the mapper's form, a function of the dict alone; every
    third image lands on the second canvas, so the buckets fill at different
    rates."""
    i = d["image_id"]
    rng = np.random.RandomState(i)
    h, w = CANVASES[i % 3 == 0]
    return {"image": (rng.rand(h, w, 3) * 255).astype(np.float32),
            "image_size": np.array([h - i % 4, w - i % 5], np.int32),
            "gt_boxes": rng.rand(G, 4).astype(np.float32), "gt_classes": rng.randint(0, 7, G).astype(np.int64),
            "gt_valid": rng.rand(G) < 0.7, "gt_ignores": rng.rand(G) < 0.2,
            "image_id": i, "canvas": (h, w)}


def expected_batches(sampler, batch_size, n):
    """The first ``n`` batches collated from the mapped examples in the
    sampler's order, bucketed by canvas."""
    buckets, out = {}, []
    for i in sampler:
        ex = fake_map(DICTS[i])
        b = buckets.setdefault(ex["canvas"], [])
        b.append(ex)
        if len(b) == batch_size:
            out.append(collate(b, train=True))
            buckets[ex["canvas"]] = []
            if len(out) == n:
                return out
    return out


def new_threads(before):
    return [t for t in threading.enumerate() if t not in before]


def assembler_of(threads):
    (t,) = [t for t in threads if t.name == "TrainLoader-assembler"]
    return t


@pytest.mark.parametrize("batch_size,workers,n,switch_s", [
    (3, 3, 6, None),
    (2, 32, 40, 1e-5),  # more threads than cores, switching often
])
def test_batches_equal_collate_of_the_examples(batch_size, workers, n, switch_s):
    switch = sys.getswitchinterval()
    if switch_s:
        sys.setswitchinterval(switch_s)
    loader = TrainLoader(DICTS, fake_map, batch_size=batch_size, num_workers=workers,
                         sampler=TrainingSampler(len(DICTS), seed=5))
    it = iter(loader)
    try:
        got = [next(it) for _ in range(n)]
    finally:
        it.close()
        sys.setswitchinterval(switch)
    want = expected_batches(TrainingSampler(len(DICTS), seed=5), batch_size, n)
    assert {w["image"].shape[1:] for w in want} == {(16, 24, 3), (24, 16, 3)}
    for g, w in zip(got, want, strict=True):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_a_kept_batch_is_not_overwritten():
    it = iter(TrainLoader(DICTS, fake_map, batch_size=2, num_workers=2, sampler=TrainingSampler(len(DICTS), seed=1)))
    try:
        kept = next(it)
        snapshot = {k: v.tobytes() for k, v in kept.items()}
        later = [next(it) for _ in range(8)]
    finally:
        it.close()
    assert {k: v.tobytes() for k, v in kept.items()} == snapshot
    assert all(not np.shares_memory(kept["image"], b["image"]) for b in later)


def test_close_stops_the_assembler_and_the_workers():
    before = set(threading.enumerate())
    it = iter(TrainLoader(DICTS, fake_map, batch_size=2, num_workers=3, sampler=TrainingSampler(len(DICTS))))
    next(it)
    time.sleep(0.2)  # the assembler fills the queue and blocks on it
    started = new_threads(before)
    assert assembler_of(started).is_alive() and 2 <= len(started) <= 1 + 3  # the pool starts workers as needed
    it.close()
    deadline = time.monotonic() + 10.0
    while any(t.is_alive() for t in started) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not [t.name for t in started if t.is_alive()]


def test_a_mapper_error_is_raised_from_next():
    def mapper(d):
        if d["image_id"] == 30:
            raise ValueError("cannot map image 30")
        return fake_map(d)

    before = set(threading.enumerate())
    it = iter(TrainLoader(DICTS, mapper, batch_size=2, num_workers=2, sampler=range(len(DICTS))))
    next(it)
    assembler = assembler_of(new_threads(before))
    with pytest.raises(ValueError, match="cannot map image 30"):
        for _ in range(len(DICTS)):
            next(it)
    assembler.join(10.0)
    assert not assembler.is_alive()


def test_take_span_counts_the_batches_found_ready():
    gate = threading.Event()

    def mapper(d):
        if d["image_id"] in (4, 5):
            assert gate.wait(60.0)
        return fake_map(d)

    before = set(threading.enumerate())
    # all on the first canvas: three batches, then the loader ends
    it = iter(TrainLoader(DICTS, mapper, batch_size=2, num_workers=2, sampler=[1, 2, 4, 5, 7, 8]))
    try:
        # the profiler starts first: on a CUDA host its start can take seconds
        with profile(activities=[ProfilerActivity.CPU]):
            next(it)
            assembler = assembler_of(new_threads(before))
            tracing.reset()
            timer = threading.Timer(0.3, gate.set)
            timer.start()
            next(it)  # waits for the gated images
            assembler.join(10.0)  # the last batch and the end are queued
            next(it)
        timer.join()
    finally:
        gate.set()
        it.close()
    take = tracing.totals()["loader.take"]
    assert take["calls"] == 2 and take["counts"] == {"loader.ready": 1}
    assert take["host_ms"] >= 200.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: page-locked host memory needs CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
def test_batches_are_page_locked_and_copy_whole(cuda_device):
    batches = list(TrainLoader(DICTS, fake_map, batch_size=2, num_workers=2, sampler=range(12)))
    assert len(batches) == 6
    for b in batches:
        host = torch.from_numpy(b["image"])
        assert host.is_pinned()
        assert torch.equal(host.to(cuda_device).cpu(), host)
