"""The seeded generators repeat by seed, and a seed changes only the order
of a fixed set of sizes."""
import torch

from benchmark import spec
from benchmark.tests import narrow
from benchmark.traffic.images import make_pool, structure
from benchmark.traffic.tree import write_tree


def _cfg():
    return dict(spec.config("lvc_r50_fpn_base")["cfg"], **narrow.OVERRIDES)


def test_device_pool_repeats_by_seed():
    cell = narrow.cell(spec.cell("base_train_b16"))
    a = make_pool(cell["traffic"], _cfg(), 2 ** 33 + 5, torch.device("cpu"))
    b = make_pool(cell["traffic"], _cfg(), 2 ** 33 + 5, torch.device("cpu"))
    c = make_pool(cell["traffic"], _cfg(), 2 ** 33 + 6, torch.device("cpu"))
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert not all(torch.equal(x["image"], z["image"]) for x, z in zip(a, c))


def test_every_seed_gets_the_same_sizes_in_another_order():
    cfg = spec.config("lvc_r50_fpn_base")["cfg"]
    traffic = spec.cell("base_train_b16")["traffic"]
    plan = structure(traffic, cfg["PAD.CANVAS_BUCKETS"], cfg["INPUT.MAX_SIZE_TRAIN"])
    assert [len(rows) for rows in plan] == [16] * len(traffic["canvases"])
    sizes = {}
    for seed in (1, 2):
        pool = make_pool(dict(traffic, canvases=traffic["canvases"][:3]), cfg, seed, torch.device("cpu"))
        sizes[seed] = sorted(tuple(s) for b in pool for s in b["image_size"].tolist())
        assert [tuple(b["image"].shape[1:3]) for b in pool] == [(832, 1344), (1344, 832), (832, 1344)]
        counts = [int(n) for b in pool for n in b["gt_valid"].sum(1)]
        assert 1 <= min(counts) and max(counts) <= 50
    assert sizes[1] == sizes[2]


def test_jpeg_tree_repeats_by_seed(tmp_path):
    cell = narrow.cell(spec.cell("base_train_loader_b16"))
    a = write_tree(str(tmp_path / "a"), cell["traffic"], 60, 9, threads=2)
    b = write_tree(str(tmp_path / "b"), cell["traffic"], 60, 9, threads=2)
    assert [d["annotations"] for d in a] == [d["annotations"] for d in b]
    for x, y in zip(a, b):
        assert open(x["file_name"], "rb").read() == open(y["file_name"], "rb").read()
