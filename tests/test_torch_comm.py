"""The port's process layer on the CPU: ``utils/comm.py``, ``engine/launch.py``,
the rank-threaded loaders, the evaluators' shard merges and
``sharded_knn_vote``.

The one-process shortcuts are checked in this process. Everything else runs
once for the module in 2 real gloo ranks (``launch(..., devices=["cpu",
"cpu"])``), mirroring ``tests/test_multihost.py:17-131`` and
``tests/test_two_process_cluster.py``: every ``comm`` function on payloads
of different sizes; ``COCOEvaluator``, ``RPNEvaluator`` and ``UBBRSaver``
each fed its rank's contiguous shard of 6 synthetic images (as
``InferenceSampler`` splits them) and merged on rank 0, equal to one
evaluator fed all 6 (results exactly, rows in the same order); and
``sharded_knn_vote`` over the 2 ranks (Q = 37 queries, padded to 38), equal
to the port's ``knn_vote`` (exactly, on clustered descriptors with no
near-ties) and to JAX's ``sharded_knn_vote`` on a 2-device CPU mesh, and
``verify_candidates`` over the group equal to its one-process keep mask.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from lvc_tpu_torch.config import get_cfg
from lvc_tpu_torch.data import build as data_build
from lvc_tpu_torch.data.catalog import MetadataCatalog
from lvc_tpu_torch.data.samplers import InferenceSampler, TrainingSampler
from lvc_tpu_torch.engine import defaults
from lvc_tpu_torch.engine.launch import launch
from lvc_tpu_torch.evaluation.coco_evaluation import COCOEvaluator
from lvc_tpu_torch.evaluation.rpn_evaluation import RPNEvaluator
from lvc_tpu_torch.evaluation.ubbr_saver import UBBRSaver
from lvc_tpu_torch.modeling.roi_heads.cascade_rcnn import RegOnlyOutput
from lvc_tpu_torch.modeling.roi_heads.fast_rcnn import Detections
from lvc_tpu_torch.ops.knn import knn_vote, sharded_knn_vote
from lvc_tpu_torch.pipeline.verification import verify_candidates
from lvc_tpu_torch.utils import comm

N_IMAGES, DATASET = 6, "dp_synth_test"
KNN = dict(n_shot=50, n_query=37, classes=6, dim=16, k=5)


def _write_gt(root: str) -> str:
    images = [{"id": i + 1, "height": 100, "width": 120, "file_name": f"{i}.jpg"} for i in range(N_IMAGES)]
    anns = [{"id": 10 * i + j + 1, "image_id": i + 1, "category_id": 1 + j % 2,
             "bbox": [10 + 5 * j, 10 + 3 * i, 30, 25], "area": 750, "iscrowd": 0}
            for i in range(N_IMAGES) for j in range(3)]
    path = os.path.join(root, "gt.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "a"}, {"id": 2, "name": "b"}]}, f)
    return path


def _register(gt_path: str):
    MetadataCatalog.get(DATASET).set(json_file=gt_path, thing_classes=["a", "b"],
                                     thing_dataset_id_to_contiguous_id={1: 0, 2: 1}, evaluator_type="coco")


def _meta(i):
    return {"image_id": i + 1, "orig_size": (100, 120), "image_size": (50, 60), "gt_ids": [10 * i + 1, 10 * i + 2],
            "gt_scores": None, "gt_boxes_orig": [[1.0, 2.0, 30.0, 40.0], [5.0, 6.0, 20.0, 30.0]], "padding": False}


def _outputs(i):
    """Seeded padded outputs of image i: Detections, ProposalNetwork's dict,
    RegOnlyOutput (batch 1)."""
    g = torch.Generator().manual_seed(i)
    xy = torch.rand(1, 8, 2, generator=g) * 40
    boxes = torch.cat([xy, xy + 5 + torch.rand(1, 8, 2, generator=g) * 15], -1)
    # the first 3 rows near image i's gt boxes (their class j % 2 is the gt's), so that the AP is not 0
    gt = torch.tensor([[10 + 5 * j, 10 + 3 * i, 40 + 5 * j, 35 + 3 * i] for j in range(3)], dtype=torch.float32) / 2
    boxes[0, :3] = gt + torch.rand(3, 4, generator=g) * 2
    scores = torch.rand(1, 8, generator=g)
    valid = torch.arange(8)[None] < 6
    dets = Detections(boxes, scores, torch.arange(8)[None] % 2, valid, torch.zeros(1, 8, dtype=torch.long))
    props = {"proposal_boxes": boxes, "objectness_logits": scores, "proposal_valid": valid}
    reg = RegOnlyOutput(boxes[:, :2], torch.tensor([[0, 1]]), torch.tensor([[True, i % 2 == 0]]))
    return dets, props, reg


def _evaluate(indices, out_dir: str, cands: str):
    """The three evaluators fed ``indices``; returns (COCO results, COCO
    rows, RPN results, RPN pickle, UBBR rows) as this process sees them."""
    coco, rpn, ubbr = COCOEvaluator(DATASET), RPNEvaluator(DATASET, output_dir=out_dir), UBBRSaver(cands)
    for e in (coco, rpn, ubbr):
        e.reset()
    for i in indices:
        dets, props, reg = _outputs(i)
        coco.process_detections(dets, [_meta(i)])
        rpn.process_detections(props, [_meta(i)])
        ubbr.process_detections(reg, [_meta(i)])
    res = coco.evaluate(), rpn.evaluate()
    ubbr.evaluate()
    if not comm.is_main_process():
        return res[0], None, res[1], None, None
    with open(os.path.join(out_dir, "coco_proposals_test_results.pkl"), "rb") as f:
        proposals = pickle.load(f)
    with open(cands.replace(".json", "_ubbr.json")) as f:
        rows = json.load(f)
    return res[0], coco._predictions, res[1], proposals, rows


def _verify_inputs():
    """(shots, queries) of ``verify_candidates``: the clustered descriptors,
    the queries' detector labels seeded (some are the vote's mode)."""
    shots, classes, queries = chip_smoke.clustered(3, KNN["n_shot"], KNN["n_query"], KNN["classes"], KNN["dim"], "cpu")
    labels = np.random.RandomState(4).randint(0, 2, KNN["n_query"])
    return ({"descriptors": shots.numpy(), "classes": classes.numpy()},
            {"descriptors": queries.numpy(), "classes": labels})


def _rank_main(out_dir: str, gt_path: str):
    r = comm.get_rank()
    res = {"world": comm.get_world_size(), "rank": r, "main": comm.is_main_process()}
    res["all_gather"] = comm.all_gather_objects({"rank": r, "data": list(range(10 * (r + 1)))})
    res["gather"] = comm.gather_objects({"rank": r})
    res["seed"] = comm.shared_random_seed()
    res["mean"] = comm.reduce_dict({"a": float(r), "b": torch.tensor(r + 1.0)})
    res["sum"] = comm.reduce_dict({"a": float(r)}, average=False)
    comm.synchronize()
    _register(gt_path)
    res["evaluators"] = _evaluate(InferenceSampler(N_IMAGES, r, 2), os.path.join(out_dir, "dp"),
                                  os.path.join(out_dir, "cands_dp.json"))
    shots, classes, queries = chip_smoke.clustered(3, KNN["n_shot"], KNN["n_query"], KNN["classes"], KNN["dim"], "cpu")
    res["knn"] = sharded_knn_vote(shots, classes, queries, k=KNN["k"], num_classes=KNN["classes"])
    res["verify"] = verify_candidates(*_verify_inputs(), k=KNN["k"], device="cpu", group=dist.group.WORLD)
    torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("comm"))
    gt = _write_gt(out)
    for name in ("cands_dp.json", "cands_one.json"):
        with open(os.path.join(out, name), "w") as f:
            json.dump({"images": [], "annotations": []}, f)
    launch(_rank_main, 2, args=(out, gt), devices=["cpu", "cpu"])
    return out, gt, [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(2)]


def test_comm_one_process_shortcuts():
    assert comm.get_world_size() == 1 and comm.get_rank() == 0 and comm.is_main_process()
    assert comm.all_gather_objects({"a": 1}) == [{"a": 1}]
    assert comm.gather_objects([1, 2]) == [[1, 2]]
    assert isinstance(comm.shared_random_seed(), int)
    d = {"x": 3.0, "y": torch.tensor(2.0)}
    assert comm.reduce_dict(d) is d
    comm.synchronize()


def test_comm_two_processes(ranks):
    _, _, (r0, r1) = ranks
    assert (r0["world"], r0["rank"], r0["main"], r1["world"], r1["rank"], r1["main"]) == (2, 0, True, 2, 1, False)
    for r in (r0, r1):
        assert [g["rank"] for g in r["all_gather"]] == [0, 1]
        assert [len(g["data"]) for g in r["all_gather"]] == [10, 20]  # payloads of different sizes
        assert r["mean"]["a"] == 0.5 and isinstance(r["mean"]["a"], float)
        assert r["mean"]["b"].dtype == torch.float32 and float(r["mean"]["b"]) == 1.5
        assert r["sum"] == {"a": 1.0}
    assert r0["gather"] == [{"rank": 0}, {"rank": 1}] and r1["gather"] == []
    assert r0["seed"] == r1["seed"]


def _one_process(out, gt):
    _register(gt)
    one = os.path.join(out, "one")
    return _evaluate(range(N_IMAGES), one, os.path.join(out, "cands_one.json"))


def test_coco_evaluator_merge_equals_one_process(ranks):
    out, gt, (r0, r1) = ranks
    want, want_rows = _one_process(out, gt)[:2]
    got, got_rows = r0["evaluators"][:2]
    assert want["bbox"]["AP"] > 0 and got == want and got_rows == want_rows
    assert r1["evaluators"][0] == {}


def test_rpn_evaluator_merge_equals_one_process(ranks):
    out, gt, (r0, r1) = ranks
    _, _, want, want_pkl, _ = _one_process(out, gt)
    got, got_pkl = r0["evaluators"][2:4]
    assert got == want and got_pkl["ids"] == want_pkl["ids"] == list(range(1, N_IMAGES + 1))
    for key in ("boxes", "objectness_logits"):
        assert all(np.array_equal(a, b) for a, b in zip(got_pkl[key], want_pkl[key]))
    assert r1["evaluators"][2] == {}


def test_ubbr_saver_merge_equals_one_process(ranks):
    out, gt, (r0, _) = ranks
    want = _one_process(out, gt)[4]
    assert len(want) == 9 and r0["evaluators"][4] == want


def test_sharded_knn_vote_equals_knn_vote(ranks):
    _, _, (r0, r1) = ranks
    shots, classes, queries = chip_smoke.clustered(3, KNN["n_shot"], KNN["n_query"], KNN["classes"], KNN["dim"], "cpu")
    topk, mode = knn_vote(shots, classes, queries, k=KNN["k"], num_classes=KNN["classes"])
    for r in (r0, r1):
        assert r["knn"][0].shape == (KNN["n_query"], KNN["k"])
        assert torch.equal(r["knn"][0], topk) and torch.equal(r["knn"][1], mode)
    # without torch.distributed it is knn_vote
    one = sharded_knn_vote(shots, classes, queries, k=KNN["k"], num_classes=KNN["classes"])
    assert torch.equal(one[0], topk) and torch.equal(one[1], mode)


def test_verify_candidates_over_a_group_equals_one_process(ranks):
    _, _, (r0, r1) = ranks
    want = verify_candidates(*_verify_inputs(), k=KNN["k"], device="cpu")
    assert want.any() and not want.all()
    assert np.array_equal(r0["verify"], want) and np.array_equal(r1["verify"], want)


def test_sharded_knn_vote_equals_jax(ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from lvc_tpu.ops.knn import sharded_knn_vote as jax_sharded_knn_vote

    _, _, (r0, _) = ranks
    shots, classes, queries = chip_smoke.clustered(3, KNN["n_shot"], KNN["n_query"], KNN["classes"], KNN["dim"], "cpu")
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("data",))
    topk, mode = jax_sharded_knn_vote(mesh, jnp.asarray(shots.numpy()), jnp.asarray(classes.numpy().astype(np.int32)),
                                      jnp.asarray(queries.numpy()), k=KNN["k"], num_classes=KNN["classes"])
    assert np.array_equal(r0["knn"][0].numpy(), topk) and np.array_equal(r0["knn"][1].numpy(), mode)


def test_launch_refusals():
    with pytest.raises(ValueError, match="devices given"):
        launch(print, 2, devices=["cpu"])
    if torch.cuda.device_count() < 2:
        parser = defaults.default_argument_parser()
        args = parser.parse_args(["--num-gpus", "2", "MODEL.DEVICE", "cuda"])
        with pytest.raises(RuntimeError, match="cards found"):
            launch(print, 2, args=(args,))
    # one rank and no devices: the function runs in this process, no group
    assert launch(lambda x: x + 1, 1, args=(1,)) == 2


def test_samplers_split_by_rank():
    import itertools

    a = list(itertools.islice(iter(TrainingSampler(16, seed=3, rank=0, world_size=2)), 8))
    b = list(itertools.islice(iter(TrainingSampler(16, seed=3, rank=1, world_size=2)), 8))
    merged = list(itertools.islice(iter(TrainingSampler(16, seed=3)), 16))
    assert merged[0::2] == a and merged[1::2] == b
    shards = [list(InferenceSampler(11, r, 3)) for r in range(3)]
    assert sum(shards, []) == list(range(11))


def test_trainer_threads_rank_into_loaders(monkeypatch):
    captured = {}

    def fake_train_loader(cfg, mapper=None, rank=0, world_size=1):
        captured["train"] = (rank, world_size)
        raise RuntimeError("stop")

    def fake_test_loader(cfg, name, mapper=None, batch_size=1, rank=0, world_size=1, with_gt=False):
        captured["test"] = (rank, world_size)
        raise RuntimeError("stop")

    monkeypatch.setattr(defaults, "build_detection_train_loader", fake_train_loader)
    monkeypatch.setattr(defaults, "build_detection_test_loader", fake_test_loader)
    monkeypatch.setattr(comm, "get_rank", lambda: 2)
    monkeypatch.setattr(comm, "get_world_size", lambda: 4)
    cfg = get_cfg()
    with pytest.raises(RuntimeError, match="stop"):
        defaults.DefaultTrainer.build_train_loader(cfg)
    with pytest.raises(RuntimeError, match="stop"):
        defaults.DefaultTrainer.build_test_loader(cfg, "x")
    assert captured == {"train": (2, 4), "test": (2, 4)}


def test_train_loader_raises_when_the_batch_does_not_divide():
    cfg = get_cfg()
    cfg.SOLVER.IMS_PER_BATCH = 16
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        data_build.build_detection_train_loader(cfg, rank=0, world_size=3)
