"""The harness finds configurations, cells and metric readers by name, and
a new cell is picked up from its files alone."""
import json
import os
import shutil

import pytest

from benchmark import spec


def test_every_entry_of_benchmark_json_has_its_files():
    bench = spec.benchmark()
    for c in bench["configs"]:
        assert spec.config(c["name"])["name"] == c["name"]
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert (cell["config"], cell["traffic"]["name"], cell["chips"], cell["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("name", ["base_train_b16", "extract_infer_b8", "base_train_loader_b16"])
def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(name):
    bench = spec.benchmark()
    e2e = [m["name"] for m in spec.end_to_end(bench, name)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(bench, name)


def test_a_new_cell_is_found_from_its_file(tmp_path, monkeypatch):
    here = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cell = json.load(open(here / "cells" / "base_train_b16.json"))
    cell["traffic"]["name"] = "device_b16_new"
    json.dump(cell, open(here / "cells" / "new_cell.json", "w"))
    monkeypatch.setattr(spec, "HERE", str(here))
    assert spec.cell("new_cell")["traffic"]["name"] == "device_b16_new"
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "base_train_b16" in m.get("workloads", []):
            m["workloads"].append("new_cell")
    assert {m["name"] for m in spec.per_layer(bench, "new_cell")} == {
        m["name"] for m in spec.per_layer(bench, "base_train_b16")}


def test_a_reader_that_finds_nothing_returns_none():
    ctx = spec.Context("infer", {"seconds": 1.0, "flops": 1.0, "peak_flops": 1.0}, None, 0)
    assert spec.reader("backbone_ms.train")(ctx) is None
    assert spec.reader("k2_roofline_pct.infer")(ctx) is None
    assert spec.reader("loader_wait_ms.train")(ctx) is None


def test_cells_share_the_mix_file_and_override_it():
    mix = json.load(open(os.path.join(spec.HERE, "traffic", "coco.json")))
    for name in ("base_train_b16", "extract_infer_b8", "base_train_loader_b16"):
        traffic = spec.cell(name)["traffic"]
        assert traffic["mix"] == "coco" and traffic["boxes"] == mix["boxes"] and traffic["photos"] == mix["photos"]
    assert spec.cell("extract_infer_b8")["traffic"]["min_sizes"] == [800]


def test_roofline_readers_declare_their_kernels():
    bench = spec.benchmark()
    calls = {k["call"]: k for k in spec.kernels(bench, "base_train_b16")}
    assert set(calls) == {"lvc_tpu_torch.ops.roi_align:roi_align_paired",
                          "lvc_tpu_torch.ops.roi_align:roi_align_paired_bwd"}
    assert [k["call"] for k in spec.kernels(bench, "extract_infer_b8")] == [
        "lvc_tpu_torch.ops.roi_align:roi_align_paired"]
    for k in calls.values():
        assert callable(spec.resolve(k["call"])) and spec.resolve(k["counts"]).least_ms


def test_a_traced_run_records_the_declared_kernels():
    """On the CPU (no device events, so no roofline is read), a traced step
    goes through the wrapped launching functions and each gets its least ms;
    the functions are put back after the traced section."""
    import torch

    from benchmark.drivers import train
    from benchmark.tests import narrow
    from lvc_tpu_torch.ops import roi_align

    cell = narrow.cell(spec.cell("base_train_b16"))
    kernels = spec.kernels(spec.benchmark(), "base_train_b16")
    before = roi_align.roi_align_paired, roi_align.roi_align_paired_bwd
    out = train.run(cell, spec.config(cell["config"]), 41, 0.2, True, torch.device("cpu"),
                    dict(narrow.OVERRIDES, **{"SOLVER.AMP.ENABLED": False}), kernels=kernels)
    assert (roi_align.roi_align_paired, roi_align.roi_align_paired_bwd) == before
    assert set(out["kernel_least_ms"]) == {k["call"] for k in kernels}
    assert all(ms > 0 for ms in out["kernel_least_ms"].values())
    ctx = spec.Context("train", out["window"], out["trace"], out["traced_steps"], out["kernel_least_ms"])
    assert spec.reader("k2_roofline_pct.train")(ctx) is None  # no device time on the CPU
