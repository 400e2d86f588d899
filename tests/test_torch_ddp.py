"""The port's data-parallel train step on the CPU: 2 gloo ranks
(``engine/launch.py`` with ``devices=["cpu", "cpu"]``) against one process,
through ``chip_smoke``'s phase-23 helpers with the CPU's plain pool
(POOLER_IMPL exact).

- A narrow R-50-FPN (float32; sampling not exhaustive: the RPN samples 256
  of 6,138 anchors, the ROI heads 64 of up to 104 boxes) and the narrow
  cascade UBBR model (RBG, 3 stages, 64 of 128 jittered boxes): one
  ``make_data_parallel_train_step`` step of 2 ranks on a global batch of 4
  equals ``make_train_step`` on the whole batch in one process. Losses rel
  2e-4 / abs 1e-5 (JAX's own data-parallel test), every trainable gradient
  rel L2 1e-5, the parameters after the step within 1e-5 of the update's
  norm plus one float32 rounding, and both ranks' parameters equal
  (``chip_smoke.dp_compare``). The same for the detector as
  ``GeneralizedRCNN_Context`` (``cont_conv``'s output is discarded, so it
  gets no gradient) and with ``MODEL.IMAGES_ONLY`` (only the backbone up to
  p5 and ``cont_cls`` get one): DDP must all-reduce the gradients that
  exist and leave the others to the optimizer's zeros, as in one process.
  And for the detector with ``MASK_ON`` (a narrow mask head, gt bitmasks
  at 1/4 of the canvas): ``loss_mask``'s normaliser is global, so 2 ranks
  give one process's ``loss_mask`` and mask-head gradients.
- Every image samples the same slots on whichever rank holds it.
- A toy loss through ``global_ratio`` on 2 ranks has its analytic gradient
  (not 2x too small or too large), within 1e-12 in float64.

The ranks run once for the module (one launch, ~30 s).
"""
import pytest
import torch

import chip_smoke
from lvc_tpu_torch.engine.launch import launch
from lvc_tpu_torch.modeling import sampling

KINDS = ("detector", "cascade", "context", "context_images_only", "mask")
SLOTS = {"detector": 8, "cascade": 4, "context": 8, "context_images_only": 0, "mask": 8}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks"))
    jobs, refs = [], {}
    for kind in KINDS:
        cfg = chip_smoke.dp_cfg(kind, "cpu", impl="exact")
        weights, batch = chip_smoke.dp_inputs(kind, cfg)
        jobs.append((kind, cfg, weights, batch, chip_smoke.DP_SEED))
        refs[kind] = (chip_smoke.dp_step(cfg, weights, batch, chip_smoke.DP_SEED, data_parallel=False), weights)
    launch(chip_smoke.dp_rank_main, 2, args=(out, jobs), devices=["cpu", "cpu"])
    return out, refs


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_equal_one_process(runs, kind):
    out, refs = runs
    ref, weights = refs[kind]
    ranks = chip_smoke.dp_load(out, kind, 2)
    assert [r["batch"] for r in ranks] == [2, 2]
    err = chip_smoke.dp_compare(ref, ranks, weights)
    # one RPN and one ROI call an image; the cascade's stage 0 alone samples; images_only runs neither
    assert err["slots"] == SLOTS[kind]
    assert ref["metrics"]["total_loss"] > 0
    if kind == "mask":
        assert ref["metrics"]["loss_mask"] > 0 and ref["launches"] == (0, 0)  # the CPU's plain pools
        assert any(".mask_head." in n and g.abs().sum() > 0 for n, g in ref["grads"].items())


def test_global_ratio_toy_gradient(runs):
    chip_smoke.dp_toy_check(runs[0], 2)


def test_image_samples_same_slots_on_either_rank(runs):
    """Image 2 sits on rank 1 (local 0) in the split batch and at local 2 of
    rank 0 in one process; it samples the same anchors and boxes."""
    out, refs = runs
    for kind in ("detector", "cascade"):
        ref = refs[kind][0]["slots"]
        r1 = chip_smoke.dp_load(out, kind, 2)[1]["slots"]
        sites = [site for site in ref if ref[site]]  # the cascade has no RPN: RBG's boxes go to the ROI heads
        assert sites == (["rpn", "roi"] if kind == "detector" else ["roi"])
        for site in sites:
            assert torch.equal(r1[site][0], ref[site][2]), (kind, site)
        # and not the slots of the image at its local position in one process
        assert not torch.equal(r1[sites[0]][0], ref[sites[0]][0])


def test_per_image_generators_follow_the_global_position(monkeypatch):
    one = [torch.rand(5, generator=g) for g in sampling.per_image_generators(7, 4, "cpu")]
    monkeypatch.setattr(sampling, "data_rank", lambda: 1)
    split = [torch.rand(5, generator=g) for g in sampling.per_image_generators(7, 2, "cpu")]
    assert torch.equal(split[0], one[2]) and torch.equal(split[1], one[3])
    assert not torch.equal(one[0], one[1])
