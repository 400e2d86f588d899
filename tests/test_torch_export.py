"""``torch.export`` of the port's eval forward, on the CPU.

The narrow detector (``torch_narrow_detector.port_narrow_model``, seeded
weights) is exported once per pool (``auto``: the exact gather off the
card; ``pallas``: K2's custom op, whose CPU implementation is the plain
version). The exported program's detections equal the eager forward's on the
same batch bit for bit, and so do those of the program saved to a ``.pt2``
and loaded again (``pallas``). Exporting leaves the eager model as it was
(its anchor cache holds no traced tensor). A fused call
(``matmul_affine_residual``), the attention and the band pool (K1) export as
their custom ops and equal their eager calls bit for bit. The NMS fixpoint is
a custom op too: its keep masks equal the greedy loop's it replaced, on sets
with exact IoU ties and with none. ``torch.library.opcheck`` holds each
custom op's fake implementation to its CPU one.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from lvc_tpu_torch.export import export_model, export_stablehlo_text, load_exported, save_exported
from lvc_tpu_torch.ops import attention, fused_matmul, nms
from lvc_tpu_torch.ops import roi_align as ra
from lvc_tpu_torch.structures import boxes as box_ops
from torch_narrow_detector import port_narrow_model


def _batch():
    rng = np.random.RandomState(3)
    image = (rng.rand(2, 128, 192, 3) * 255).astype(np.float32)
    return {"image": torch.from_numpy(image), "image_size": torch.tensor([[128, 192], [112, 160]], dtype=torch.int32)}


def custom_ops(gm) -> Counter:
    """The ``lvc_tpu_torch::*`` nodes of a graph module and its submodules."""
    c = Counter()
    for m in gm.modules():
        if isinstance(m, torch.fx.GraphModule):
            c.update(str(n.target) for n in m.graph.nodes if str(n.target).startswith("lvc_tpu_torch."))
    return c


@pytest.fixture(scope="module")
def programs():
    """impl -> (eager model, its exported program): one export per pool."""
    out = {}
    for impl in ("auto", "pallas"):
        model = port_narrow_model(impl)
        out[impl] = model, export_model(model, _batch())
    return out


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_exported_detector_equals_eager(programs, impl):
    model, ep = programs[impl]
    ops = custom_ops(ep.graph_module)
    assert ops["lvc_tpu_torch.nms_fixpoint.default"] == 2  # the RPN's and the detections'
    assert ops["lvc_tpu_torch.roi_align_paired_fwd.default"] == (impl == "pallas")
    want = model(_batch())._asdict()
    got = ep.module()(_batch())
    assert got.keys() == {k for k, v in want.items() if v is not None}
    assert want["valid"].sum() > 10
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def test_saved_program_loads_and_equals(programs, tmp_path):
    model, ep = programs["pallas"]
    path = str(tmp_path / "detector.pt2")
    save_exported(ep, path)
    got = load_exported(path).module()(_batch())
    want = model(_batch())._asdict()
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


class _Fused(torch.nn.Module):
    def forward(self, x, w, scale, shift, res):
        return fused_matmul.conv1x1_affine_residual(x, w, scale, shift, res, relu=True)


class _Attention(torch.nn.Module):
    def forward(self, qkv):
        return attention.flash_attention(qkv, 0.125)


class _Band(torch.nn.Module):
    def forward(self, p2, p3, boxes):
        return ra.pool_band([p2, p3], boxes, (4, 8), output_size=7)


def _kernel_cases():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 10, 32, generator=g).to(torch.bfloat16)
    w = torch.randn(32, 16, generator=g).to(torch.bfloat16)
    fused = (_Fused(), (x, w, torch.rand(16, generator=g) + 0.5, torch.randn(16, generator=g),
                        torch.randn(2, 6, 10, 16, generator=g).to(torch.bfloat16)))
    attn = (_Attention(), (torch.randn(2, 17, 3, 2, 64, generator=g),))
    boxes = torch.tensor([[[4.0, 6.0, 60.0, 40.0], [10.0, 2.0, 30.0, 50.0], [0.0, 0.0, 120.0, 90.0]]])
    band = (_Band(), (torch.randn(1, 24, 32, 16, generator=g), torch.randn(1, 12, 16, 16, generator=g), boxes))
    return {"matmul_affine_residual": fused, "flash_attention_fwd": attn, "roi_align_band_fwd": band}


@pytest.mark.parametrize("name", ["matmul_affine_residual", "flash_attention_fwd", "roi_align_band_fwd"])
def test_kernel_call_exports_as_its_custom_op(name):
    module, args = _kernel_cases()[name]
    ep = torch.export.export(module, args, strict=False)
    assert custom_ops(ep.graph_module) == Counter({f"lvc_tpu_torch.{name}.default": 1})
    assert torch.equal(ep.module()(*args), module(*args))


def test_custom_ops_pass_opcheck():
    g = torch.Generator().manual_seed(1)
    (_, (x, w, scale, shift, res)), (_, (qkv,)), (_, (p2, p3, boxes)) = _kernel_cases().values()
    shapes = [tuple(p2.shape[1:3]), tuple(p3.shape[1:3])]
    band = ra.band_taps(ra.tiled_prep_band(shapes, 1, boxes, (4, 8)), shapes, 1, 32, True)
    paired = ra.paired_taps(ra.tiled_prep_2d(shapes, 1, boxes, (4, 8)), shapes, 48)
    sup = torch.rand(2, 12, 12, generator=g) > 0.7
    cases = [
        (torch.ops.lvc_tpu_torch.matmul_affine_residual, (x.view(-1, 32), w, scale, shift, res.view(-1, 16), True)),
        (torch.ops.lvc_tpu_torch.flash_attention_fwd, (qkv, 0.125)),
        (torch.ops.lvc_tpu_torch.roi_align_band_fwd, ([p2, p3], *band)),
        (torch.ops.lvc_tpu_torch.roi_align_paired_fwd, ([p2, p3], *paired)),
        (torch.ops.lvc_tpu_torch.nms_fixpoint, (sup.triu(1), torch.rand(2, 12, generator=g) > 0.2)),
    ]
    for op, args in cases:
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))


def _greedy_loop(boxes, scores, valid, thr):
    """The fixpoint as a Python loop on the host, as ``_nms_core`` ran it
    before it became a custom op."""
    order = torch.sort(torch.where(valid, scores, torch.full_like(scores, nms.NEG_INF)), dim=-1, descending=True,
                       stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    v = torch.gather(valid, -1, order)
    n = boxes.shape[-2]
    sup = (box_ops.pairwise_iou(b, b) > thr) & torch.ones((n, n), dtype=torch.bool).triu(1)
    cur = v
    while True:
        nxt = v & ~(sup & cur[..., :, None]).any(dim=-2)
        if torch.equal(nxt, cur):
            break
        cur = nxt
    return torch.zeros_like(valid).scatter(-1, order, cur)


@pytest.mark.parametrize("grid", [False, True])
def test_nms_keep_masks_unchanged(grid):
    g = torch.Generator().manual_seed(4)
    if grid:  # anchor-like boxes on a grid: exact IoU ties and long chains
        xy = torch.stack(torch.meshgrid(torch.arange(12.0), torch.arange(12.0), indexing="ij"), -1).reshape(-1, 2) * 3
        boxes = torch.cat([xy, xy + 8], -1).expand(3, -1, -1).contiguous()
        scores = torch.randint(0, 5, (3, 144), generator=g).float()
    else:
        xy = torch.rand(3, 300, 2, generator=g) * 100
        boxes = torch.cat([xy, xy + 5 + torch.rand(3, 300, 2, generator=g) * 40], -1)
        scores = torch.rand(3, 300, generator=g)
    valid = torch.rand(scores.shape, generator=g) > 0.1
    for thr in (0.3, 0.5, 0.7):
        keep = nms.nms_mask(boxes, scores, valid, thr)
        assert torch.equal(keep, _greedy_loop(boxes, scores, valid, thr))
        assert 0 < keep.sum() <= valid.sum()
    assert nms.nms_mask(boxes, scores, valid, 0.3).sum() < valid.sum()


def test_export_stablehlo_text_is_the_aten_graph():
    text = export_stablehlo_text(_Attention(), _kernel_cases()["flash_attention_fwd"][1][0])
    assert "lvc_tpu_torch.flash_attention_fwd" in text and "ExportedProgram" in text
