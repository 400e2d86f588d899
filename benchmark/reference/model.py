"""The plain reference detector: Faster R-CNN with a ResNet-FPN backbone, an
RPN and the FPN box head (detectron2's ``Base-RCNN-FPN``), as functions of
a dict of tensors under detectron2's parameter names.

It follows detectron2's published description with the port's documented
departures, which are the configuration's behaviour and so are kept here
too: fixed-shape proposal selection (per level the top PRE_NMS_TOPK
anchors, NMS per level, then the top POST_NMS_TOPK of the image; the
anchor sampling of a fixed number of slots from uniform priorities; the
gradient of the box-regression loss flows into the proposals, as in the
JAX package); the paired RoIAlign's level bump and window clamp
(``pool.py``); the box-head NMS over at most ``pre_nms_candidates``
(box, class) pairs; FrozenBN as an affine folded in float32.

Precision: ``precision`` is where each convolution and each linear of the
box head computes: "fp32" (float32 with TF32 off, set by the caller),
"bf16" (inputs and weights rounded to bfloat16, bfloat16 products with
float32 accumulation) or "fp8" (inputs and weights rounded to float8 e4m3
with one scale per tensor, products in float32; the backward passes the
gradient straight through the rounding). The last two are the controls.
Everything else is float32. Nothing here imports the port.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import boxes as bx
from benchmark.reference.pool import roi_align

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}
FP8_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


def _cast(precision: str, *ts):
    if precision == "bf16":
        return [None if t is None else t.to(torch.bfloat16) for t in ts]
    if precision == "fp8":
        return [None if t is None else _fp8(t) for t in ts]
    return list(ts)


class Selection(NamedTuple):
    """The RPN's discrete choices: each level's top-k anchor indices (B, k),
    and the image's kept slots in the (B, L*K) list of level candidates with
    their validity (B, post)."""
    level_order: List[torch.Tensor]
    order: torch.Tensor
    valid: torch.Tensor


class Detections(NamedTuple):
    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    valid: torch.Tensor
    proposal_idx: torch.Tensor


class Detector:
    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor], precision: str = "fp32", remat: bool = False):
        if precision not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.cfg = cfg
        self.p = params
        self.precision = precision
        self.remat = remat
        self.depth = cfg["MODEL.RESNETS.DEPTH"]
        self.strides = (4, 8, 16, 32, 64)
        self.num_classes = cfg["MODEL.ROI_HEADS.NUM_CLASSES"]
        self.cosine = cfg["MODEL.ROI_HEADS.OUTPUT_LAYER"] == "CosineSimOutputLayers"

    # ------------------------------------------------------------ layers
    def conv(self, x, name: str, stride=1, padding=0, bias=True, norm=False, relu=False, residual=None):
        w = self.p[name + ".weight"]
        b = self.p.get(name + ".bias") if bias else None
        xc, wc, bc = _cast(self.precision, x, w, b)
        y = F.conv2d(xc, wc, bc, stride, padding).float()
        if norm:
            scale = self.p[name + ".norm.weight"] * torch.rsqrt(self.p[name + ".norm.running_var"] + 1e-5)
            shift = self.p[name + ".norm.bias"] - self.p[name + ".norm.running_mean"] * scale
            y = y * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)
        if residual is not None:
            y = y + residual
        return F.relu(y) if relu else y

    def linear(self, x, name: str, bias=True, precision: Optional[str] = None):
        xc, wc, bc = _cast(precision or self.precision, x, self.p[name + ".weight"],
                           self.p[name + ".bias"] if bias else None)
        return F.linear(xc, wc, bc).float()

    # ---------------------------------------------------------- backbone
    def _block(self, x, name: str, stride: int, shortcut: bool):
        sc = self.conv(x, name + ".shortcut", stride, bias=False, norm=True) if shortcut else x
        y = self.conv(x, name + ".conv1", stride, bias=False, norm=True, relu=True)
        y = self.conv(y, name + ".conv2", 1, 1, bias=False, norm=True, relu=True)
        return self.conv(y, name + ".conv3", bias=False, norm=True, relu=True, residual=sc)

    def features(self, images: torch.Tensor, image_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``images`` (B, H, W, 3) raw pixels -> p2..p6."""
        mean = torch.tensor(self.cfg["MODEL.PIXEL_MEAN"], device=images.device)
        std = torch.tensor(self.cfg["MODEL.PIXEL_STD"], device=images.device)
        x = (images.float() - mean) / std
        H, W = images.shape[1:3]
        rows = torch.arange(H, device=images.device)[None, :, None, None]
        cols = torch.arange(W, device=images.device)[None, None, :, None]
        inside = (rows < image_sizes[:, 0, None, None, None]) & (cols < image_sizes[:, 1, None, None, None])
        x = torch.where(inside, x, torch.zeros((), device=images.device)).permute(0, 3, 1, 2)
        x = self.conv(x, "backbone.bottom_up.stem.conv1", 2, 3, bias=False, norm=True, relu=True)
        x = F.max_pool2d(x, 3, 2, 1)
        res = {}
        for i, n in enumerate(STAGE_BLOCKS[self.depth]):
            stage = f"res{i + 2}"
            for b in range(n):
                name = f"backbone.bottom_up.{stage}.{b}"
                stride = 2 if (b == 0 and i > 0) else 1
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(self._block, x, name, stride, b == 0, use_reentrant=False)
                else:
                    x = self._block(x, name, stride, b == 0)
            res[stage] = x
        out, prev = {}, None
        for sid in (5, 4, 3, 2):
            lat = f"backbone.fpn_lateral{sid}"
            up = None if prev is None else F.interpolate(prev, scale_factor=2, mode="nearest")
            prev = self.conv(res[f"res{sid}"], lat, residual=up)
            out[f"p{sid}"] = self.conv(prev, f"backbone.fpn_output{sid}", 1, 1)
        out["p6"] = out["p5"][:, :, ::2, ::2]
        return {k: out[k] for k in ("p2", "p3", "p4", "p5", "p6")}

    # --------------------------------------------------------------- RPN
    def rpn_outputs(self, feats: Dict[str, torch.Tensor]):
        """(anchors per level (HWA, 4), objectness per level (B, HWA) float32,
        deltas per level (B, HWA, 4) float32)."""
        B = feats["p2"].shape[0]
        logits, deltas = [], []
        for f in ("p2", "p3", "p4", "p5", "p6"):
            t = self.conv(feats[f], "proposal_generator.rpn_head.conv", 1, 1, relu=True)
            lo = self.conv(t, "proposal_generator.rpn_head.objectness_logits")
            de = self.conv(t, "proposal_generator.rpn_head.anchor_deltas")
            logits.append(lo.permute(0, 2, 3, 1).reshape(B, -1).float())
            deltas.append(de.permute(0, 2, 3, 1).reshape(B, -1, 4).float())
        c = self.cfg
        anchors = bx.grid_anchors(c["MODEL.ANCHOR_GENERATOR.SIZES"], c["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"],
                                  self.strides, [feats[f].shape[2:4] for f in ("p2", "p3", "p4", "p5", "p6")],
                                  feats["p2"].device)
        return anchors, logits, deltas

    def _level_boxes(self, anchors, deltas, order, sizes):
        B, k = order.shape
        d_k = torch.gather(deltas, 1, order[..., None].expand(B, k, 4)).float()
        boxes = bx.apply_deltas(self.cfg["MODEL.RPN.BBOX_REG_WEIGHTS"], d_k, anchors[order])
        return bx.clip(boxes, sizes[:, 0:1], sizes[:, 1:2])

    def select(self, anchors, logits, deltas, image_sizes, train: bool):
        """The port's proposal selection on these objectness logits and
        deltas: (proposals (B, post, 4), their validity, the Selection)."""
        c = self.cfg
        pre = c["MODEL.RPN.PRE_NMS_TOPK_TRAIN" if train else "MODEL.RPN.PRE_NMS_TOPK_TEST"]
        post = c["MODEL.RPN.POST_NMS_TOPK_TRAIN" if train else "MODEL.RPN.POST_NMS_TOPK_TEST"]
        B = logits[0].shape[0]
        k_max = min(pre, max(lo.shape[1] for lo in logits))
        sizes = image_sizes.to(torch.float32)
        lvl_boxes, lvl_scores, lvl_valid, lvl_order = [], [], [], []
        for a, lo, de in zip(anchors, logits, deltas):
            k = min(pre, lo.shape[1])
            order = torch.sort(lo, dim=1, descending=True, stable=True).indices[:, :k]
            scores = torch.gather(lo, 1, order)
            boxes = self._level_boxes(a, de, order, sizes)
            valid = bx.nonempty(boxes, float(c["MODEL.PROPOSAL_GENERATOR.MIN_SIZE"])) & torch.isfinite(scores)
            pad = k_max - k
            if pad > 0:
                boxes = F.pad(boxes, (0, 0, 0, pad))
                scores = F.pad(scores, (0, pad), value=bx.NEG_INF)
                valid = F.pad(valid, (0, pad))
            lvl_boxes.append(boxes)
            lvl_scores.append(scores)
            lvl_valid.append(valid)
            lvl_order.append(order)
        boxes = torch.stack(lvl_boxes, 1)
        scores = torch.stack(lvl_scores, 1)
        valid = torch.stack(lvl_valid, 1)
        keep = bx.nms_mask(boxes, scores, valid, c["MODEL.RPN.NMS_THRESH"]) & valid
        order, top_valid = bx.masked_topk(scores.reshape(B, -1), keep.reshape(B, -1), post)
        out = torch.gather(boxes.reshape(B, -1, 4), 1, order[..., None].expand(order.shape + (4,)))
        return out, top_valid, Selection(lvl_order, order, top_valid)

    def follow(self, sel: Selection, anchors, deltas, image_sizes):
        """Proposals at the slots ``sel`` chose, decoded from these deltas
        (differentiable in them): the reference's continuous values along
        another run's discrete choices."""
        sizes = image_sizes.to(torch.float32)
        k_max = max(o.shape[1] for o in sel.level_order)
        lv = []
        for a, de, order in zip(anchors, deltas, sel.level_order):
            b = self._level_boxes(a, de, order, sizes)
            lv.append(F.pad(b, (0, 0, 0, k_max - b.shape[1])))
        boxes = torch.stack(lv, 1).reshape(sizes.shape[0], -1, 4)
        return torch.gather(boxes, 1, sel.order[..., None].expand(sel.order.shape + (4,))), sel.valid

    def rpn_losses(self, anchors, logits, deltas, gt, gens):
        c = self.cfg
        a = torch.cat(anchors)
        lo = torch.cat(logits, 1)
        de = torch.cat(deltas, 1)
        B = lo.shape[0]
        S = c["MODEL.RPN.BATCH_SIZE_PER_IMAGE"]
        rows = []
        for b in range(B):
            iou = bx.pairwise_iou(gt["boxes"][b], a)
            matched, labels = bx.match(iou, gt["valid"][b], c["MODEL.RPN.IOU_THRESHOLDS"],
                                       c["MODEL.RPN.IOU_LABELS"], low_quality=True)
            idxs, is_pos, slot_valid = bx.subsample(labels, S, c["MODEL.RPN.POSITIVE_FRACTION"], gens[b])
            rows.append((idxs, is_pos, slot_valid, a[idxs], gt["boxes"][b][matched[idxs]]))
        idxs, is_pos, slot_valid, s_anchors, s_gt = (torch.stack(t) for t in zip(*rows))
        s_logits = torch.gather(lo, 1, idxs)
        s_deltas = torch.gather(de, 1, idxs[..., None].expand(-1, -1, 4))
        target = bx.get_deltas(c["MODEL.RPN.BBOX_REG_WEIGHTS"], s_anchors, s_gt)
        loc = (s_deltas - target).abs().sum(-1)
        zero = torch.zeros((), device=loc.device)
        lab = is_pos.float()
        bce = s_logits.clamp(min=0) - s_logits * lab + torch.log1p(torch.exp(-s_logits.abs()))
        norm = float(S * B)
        return {"loss_rpn_cls": torch.where(slot_valid, bce, zero).sum() / norm,
                "loss_rpn_loc": torch.where(is_pos, loc, zero).sum() / norm}

    # --------------------------------------------------------- ROI heads
    def box_features(self, feats, boxes):
        P = self.cfg["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION"]
        pooled = roi_align([feats[f] for f in ("p2", "p3", "p4", "p5")], boxes, self.strides[:4], P)
        x = pooled.permute(0, 1, 4, 2, 3).reshape(-1, pooled.shape[-1] * P * P)
        x = F.relu(self.linear(x, "roi_heads.box_head.fc1"))
        return F.relu(self.linear(x, "roi_heads.box_head.fc2"))

    def predictor(self, x):
        """(class logits (N, K+1), deltas (N, K*4)), float32."""
        if self.cosine:
            xn = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-5)
            w = self.p["roi_heads.box_predictor.cls_score.weight"]
            wn = w / (torch.linalg.vector_norm(w, dim=1, keepdim=True) + 1e-5)
            scores = self.cfg["MODEL.ROI_HEADS.COSINE_SCALE"] * (xn @ wn.t())
            return scores, self.linear(x, "roi_heads.box_predictor.bbox_pred", precision="fp32")
        return (self.linear(x, "roi_heads.box_predictor.cls_score"),
                self.linear(x, "roi_heads.box_predictor.bbox_pred"))

    def roi_losses(self, feats, proposals, prop_valid, gt, gens, sample_from=None):
        """The Fast R-CNN losses on ``proposals``; the matching and the
        sampling read ``sample_from`` (another run's proposals: the same
        labels and slots as that run) where it is given."""
        c = self.cfg
        K = self.num_classes
        proposals = torch.cat([proposals, gt["boxes"]], 1)
        prop_valid = torch.cat([prop_valid, gt["valid"]], 1)
        labelled = proposals.detach() if sample_from is None else torch.cat([sample_from, gt["boxes"]], 1)
        iou = bx.pairwise_iou(gt["boxes"], labelled)
        matched, labels = bx.match(iou, gt["valid"], c["MODEL.ROI_HEADS.IOU_THRESHOLDS"],
                                   c["MODEL.ROI_HEADS.IOU_LABELS"], low_quality=False)
        labels = torch.where(prop_valid, labels, torch.full_like(labels, -1))
        cls = torch.where(labels == 1, torch.gather(gt["classes"].long(), 1, matched),
                          torch.where(labels == 0, K, -1))
        rows = []
        for b in range(proposals.shape[0]):
            idxs, _, slot_valid = bx.subsample(labels[b], c["MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE"],
                                               c["MODEL.ROI_HEADS.POSITIVE_FRACTION"], gens[b])
            rows.append((proposals[b][idxs], gt["boxes"][b][matched[b][idxs]],
                         torch.where(slot_valid, cls[b][idxs], -1), slot_valid))
        s_boxes, s_gt, s_cls, s_valid = (torch.stack(t) for t in zip(*rows))
        scores, deltas = self.predictor(self.box_features(feats, s_boxes))
        s_boxes, s_gt, s_cls, s_valid = (t.reshape((-1,) + t.shape[2:]) for t in (s_boxes, s_gt, s_cls, s_valid))
        zero = torch.zeros((), device=scores.device)
        ce_valid = s_valid & (s_cls >= 0)
        logp = F.log_softmax(scores, dim=-1)
        ce = -torch.gather(logp, 1, s_cls.clamp(0, K).long()[:, None])[:, 0]
        loss_cls = torch.where(ce_valid, ce, zero).sum() / ce_valid.sum().clamp(min=1).float()
        fg = ce_valid & (s_cls < K)
        d = deltas.reshape(-1, K, 4)
        pred = torch.gather(d, 1, s_cls.clamp(0, K - 1).long()[:, None, None].expand(-1, 1, 4))[:, 0]
        target = bx.get_deltas(c["MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS"], s_boxes, s_gt)
        reg = (pred - target).abs().sum(-1)
        loss_box_reg = torch.where(fg, reg, zero).sum() / s_valid.sum().clamp(min=1).float()
        return {"loss_cls": loss_cls, "loss_box_reg": loss_box_reg}

    def predict(self, feats, proposals):
        """Softmax probabilities (B, R, K+1) and decoded per-class boxes (B, R, K*4)."""
        B, R = proposals.shape[:2]
        scores, deltas = self.predictor(self.box_features(feats, proposals))
        return self.decode(scores, deltas, proposals)

    def decode(self, scores, deltas, proposals):
        B, R = proposals.shape[:2]
        probs = torch.softmax(scores, dim=-1).reshape(B, R, -1)
        return probs, bx.apply_deltas(self.cfg["MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS"], deltas.reshape(B, R, -1), proposals)

    def detections(self, boxes, probs, image_sizes, prop_valid, pre_nms_candidates: int = 2048) -> Detections:
        """The port's fixed-shape post-processing: score filter, per-class
        NMS over at most ``pre_nms_candidates`` pairs, top-k."""
        c = self.cfg
        B, r, k1 = probs.shape
        k = k1 - 1
        fg = probs[..., :-1]
        sizes = image_sizes.to(boxes.dtype)
        boxes = bx.clip(boxes.reshape(B, r, k, 4), sizes[:, 0, None, None], sizes[:, 1, None, None])
        cand_valid = (fg > c["MODEL.ROI_HEADS.SCORE_THRESH_TEST"]) & prop_valid[..., None]
        flat = fg.reshape(B, -1)
        cand_idx, cand_ok = bx.masked_topk(flat, cand_valid.reshape(B, -1), min(pre_nms_candidates, r * k))
        prop_idx = torch.div(cand_idx, k, rounding_mode="floor")
        cls_idx = cand_idx % k
        sel = (prop_idx * k + cls_idx)[..., None].expand(-1, -1, 4)
        cand_boxes = torch.gather(boxes.reshape(B, r * k, 4), 1, sel)
        cand_scores = torch.gather(flat, 1, cand_idx)
        keep = bx.batched_nms_mask(cand_boxes, cand_scores, cls_idx, cand_ok, c["MODEL.ROI_HEADS.NMS_THRESH_TEST"])
        order, det_valid = bx.masked_topk(cand_scores, keep, c["TEST.DETECTIONS_PER_IMAGE"])
        return Detections(torch.gather(cand_boxes, 1, order[..., None].expand(-1, -1, 4)),
                          torch.gather(cand_scores, 1, order), torch.gather(cls_idx, 1, order), det_valid,
                          torch.gather(prop_idx, 1, order))
