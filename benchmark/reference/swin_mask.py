"""The plain reference of Swin Mask R-CNN (``swin_s_mask_rcnn_3x``): the Swin
Transformer bottom-up and the FPN on it, then the RPN and the box path of
``model.py``'s ``Detector`` (by inheritance), and the Mask R-CNN mask head
with its gt crops and loss; AdamW as the Swin detection recipe configures
it. Plain PyTorch in float32 (the caller turns TF32 off); nothing of the
port.

It follows the published description (Liu et al., arXiv:2103.14030, and the
authors' Swin-Transformer-Object-Detection code; detectron2's Mask R-CNN)
with the program's documented departures, which are the configuration's
behaviour and so are kept here too:

- the patch embedding pads as "SAME": ``ceil(H / p)`` patches, the padding
  split ``total // 2`` before and the rest after (the published code pads
  the bottom and right only);
- no drop path (the published recipe's is 0.2), no absolute position
  embedding (as published for detection), the qkv bias on;
- each block pads its tokens to the window after ``norm1``, rolls by
  ``-shift`` and back, adds -100 between tokens of different regions of the
  rolled, padded grid, and an unshifted block attends to the padding
  unmasked (as published);
- the mask head pools every sampled slot and the loss masks the
  non-foreground ones (detectron2 pools the foreground alone: the same
  loss); the gt crop is a half-pixel bilinear gather of the bitmask at the
  centres of a 28x28 grid over the box, thresholded at 0.5 (detectron2
  crops the polygons and rasterises them per box);
- the mask head runs in float32 under AMP (as the program promotes it),
  so the controls leave it in float32 too.

``precision`` is ``model.py``'s: where each convolution, each linear and
each of the attention's two products computes ("fp32", or the controls
"bf16" and "fp8"). LayerNorm, softmax and everything else are float32.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import boxes as bx
from benchmark.reference.model import Detector, _cast
from benchmark.reference.pool import roi_align

SWIN_SIZES = {
    "tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24)),
    "small": (96, (2, 2, 18, 2), (3, 6, 12, 24)),
    "base": (128, (2, 2, 18, 2), (4, 8, 16, 32)),
}
NO_DECAY = ("relative_position_bias_table", "absolute_pos_embed")


def swin_dims(cfg: Dict):
    """(embed dim, depths, heads) of MODEL.SWIN.SWIN_SIZE."""
    return SWIN_SIZES[cfg["MODEL.SWIN.SWIN_SIZE"]]


def decays(name: str) -> bool:
    """Whether AdamW decays the tensor: not a norm's affine (a module named
    ``norm*``), not a position table."""
    parts = name.split(".")
    return not (parts[-1] in NO_DECAY or (len(parts) > 1 and parts[-2].startswith("norm")))


def measured(name: str, t: torch.Tensor) -> torch.Tensor:
    """The part of a tensor's gradient or change that the comparison reads:
    all of it but the key third of a qkv bias. That bias shifts every
    logit of a query's row alike, which the softmax cancels, so its exact
    gradient is 0 and each side's is float noise; AdamW divides by the
    noise's own size, which steps it by up to the learning rate in a
    direction neither side can reproduce."""
    if name.endswith("attn.qkv.bias"):
        c = t.shape[0] // 3
        return torch.cat([t[:c], t[2 * c:]])
    return t


def partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    B, H, W, C = x.shape
    return x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def reverse(w: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    B = w.shape[0] // ((H // ws) * (W // ws))
    return w.reshape(B, H // ws, W // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def position_index(ws: int) -> torch.Tensor:
    """(ws*ws, ws*ws) rows of the (2ws-1)^2-row bias table."""
    ys, xs = np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")
    c = np.stack([ys.reshape(-1), xs.reshape(-1)])
    d = c[:, :, None] - c[:, None, :] + ws - 1
    return torch.from_numpy(d[0] * (2 * ws - 1) + d[1])


def region_mask(Hp: int, Wp: int, ws: int, shift: int) -> torch.Tensor:
    """(nW, ws*ws, ws*ws): -100 between tokens of different regions of the
    rolled, padded grid."""
    label = torch.zeros(Hp, Wp)
    n = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            label[hs, wsl] = n
            n += 1
    w = partition(label[None, :, :, None], ws)[..., 0]
    return torch.where(w[:, None, :] != w[:, :, None], -100.0, 0.0)


class SwinMaskDetector(Detector):
    """``Detector`` with the Swin-FPN as its features and the mask head in
    its ROI losses."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor], precision: str = "fp32", remat: bool = False):
        if precision not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.cfg = cfg
        self.p = params
        self.precision = precision
        self.remat = remat
        self.strides = (4, 8, 16, 32, 64)
        self.num_classes = cfg["MODEL.ROI_HEADS.NUM_CLASSES"]
        self.cosine = False
        self.ws = cfg["MODEL.SWIN.WINDOW_SIZE"]
        self.embed, self.depths, self.heads = swin_dims(cfg)
        self._index = position_index(self.ws)
        self._masks: Dict = {}

    # ------------------------------------------------------------ Swin
    def _lin(self, x, name: str, bias: bool = True):
        xc, wc, bc = _cast(self.precision, x, self.p[name + ".weight"], self.p[name + ".bias"] if bias else None)
        return F.linear(xc, wc, bc).float()

    def _ln(self, x, name: str):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"], self.p[name + ".bias"], 1e-5)

    def _mm(self, a, b):
        a, b = _cast(self.precision, a, b)
        return (a @ b).float()

    def _attention(self, windows, name: str, heads: int, mask: Optional[torch.Tensor]):
        Bn, N, C = windows.shape
        hd = C // heads
        qkv = self._lin(windows, name + ".qkv").reshape(Bn, N, 3, heads, hd).permute(2, 0, 3, 1, 4)
        attn = self._mm(qkv[0], qkv[1].transpose(-2, -1)) * hd ** -0.5
        table = self.p[name + ".relative_position_bias_table"]
        attn = attn + table[self._index.to(table.device).reshape(-1)].reshape(N, N, heads).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(Bn // nw, nw, heads, N, N) + mask[None, :, None]).reshape(Bn, heads, N, N)
        out = self._mm(torch.softmax(attn, dim=-1), qkv[2]).transpose(1, 2).reshape(Bn, N, C)
        return self._lin(out, name + ".proj")

    def _block(self, x, name: str, heads: int, shift: int):
        B, H, W, C = x.shape
        ws = self.ws
        ph, pw = (-H) % ws, (-W) % ws
        Hp, Wp = H + ph, W + pw
        y = F.pad(self._ln(x, name + ".norm1"), (0, 0, 0, pw, 0, ph))
        mask = None
        if shift:
            y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
            key = (Hp, Wp, y.device)
            if key not in self._masks:
                self._masks[key] = region_mask(Hp, Wp, ws, shift).to(y.device)
            mask = self._masks[key]
        y = reverse(self._attention(partition(y, ws), name + ".attn", heads, mask), ws, Hp, Wp)
        if shift:
            y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
        x = x + y[:, :H, :W]
        h = F.gelu(self._lin(self._ln(x, name + ".norm2"), name + ".mlp.fc1"))
        return x + self._lin(h, name + ".mlp.fc2")

    def _merge(self, x, name: str):
        H, W = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self._lin(self._ln(x, name + ".norm"), name + ".reduction", bias=False)

    def bottom_up(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B, 3, H, W) normalised image -> res2..res5 (B, C_i, H/2^(i+2), ...)."""
        bu = "backbone.bottom_up"
        p = self.cfg["MODEL.SWIN.PATCH_SIZE"]
        pads = []
        for n in (x.shape[3], x.shape[2]):
            total = max((-(-n // p) - 1) * p + p - n, 0)
            pads += [total // 2, total - total // 2]
        x = self.conv(F.pad(x, pads), f"{bu}.patch_embed.proj", stride=p)
        x = self._ln(x.permute(0, 2, 3, 1), f"{bu}.patch_embed.norm")
        res = {}
        for i, (depth, heads) in enumerate(zip(self.depths, self.heads)):
            for j in range(depth):
                args = (x, f"{bu}.layers.{i}.blocks.{j}", heads, 0 if j % 2 == 0 else self.ws // 2)
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(self._block, *args, use_reentrant=False)
                else:
                    x = self._block(*args)
            res[f"res{i + 2}"] = self._ln(x, f"{bu}.norm{i}").permute(0, 3, 1, 2)
            if i < len(self.depths) - 1:
                x = self._merge(x, f"{bu}.layers.{i}.downsample")
        return res

    def features(self, images: torch.Tensor, image_sizes: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``images`` (B, H, W, 3) raw pixels -> p2..p6."""
        mean = torch.tensor(self.cfg["MODEL.PIXEL_MEAN"], device=images.device)
        std = torch.tensor(self.cfg["MODEL.PIXEL_STD"], device=images.device)
        x = (images.float() - mean) / std
        H, W = images.shape[1:3]
        rows = torch.arange(H, device=images.device)[None, :, None, None]
        cols = torch.arange(W, device=images.device)[None, None, :, None]
        inside = (rows < image_sizes[:, 0, None, None, None]) & (cols < image_sizes[:, 1, None, None, None])
        res = self.bottom_up(torch.where(inside, x, torch.zeros((), device=images.device)).permute(0, 3, 1, 2))
        out, prev = {}, None
        for sid in (5, 4, 3, 2):
            up = None if prev is None else F.interpolate(prev, scale_factor=2, mode="nearest")
            prev = self.conv(res[f"res{sid}"], f"backbone.fpn_lateral{sid}", residual=up)
            out[f"p{sid}"] = self.conv(prev, f"backbone.fpn_output{sid}", 1, 1)
        out["p6"] = out["p5"][:, :, ::2, ::2]
        return {k: out[k] for k in ("p2", "p3", "p4", "p5", "p6")}

    # ------------------------------------------------------------ masks
    def mask_logits(self, feats, boxes: torch.Tensor) -> torch.Tensor:
        """(B, S, 4) boxes -> (B * S, K, 2P, 2P) float32 mask logits: the
        pool at ROI_MASK_HEAD.POOLER_RESOLUTION, NUM_CONV 3x3 convs with
        ReLU, a 2x2 stride-2 transposed conv with ReLU, a 1x1 predictor, all
        in float32."""
        P = self.cfg["MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION"]
        pooled = roi_align([feats[f] for f in ("p2", "p3", "p4", "p5")], boxes, self.strides[:4], P)
        x = pooled.reshape(-1, P, P, pooled.shape[-1]).permute(0, 3, 1, 2).float()
        h = "roi_heads.mask_head"
        for i in range(self.cfg["MODEL.ROI_MASK_HEAD.NUM_CONV"]):
            x = F.relu(F.conv2d(x, self.p[f"{h}.mask_fcn{i + 1}.weight"], self.p[f"{h}.mask_fcn{i + 1}.bias"],
                                padding=1))
        x = F.relu(F.conv_transpose2d(x, self.p[f"{h}.deconv.weight"], self.p[f"{h}.deconv.bias"], stride=2))
        return F.conv2d(x, self.p[f"{h}.predictor.weight"], self.p[f"{h}.predictor.bias"])

    @staticmethod
    def crop(gt_masks: torch.Tensor, boxes: torch.Tensor, gt_idx: torch.Tensor, M: int) -> torch.Tensor:
        """(G, Hm, Wm) bitmasks, (S, 4) boxes in their coordinates, each
        box's gt row -> (S, M, M): the bitmask sampled bilinearly at the
        centres of an M x M grid over the box, the points clamped into it."""
        h, w = gt_masks.shape[1:]
        t = (torch.arange(M, dtype=torch.float32, device=boxes.device) + 0.5) / M
        x = (boxes[:, 0:1] + t * (boxes[:, 2:3] - boxes[:, 0:1]) - 0.5).clamp(0.0, w - 1.0)
        y = (boxes[:, 1:2] + t * (boxes[:, 3:4] - boxes[:, 1:2]) - 0.5).clamp(0.0, h - 1.0)
        x0, y0 = x.floor().long(), y.floor().long()
        x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
        fx, fy = (x - x0)[:, None, :], (y - y0)[:, :, None]
        g = gt_idx.long()[:, None, None]

        def at(yy, xx):
            return gt_masks[g, yy[:, :, None], xx[:, None, :]].float()

        top = at(y0, x0) * (1 - fx) + at(y0, x1) * fx
        bottom = at(y1, x0) * (1 - fx) + at(y1, x1) * fx
        return top * (1 - fy) + bottom * fy

    def roi_losses(self, feats, proposals, prop_valid, gt, gens, sample_from=None):
        """``Detector.roi_losses`` plus ``loss_mask`` when ``gt`` holds
        ``masks`` (B, G, Hm, Wm): the BCE of each foreground slot's gt-class
        logits against its crop (of the boxes the sampling read) over 0.5,
        each slot's mean, over the foreground count. Keeps the foreground
        slots' logits in ``self.fg_mask_logits`` and their rows among the
        (B * S) slots in ``self.fg_rows``."""
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
                         torch.where(slot_valid, cls[b][idxs], -1), slot_valid, labelled[b][idxs],
                         matched[b][idxs]))
        s_boxes, s_gt, s_cls, s_valid, s_labelled, s_match = (torch.stack(t) for t in zip(*rows))
        B, S = s_cls.shape
        x = self.box_features(feats, s_boxes)
        scores, deltas = self.predictor(x)
        masks = self.mask_logits(feats, s_boxes) if "masks" in gt else None
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
        out = {"loss_cls": loss_cls, "loss_box_reg": loss_box_reg}
        if masks is None:
            return out
        G, Hm = gt["masks"].shape[1:3]
        M = masks.shape[-1]
        scale = Hm / (feats["p2"].shape[2] * self.strides[0])
        image = torch.arange(B, device=s_match.device)[:, None] * G
        crops = self.crop(gt["masks"].reshape(B * G, *gt["masks"].shape[2:]),
                          s_labelled.reshape(B * S, 4).float() * scale, (s_match + image).reshape(-1), M)
        logits = masks[torch.arange(B * S, device=masks.device), s_cls.clamp(0, masks.shape[1] - 1).long()]
        tgt = (crops > 0.5).float()
        bce = (logits.clamp(min=0) - logits * tgt + torch.log1p(torch.exp(-logits.abs()))).mean(dim=(1, 2))
        out["loss_mask"] = torch.where(fg, bce, zero).sum() / fg.sum().clamp(min=1).float()
        self.fg_rows = fg.nonzero().squeeze(1)
        self.fg_mask_logits = masks.detach()[self.fg_rows]
        return out


def step_losses(det: SwinMaskDetector, batch: Dict, step_seed: int, follow: Optional[Dict]):
    """``train.step_losses`` with the batch's ``gt_masks`` in the gt."""
    images, sizes = batch["image"], batch["image_size"]
    gt = {"boxes": batch["gt_boxes"].float(), "classes": batch["gt_classes"], "valid": batch["gt_valid"].bool(),
          "masks": batch["gt_masks"]}
    gens = bx.image_generators(step_seed, images.shape[0], images.device)
    feats = det.features(images, sizes)
    anchors, logits, deltas = det.rpn_outputs(feats)
    losses = det.rpn_losses(anchors, logits, deltas, gt, gens)
    if follow is None:
        with torch.no_grad():
            own, _, sel = det.select(anchors, [lo.detach() for lo in logits], [d.detach() for d in deltas],
                                     sizes, train=True)
        follow = {"selection": sel, "proposals": own}
    proposals, valid = det.follow(follow["selection"], anchors, deltas, sizes)
    losses.update(det.roi_losses(feats, proposals, valid, gt, gens, follow["proposals"]))
    return losses, follow, [lo.detach() for lo in logits]


def steps(cfg: Dict, params0: Dict[str, torch.Tensor], batches, step_seeds, precision: str = "fp32",
          follow: Optional[List[Dict]] = None) -> Dict:
    """len(batches) AdamW steps from ``params0`` (not modified), every
    tensor trained: decoupled decay ``p *= 1 - lr * WEIGHT_DECAY`` (0 where
    ``decays`` says so), then ``p -= lr / (1 - b1^t) * m / (sqrt(v) /
    sqrt(1 - b2^t) + 1e-8)`` (torch's and mmdetection's AdamW). Returns the
    losses, the selections, the objectness, the first step's gradients and
    their norms, the parameters' changes' norms (each of its ``measured`` part),
    each step's foreground mask logits and rows, and the last parameters."""
    from benchmark.reference.train import learning_rate

    b1, b2 = cfg["SOLVER.BETAS"]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    det = SwinMaskDetector(cfg, params, precision, remat=True)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    out: Dict = {"losses": [], "selections": [], "rpn_logits": [], "mask_logits": [], "fg_rows": []}
    for i, (batch, seed) in enumerate(zip(batches, step_seeds)):
        losses, sel, logits = step_losses(det, batch, seed, None if follow is None else follow[i])
        for p in params.values():
            p.grad = None
        sum(losses.values()).backward()
        lr = learning_rate(cfg, i)
        t = i + 1
        with torch.no_grad():
            for k, p in params.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                if decays(k):
                    p.mul_(1 - lr * cfg["SOLVER.WEIGHT_DECAY"])
                denom = v2[k].sqrt() / (1 - b2 ** t) ** 0.5 + 1e-8
                p -= lr / (1 - b1 ** t) * m[k] / denom
                if i == 0:
                    out.setdefault("grads", {})[k] = g.clone()
                    out.setdefault("grad_norms", {})[k] = float(torch.linalg.vector_norm(measured(k, g).double()))
        out["losses"].append({k: float(v.detach()) for k, v in losses.items()})
        out["selections"].append(sel)
        out["rpn_logits"].append(logits)
        out["mask_logits"].append(det.fg_mask_logits)
        out["fg_rows"].append(det.fg_rows)
    with torch.no_grad():
        out["update_norms"] = {k: float(torch.linalg.vector_norm(measured(k, params[k] - params0[k]).double()))
                               for k in params}
    out["params"] = {k: p.detach() for k, p in params.items()}
    return out
