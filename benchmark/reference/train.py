"""The reference's training steps: the detector's losses, autograd, and SGD
with momentum as detectron2 configures it (weight decay added to the
gradient, WEIGHT_DECAY for weights and WEIGHT_DECAY_BIAS for biases,
momentum with dampening 0, the warmup multi-step learning rate), with
FREEZE_AT's stem and res2 frozen. ``steps`` returns what the comparison
reads: each step's losses, each trainable tensor's gradient as the
optimizer takes it in the first step (gradient plus weight decay, which is
the momentum buffer after one step), and each tensor's change after the
last step."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from benchmark.reference import boxes as bx
from benchmark.reference.model import Detector


def trainable(cfg: Dict, name: str) -> bool:
    if not name.endswith(("weight", "bias")) or ".norm." in name:
        return False
    freeze_at = cfg["MODEL.BACKBONE.FREEZE_AT"]
    if freeze_at >= 1 and "backbone.bottom_up.stem." in name:
        return False
    return not any(freeze_at >= s and f"backbone.bottom_up.res{s}." in name for s in range(2, 6))


def learning_rate(cfg: Dict, count: int) -> float:
    base = cfg["SOLVER.BASE_LR"]
    warm = cfg["SOLVER.WARMUP_ITERS"]
    factor = 1.0
    if count < warm:
        alpha = count / warm
        factor = cfg["SOLVER.WARMUP_FACTOR"] * (1.0 - alpha) + alpha
    return base * factor * cfg["SOLVER.GAMMA"] ** sum(count >= m for m in cfg["SOLVER.STEPS"])


def step_losses(det: Detector, batch: Dict, step_seed: int, follow: Optional[Dict]):
    """One step's loss dict, the discrete choices it made or followed
    (``{"selection": the RPN's Selection, "proposals": the proposals the ROI
    heads' matching and sampling read}``), and its objectness. ``follow``
    gives another run's choices: its proposal selection, and its proposals
    for the ROI heads' labels and slots."""
    images = batch["image"]
    sizes = batch["image_size"]
    gt = {"boxes": batch["gt_boxes"].float(), "classes": batch["gt_classes"], "valid": batch["gt_valid"].bool()}
    if "gt_ignores" in batch and bool(batch["gt_ignores"].any()):
        raise ValueError("the reference takes no gt ignore regions")
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


def steps(cfg: Dict, params0: Dict[str, torch.Tensor], batches: Sequence[Dict], step_seeds: Sequence[int],
          precision: str = "fp32", follow: Optional[Sequence[Dict]] = None) -> Dict:
    """Runs len(batches) SGD steps from ``params0`` (not modified)."""
    params = {k: (v.detach().clone().requires_grad_(True) if trainable(cfg, k) else v.detach())
              for k, v in params0.items()}
    names = [k for k in params if trainable(cfg, k)]
    det = Detector(cfg, params, precision, remat=True)
    buf: Dict[str, torch.Tensor] = {}
    out: Dict = {"losses": [], "selections": [], "rpn_logits": []}
    for i, (batch, seed) in enumerate(zip(batches, step_seeds)):
        losses, sel, logits = step_losses(det, batch, seed, None if follow is None else follow[i])
        total = sum(losses.values())
        for k in names:
            params[k].grad = None
        total.backward()
        lr = learning_rate(cfg, i)
        with torch.no_grad():
            for k in names:
                p = params[k]
                wd = cfg["SOLVER.WEIGHT_DECAY_BIAS"] if k.endswith("bias") else cfg["SOLVER.WEIGHT_DECAY"]
                g = (p.grad if p.grad is not None else torch.zeros_like(p)) + wd * p
                buf[k] = g.clone() if i == 0 else cfg["SOLVER.MOMENTUM"] * buf[k] + g
                p -= lr * buf[k]
        if i == 0:
            out["grad_norms"] = {k: float(torch.linalg.vector_norm(buf[k].double())) for k in names}
        out["losses"].append({k: float(v.detach()) for k, v in losses.items()})
        out["selections"].append(sel)
        out["rpn_logits"].append(logits)
    with torch.no_grad():
        out["update_norms"] = {k: float(torch.linalg.vector_norm((params[k] - params0[k]).double())) for k in names}
    return out
