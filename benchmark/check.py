"""The comparison that decides ``correct``: what the timed path produced,
judged by the plain reference (``benchmark/reference``) after the window.

The reference computes every continuous value itself, in float32 with TF32
off, from the same seeded weights and inputs. Where the program makes a
discrete choice from a float (the RPN's top-k and NMS, the detections' NMS
and top-k), the reference first replays that choice on the program's own
floats, which must give the program's result exactly, and then follows the
program's choice with its own floats, so that the continuous gaps below
measure precision and not a different choice of boxes.

Numbers (each beside its limit from the cell file):

- ``proposal_mismatch``: proposal slots whose validity or box differs when
  the reference's selection runs on the program's objectness and deltas;
- ``rpn_logit_gap`` (training): ||program objectness - reference|| /
  ||reference||; ``rpn_logit_peak_gap`` (inference): the largest gap of an
  objectness logit over the reference's largest logit (in float32 with TF32
  convolutions the norm of the gap reads a third to a half of a bfloat16
  control's, where this reads a fifth of it);
- training: ``loss_gap``, the largest relative gap of a step's loss over the
  first steps; ``grad_gap`` and ``update_gap``, over the trainable tensors
  whose reference gradient is at least 1e-3 of the median tensor's, the
  largest gap of norms ``| |p| - |r| |`` over the larger of the reference
  tensor's norm and the median tensor's norm, for the first gradient as
  the optimizer takes it and for the change of the parameters after the
  first steps; ``grad_gap_second`` and ``update_gap_second``, the second
  largest of those gaps (the largest is, on every sound run, the RPN
  objectness bias's, a sum over the sampled anchors whose terms cancel, so
  bf16 leaves 3-13% of it; the next tensors read under 1% and a gradient
  exchange left out moves several of them by 5-80%);
- inference: ``detection_mismatch``, detection slots that differ when the
  reference's post-processing runs on the program's class logits and box
  deltas; ``score_gap`` and ``box_gap``, the largest relative gap of a
  served detection's score, and of its box (over the box's size), from the
  reference's for the same proposal and class;
- the loader: ``loader_mismatch``, images whose pixels (more than 1 level
  apart: the native decoder and resize are within 1 of PIL's) or boxes
  differ from the reference's decode, resize, flip and padding of the
  source file.
"""
from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import boxes as bx
from benchmark.reference import train as ref_train
from benchmark.reference.model import Detector


@torch.no_grad()
def logit_gap(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> float:
    p = torch.cat([t.reshape(-1) for t in prog]).double()
    r = torch.cat([t.reshape(-1).to(p.device) for t in ref]).double()
    return float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r).clamp(min=1e-30))


@torch.no_grad()
def logit_peak_gap(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> float:
    p = torch.cat([t.reshape(-1) for t in prog]).double()
    r = torch.cat([t.reshape(-1).to(p.device) for t in ref]).double()
    return float((p - r).abs().max() / r.abs().max().clamp(min=1e-30))


@torch.no_grad()
def replay_selection(cfg: Dict, call: Dict, image_sizes: torch.Tensor, train: bool):
    """The reference's proposal selection on the program's objectness and
    deltas: (Selection, count of slots unlike the program's proposals)."""
    B = image_sizes.shape[0]
    if call["logits"][0].shape[0] != B:  # proposals for another number of images than the batch's
        return None, B * cfg["MODEL.RPN.POST_NMS_TOPK_TRAIN" if train else "MODEL.RPN.POST_NMS_TOPK_TEST"]
    det = Detector(cfg, {})
    anchors = bx.grid_anchors(cfg["MODEL.ANCHOR_GENERATOR.SIZES"], cfg["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"],
                              det.strides, call["grids"], image_sizes.device)
    boxes, valid, sel = det.select(anchors, call["logits"], call["deltas"], image_sizes, train)
    want_b, want_v = call["proposals"], call["prop_valid"]
    bad = (valid != want_v) | (valid & (boxes != want_b).any(-1))
    return sel, int(bad.sum())


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], grads: Dict[str, float]) -> Tuple[float, float, str]:
    """The gaps of norms over the tensors that count: (the largest, the
    second largest, the largest's tensor); a NaN gap counts as the
    largest."""
    med = statistics.median(grads.values())
    keep = [k for k in ref if grads[k] >= 1e-3 * med]
    ref_med = statistics.median(ref[k] for k in keep)
    gaps = {k: abs(prog[k] - ref[k]) / max(ref[k], ref_med, 1e-30) for k in keep}
    top = sorted(gaps.items(), key=lambda kv: -(math.inf if kv[1] != kv[1] else kv[1]))
    print("leaf gaps: " + ", ".join(f"{k}={v:.5f}" for k, v in top[:8]), file=sys.stderr)
    return top[0][1], top[1][1], top[0][0]


def train_numbers(cfg: Dict, prog: Dict, ref: Dict) -> Dict[str, float]:
    loss = 0.0
    for p, r in zip(prog["losses"], ref["losses"]):
        for k, v in r.items():
            g = abs(p[k] - v) / max(abs(v), 1e-12)
            loss = g if not g <= loss else loss
    grad, grad_second, grad_leaf = leaf_gap(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    update, update_second, update_leaf = leaf_gap(prog["update_norms"], ref["update_norms"], ref["grad_norms"])
    print(f"worst tensors: gradient {grad_leaf}, update {update_leaf}", file=sys.stderr)
    return {
        "proposal_mismatch": prog["proposal_mismatch"],
        "rpn_logit_gap": max(logit_gap(p, [t[: p[0].shape[0]] for t in r])
                             for p, r in zip(prog["rpn_logits"], ref["rpn_logits"])),
        "loss_gap": loss, "grad_gap": grad, "update_gap": update,
        "grad_gap_second": grad_second, "update_gap_second": update_second,
    }


def train_reference(cfg: Dict, params0: Dict[str, torch.Tensor], batches: Sequence[Dict], seeds: Sequence[int],
                    prog: Dict) -> Dict[str, float]:
    """Runs the reference's steps along the program's selections and
    compares. ``prog`` holds the program's readings (``program_readings``)."""
    ref = ref_train.steps(cfg, params0, batches, seeds, "fp32", prog["selections"])
    return train_numbers(cfg, prog, ref)


def program_readings(cfg: Dict, captures: Sequence[Dict], batches: Sequence[Dict], losses: Sequence[Dict],
                     grad_norms: Dict[str, float], update_norms: Dict[str, float]) -> Dict:
    sels, mismatch = [], 0
    for call, batch in zip(captures, batches):
        sel, bad = replay_selection(cfg, call, batch["image_size"], train=True)
        sels.append(None if sel is None else {"selection": sel, "proposals": call["proposals"]})
        mismatch += bad
    return {"losses": [{k: float(v) for k, v in d.items() if k != "total_loss"} for d in losses],
            "grad_norms": grad_norms, "update_norms": update_norms, "selections": sels,
            "rpn_logits": [c["logits"] for c in captures], "proposal_mismatch": mismatch}


def player_readings(cfg: Dict, params0, batches, seeds, precision: str, drop_half: bool = False) -> Dict:
    """The reference in the program's place (a control, or a planted fault):
    its own steps at ``precision``; ``drop_half`` leaves out the second half
    of each batch and takes the losses' means over the rest."""
    if drop_half:
        batches = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]
    out = ref_train.steps(cfg, params0, batches, seeds, precision)
    out["proposal_mismatch"] = 0
    return out


# ----------------------------------------------------------------- inference

@torch.no_grad()
def infer_numbers(cfg: Dict, params: Dict[str, torch.Tensor], batch: Dict, call: Dict, dets) -> Dict[str, float]:
    """One served batch: the program's capture of its RPN and predictor,
    and its detections (any object with boxes, scores, classes, valid and
    proposal_idx, on any device)."""
    dev = batch["image"].device
    sizes = batch["image_size"]
    sel, prop_bad = replay_selection(cfg, call, sizes, train=False)
    det = Detector(cfg, params)
    # the post-processing replayed on the program's own floats
    probs_p, boxes_p = det.decode(call["scores"], call["box_deltas"], call["proposals"])
    mine = det.detections(boxes_p, probs_p, sizes, call["prop_valid"])
    got = [getattr(dets, f).to(dev) for f in ("boxes", "scores", "classes", "valid", "proposal_idx")]
    v = got[3]
    det_bad = ((mine.valid != v) | (v & ((mine.classes != got[2]) | (mine.proposal_idx != got[4])
                                        | (mine.scores != got[1]) | (mine.boxes != got[0]).any(-1)))).sum()
    # the reference's own floats along the program's choices
    feats = det.features(batch["image"], sizes)
    anchors, logits, deltas = det.rpn_outputs(feats)
    if sel is None:
        _, _, sel = det.select(anchors, logits, deltas, sizes, train=False)
    proposals, _ = det.follow(sel, anchors, deltas, sizes)
    probs, boxes = det.predict(feats, proposals)
    B, R, K1 = probs.shape
    K = K1 - 1
    pidx, cls = got[4].long(), got[2].long()
    s_ref = torch.gather(probs.reshape(B, R * K1), 1, pidx * K1 + cls)
    box_ref = boxes.reshape(B, R * K, 4)
    box_ref = torch.gather(box_ref, 1, (pidx * K + cls)[..., None].expand(-1, -1, 4))
    box_ref = bx.clip(box_ref, sizes[:, 0, None].float(), sizes[:, 1, None].float())
    score_gap = ((got[1] - s_ref).abs() / s_ref.clamp(min=1e-30))[v]
    scale = torch.sqrt(bx.area(box_ref).clamp(min=1.0))
    box_gap = ((got[0] - box_ref).abs().amax(-1) / scale)[v]
    return {
        "proposal_mismatch": prop_bad, "detection_mismatch": int(det_bad),
        "rpn_logit_peak_gap": logit_peak_gap(call["logits"], logits),
        "score_gap": float(score_gap.max()) if score_gap.numel() else 0.0,
        "box_gap": float(box_gap.max()) if box_gap.numel() else 0.0,
    }


@torch.no_grad()
def infer_player(cfg: Dict, params, batch: Dict, precision: str):
    """The reference in the program's place at ``precision``: (a capture
    like the program's, its detections)."""
    det = Detector(cfg, params, precision)
    sizes = batch["image_size"]
    feats = det.features(batch["image"], sizes)
    anchors, logits, deltas = det.rpn_outputs(feats)
    proposals, valid, _ = det.select(anchors, logits, deltas, sizes, train=False)
    scores, box_deltas = det.predictor(det.box_features(feats, proposals))
    probs, boxes = det.decode(scores, box_deltas, proposals)
    dets = det.detections(boxes, probs, sizes, valid)
    call = {"grids": [tuple(feats[f].shape[2:4]) for f in ("p2", "p3", "p4", "p5", "p6")], "logits": logits,
            "deltas": deltas, "proposals": proposals, "prop_valid": valid, "scores": scores,
            "box_deltas": box_deltas}
    return call, dets


# -------------------------------------------------------------------- loader

def loader_mismatch(batch: Dict[str, np.ndarray], dicts: Sequence[Dict], cfg: Dict) -> int:
    """Images of a loader batch unlike the reference's own decode (PIL, in
    INPUT.FORMAT order), resize (the batch's size must be a MIN_SIZE_TRAIN
    choice's), flip and zero padding of some source file whose annotations
    give the batch's boxes."""
    from PIL import Image

    from benchmark.traffic.images import resized

    bad = 0
    by_size: Dict[Tuple[int, int], List[Dict]] = {}
    for d in dicts:
        by_size.setdefault((d["height"], d["width"]), []).append(d)
    for i in range(batch["image"].shape[0]):
        h, w = (int(v) for v in batch["image_size"][i])
        n = int(batch["gt_valid"][i].sum())
        got_boxes = batch["gt_boxes"][i][:n]
        found = None
        for (h0, w0), ds in by_size.items():
            if not any(resized(h0, w0, s, cfg["INPUT.MAX_SIZE_TRAIN"]) == (h, w) for s in cfg["INPUT.MIN_SIZE_TRAIN"]):
                continue
            for d in ds:
                if len(d["annotations"]) != n:
                    continue
                src = np.array([a["bbox"] for a in d["annotations"]], np.float32).reshape(-1, 4)
                src = np.stack([src[:, 0], src[:, 1], src[:, 0] + src[:, 2], src[:, 1] + src[:, 3]], 1)
                b = src.astype(np.float64)
                b[:, 0::2] *= w * 1.0 / w0
                b[:, 1::2] *= h * 1.0 / h0
                b = b.astype(np.float32)
                flipped = b.copy()
                flipped[:, 0], flipped[:, 2] = w - b[:, 2], w - b[:, 0]
                for flip, want in ((False, b), (True, flipped)):
                    if np.array_equal(want, got_boxes):
                        found = (d, flip)
                if found:
                    break
            if found:
                break
        if found is None:
            bad += 1
            continue
        d, flip = found
        img = np.asarray(Image.open(d["file_name"]).convert("RGB"))
        img = np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
        if cfg["INPUT.FORMAT"] == "BGR":
            img = img[:, :, ::-1]
        if flip:
            img = img[:, ::-1]
        want = np.zeros_like(batch["image"][i])
        want[:h, :w] = img
        if np.abs(want - batch["image"][i]).max() > 1.0:
            bad += 1
    return bad


# --------------------------------------------------------------------- judge

def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Every number at or under its limit; a number without a limit, or a
    limit without a number, is a failure."""
    out, ok = {}, set(numbers) == set(limits)
    for k in sorted(set(numbers) | set(limits)):
        v, lim = numbers.get(k, math.nan), limits.get(k, math.nan)
        out[k] = {"value": v, "limit": lim}
        ok = ok and v <= lim
    return ok, out
