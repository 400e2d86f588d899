"""Training CLI of the UBBR box corrector, with its IoU test (twin of
``tools/train_net_reg.py``; the same flags as ``train_net``):

    python -m lvc_tpu_torch.tools.train_net_reg \\
        --config-file configs/COCO-detection/cascade_ubbr_R_50_FPN_base.yaml \\
        DATASETS.PROPOSAL_FILES_TRAIN "('props/coco_proposals_trainval_results.pkl',)" \\
        MODEL.WEIGHTS r50.pth OUTPUT_DIR out

``RegTrainer`` trains the config's model (RBG proposals and the cascade
heads); its ``test`` copies the weights into the reg-only meta-architecture
(strictly: no key missing or unexpected), regresses seeded jitters of every
test image's gt boxes (``jitter_candidates``, one ``RandomState(0)`` over
each padded (B, G) batch in turn, B = 1 image per batch here) and writes the
per-class mean input and output IoU with the gt to
``inference/results_<dataset>.json``. It runs on the card; ``MODEL.DEVICE
cpu`` asks for the CPU. With ``--num-gpus N`` the ranks train together and
the main rank alone runs the IoU test on the whole test set (its jitter is
one random stream over the batches in turn); the others return an empty
dict.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict

import numpy as np
import torch

from lvc_tpu_torch.data import builtin  # noqa: F401  (registers the COCO splits)
from lvc_tpu_torch.data.build import build_detection_test_loader
from lvc_tpu_torch.engine.defaults import DefaultTrainer, default_argument_parser
from lvc_tpu_torch.engine.launch import launch
from lvc_tpu_torch.modeling.meta_arch.build import build_model
from lvc_tpu_torch.structures import boxes as box_ops
from lvc_tpu_torch.tools.train_net import setup
from lvc_tpu_torch.utils import comm


def jitter_candidates(rng, gt_boxes, gt_valid, alpha=0.25, beta=0.3):
    """Seeded RBG-style jitter of (B, G, 4) numpy gt boxes: every tx, then
    every ty, tw and th of the padded batch from ``rng``."""
    x, y = gt_boxes[..., 0], gt_boxes[..., 1]
    w = gt_boxes[..., 2] - gt_boxes[..., 0]
    h = gt_boxes[..., 3] - gt_boxes[..., 1]
    tx = rng.uniform(-alpha, alpha, x.shape)
    ty = rng.uniform(-alpha, alpha, y.shape)
    tw = rng.uniform(np.log(1 - beta), np.log(1 + beta), w.shape)
    th = rng.uniform(np.log(1 - beta), np.log(1 + beta), h.shape)
    nx = x + w * tx
    ny = y + h * ty
    nw = w * np.exp(tw)
    nh = h * np.exp(th)
    out = np.stack([nx, ny, nx + nw, ny + nh], axis=-1).astype(np.float32)
    return np.where(gt_valid[..., None], out, gt_boxes)


def reg_only_model(cfg, model):
    """The reg-only meta-architecture of ``cfg`` holding ``model``'s
    weights, on ``model``'s device, in eval mode."""
    reg_cfg = cfg.clone().defrost()
    reg_cfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNNRegOnly"
    reg = build_model(reg_cfg.freeze(), device=next(model.parameters()).device)
    reg.load_state_dict(model.state_dict(), strict=True)
    return reg


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return box_ops.matched_pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()


class RegTrainer(DefaultTrainer):
    @classmethod
    def test(cls, cfg, model):
        """Per-class mean input and output IoU of the corrector (on the main
        rank)."""
        if not comm.is_main_process():
            return {}
        reg = reg_only_model(cfg, model)
        rng = np.random.RandomState(0)
        all_results = {}
        for dataset_name in cfg.DATASETS.TEST:
            loader = build_detection_test_loader(cfg, dataset_name, batch_size=1, with_gt=True)
            iou_in, iou_out = defaultdict(list), defaultdict(list)
            for batch, metas in loader:
                cands = jitter_candidates(rng, batch["gt_boxes"], batch["gt_valid"])
                out = reg(dict(batch, gt_boxes=cands))
                boxes, valid = out.boxes.cpu().numpy(), out.valid.cpu().numpy()
                for i, meta in enumerate(metas):
                    if meta.get("padding"):
                        continue
                    gt = batch["gt_boxes"][i]
                    before, after = _iou(cands[i], gt), _iou(boxes[i], gt)
                    cls_i = batch["gt_classes"][i]
                    for k in np.nonzero(batch["gt_valid"][i] & valid[i])[0]:
                        iou_in[int(cls_i[k])].append(float(before[k]))
                        iou_out[int(cls_i[k])].append(float(after[k]))
            per_class = {
                str(c): {
                    "iou_in": float(np.mean(iou_in[c])),
                    "iou_out": float(np.mean(iou_out[c])),
                    "n": len(iou_in[c]),
                }
                for c in sorted(iou_in)
            }
            mean_in = float(np.mean([v["iou_in"] for v in per_class.values()])) if per_class else 0.0
            mean_out = float(np.mean([v["iou_out"] for v in per_class.values()])) if per_class else 0.0
            results = {"per_class": per_class, "mean_iou_in": mean_in, "mean_iou_out": mean_out}
            print(f"[{dataset_name}] corrector IoU: in={mean_in:.4f} out={mean_out:.4f}")
            out_dir = os.path.join(cfg.OUTPUT_DIR, "inference")
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"results_{dataset_name.replace('/', '_')}.json"), "w") as f:
                json.dump(results, f)
            all_results[dataset_name] = {"ubbr": results}
        if len(all_results) == 1:
            return list(all_results.values())[0]
        return all_results


def main(args):
    cfg = setup(args)
    trainer = RegTrainer(cfg, eval_only=args.eval_only)
    trainer.resume_or_load(resume=args.resume)
    if args.eval_only:
        return RegTrainer.test(cfg, trainer.model)
    return trainer.train()


if __name__ == "__main__":
    args = default_argument_parser().parse_args()
    launch(main, args.num_gpus, args.num_machines, args.machine_rank, args.dist_url, args=(args,))
