"""Checkpoint surgery for few-shot fine-tuning (twin of
``tools/ckpt_surgery.py``, the same CLI and methods):

    python -m lvc_tpu_torch.tools.ckpt_surgery --method remove --coco \\
        --src1 out/base/model_final.pth --save-dir out/base/
    python -m lvc_tpu_torch.tools.ckpt_surgery --method combine --coco \\
        --src1 out/base/model_final.pth --src2 out/novel/model_final.pth --save-dir out/novel/

  --method remove           drop the final predictor layers
  --method randinit         re-init a (TAR_SIZE+1)-way classifier /
                            4*TAR_SIZE regressor, copying base-class rows
  --method combine          merge base rows from --src1 and novel rows from
                            --src2 (bg row from base)
  --method combine_parallel rewrite roi_heads.* into parallel base/novel
                            twin heads

Inputs are state dicts of detectron2 names: the port's ``.pth`` checkpoints
(``{"model": state_dict, ...}``), a detectron2 ``.pkl`` or a JAX ``.ckpt``
(flax msgpack, mapped by ``from_flax``). The result is written as
``<save-dir>/<tar-name>_<suffix>.pth``, ``{"model": state_dict,
"iteration": 0}``. ``randinit`` draws from ``np.random.RandomState(0)`` in
the order JAX's tool does, so both tools write the same arrays.
"""
from __future__ import annotations

import argparse
import copy
import os
from typing import Dict

import numpy as np
import torch

from lvc_tpu_torch.checkpoint.checkpointer import load_state_dict_file
from lvc_tpu_torch.data.builtin_meta import LVIS_NOVEL_IDS

NOVEL_CLASSES_COCO = [1, 2, 3, 4, 5, 6, 7, 9, 16, 17, 18, 19, 20, 21, 44, 62, 63, 64, 67, 72]
BASE_CLASSES_COCO = [
    8, 10, 11, 13, 14, 15, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37,
    38, 39, 40, 41, 42, 43, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 65, 70, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 84, 85, 86, 87,
    88, 89, 90,
]
SUFFIX = {"remove": "remove", "randinit": "surgery", "combine": "combine", "combine_parallel": "combine_parallel"}


parser = argparse.ArgumentParser(description="Checkpoint surgery for few-shot fine-tuning")
parser.add_argument("--src1", type=str, default="", help="Path to the main checkpoint")
parser.add_argument("--src2", type=str, default="", help="Path to the secondary checkpoint")
parser.add_argument("--save-dir", type=str, default="", help="Save directory")
parser.add_argument("--method", choices=list(SUFFIX), required=True)
parser.add_argument("--cascade", action="store_true")
parser.add_argument(
    "--param-name",
    type=str,
    nargs="+",
    default=["roi_heads.box_predictor.cls_score", "roi_heads.box_predictor.bbox_pred"],
)
parser.add_argument("--tar-name", type=str, default="model_reset")
parser.add_argument("--coco", action="store_true")
parser.add_argument("--lvis", action="store_true")


def load_any(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` or ``.pkl`` checkpoint -> its flat numpy state dict."""
    return {k: v.numpy() for k, v in load_state_dict_file(path).items()}


def save_pth(sd: Dict[str, np.ndarray], path: str) -> None:
    model = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({"model": model, "iteration": 0}, path)
    print(f"save changed ckpt to {path}")


def surgery(args) -> Dict[str, np.ndarray]:
    """The state dict that ``args.method`` makes of ``--src1`` (and
    ``--src2``)."""
    rng = np.random.RandomState(0)
    if args.coco:
        novel, base, tar_size = NOVEL_CLASSES_COCO, BASE_CLASSES_COCO, 80
    elif args.lvis:
        # LVIS v0.5: 454 rare (novel) categories out of 1230 contiguous ids
        novel = list(LVIS_NOVEL_IDS)
        base = [c for c in range(1230) if c not in set(novel)]
        tar_size = 1230
    else:
        novel, base, tar_size = None, None, 20
    idmap = {v: i for i, v in enumerate(sorted(base + novel))} if base is not None else None

    sd = load_any(args.src1)
    sd2 = load_any(args.src2) if args.method in ("combine", "combine_parallel") else None

    if args.method == "remove":
        for pname in args.param_name:
            sd.pop(pname + ".weight", None)
            sd.pop(pname + ".bias", None)
        return sd

    if args.method == "combine_parallel":
        new_sd = {k: copy.deepcopy(v) for k, v in sd.items() if "roi_heads" not in k}
        for k, v in sd.items():
            if "roi_heads" in k:
                new_sd[k.replace("roi_heads", "roi_heads.roi_heads.base")] = copy.deepcopy(v)
        for k, v in sd2.items():
            if "roi_heads" in k:
                new_sd[k.replace("roi_heads", "roi_heads.roi_heads.novel")] = copy.deepcopy(v)
        return new_sd

    tar_sizes = [tar_size + 1, tar_size * 4]
    if args.cascade:
        tar_sizes = [tar_size + 1] * len(args.param_name)

    def one_surgery(pname: str, is_weight: bool, tsize: int):
        wname = pname + (".weight" if is_weight else ".bias")
        if not is_weight and wname not in sd:
            return
        pretrained = sd[wname]
        prev_cls = pretrained.shape[0]
        if "cls_score" in pname:
            prev_cls -= 1
        if is_weight:
            new_w = rng.normal(0, 0.01, size=(tsize, pretrained.shape[1])).astype(pretrained.dtype)
        else:
            new_w = np.zeros((tsize,), pretrained.dtype)

        if base is not None:
            # base-class rows through the id map; the LVIS base detector
            # holds all-class rows, so its source row is the class id itself
            for i, c in enumerate(base):
                src = i if args.coco else c
                if "cls_score" in pname:
                    new_w[idmap[c]] = pretrained[src]
                else:
                    new_w[idmap[c] * 4 : (idmap[c] + 1) * 4] = pretrained[src * 4 : (src + 1) * 4]
        else:
            new_w[:prev_cls] = pretrained[:prev_cls]

        if args.method == "combine":
            w2 = sd2[wname]
            if base is not None:
                for i, c in enumerate(novel):
                    if "cls_score" in pname:
                        new_w[idmap[c]] = w2[i]
                    else:
                        new_w[idmap[c] * 4 : (idmap[c] + 1) * 4] = w2[i * 4 : (i + 1) * 4]
            elif "cls_score" in pname:
                new_w[prev_cls:-1] = w2[:-1]
            else:
                new_w[prev_cls:] = w2

        if "cls_score" in pname:
            new_w[-1] = pretrained[-1]  # the background row from the base detector
        sd[wname] = new_w

    for pname, tsize in zip(args.param_name, tar_sizes):
        one_surgery(pname, True, tsize)
        one_surgery(pname, False, tsize)
    return sd


def main(args) -> str:
    save_dir = args.save_dir or os.path.dirname(args.src1)
    os.makedirs(save_dir, exist_ok=True)
    save_path = os.path.join(save_dir, f"{args.tar_name}_{SUFFIX[args.method]}.pth")
    save_pth(surgery(args), save_path)
    return save_path


if __name__ == "__main__":
    main(parser.parse_args())
