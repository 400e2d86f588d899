"""Released-checkpoint URL table and loaders (counterpart of
``lvc_tpu/model_zoo/model_zoo.py``; lvc/model_zoo/model_zoo.py:11-182).

The FsDet/LVC table maps a config path to its checkpoint's URL, generated as
JAX generates it. ``get_config_file`` looks the path up under ``configs/`` at
the root of the checkout and raises when it is not there, which it is not for
any table entry (``configs/`` holds the COCO R-50 configs and the
verifier's). ``get`` builds the port's model with the ``"he"`` rule from seed
0, as ``DefaultPredictor`` does; with ``trained=True`` it loads the weights
only from a file already on disk, and nothing is fetched.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

URL_PREFIX = "http://dl.yf.io/fs-det/models/"


def _build_table() -> Dict[str, str]:
    t: Dict[str, str] = {}
    # PASCAL VOC: base + three method families x splits x shots
    for s in (1, 2, 3):
        t[f"PascalVOC-detection/split{s}/faster_rcnn_R_101_FPN_base{s}.yaml"] = (
            f"voc/split{s}/base_model/model_final.pth"
        )
        for shot in (1, 2, 3, 5, 10):
            t[f"PascalVOC-detection/split{s}/faster_rcnn_R_101_FPN_ft_all{s}_{shot}shot_unfreeze.yaml"] = (
                f"voc/split{s}/FRCN+ft-full_{shot}shot/model_final.pth"
            )
            t[f"PascalVOC-detection/split{s}/faster_rcnn_R_101_FPN_ft_all{s}_{shot}shot.yaml"] = (
                f"voc/split{s}/tfa_cos_{shot}shot/model_final.pth"
            )
            t[f"PascalVOC-detection/split{s}/faster_rcnn_R_101_FPN_ft_fc_all{s}_{shot}shot.yaml"] = (
                f"voc/split{s}/tfa_fc_{shot}shot/model_final.pth"
            )
    # COCO: base + TFA cos/fc x shots
    t["COCO-detection/faster_rcnn_R_101_FPN_base.yaml"] = "coco/base_model/model_final.pth"
    for shot in (1, 2, 3, 5, 10, 30):
        t[f"COCO-detection/faster_rcnn_R_101_FPN_ft_all_{shot}shot.yaml"] = (
            f"coco/tfa_cos_{shot}shot/model_final.pth"
        )
        t[f"COCO-detection/faster_rcnn_R_101_FPN_ft_fc_all_{shot}shot.yaml"] = (
            f"coco/tfa_fc_{shot}shot/model_final.pth"
        )
    # LVIS: depth x cls head x repeat sampling
    for depth in (50, 101):
        for cos, cs in (("", "fc"), ("_cosine", "cos")):
            for rep, rs in (("", "repeat"), ("_norepeat", "norepeat")):
                t[f"LVIS-detection/faster_rcnn_R_{depth}_FPN_base{rep}{cos}.yaml"] = (
                    f"lvis/R_{depth}_FPN_base_{rs}_{cs}/model_final.pth"
                )
    return t


CONFIG_PATH_TO_URL_SUFFIX = _build_table()
CONFIG_ROOT = Path(__file__).resolve().parents[2] / "configs"


def get_checkpoint_url(config_path: str) -> str:
    if config_path in CONFIG_PATH_TO_URL_SUFFIX:
        return URL_PREFIX + CONFIG_PATH_TO_URL_SUFFIX[config_path]
    raise RuntimeError(f"{config_path} not available in Model Zoo!")


def get_config_file(config_path: str) -> str:
    cfg_file = CONFIG_ROOT / config_path
    if not cfg_file.exists():
        raise RuntimeError(f"{config_path} not available in Model Zoo!")
    return str(cfg_file)


def get(config_path: str, trained: bool = False, device=None):
    """The config's model on ``device`` (``cfg.MODEL.DEVICE`` unless given),
    in eval mode, its weights the ``"he"`` rule from seed 0; with
    ``trained`` the zoo checkpoint is loaded if its path is a local file."""
    import torch

    from lvc_tpu_torch.checkpoint.checkpointer import DetectionCheckpointer
    from lvc_tpu_torch.config import get_cfg
    from lvc_tpu_torch.modeling.meta_arch.build import build_model, resolve_device
    from lvc_tpu_torch.utils.init import he_init

    cfg = get_cfg()
    cfg.merge_from_file(get_config_file(config_path))
    if trained:
        cfg.MODEL.WEIGHTS = get_checkpoint_url(config_path)
    device = resolve_device(device if device is not None else cfg.MODEL.DEVICE)
    model = build_model(cfg, device=device)
    he_init(model, torch.Generator(device=device).manual_seed(0))
    if cfg.MODEL.WEIGHTS and os.path.isfile(cfg.MODEL.WEIGHTS):
        DetectionCheckpointer(model).load(cfg.MODEL.WEIGHTS)
    return model.eval()
