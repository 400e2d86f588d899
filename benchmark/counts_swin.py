"""Operation and byte counts of Swin Mask R-CNN, from the configuration's
shapes and a canvas, never from what the program executes (as
``counts.py``).

``model_flops``: the multiply-adds (x2) of one image's products: the patch
embedding, each Swin block's qkv, QK^T, AV and projection on the windows of
its padded token grid and its MLP on the tokens, the patch mergings, the
FPN and the RPN head on every level, the box head and predictor on
BATCH_SIZE_PER_IMAGE boxes, and the mask head on the image's foreground
boxes (detectron2's mask head sees the foreground alone; the program's work
on the other slots is not model work), counted as its ground-truth boxes:
each is appended to the proposals and is foreground, so this is the least
foreground a step can have. A training step counts 3x (every weight
trains).

``attention_least_ms``: the least time the card could take for the forward
of every Swin block's attention branch on a batch, from its FLOPs (the four
products above) at the bf16 peak and its bytes (each block's input read,
its weights and bias table read, its output written, in bf16) at the memory
rate, the larger of the two, block by block.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

from benchmark.counts import HBM_BYTES_PER_S, PEAK_FLOPS, _conv
from benchmark.reference.swin_mask import swin_dims

BF16_BYTES = 2


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def blocks(cfg: Dict, H: int, W: int) -> Iterator[Tuple[int, int, int, int, int]]:
    """(h, w, padded tokens, channels, heads) of each Swin block of one
    image on an H x W canvas."""
    embed, depths, heads = swin_dims(cfg)
    ws = cfg["MODEL.SWIN.WINDOW_SIZE"]
    h, w = _ceil(H, cfg["MODEL.SWIN.PATCH_SIZE"]), _ceil(W, cfg["MODEL.SWIN.PATCH_SIZE"])
    for i, (depth, nh) in enumerate(zip(depths, heads)):
        c = embed * 2 ** i
        padded = _ceil(h, ws) * ws * _ceil(w, ws) * ws
        for _ in range(depth):
            yield h, w, padded, c, nh
        h, w = _ceil(h, 2), _ceil(w, 2)


def attention_flops(cfg: Dict, padded: int, c: int) -> float:
    """qkv, QK^T, AV and the projection of one block on ``padded`` tokens."""
    n = cfg["MODEL.SWIN.WINDOW_SIZE"] ** 2
    return 2.0 * padded * (3 * c * c + 2 * n * c + c * c)


def backbone_flops(cfg: Dict, H: int, W: int) -> Tuple[float, Dict[str, Tuple[int, int]]]:
    """(FLOPs of the Swin and the FPN for one image, FPN level shapes)."""
    embed, depths, _ = swin_dims(cfg)
    p = cfg["MODEL.SWIN.PATCH_SIZE"]
    h, w = _ceil(H, p), _ceil(W, p)
    flops = 2.0 * h * w * embed * 3 * p * p
    ratio = cfg["MODEL.SWIN.MLP_RATIO"]
    for bh, bw, padded, c, _ in blocks(cfg, H, W):
        flops += attention_flops(cfg, padded, c) + 2.0 * bh * bw * 2 * c * int(c * ratio)
    res = {}
    for i in range(len(depths)):
        c = embed * 2 ** i
        res[i + 2] = (h, w, c)
        if i < len(depths) - 1:
            h, w = _ceil(h, 2), _ceil(w, 2)
            flops += 2.0 * h * w * 4 * c * 2 * c
    fpn = cfg["MODEL.FPN.OUT_CHANNELS"]
    levels = {}
    for stage, (lh, lw, c) in res.items():
        flops += _conv(lh, lw, c, fpn, 1, 1, 0)[2] + _conv(lh, lw, fpn, fpn, 3, 1, 1)[2]
        levels[f"p{stage}"] = (lh, lw)
    h5, w5 = levels["p5"]
    levels["p6"] = ((h5 + 1) // 2, (w5 + 1) // 2)
    return flops, levels


def mask_head_flops(cfg: Dict) -> float:
    """One box: NUM_CONV 3x3 convs at P x P, the 2x2 stride-2 transposed
    conv to 2P x 2P, the 1x1 predictor."""
    P = cfg["MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION"]
    cm = cfg["MODEL.ROI_MASK_HEAD.CONV_DIM"]
    cin = cfg["MODEL.FPN.OUT_CHANNELS"]
    flops = 0.0
    for _ in range(cfg["MODEL.ROI_MASK_HEAD.NUM_CONV"]):
        flops += 2.0 * P * P * cm * cin * 9
        cin = cm
    M = 2 * P
    return flops + 2.0 * M * M * cm * cin + 2.0 * M * M * cfg["MODEL.ROI_HEADS.NUM_CLASSES"] * cm


def model_flops(cfg: Dict, H: int, W: int, gts: int) -> float:
    """Model FLOPs of a training step (x3) of one image on an H x W canvas
    with ``gts`` ground-truth boxes (the mask head's foreground, at most
    the sampler's BATCH_SIZE_PER_IMAGE x POSITIVE_FRACTION)."""
    flops, levels = backbone_flops(cfg, H, W)
    fpn = cfg["MODEL.FPN.OUT_CHANNELS"]
    A = len(cfg["MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS"][0])
    for h, w in levels.values():
        flops += 2.0 * h * w * fpn * (fpn * 9 + A + 4 * A)
    P = cfg["MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION"]
    fc = cfg["MODEL.ROI_BOX_HEAD.FC_DIM"]
    K = cfg["MODEL.ROI_HEADS.NUM_CLASSES"]
    per_box = 2.0 * (fpn * P * P * fc + (cfg["MODEL.ROI_BOX_HEAD.NUM_FC"] - 1) * fc * fc + fc * (K + 1) + fc * 4 * K)
    boxes = cfg["MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE"]
    masked = min(gts, int(boxes * cfg["MODEL.ROI_HEADS.POSITIVE_FRACTION"]))
    flops += per_box * boxes + mask_head_flops(cfg) * masked
    return 3.0 * flops


def attention_least_ms(cfg: Dict, B: int, H: int, W: int) -> float:
    """Least ms of the attention branches' forward for B images on an
    H x W canvas (bf16 under AMP)."""
    ws = cfg["MODEL.SWIN.WINDOW_SIZE"]
    total = 0.0
    for h, w, padded, c, nh in blocks(cfg, H, W):
        flops = B * attention_flops(cfg, padded, c)
        weights = 4 * c * c + 4 * c + (2 * ws - 1) ** 2 * nh + 2 * c  # qkv, proj, their biases, table, norm1
        nbytes = BF16_BYTES * (2 * B * h * w * c + weights)
        total += max(flops / PEAK_FLOPS["bf16"], nbytes / HBM_BYTES_PER_S)
    return 1e3 * total
