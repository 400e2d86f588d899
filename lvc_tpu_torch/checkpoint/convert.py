"""Weight bridge between the JAX package's flax variables and the port.

The port's module names are detectron2's ``state_dict`` names, which
``lvc_tpu/checkpoint/convert.py:28`` (``torch_to_flax``) already maps onto the
flax tree. ``from_flax`` is the inverse of that mapping (as ``flax_to_torch``
at ``convert.py:113`` is): conv kernels HWIO -> OIHW, dense kernels
(in, out) -> (out, in), FrozenBN affine and statistics to ``<conv>.norm.*``.
``to_flax`` goes the other way. The cascade heads' stages are
``box_head_{k}``/``box_predictor_{k}`` in flax and ``box_head.{k}``/
``box_predictor.{k}`` in the state_dict (``convert.py:51-53, 119-123``).
``CosineSimOutputLayers`` keeps a bare ``cls_score_weight`` (in, K+1) in
flax and ``cls_score.weight`` (K+1, in) with no bias here; its learnable
``scale`` has one name in both (``convert.py:80, 109, 136``).
``ParallelStandardROIHeads``' twins are ``roi_heads/{base,novel}_head`` in
flax and ``roi_heads.roi_heads.{base,novel}`` here, the keys
``ckpt_surgery --method combine_parallel`` writes (JAX's ``torch_to_flax``
keeps that doubled prefix, so its flax tree cannot take such a file). The
C4 head's blocks are ``res5.{0,1,2}`` in both, its extra regressor
``bbox_branch``. ``GeneralizedRCNN_Context``'s head is a bare flax
``nn.Conv`` and ``nn.Dense``: ``cont_conv/{kernel,bias}`` and
``cont_cls/kernel`` in flax, ``cont_conv.{weight,bias}`` and
``cont_cls.weight`` here (JAX's ``torch_to_flax`` sends a reference
``cont_conv`` to ``cont_conv/conv/*``, which its tree does not hold).
The mask and keypoint heads are bare flax ``nn.Conv``/``nn.ConvTranspose``
too (``roi_heads/mask_head/{mask_fcn1..n,deconv,predictor}``,
``roi_heads/keypoint_head/{conv_fcn1..n,score_lowres}``), detectron2's
names here. flax's ``ConvTranspose`` (``transpose_kernel=False``) stores
(kh, kw, in, out) and does not flip its kernel; ``nn.ConvTranspose2d``
stores (in, out, kh, kw) and computes the true transpose of a convolution,
so ``deconv`` and ``score_lowres`` are flipped in both spatial axes on the
way across (JAX's ``torch_to_flax`` maps every 4-D weight to
``<module>/conv/kernel`` unflipped, so its tree cannot take a reference mask
or keypoint head).
The dense meta-architectures: RetinaNet's towers are
``head/{cls,bbox}_subnet_{i}`` in flax and ``head.{cls,bbox}_subnet.{2i}``
here (detectron2's ``nn.Sequential`` of conv and ReLU), the semantic head's
blocks ``sem_seg_head/{f}_conv{k}`` (and their ``GroupNorm_0``) in flax and
``sem_seg_head.{f}.{2k}`` (and ``.norm``) here, the ``p6p7`` top block
``backbone/top_block_p{6,7}`` in flax and ``backbone.top_block.p{6,7}``
here. JAX's ``torch_to_flax`` sends ``head.cls_subnet.2.weight`` to
``head/cls_subnet/2/conv/kernel``, which its tree does not hold, so JAX
cannot load a detectron2 RetinaNet or semantic head.
``vit_from_flax`` and ``vit_to_flax`` do the same for the DINO verifier
ViT. All work on plain nested dicts of numpy
arrays, so the port needs neither flax nor jax.
"""
from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

_RES_BLOCK = re.compile(r"res\d\.\d+")
_RES_STAGE = re.compile(r"res\d")
_CASCADE = re.compile(r"^(box_head|box_predictor)_(\d+)$")
_CASCADE_MODULES = ("box_head", "box_predictor")
_TWINS = {"base_head": "base", "novel_head": "novel"}  # flax name -> ParallelStandardROIHeads key
_BARE_HEADS = ("mask_head", "keypoint_head")  # heads of bare flax nn.Conv / nn.ConvTranspose modules
_TRANSPOSED = ("deconv", "score_lowres")  # their ConvTranspose modules
_DENSE_PARTS = (  # flax module name -> the port's dotted path, for RetinaNet, the semantic head and the p6p7 block
    (re.compile(r"^(cls_subnet|bbox_subnet)_(\d+)$"), lambda m: f"{m[1]}.{2 * int(m[2])}"),
    (re.compile(r"^(p\d+)_conv(\d+)$"), lambda m: f"{m[1]}.{2 * int(m[2])}"),
    (re.compile(r"^top_block_(p\d+)$"), lambda m: f"top_block.{m[1]}"),
)
_TOWERS = ("cls_subnet", "bbox_subnet")


def _part_to_torch(part: str) -> str:
    part = _CASCADE.sub(r"\1.\2", part)
    for pattern, repl in _DENSE_PARTS:
        part = pattern.sub(repl, part)
    return part


def _in_bare_head(parts) -> bool:
    return any(p in _BARE_HEADS for p in parts)


def _twin_to_torch(path):
    """``roi_heads/base_head/...`` -> ``roi_heads.roi_heads.base...``."""
    if len(path) > 2 and path[0] == "roi_heads" and path[1] in _TWINS:
        return ("roi_heads", "roi_heads", _TWINS[path[1]]) + tuple(path[2:])
    return tuple(path)


def _flatten(tree: Dict, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _unflatten(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` numpy tree -> the port's state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(variables.get("params", {})).items():
        parts = [_part_to_torch(p) for p in _twin_to_torch(path)]
        if parts[-1] == "kernel" and parts[-2] == "conv":
            out[".".join(parts[:-2]) + ".weight"] = v.transpose(3, 2, 0, 1)
        elif parts[-1] == "bias" and parts[-2] == "conv":
            out[".".join(parts[:-2]) + ".bias"] = v
        elif parts[-1] == "kernel" and parts[-2] in _TRANSPOSED and _in_bare_head(parts):
            out[".".join(parts[:-1]) + ".weight"] = v[::-1, ::-1].transpose(2, 3, 0, 1)
        elif parts[-1] == "kernel" and v.ndim == 4:  # a bare nn.Conv (cont_conv, the mask and keypoint heads)
            out[".".join(parts[:-1]) + ".weight"] = v.transpose(3, 2, 0, 1)
        elif parts[-1] == "kernel":
            out[".".join(parts[:-1]) + ".weight"] = v.T
        elif parts[-1] == "cls_score_weight":
            out[".".join(parts[:-1] + ["cls_score", "weight"])] = v.T
        elif parts[-2] == "FrozenBatchNorm_0":
            out[".".join(parts[:-2]) + ".norm." + parts[-1]] = v
        elif parts[-2] == "GroupNorm_0":
            out[".".join(parts[:-2]) + ".norm." + {"scale": "weight"}.get(parts[-1], parts[-1])] = v
        else:
            out[".".join(parts)] = v
    for path, v in _flatten(variables.get("batch_stats", {})).items():
        path = _twin_to_torch(path)
        if path[-2] != "FrozenBatchNorm_0":
            raise KeyError(f"unexpected batch_stats entry {'/'.join(path)}")
        out[".".join(path[:-2]) + ".norm." + path[-1]] = v
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in out.items()}


def to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """The port's state_dict -> ``{"params", "batch_stats"}`` numpy tree, the
    layout ``torch_to_flax`` produces. A norm with running statistics is
    FrozenBN; one without them is GroupNorm (``GroupNorm_0/{scale,bias}``)."""
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    stats: Dict[Tuple[str, ...], np.ndarray] = {}
    for key, val in state_dict.items():
        if key in ("pixel_mean", "pixel_std"):
            continue
        v = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        parts = []
        for p in key.split("."):
            # flax names stage blocks "res2.0": re-fuse stage and block index
            if parts and _RES_STAGE.fullmatch(parts[-1]) and p.isdigit():
                parts[-1] = parts[-1] + "." + p
            elif parts and parts[-1] in _CASCADE_MODULES and p.isdigit():
                parts[-1] = parts[-1] + "_" + p  # a cascade stage
            elif parts and parts[-1] in _TOWERS and p.isdigit():
                parts[-1] = f"{parts[-1]}_{int(p) // 2}"  # a RetinaNet tower conv
            elif len(parts) == 2 and parts[0] == "sem_seg_head" and p.isdigit():
                parts[-1] = f"{parts[-1]}_conv{int(p) // 2}"  # a semantic head block
            elif parts and parts[-1] == "top_block":
                parts[-1] = f"top_block_{p}"
            else:
                parts.append(p)
        if parts[:2] == ["roi_heads", "roi_heads"] and parts[2] in _TWINS.values():
            parts[1:3] = [parts[2] + "_head"]  # a ParallelStandardROIHeads twin
        name, mod = parts[-1], parts[:-1]
        if mod and mod[-1] == "norm" and key.rsplit(".", 1)[0] + ".running_var" not in state_dict:
            if name not in ("weight", "bias"):
                raise KeyError(f"unrecognized norm key {key}")
            params[tuple(mod[:-1] + ["GroupNorm_0", {"weight": "scale"}.get(name, name)])] = v
        elif mod and mod[-1] == "norm":
            base = mod[:-1] + ["FrozenBatchNorm_0"]
            if name in ("weight", "bias"):
                params[tuple(base + [name])] = v
            elif name in ("running_mean", "running_var"):
                stats[tuple(base + [name])] = v
            else:
                raise KeyError(f"unrecognized norm key {key}")
        elif mod == ["cont_conv"] or (_in_bare_head(mod) and v.ndim in (1, 4)):  # bare nn.Conv / ConvTranspose
            if name == "weight":
                v = v.transpose(2, 3, 0, 1)[::-1, ::-1] if mod[-1] in _TRANSPOSED else v.transpose(2, 3, 1, 0)
            params[tuple(mod + [{"weight": "kernel"}.get(name, name)])] = v
        elif name == "weight" and v.ndim == 4:
            params[tuple(mod + ["conv", "kernel"])] = v.transpose(2, 3, 1, 0)
        elif name == "weight" and v.ndim == 2 and mod[-1] == "cls_score" and (
            key.rsplit(".", 1)[0] + ".bias" not in state_dict
        ):
            params[tuple(mod[:-1] + ["cls_score_weight"])] = v.T  # the cosine classifier
        elif name == "weight" and v.ndim == 2:
            params[tuple(mod + ["kernel"])] = v.T
        elif name == "bias" and state_dict[".".join(key.split(".")[:-1]) + ".weight"].dim() == 4:
            params[tuple(mod + ["conv", "bias"])] = v
        else:
            params[tuple(mod + [name])] = v
    out = {"params": _unflatten(params)}
    if stats:
        out["batch_stats"] = _unflatten(stats)
    return out


# ---------------------------------------------------------------------------
# The DINO verifier ViT (``modeling/backbone/vit.py``)
# ---------------------------------------------------------------------------


def vit_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """The JAX ViT's ``{"params"}`` numpy tree -> the port's (DINO's) state
    dict: the inverse of ``convert_dino_torch_params``
    (``lvc_tpu/modeling/backbone/vit.py:214``). Dense kernels (in, out) ->
    (out, in), the patch-embed kernel (kh, kw, in, out) -> (out, in, kh, kw),
    LayerNorm ``scale`` -> ``weight``."""
    out: Dict[str, torch.Tensor] = {}
    for path, v in _flatten(variables["params"]).items():
        parts, name = list(path[:-1]), path[-1]
        if parts == ["patch_embed"]:
            parts.append("proj")
            if name == "kernel":
                v = v.transpose(3, 2, 0, 1)
        elif name == "kernel":
            v = v.T
        key = ".".join(parts + [{"kernel": "weight", "scale": "weight"}.get(name, name)])
        out[key] = torch.from_numpy(np.array(v, dtype=np.float32))
    return out


def vit_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict:
    """The port's (or a DINO checkpoint's) ViT state dict -> the JAX ViT's
    ``{"params"}`` tree; ``head.*`` is dropped. The inverse of
    ``vit_from_flax``."""
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    for key, val in state_dict.items():
        if key.startswith("head."):
            continue
        v = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        parts = key.split(".")
        if parts[0] == "blocks":  # flax names the block "blocks.{i}"
            parts = [f"blocks.{parts[1]}"] + parts[2:]
        mod, name = parts[:-1], parts[-1]
        if mod == ["patch_embed", "proj"]:
            mod = ["patch_embed"]
            if name == "weight":
                v, name = v.transpose(2, 3, 1, 0), "kernel"
        elif name == "weight" and v.ndim == 2:
            v, name = v.T, "kernel"
        elif name == "weight":
            name = "scale"
        params[tuple(mod + [name])] = v
    return {"params": _unflatten(params)}
