"""Weight bridge between the JAX package's flax variables and the port.

The port's module names are detectron2's ``state_dict`` names, which
``lvc_tpu/checkpoint/convert.py:28`` (``torch_to_flax``) already maps onto the
flax tree. ``from_flax`` is the inverse of that mapping (as ``flax_to_torch``
at ``convert.py:113`` is): conv kernels HWIO -> OIHW, dense kernels
(in, out) -> (out, in), the affine and statistics of FrozenBN and of
``SyncBatchNorm`` (``FrozenBatchNorm_0`` and ``SyncBatchNorm_0``, the
affine in ``params``, the statistics in ``batch_stats``) to
``<conv>.norm.*``. ``to_flax`` goes the other way; a state dict alone does
not tell a SyncBN norm from a FrozenBN one (both hold running statistics),
so ``to_flax`` takes the model for that. JAX's ``torch_to_flax`` names
every detectron2 ``.norm`` ``FrozenBatchNorm_0``, so its tree of a
detectron2 SyncBN checkpoint does not hold a SyncBN model's norms. The
cascade heads' stages are ``box_head_{k}``/``box_predictor_{k}`` in flax and ``box_head.{k}``/
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
The Swin bottom-up (``backbone/bottom_up``) keeps the public Swin names
here: flax's ``patch_embed/{kernel,bias}`` (a bare ``nn.Conv``),
``patch_norm`` and ``out_norm{i}`` are ``patch_embed.proj``,
``patch_embed.norm`` and ``norm{i}``; LayerNorm ``scale`` is ``weight``;
flax's dotted module names (``layers.0.blocks.1``, ``mlp.fc1``,
``layers.0.downsample``) are the same dotted paths. JAX's ``torch_to_flax``
cannot load such a state dict: it sends ``patch_embed.proj.weight`` to
``patch_embed/proj/conv/kernel``, ``layers.0.blocks.1.attn.qkv.weight`` to
``layers/0/blocks/1/attn/qkv/kernel`` and a LayerNorm's ``weight`` to
``weight`` rather than ``scale``, none of which its tree holds. A
deformable block's 3x3 is ``conv2/offset_conv`` (a bare ``nn.Conv``),
``conv2/weight`` (HWIO, no ``conv`` child) and the block's own
``FrozenBatchNorm_0`` (or ``GroupNorm_0``) in flax, detectron2's
``conv2_offset``, ``conv2.weight`` and ``conv2.norm`` here; JAX's
``torch_to_flax`` sends ``conv2.weight`` to ``conv2/conv/kernel`` and
``conv2.norm`` to ``conv2/FrozenBatchNorm_0``, so it cannot load a
detectron2 DCN checkpoint either.
``vit_from_flax`` and ``vit_to_flax`` do the same for the DINO verifier
ViT. All work on plain nested dicts of numpy
arrays, so the port needs neither flax nor jax. ``load_flax_checkpoint`` reads
the JAX checkpointer's ``.ckpt`` files (flax's msgpack) into such a dict with
``msgpack`` and numpy alone.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

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
_SWIN_TOP = re.compile(r"^(patch_embed|patch_norm|out_norm\d+|layers\.\d+\.(blocks\.\d+|downsample))$")
_SWIN_KEY = re.compile(r"^(.*bottom_up)\.(patch_embed\..*|norm\d+\..*|layers\.\d+\.(blocks\.\d+|downsample)\..*)$")
_SWIN_MODULE = re.compile(r"^(layers\.\d+\.(?:blocks\.\d+|downsample))\.(.*)$")
_STAT_NORMS = ("FrozenBatchNorm_0", "SyncBatchNorm_0")  # the flax norms with batch_stats
_NORMS = _STAT_NORMS + ("GroupNorm_0",)


def _flax_ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray ext payload: msgpack of (shape, dtype name, C-order
    bytes). numpy has no bfloat16: such arrays come back as float32, exactly."""
    import msgpack

    shape, dtype, buffer = msgpack.unpackb(data, raw=True)
    if dtype == b"bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype.decode())).reshape(shape).copy()


def _flax_ext(code: int, data: bytes):
    """flax's msgpack ext types for arrays (``flax.serialization._MsgpackExtType``):
    1 an ndarray, 3 a numpy scalar."""
    if code == 1:
        return _flax_ndarray(data)
    if code == 3:
        return _flax_ndarray(data)[()]
    raise ValueError(f"flax msgpack ext type {code} holds no array")


def _unchunk(tree: Any) -> Any:
    """flax stores an array over its chunk size as ``{"__msgpack_chunked_array__",
    "shape", "chunks"}`` with tuples as ``{"0": ..., "1": ...}`` dicts."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_flax_checkpoint(path: str) -> Dict:
    """A ``.ckpt`` that the JAX package wrote (``DetectionCheckpointer.save``:
    ``flax.serialization.to_bytes`` of a ``TrainState``, or the
    variables-only file of ``tools/convert_reference_ckpt.py``) -> its
    ``{"params", "batch_stats"}`` as nested dicts of numpy arrays, for
    ``from_flax``. Reads flax's msgpack with ``msgpack`` and numpy alone."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            f"reading the JAX checkpoint {path} needs the msgpack package, which this "
            "environment lacks; convert it to a .pth with "
            "lvc_tpu_torch.tools.convert_reference_ckpt where msgpack is installed"
        ) from e
    with open(path, "rb") as f:
        tree = _unchunk(msgpack.unpackb(f.read(), ext_hook=_flax_ext, raw=False))
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError(f"{path} holds no flax variables (no 'params' entry)")
    return {"params": tree["params"], "batch_stats": tree.get("batch_stats") or {}}


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


def _swin_from_flax(path, v):
    """(port key, value) of a Swin bottom-up leaf, else None."""
    if "bottom_up" not in path:
        return None
    i = path.index("bottom_up") + 1
    if i >= len(path) - 1 or not _SWIN_TOP.match(path[i]):
        return None
    head, top, rest, leaf = list(path[:i]), path[i], list(path[i + 1:-1]), path[-1]
    if top == "patch_embed":
        mod = ["patch_embed", "proj"]
        v = v.transpose(3, 2, 0, 1) if leaf == "kernel" else v
    else:
        mod = [{"patch_norm": "patch_embed.norm"}.get(top, top.replace("out_norm", "norm"))] + rest
        v = v.T if leaf == "kernel" else v
    return ".".join(head + mod + [{"kernel": "weight", "scale": "weight"}.get(leaf, leaf)]), v


def _deform_from_flax(flat):
    """Moves a flax deformable block's leaves to detectron2's places:
    ``conv2/offset_conv`` -> ``conv2_offset`` (a bare conv), ``conv2/weight``
    -> ``conv2/conv/kernel``, the block's ``FrozenBatchNorm_0`` /
    ``SyncBatchNorm_0`` / ``GroupNorm_0`` -> ``conv2``'s."""
    blocks = {p[:-3] for p in flat if len(p) > 3 and p[-3:-1] == ("conv2", "offset_conv")}
    out = {}
    for path, v in flat.items():
        if path[:-3] in blocks and path[-3:-1] == ("conv2", "offset_conv"):
            path = path[:-3] + ("conv2_offset", path[-1])
        elif path[:-2] in blocks and path[-2:] == ("conv2", "weight"):
            path = path[:-2] + ("conv2", "conv", "kernel")
        elif path[:-2] in blocks and path[-2] in _NORMS:
            path = path[:-2] + ("conv2",) + path[-2:]
        out[path] = v
    return out


def from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` numpy tree -> the port's state_dict."""
    return flax_state_dict(variables)[0]


def flax_state_dict(variables: Dict) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """``from_flax``'s state_dict, and the flax norm (``FrozenBatchNorm_0``,
    ``SyncBatchNorm_0``, ``GroupNorm_0``) of each of its norm entries."""
    out: Dict[str, torch.Tensor] = {}
    norms: Dict[str, str] = {}
    params = _flatten(variables.get("params", {}))
    for path, v in _deform_from_flax(params).items():
        swin = _swin_from_flax(path, v)
        if swin is not None:
            out[swin[0]] = swin[1]
            continue
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
        elif parts[-2] in _NORMS:
            key = ".".join(parts[:-2]) + ".norm." + {"scale": "weight"}.get(parts[-1], parts[-1])
            out[key], norms[key] = v, parts[-2]
        else:
            out[".".join(parts)] = v
    for path, v in _flatten(variables.get("batch_stats", {})).items():
        path = _twin_to_torch(path)
        if path[-2] in _STAT_NORMS and path[:-2] + ("conv2", "offset_conv", "kernel") in params:
            path = path[:-2] + ("conv2",) + path[-2:]  # a deformable block's norm
        if path[-2] not in _STAT_NORMS:
            raise KeyError(f"unexpected batch_stats entry {'/'.join(path)}")
        key = ".".join(path[:-2]) + ".norm." + path[-1]
        out[key], norms[key] = v, path[-2]
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in out.items()}, norms


def to_flax(state_dict: Dict[str, torch.Tensor], model: Optional[torch.nn.Module] = None) -> Dict:
    """The port's state_dict -> ``{"params", "batch_stats"}`` numpy tree, the
    layout ``torch_to_flax`` produces. A norm without running statistics is
    GroupNorm (``GroupNorm_0/{scale,bias}``); one with them is
    ``SyncBatchNorm_0`` where it is a ``SyncBatchNorm`` of ``model`` (the
    module the state dict came from), else FrozenBN."""
    from lvc_tpu_torch.modeling.layers import SyncBatchNorm

    sync = set() if model is None else {n for n, m in model.named_modules() if isinstance(m, SyncBatchNorm)}
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    stats: Dict[Tuple[str, ...], np.ndarray] = {}
    deform = {k[: -len(".conv2_offset.weight")] for k in state_dict if k.endswith(".conv2_offset.weight")}
    for key, val in state_dict.items():
        if key in ("pixel_mean", "pixel_std"):
            continue
        v = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else np.asarray(val)
        swin = _SWIN_KEY.match(key)
        if swin:
            path, v = _swin_to_flax(swin[1].split("."), swin[2], v)
            params[path] = v
            continue
        block, _, rest = key.rpartition(".conv2")
        if block in deform and (rest in (".weight", "_offset.weight", "_offset.bias") or rest.startswith(".norm.")):
            path, kind = _deform_to_flax(_block_parts(block), rest, key, state_dict, sync)
            (stats if kind == "stats" else params)[path] = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v
            continue
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
            base = mod[:-1] + [_stat_norm(key, sync)]
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


def _stat_norm(key: str, sync) -> str:
    """The flax name of the norm holding ``key``, one with running
    statistics."""
    return "SyncBatchNorm_0" if key.rsplit(".", 1)[0] in sync else "FrozenBatchNorm_0"


def _block_parts(block: str):
    """A block's port path as flax parts (``res3.0`` fused)."""
    parts = []
    for p in block.split("."):
        if parts and _RES_STAGE.fullmatch(parts[-1]) and p.isdigit():
            parts[-1] = parts[-1] + "." + p
        else:
            parts.append(p)
    return parts


def _deform_to_flax(block, rest: str, key: str, state_dict, sync):
    """(flax path, "params" or "stats") of a deformable block's 3x3 leaf
    (``rest``: what follows ``conv2`` in ``key``; ``sync``: the names of
    the SyncBN norms)."""
    if rest == ".weight":
        return tuple(block + ["conv2", "weight"]), "params"
    if rest.startswith("_offset."):
        return tuple(block + ["conv2", "offset_conv", {"weight": "kernel"}.get(rest[8:], rest[8:])]), "params"
    leaf = rest[len(".norm."):]
    if key.rsplit(".", 1)[0] + ".running_var" not in state_dict:
        return tuple(block + ["GroupNorm_0", {"weight": "scale"}.get(leaf, leaf)]), "params"
    return tuple(block + [_stat_norm(key, sync), leaf]), "stats" if leaf.startswith("running_") else "params"


def _swin_to_flax(head, rest: str, v):
    """(flax path, value) of a Swin bottom-up key: ``head`` the parts up to
    ``bottom_up``, ``rest`` the key after it."""
    mod, leaf = rest.rsplit(".", 1)
    if mod == "patch_embed.proj":
        return tuple(head + ["patch_embed", {"weight": "kernel"}.get(leaf, leaf)]), (
            v.transpose(2, 3, 1, 0) if leaf == "weight" else v)
    m = _SWIN_MODULE.match(mod)
    if m:
        path = m[2].split(".")
        if path[0] == "mlp":  # flax names the MLP's layers "mlp.fc1", "mlp.fc2"
            path = [f"mlp.{path[1]}"] + path[2:]
        path = [m[1]] + path
    else:
        path = [{"patch_embed.norm": "patch_norm"}.get(mod, mod.replace("norm", "out_norm"))]
    if leaf == "weight" and v.ndim == 2:
        return tuple(head + path + ["kernel"]), v.T
    return tuple(head + path + [{"weight": "scale"}.get(leaf, leaf)]), v


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
